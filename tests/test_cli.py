"""In-process CLI tests for the app entry points (file modes)."""

import io
import sys

import numpy as np
import pytest

from tpu_sdr.utils import synth


@pytest.fixture
def capture_file(tmp_path):
    u8, _ = synth.synth_wbfm_u8(510 * 500, capture_rate=1_020_000)
    path = tmp_path / "cap.bin"
    path.write_bytes(bytes(u8))
    return str(path)


class _BinStdout:
    def __init__(self):
        self.buffer = io.BytesIO()

    def flush(self):
        pass

    def write(self, s):  # stray text writes
        pass


def _run_capture_stdout(main, argv):
    old = sys.stdout
    sys.stdout = out = _BinStdout()
    try:
        rc = main(argv)
    finally:
        sys.stdout = old
    return rc, out.buffer.getvalue()


@pytest.mark.parametrize("mode", ["fir", "exact", "boxcar"])
def test_simple_fm_file_modes(capture_file, mode):
    from tpu_sdr.apps.simple_fm import main

    rc, audio = _run_capture_stdout(main, ["--file", capture_file,
                                           "--mode", mode])
    assert rc == 0
    assert len(audio) > 8000  # s16 samples emitted
    pcm = np.frombuffer(audio, dtype="<i2").astype(np.float64)
    snr = synth.tone_snr(pcm, 1_000.0, 32_000, skip=300)
    # the exact integer chain and its float twin share the reference's
    # boxcar filters, which score lower on short captures with the
    # startup transient included
    floor = 25.0 if mode == "fir" else 18.0
    assert snr >= floor, f"{mode}: {snr:.1f} dB"


def test_rtl_fm_am_mode(tmp_path):
    from tpu_sdr.apps.rtl_fm import main

    n = 510 * 500
    t = np.arange(n) / 1_020_000
    bb = 0.45 * (1.0 + 0.8 * np.sin(2 * np.pi * 1_000.0 * t))
    k = np.arange(n) % 4
    off = np.choose(k, [1 + 0j, -1j, -1 + 0j, 1j])
    sig = bb * off
    iq = np.empty(2 * n)
    iq[0::2], iq[1::2] = sig.real, sig.imag
    path = tmp_path / "am.bin"
    path.write_bytes(np.clip(np.round(iq * 127.0 + 127.5), 0, 255)
                     .astype(np.uint8).tobytes())

    rc, audio = _run_capture_stdout(main, ["-M", "am", "--file", str(path)])
    assert rc == 0
    pcm = np.frombuffer(audio, dtype="<i2").astype(np.float64)
    snr = synth.tone_snr(pcm, 1_000.0, 32_000, skip=300)
    assert snr >= 25.0, f"AM CLI: {snr:.1f} dB"


def test_multi_fm_writes_station_files(tmp_path):
    from tpu_sdr.apps.multi_fm import main

    u8, _ = synth.synth_multistation_u8(
        64 * 85 * 4 * 20, 64 * 170_000,
        station_freqs=[3 * 170_000.0], audio_freqs=[1_000.0],
        deviation=45_000.0)
    path = tmp_path / "wb.bin"
    path.write_bytes(bytes(u8))
    out_dir = tmp_path / "out"
    rc = main(["--file", str(path), "--channels", "3",
               "--out-dir", str(out_dir)])
    assert rc == 0
    raw = (out_dir / "station_3.raw").read_bytes()
    pcm = np.frombuffer(raw, dtype="<i2").astype(np.float64)
    snr = synth.tone_snr(pcm, 1_000.0, 32_000, skip=300)
    assert snr >= 25.0, f"multi_fm: {snr:.1f} dB"


def test_rtl_fm_rds_prints_station_text(tmp_path, capsys):
    """rtl_fm --rds decodes PI/PS from a synthesized RDS multiplex and
    prints them to stderr while audio still flows to stdout."""
    from tpu_sdr.apps.rtl_fm import main
    from tpu_sdr.models import rds as R

    pi, ps = 0xBEEF, "RDSRADIO"
    groups = [R.make_group_0a(pi, 4, seg, ps[2 * seg: 2 * seg + 2])
              for seg in range(4)]
    bits = np.concatenate([np.concatenate(groups)] * 5)
    n = int(np.ceil((len(bits) + 8) / 1187.5 * 1_020_000))
    n -= n % (6 * 85)
    u8, _, _ = synth.synth_wbfm_stereo_u8(n, capture_rate=1_020_000,
                                          rds_bits=bits)
    path = tmp_path / "rds.bin"
    path.write_bytes(bytes(u8))

    rc, audio = _run_capture_stdout(
        main, ["--file", str(path), "--rds"])
    assert rc == 0
    assert len(audio) > 1000
    err = capsys.readouterr().err
    assert f"[rds] PI: {pi:04X}" in err
    assert f"[rds] PS: '{ps}'" in err


def test_multi_fm_rds_per_station(tmp_path, capsys):
    """Band-wide RDS: the wideband receiver demodulates two stations at
    once and the per-station RDS decoders identify the one carrying a
    subcarrier — the [rds ch<N>] lines name the right channel."""
    from tpu_sdr.apps.multi_fm import main
    from tpu_sdr.models import rds as R

    pi, ps = 0xC0DE, "WIDEBAND"
    groups = [R.make_group_0a(pi, 7, seg, ps[2 * seg: 2 * seg + 2])
              for seg in range(4)]
    bits = np.concatenate([np.concatenate(groups)] * 4)
    K, ch_rate = 16, 170_000
    fs = K * ch_rate
    n = int(np.ceil((len(bits) + 120) / 1187.5 * fs))
    n -= n % (16 * K * 85)  # streamer quantum alignment
    u8, _ = synth.synth_multistation_u8(
        n, fs, station_freqs=[3 * ch_rate, -4 * ch_rate],
        audio_freqs=[1000.0, 2500.0], deviation=60_000.0,
        rds_bits=[bits, None])
    path = tmp_path / "wb_rds.bin"
    path.write_bytes(bytes(u8))

    rc, _ = _run_capture_stdout(
        main, ["--file", str(path), "--channels", f"3,{K - 4}",
               "--num-channels", str(K), "--rds",
               "--out-dir", str(tmp_path / "out")])
    assert rc == 0
    err = capsys.readouterr().err
    assert f"[rds ch3] PI: {pi:04X}" in err
    assert f"[rds ch3] PS: '{ps}'" in err
    assert f"ch{K - 4}]" not in err  # no-RDS station stays silent


def test_simple_fm_stereo_rds(tmp_path, capsys):
    """Stereo decode and RDS share one multiplex: --mode stereo --rds
    yields interleaved L/R audio on stdout and station text on stderr."""
    from tpu_sdr.apps.simple_fm import main
    from tpu_sdr.models import rds as R

    pi, ps = 0xD00D, "STEREO+R"
    groups = [R.make_group_0a(pi, 10, seg, ps[2 * seg: 2 * seg + 2])
              for seg in range(4)]
    bits = np.concatenate([np.concatenate(groups)] * 4)
    n = int(np.ceil((len(bits) + 120) / 1187.5 * 1_020_000))
    n -= n % (6 * 85)
    u8, _, _ = synth.synth_wbfm_stereo_u8(n, capture_rate=1_020_000,
                                          rds_bits=bits)
    path = tmp_path / "st_rds.bin"
    path.write_bytes(bytes(u8))

    rc, audio = _run_capture_stdout(
        main, ["--file", str(path), "--mode", "stereo", "--rds"])
    assert rc == 0
    pcm = np.frombuffer(audio, dtype="<i2").astype(np.float64)
    left = pcm[0::2]
    snr = synth.tone_snr(left, 800.0, 32_000, skip=2000)
    # measured 36.7 dB with the wideband (340 kHz) stereo front end on this
    # short RDS-bearing capture; floor leaves ~6 dB margin
    assert snr > 30, f"stereo L channel degraded: {snr:.1f} dB"
    err = capsys.readouterr().err
    assert f"[rds] PI: {pi:04X}" in err
    assert f"[rds] PS: '{ps}'" in err


def test_simple_fm_tcp_source(tmp_path, capsys):
    """simple_fm --tcp: network receive chain — an rtl_tcp server on a
    fake dongle synthesizing a WBFM station feeds the demodulator over a
    real socket; the 1 kHz tone must survive the whole path."""
    import threading
    import time

    from tpu_sdr import api
    from tpu_sdr.apps.simple_fm import main
    from tpu_sdr.control import fake
    from tpu_sdr.stream.rtl_tcp_server import RtlTcpServer

    fake.clear_fake_devices()
    fake.register_fake_device(fake.FakeDeviceSpec(
        serial="tcp00001",
        source_factory=lambda: fake.SynthFmSource(capture_rate=1_020_000)))
    sdr = api.RtlSdr.open_with_index(0)
    srv = RtlTcpServer(sdr, "127.0.0.1", 0, queue_limit=32)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    deadline = time.time() + 5
    while srv.bound_port is None and time.time() < deadline:
        time.sleep(0.01)
    try:
        rc, audio = _run_capture_stdout(
            main, ["--tcp", f"127.0.0.1:{srv.bound_port}", "--mode", "fir",
                   "--blocks", "6"])
        assert rc == 0
        pcm = np.frombuffer(audio, dtype="<i2").astype(np.float64)
        assert len(pcm) > 20_000
        snr = synth.tone_snr(pcm, 1_000.0, 32_000, skip=4000)
        assert snr > 20, f"tone lost over the tcp path: {snr:.1f} dB"
    finally:
        srv.stop()
        t.join(timeout=5)
        sdr.close()
        fake.clear_fake_devices()


def test_rtl_sdr_capture_to_file(tmp_path):
    """rtl_sdr capture CLI (beyond-reference: osmocom rtl_sdr equivalent):
    captures exactly -n bytes of raw u8 I/Q from a fake dongle to a file,
    and the capture feeds the file-mode receiver."""
    from tpu_sdr.apps.rtl_sdr_capture import main
    from tpu_sdr.control import fake

    fake.clear_fake_devices()
    fake.register_fake_device(fake.FakeDeviceSpec(
        serial="cap00001",
        source_factory=lambda: fake.SynthFmSource(capture_rate=1_020_000)))
    out = tmp_path / "cap.bin"
    try:
        rc = main([str(out), "-f", "94.9M", "-s", "1020k", "-n", "255k",
                   "-g", "28.0"])
        assert rc == 0
        data = out.read_bytes()
        assert len(data) == 255_000
        # the capture is a real synthesized WBFM signal: demodulate it
        from tpu_sdr.apps.simple_fm import main as fm_main

        rc2, audio = _run_capture_stdout(
            fm_main, ["--file", str(out), "--mode", "fir"])
        assert rc2 == 0
        pcm = np.frombuffer(audio, dtype="<i2").astype(np.float64)
        snr = synth.tone_snr(pcm, 1_000.0, 32_000, skip=300)
        assert snr > 20, f"captured signal lost the tone: {snr:.1f} dB"
    finally:
        fake.clear_fake_devices()


def test_rtl_sdr_capture_stdout_counter(tmp_path):
    """rtl_sdr capture to stdout ('-'): exact byte count delivered through
    the binary-stdout path with a non-default block size."""
    from tpu_sdr.apps.rtl_sdr_capture import main
    from tpu_sdr.control import fake

    fake.clear_fake_devices()
    fake.register_fake_device(fake.FakeDeviceSpec(serial="cap00002"))
    try:
        rc, data = _run_capture_stdout(
            main, ["-", "-n", "131072", "-b", "16384"])
        assert rc == 0
        assert len(data) == 131072
    finally:
        fake.clear_fake_devices()


def test_rtl_eeprom_dump_and_parse(capsys):
    """rtl_eeprom (beyond-reference, read-only): hex dump + parsed layout
    from a crafted fake EEPROM — magic, VID/PID, UTF-16LE strings,
    have-serial flag, and the byte-7 hack bits exactly as init reads
    them."""
    from tpu_sdr.apps.rtl_eeprom import main
    from tpu_sdr.control import fake

    def desc(s):
        raw = s.encode("utf-16-le")
        return bytes([len(raw) + 2, 0x03]) + raw

    eeprom = bytearray(256)
    eeprom[0:2] = b"\x28\x32"
    eeprom[2:4] = (0x0BDA).to_bytes(2, "little")
    eeprom[4:6] = (0x2838).to_bytes(2, "little")
    eeprom[6] = 0xA5  # have serial
    eeprom[7] = 0x01  # bit1=0 -> force bias tee; bit0=1 -> force direct
    strings = desc("Realtek") + desc("RTL2838UHIDIR") + desc("00000101")
    eeprom[9:9 + len(strings)] = strings

    fake.clear_fake_devices()
    fake.register_fake_device(fake.FakeDeviceSpec(
        serial="ee000001", eeprom=bytes(eeprom)))
    try:
        rc = main([])
        assert rc == 0
    finally:
        fake.clear_fake_devices()
    out = capsys.readouterr().out
    assert "0x28 0x32 (valid)" in out
    assert "0x0bda" in out and "0x2838" in out
    assert "Manufacturer:     Realtek" in out
    assert "Product:          RTL2838UHIDIR" in out
    assert "Serial:           00000101" in out
    assert "Have serial:      yes" in out
    assert "Force bias tee:   yes" in out
    assert "Force direct smp: yes" in out


def test_rtl_fm_squelch_flag(tmp_path):
    """rtl_fm -l: a threshold above the signal mutes the whole capture
    (s16 zeros on stdout); wbfm mode rejects the flag."""
    from tpu_sdr.apps.rtl_fm import main

    n = 510 * 300
    t = np.arange(n) / 1_020_000
    bb = 0.45 * (1.0 + 0.8 * np.sin(2 * np.pi * 1_000.0 * t))
    k = np.arange(n) % 4
    off = np.choose(k, [1 + 0j, -1j, -1 + 0j, 1j])
    sig = bb * off
    iq = np.empty(2 * n)
    iq[0::2], iq[1::2] = sig.real, sig.imag
    path = tmp_path / "am_sq.bin"
    path.write_bytes(np.clip(np.round(iq * 127.0 + 127.5), 0, 255)
                     .astype(np.uint8).tobytes())

    rc, audio = _run_capture_stdout(
        main, ["-M", "am", "--file", str(path), "-l", "0"])
    assert rc == 0
    pcm = np.frombuffer(audio, dtype="<i2")
    assert len(pcm) > 1000 and np.all(pcm == 0)

    with pytest.raises(SystemExit):
        main(["-M", "wbfm", "--file", str(path), "-l", "-40"])
