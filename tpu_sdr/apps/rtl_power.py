"""rtl_power — wideband spectrum scanner (osmocom ``rtl_power`` model).

Beyond-reference: hops the tuner across a frequency range, integrates a
Welch PSD per hop on the JAX data plane (ops/spectrum.py), and emits
osmocom-compatible CSV rows::

    date, time, Hz low, Hz high, Hz step, samples, dB, dB, ...

Range syntax is rtl_power's ``low:high:step`` with k/M/G suffixes::

    tpu-sdr-rtl-power -f 88M:108M:125k -s 2048k -b 4 scan.csv
    TPU_SDR_FAKE_DEVICES=1 python -m tpu_sdr.apps.rtl_power -f 94M:96M:8k

``--file`` mode computes one PSD row from a capture instead of a device
(center set by ``-f <center>``).  Logs go to stderr; CSV to stdout or the
optional output file.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

from tpu_sdr import DEFAULT_BUF_LENGTH
from tpu_sdr.utils.units import parse_scaled

DEFAULT_RATE = 2_048_000


def parse_range(text: str) -> tuple[int, int, int]:
    parts = text.split(":")
    if len(parts) != 3:
        raise SystemExit("range must be low:high:step (e.g. 88M:108M:125k)")
    low, high, step = (parse_scaled(p) for p in parts)
    if not (low < high and step > 0):
        raise SystemExit("range must satisfy low < high and step > 0")
    return low, high, step


def fft_size_for(rate: int, step: int, max_fft: int = 1 << 15) -> int:
    """Smallest power of two giving bin width <= step (rtl_power picks the
    FFT from the requested bin size the same way)."""
    n = 1
    while rate / n > step and n < max_fft:
        n *= 2
    return n


# Keep the center 80% of each hop's bins by default: the outer bins sit
# in the tuner/anti-alias rolloff at the hop edges and bias readings on
# real hardware, so hops overlap by 20% of fs.  osmocom rtl_power's crop
# is opt-in (-c, default 0%); ``--crop 0`` restores that full-fs
# single-hop behavior.
HOP_CROP = 0.8


def hop_centers(low: int, high: int, rate: int,
                keep: float = HOP_CROP) -> list[int]:
    usable = int(rate * keep)
    centers = []
    c = low + usable // 2
    while c - usable // 2 < high:
        centers.append(c)
        c += usable
    return centers


def row_for(center: int, low: int, high: int, rate: int, n_fft: int,
            db, crop: float = HOP_CROP) -> tuple[int, int, float, list[float]]:
    """Crop a hop's fftshifted bins to the usable ``crop`` fraction of fs
    intersected with [low, high) -> (hz_low, hz_high, hz_step, bins)."""
    bin_hz = rate / n_fft
    f0 = center - rate / 2  # frequency of bin 0
    lo = max(low, center - crop * rate / 2)
    hi = min(high, center + crop * rate / 2)
    first = max(0, math.ceil((lo - f0) / bin_hz))  # bins start >= lo
    last = min(n_fft, int((hi - f0) / bin_hz + 0.999999))
    return (int(f0 + first * bin_hz), int(f0 + last * bin_hz), bin_hz,
            [round(float(v), 2) for v in db[first:last]])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Wideband spectrum scan -> rtl_power-format CSV")
    p.add_argument("output", nargs="?", default=None,
                   help="CSV output file (default stdout)")
    p.add_argument("-f", "--freq", required=True,
                   help="low:high:step scan range, or a single center "
                        "frequency with --file")
    p.add_argument("-s", "--sample-rate", default=str(DEFAULT_RATE))
    p.add_argument("-d", "--device", type=int, default=0)
    p.add_argument("-g", "--gain", type=float, default=None)
    p.add_argument("-b", "--blocks", type=int, default=2,
                   help="integration: blocks read per hop")
    p.add_argument("-p", "--passes", type=int, default=1,
                   help="repeat the whole scan N times, one row set per "
                        "pass (waterfall/time series; 0 = until "
                        "interrupted)")
    p.add_argument("--file", default=None,
                   help="compute one PSD row from this capture instead of "
                        "a device")
    p.add_argument("--tcp", metavar="HOST:PORT", default=None,
                   help="scan a REMOTE dongle over the rtl_tcp protocol "
                        "instead of a local device (hops ride the "
                        "command channel)")
    p.add_argument("-c", "--crop", type=float, default=20.0, metavar="PCT",
                   help="discard this percent of each hop's bins at the "
                        "band edges (tuner rolloff); hops overlap to "
                        "cover the gap.  0 disables cropping "
                        "(osmocom's default).  Default 20")
    p.add_argument("--settle", type=int, default=None, metavar="N",
                   help="discard N blocks after each hop (default 0 for "
                        "a local device, whose buffer is reset; 1 for "
                        "--tcp, where the server queue still holds "
                        "pre-hop samples)")
    args = p.parse_args(argv)

    from tpu_sdr.ops.spectrum import PsdStreamer

    rate = parse_scaled(args.sample_rate)
    out = sys.stdout if args.output is None else open(args.output, "w")
    rows = 0
    try:
        if args.file is not None:
            center = parse_scaled(args.freq)
            low, high = center - rate // 2, center + rate // 2
            n_fft = fft_size_for(rate, max(1, rate // 1024))
            ps = PsdStreamer(n_fft)
            with open(args.file, "rb") as f:
                while True:
                    chunk = f.read(DEFAULT_BUF_LENGTH)
                    if not chunk:
                        break
                    import numpy as np

                    ps.accumulate(np.frombuffer(chunk, np.uint8))
            rows += _emit(out, center, low, high, rate, n_fft, ps,
                          crop=1.0)
        else:
            low, high, step = parse_range(args.freq)
            n_fft = fft_size_for(rate, step)
            settle = args.settle
            if args.tcp:
                from tpu_sdr.stream.feeder import RtlTcpClientSource

                host, _, port = args.tcp.rpartition(":")
                client = RtlTcpClientSource(host or "127.0.0.1", int(port))
                client.set_sample_rate(rate)
                if args.gain is None:
                    client.set_gain_mode(False)
                else:
                    client.set_gain_mode(True)
                    client.set_gain(int(round(args.gain * 10)))

                def tune(freq: int) -> None:
                    client.set_frequency(freq)

                def read_one():
                    return client.read_block(DEFAULT_BUF_LENGTH)

                close = client.close
                if settle is None:
                    settle = 1  # server queue holds pre-hop samples
            else:
                from tpu_sdr.api import DeviceId, RtlSdr, TunerGain

                sdr = RtlSdr.open(DeviceId.index(args.device))
                sdr.set_sample_rate(rate)
                if args.gain is None:
                    sdr.set_tuner_gain(TunerGain.AUTO)
                else:
                    sdr.set_tuner_gain(
                        TunerGain.manual(int(round(args.gain * 10))))

                def tune(freq: int) -> None:
                    sdr.set_center_freq(freq)
                    sdr.reset_buffer()

                def read_one():
                    data = sdr.read_sync(DEFAULT_BUF_LENGTH)
                    return data if len(data) == DEFAULT_BUF_LENGTH else None

                close = sdr.close
                if settle is None:
                    settle = 0
            keep = 1.0 - max(0.0, min(90.0, args.crop)) / 100.0
            try:
                centers = hop_centers(low, high, rate, keep)
                print(f"Scanning {len(centers)} hop(s), FFT {n_fft}, "
                      f"bin {rate / n_fft:.0f} Hz", file=sys.stderr)
                import numpy as np

                done = 0
                try:
                    while args.passes == 0 or done < args.passes:
                        for center in centers:
                            tune(center)
                            for _ in range(settle):
                                read_one()
                            ps = PsdStreamer(n_fft)
                            for _ in range(args.blocks):
                                data = read_one()
                                if data is None:
                                    print("Short read, hop truncated",
                                          file=sys.stderr)
                                    break
                                ps.accumulate(
                                    np.frombuffer(data, np.uint8))
                            rows += _emit(out, center, low, high, rate,
                                          n_fft, ps, crop=keep)
                        done += 1
                        out.flush()
                except KeyboardInterrupt:
                    print("\nUser cancel, exiting...", file=sys.stderr)
            finally:
                close()
    finally:
        out.flush()
        if out is not sys.stdout:
            out.close()
    print(f"Wrote {rows} row(s).", file=sys.stderr)
    return 0


def _emit(out, center, low, high, rate, n_fft, ps,
          crop: float = HOP_CROP) -> int:
    if int(ps.segments) == 0:
        return 0  # capture shorter than one FFT segment: no data, no row
    db = ps.finalize_db()
    hz_low, hz_high, bin_hz, bins = row_for(
        center, low, high, rate, n_fft, db, crop)
    if not bins:
        return 0
    now = time.localtime()
    date = time.strftime("%Y-%m-%d", now)
    tod = time.strftime("%H:%M:%S", now)
    n_samples = int(ps.segments) * n_fft
    print(f"{date}, {tod}, {hz_low}, {hz_high}, {bin_hz:.2f}, "
          f"{n_samples}, " + ", ".join(f"{v:.2f}" for v in bins),
          file=out)
    return 1


if __name__ == "__main__":
    sys.exit(main())
