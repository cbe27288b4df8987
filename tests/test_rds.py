"""RDS physical-layer bit recovery from a synthesized multiplex."""

import numpy as np
import pytest

from tpu_sdr.models import rds as R

FS = 170_000


def _synth_mpx(n_bits: int, seed: int = 4, bits: np.ndarray | None = None):
    """Standard multiplex: mono tone + pilot + RDS BPSK at 3x pilot."""
    if bits is None:
        rng = np.random.default_rng(seed)
        bits = rng.integers(0, 2, n_bits).astype(np.uint8)
    d = np.bitwise_xor.accumulate(bits)  # differential encode
    n = int(np.ceil((n_bits + 2) / R.RDS_RATE * FS))
    n -= n % 85  # resampler alignment
    t = np.arange(n) / FS
    theta = 2 * np.pi * 19_000.0 * t
    tb = t * R.RDS_RATE
    k = np.minimum(tb.astype(int), n_bits - 1)
    frac = tb - tb.astype(int)
    sign = np.where(d[k] == 0, 1.0, -1.0) * np.where(frac < 0.5, 1.0, -1.0)
    mpx = (0.4 * np.sin(2 * np.pi * 1_000.0 * t)
           + 0.1 * np.cos(theta)
           + 0.06 * sign * np.cos(3 * theta))
    return mpx.astype(np.float32), bits


def _best_alignment(got: np.ndarray, want: np.ndarray, max_off: int = 8):
    best = (0.0, 0)
    for off in range(-max_off, max_off + 1):
        if off >= 0:
            m = min(len(got) - off, len(want))
            agree = np.mean(got[off:off + m] == want[:m])
        else:
            m = min(len(got), len(want) + off)
            agree = np.mean(got[:m] == want[-off:-off + m])
        best = max(best, (float(agree), off))
    return best


def test_rds_bits_recovered():
    mpx, bits = _synth_mpx(3000)
    rx = R.RdsReceiver()
    b152 = rx.process(mpx)
    got = R.decode_bits(b152)
    assert len(got) >= 2500
    # drop the filter-transient first symbols, then align (the analog front
    # end delays the stream by a couple of bits)
    agree, off = _best_alignment(got[2:], bits[2:])
    assert agree >= 0.995, f"bit agreement {agree:.3f} (offset {off})"


def test_rds_streaming_invariance():
    mpx, _ = _synth_mpx(1200)
    one = R.RdsReceiver()
    full = one.process(mpx)
    two = R.RdsReceiver()
    cut = (len(mpx) // 2) - ((len(mpx) // 2) % 85)
    split = np.concatenate([two.process(mpx[:cut]), two.process(mpx[cut:])])
    np.testing.assert_allclose(split, full, rtol=2e-3, atol=2e-4)


def test_rds_through_full_fm_chain():
    """u8 FM capture (stereo multiplex + RDS) -> WBFM front end ->
    discriminator -> RDS bits: the whole physical layer end to end."""
    import jax.numpy as jnp

    from tpu_sdr.models import wbfm
    from tpu_sdr.ops import fm as F
    from tpu_sdr.utils import synth

    rng = np.random.default_rng(6)
    n_bits = 1500
    want = rng.integers(0, 2, n_bits).astype(np.uint8)
    n = int(np.ceil((n_bits + 2) / R.RDS_RATE * 1_020_000))
    n -= n % (6 * 85)
    u8, _, _ = synth.synth_wbfm_stereo_u8(
        n, capture_rate=1_020_000, rds_bits=want)

    # front end to the multiplex (discriminator output at 170 kHz)
    config = wbfm.WbfmConfig(filter_mode="fir")
    params = wbfm.make_params(config)
    re, im = F.u8_to_f32(jnp.asarray(np.asarray(u8, np.uint8)))
    re, im, _ = F.rotate_fs4(re, im, F.rotator_init())
    L = config.decim * config.fir_taps_per_phase
    re, im, _ = F.fir_decimate_mxu(re, im, params.decim_W, L, config.decim,
                                   F.fir_init(L), W_split=params.decim_W_split)
    mpx, _ = F.quadrature_demod(re, im, F.quad_init())

    rx = R.RdsReceiver()
    b152 = rx.process(np.asarray(mpx))
    got = R.decode_bits(b152)
    agree, off = _best_alignment(got[2:], want[2:])
    assert agree >= 0.99, f"end-to-end RDS agreement {agree:.3f} ({off})"


def test_rds_group_sync_end_to_end():
    """Synthesized RDS groups survive the whole physical layer: multiplex
    -> coherent demod -> bits -> block sync -> checkword-validated 16-bit
    words."""
    words = [(0x3001 + 7 * g, 0x0520 + g, 0xABC0 ^ g, 0x2020 + g)
             for g in range(20)]
    payload = np.concatenate([R.make_group(w) for w in words])
    # pad front/back with random bits so sync must actually search
    rng = np.random.default_rng(8)
    bits = np.concatenate([rng.integers(0, 2, 37).astype(np.uint8), payload,
                           rng.integers(0, 2, 40).astype(np.uint8)])
    mpx, _ = _synth_mpx(len(bits), bits=bits)

    rx = R.RdsReceiver()
    got_bits = R.decode_bits(rx.process(mpx))
    groups = R.sync_and_parse(got_bits)
    assert len(groups) >= 18, f"only {len(groups)} groups decoded"
    # decoded groups must be a contiguous run of the transmitted ones
    first = groups[0]
    assert first in [tuple(w) for w in words]
    start = [tuple(w) for w in words].index(first)
    for i, g in enumerate(groups[: len(words) - start]):
        assert g == tuple(words[start + i])


def _groups_bits(groups: list[np.ndarray], repeats: int = 3) -> np.ndarray:
    one = np.concatenate(groups)
    return np.concatenate([one] * repeats)


def _ps_rt_bits(pi=0xF201, ps="RDS SDR!", rt="HELLO FROM THE SDR\r",
                repeats=3) -> np.ndarray:
    rt = rt + " " * (-len(rt) % 4)
    groups = [R.make_group_0a(pi, 9, seg, ps[2 * seg: 2 * seg + 2])
              for seg in range(4)]
    groups += [R.make_group_2a(pi, 9, seg, rt[4 * seg: 4 * seg + 4])
               for seg in range(len(rt) // 4)]
    return _groups_bits(groups, repeats)


def test_rds_stream_decoder_text():
    """Full streaming receiver on a synthesized multiplex: pilot lock,
    one-shot bit-phase search, flywheel group sync, PS and RadioText
    assembly — fed in irregular chunks like a live discriminator."""
    bits = _ps_rt_bits()
    mpx, _ = _synth_mpx(len(bits), bits=bits)

    rx = R.RdsStreamDecoder()
    events = []
    pos, sizes = 0, [7000, 12345, 30000]
    i = 0
    while pos < len(mpx):
        n = sizes[i % len(sizes)]
        events += rx.feed_mpx(mpx[pos:pos + n])
        pos += n
        i += 1
    assert rx.locked
    assert rx.text.pi == 0xF201
    assert rx.text.pty == 9
    assert rx.text.ps == "RDS SDR!"
    assert rx.text.rt == "HELLO FROM THE SDR"
    assert any(e.startswith("PS:") for e in events)
    assert any(e.startswith("RT:") for e in events)
    assert rx.sync.groups_ok >= 10


def test_rds_stream_decoder_requires_pilot():
    """No pilot -> no lock, no events (the squelch path)."""
    t = np.arange(85 * 3000) / FS
    mpx = (0.4 * np.sin(2 * np.pi * 1_000.0 * t)).astype(np.float32)
    rx = R.RdsStreamDecoder()
    assert rx.feed_mpx(mpx) == []
    assert not rx.locked


def test_group_synchronizer_flywheel():
    """Without correction a corrupted block drops only its group; a bit
    slip forces re-acquisition and sync returns."""
    words = [(0x1111 + g, 0x2000 + g, 0x3000 + g, 0x4000 + g)
             for g in range(12)]
    bits = np.concatenate([R.make_group(w) for w in words])
    bits = np.concatenate([np.ones(15, np.uint8), bits])  # offset the start
    bits[15 + 104 * 3 + 40] ^= 1          # corrupt group 3
    slip_at = 15 + 104 * 6                # delete a bit before group 6
    bits = np.concatenate([bits[:slip_at], bits[slip_at + 1:]])

    sync = R.GroupSynchronizer(max_bad_groups=2, correct=False)
    got = []
    for chunk in np.array_split(bits, 9):
        got += sync.feed(chunk)
    assert tuple(words[0]) in got and tuple(words[2]) in got
    assert tuple(words[3]) not in got     # corrupted group dropped
    # the slip costs max_bad_groups misaligned groups plus the one the
    # re-search lands inside; everything after that must decode again
    late = [w for w in words[9:] if tuple(w) in got]
    assert len(late) == 3, f"flywheel failed to re-acquire: {got}"


def test_burst_error_correction():
    """The (26,16) code corrects any burst of <= 5 bits per block once
    synced; 6-bit bursts are detected, not mis-corrected."""
    # table sanity: burst syndromes are unique and never zero
    table = R._burst_table()
    assert len(table) == 367 and 0 not in table

    words = [(0xAAA0 + g, 0x2000 + g, 0x3000 + g, 0x4000 + g)
             for g in range(8)]
    bits = np.concatenate([R.make_group(w) for w in words])
    # group 2 block A: 5-bit burst; group 3 block D: 2 separated flips
    # (= a burst of span <= 5 here); group 5 block B: 6-bit burst
    for off in range(5):
        bits[104 * 2 + 3 + off] ^= 1
    bits[104 * 3 + 26 * 3 + 7] ^= 1
    bits[104 * 3 + 26 * 3 + 10] ^= 1
    for off in range(6):
        bits[104 * 5 + 26 + 2 + off] ^= 1

    sync = R.GroupSynchronizer()
    got = sync.feed(bits)
    assert tuple(words[2]) in got, "5-bit burst not corrected"
    assert tuple(words[3]) in got, "span-4 burst not corrected"
    assert tuple(words[5]) not in got, "6-bit burst must not pass"
    assert sync.blocks_corrected >= 2
    assert sync.bits_corrected >= 7


def test_correct_block_direct():
    blk = R.make_block(0x1234, "B")
    info, n = R.correct_block(blk, "B")
    assert (info, n) == (0x1234, 0)
    blk2 = blk.copy()
    blk2[5] ^= 1
    blk2[8] ^= 1  # burst span 4
    info, n = R.correct_block(blk2, "B")
    assert info == 0x1234 and n == 2
    assert R.correct_block(blk2, "A") != (0x1234, 2)  # wrong offset


def test_pty_name_event():
    txt = R.RdsText()
    events = txt.update((0x1234, (0 << 12) | (4 << 5) | 0, 0xE0E0, 0x4142))
    assert "PTY: 4 (Sport)" in events
    assert R.PTY_NAMES[31] == "Alarm" and len(R.PTY_NAMES) == 32


def test_af_list_assembly():
    """Method-A AF list over two 0A groups: count code 224+3, then three
    frequency codes (one per word C byte, filler 205 ignored)."""
    txt = R.RdsText()
    # word C = (224+3)<<8 | code(98.5 MHz = 87.5 + 0.1*110 -> code 110)
    ev1 = txt.update((0x1234, 0 << 12, (227 << 8) | 110, 0x4142))
    assert txt.af is None and not any(e.startswith("AF:") for e in ev1)
    # codes for 87.6 (1) and 107.9 (204); list completes here
    ev2 = txt.update((0x1234, (0 << 12) | 1, (1 << 8) | 204, 0x4344))
    assert txt.af == [87.6, 98.5, 107.9]
    assert "AF: 87.6, 98.5, 107.9 MHz" in ev2
    # repeat of the same list: no duplicate event
    txt.update((0x1234, 0 << 12, (227 << 8) | 110, 0x4142))
    ev4 = txt.update((0x1234, (0 << 12) | 1, (1 << 8) | 204, 0x4344))
    assert not any(e.startswith("AF:") for e in ev4)


def test_af_ignores_fillers_and_0b():
    txt = R.RdsText()
    # 0B group (version B): word C is the PI repeat, must NOT be parsed as AF
    txt.update((0x1234, (0 << 12) | (1 << 11), (227 << 8) | 110, 0x4142))
    assert txt._af_expect == 0
    # fillers (205) and the LF/MF escape (250) don't contribute entries:
    # count 2 announced, but only one real carrier (code 90 = 96.5 MHz)
    # arrives, so the list stays open and no event fires
    txt.update((0x1234, 0 << 12, (226 << 8) | 205, 0x4142))
    txt.update((0x1234, 0 << 12, (250 << 8) | 90, 0x4344))
    assert txt.af is None
    assert txt._af_partial == [96.5]


def test_ct_clock_time_group():
    """4A clock-time: 2026-08-20 10:30 UTC+2 (MJD 61272)."""
    year, month, day = R.mjd_to_date(61272)
    assert (year, month, day) == (2026, 8, 20)
    txt = R.RdsText()
    events = txt.update((0x1234, (4 << 12) | ((61272 >> 15) & 0x3),
                         ((61272 & 0x7FFF) << 1) | (10 >> 4),
                         ((10 & 0xF) << 12) | (30 << 6) | 4))
    assert "CT: 2026-08-20 10:30 UTC+2:00" in events
    # same time again: no duplicate event
    assert not txt.update((0x1234, (4 << 12) | ((61272 >> 15) & 0x3),
                           ((61272 & 0x7FFF) << 1) | (10 >> 4),
                           ((10 & 0xF) << 12) | (30 << 6) | 4))


def test_ct_negative_offset_and_zero_mjd():
    txt = R.RdsText()
    g = R.make_group_4a(0x1234, 61272, 23, 59, offset_half_hours=-11)
    # decode the encoded group via the block layer to close the loop
    words = R.sync_and_parse(np.concatenate([g] * 4))
    assert words and words[0][0] == 0x1234
    events = txt.update(words[0])
    assert "CT: 2026-08-20 23:59 UTC-5:30" in events
    # MJD 0 = "no date": ignored per spec (PI/PTY events still fire)
    txt2 = R.RdsText()
    ev = txt2.update((0x1234, 4 << 12, 0 | 0, (5 << 12) | (1 << 6)))
    assert not any(e.startswith("CT:") for e in ev)
    assert txt2.ct is None


def test_ct_through_stream_decoder():
    """CT groups through the full physical layer: multiplex -> stream
    decoder -> clock-time event."""
    groups = [R.make_group_4a(0xF201, 61272, 10, 30, offset_half_hours=4)
              for _ in range(4)]
    bits = _groups_bits(groups, repeats=3)
    mpx, _ = _synth_mpx(len(bits), bits=bits)
    rx = R.RdsStreamDecoder()
    events = rx.feed_mpx(mpx)
    assert any(e == "CT: 2026-08-20 10:30 UTC+2:00" for e in events), events


def test_ptyn_assembly():
    """10A programme-type name over two segments, with the A/B toggle
    restarting assembly."""
    txt = R.RdsText()
    g0 = R.sync_and_parse(np.concatenate(
        [R.make_group_10a(0x1234, 0, "Foot")] * 4))[0]
    g1 = R.sync_and_parse(np.concatenate(
        [R.make_group_10a(0x1234, 1, "ball")] * 4))[0]
    txt.update(g0)
    assert txt.ptyn is None
    events = txt.update(g1)
    assert txt.ptyn == "Football"
    assert "PTYN: 'Football'" in events
    # flag flip clears the buffer: one segment alone no longer completes
    gf = R.sync_and_parse(np.concatenate(
        [R.make_group_10a(0x1234, 0, "News", flag=1)] * 4))[0]
    txt.update(gf)
    assert txt.ptyn == "Football"  # unchanged until the new name completes
