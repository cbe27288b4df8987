"""Long-run soak: thousands of blocks through the streaming state.

Every carry (FIR history, rotator phase, discriminator prev, resampler
history, residual-byte pending buffers) is elsewhere tested over a
handful of blocks; the reference's real job is HOURS of unbounded stream
(simple_fm.rs:232-239 carries).  These tests drive thousands of
block-boundary crossings and assert

* split-invariance against a one-shot demodulation of the same bytes
  (bit-identical for the integer chain, f32-tight for the float chain) —
  any carry drift, residual mis-carry, or rotator phase slip accumulates
  and fails this;
* counter continuity across the full rtl_tcp server -> socket -> feeder
  path under sustained load (no dropped/duplicated bytes end to end).
"""

import threading
import time

import numpy as np
import pytest

from tpu_sdr.utils import synth

CAPTURE_RATE = 1_020_000


def _synth_long(n_complex: int) -> np.ndarray:
    u8, _ = synth.synth_wbfm_u8(n_complex, capture_rate=CAPTURE_RATE,
                                audio_freq=1_000.0, noise_std=0.01)
    return np.asarray(u8, np.uint8)


def test_soak_wbfm_streamer_2000_blocks():
    """2000 uneven blocks through WbfmStreamer == one-shot demodulation.
    Block length 5100 bytes is NOT a multiple of the 1020-byte quantum
    times anything convenient, so the pending-residual path cycles
    continuously."""
    from tpu_sdr.models import wbfm

    n_blocks, block_bytes = 2000, 5_100
    data = _synth_long(n_blocks * block_bytes // 2)

    streamed = wbfm.WbfmStreamer(wbfm.WbfmConfig(filter_mode="fir"))
    parts = [streamed.demodulate(data[i * block_bytes:(i + 1) * block_bytes])
             for i in range(n_blocks)]
    got = np.concatenate(parts)

    oneshot = wbfm.WbfmStreamer(wbfm.WbfmConfig(filter_mode="fir"))
    exp = oneshot.demodulate(data)
    n = min(len(got), len(exp))
    assert n > 0.95 * len(exp)
    np.testing.assert_allclose(got[:n], exp[:n], rtol=1e-5, atol=1e-6)
    # audio must still be the clean program tone at the END of the soak
    # (a slow carry drift would degrade the tail first)
    tail = got[len(got) // 2:].astype(np.float64)
    snr = synth.tone_snr(tail, 1_000.0, 32_000, skip=0)
    assert snr > 40.0, f"tail tone SNR {snr:.1f} dB"


def test_soak_exact_chain_1000_blocks():
    """The integer-exact chain over 1000 awkward blocks.

    The reference is deliberately NOT split-invariant at the
    discriminator: each block's FIRST sample uses the exact atan2, the
    rest fast_atan2 (simple_fm.rs:355-367), so a different split moves
    which samples take which path.  What it DOES guarantee — and what
    carries must preserve over thousands of boundaries:

    * determinism: the same split twice is bit-identical,
    * vs one-shot, only first-sample-influenced audio may move, and only
      by the fast-vs-exact atan2 error (bounded), never accumulating.
    """
    from tpu_sdr.models import wbfm_exact

    # multiple of 8 (the rotate_90 group, same constraint the reference's
    # byte shuffle has) but NOT of 2*decim=12: the boxcar/resampler
    # carries cycle through every phase
    n_blocks, block_bytes = 1000, 1_024
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, n_blocks * block_bytes, dtype=np.uint8)

    def stream():
        s = wbfm_exact.WbfmExactStreamer()
        return np.concatenate(
            [s.demodulate(data[i * block_bytes:(i + 1) * block_bytes])
             for i in range(n_blocks)])

    got = stream()
    np.testing.assert_array_equal(got, stream())  # bit-exact determinism

    exp = wbfm_exact.WbfmExactStreamer().demodulate(data)
    n = min(len(got), len(exp))
    assert n > 0.95 * len(exp)
    diff = np.abs(got[:n].astype(np.int32) - exp[:n].astype(np.int32))
    # each block start injects one exact-atan2 sample into a ~5-sample
    # boxcar average: bounded, sparse, and critically NOT drifting — the
    # mismatch rate must stay flat between the first and second half
    assert diff.max() <= 200, f"max {diff.max()}"
    frac = (diff > 0).mean()
    assert frac < 0.10, f"{frac:.1%} samples differ"
    first, second = diff[: n // 2], diff[n // 2:]
    assert abs((second > 0).mean() - (first > 0).mean()) < 0.05, (
        "mismatch rate drifts over the soak: "
        f"{(first > 0).mean():.2%} -> {(second > 0).mean():.2%}")


@pytest.mark.slow
def test_soak_rtl_tcp_counter_continuity_2000_blocks():
    """2000 blocks of the on-chip counter pattern through the live
    server -> TCP -> client path: every byte increments mod 256 with no
    gap — the end-to-end no-sample-loss guarantee under sustained load."""
    from tpu_sdr import api
    from tpu_sdr.control import fake
    from tpu_sdr.stream.feeder import RtlTcpClientSource
    from tpu_sdr.stream.rtl_tcp_server import RtlTcpServer

    fake.clear_fake_devices()
    fake.register_fake_device()
    sdr = api.RtlSdr.open_with_index(0)
    sdr.set_sample_rate(2_048_000)
    srv = RtlTcpServer(sdr, "127.0.0.1", 0, queue_limit=64)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    deadline = time.time() + 5
    while srv.bound_port is None and time.time() < deadline:
        time.sleep(0.01)
    assert srv.bound_port is not None
    try:
        client = RtlTcpClientSource("127.0.0.1", srv.bound_port)
        client.set_test_mode(True)
        time.sleep(0.2)  # let pre-testmode bytes drain out of the queue
        block_bytes, n_blocks = 8192, 2000
        prev = None
        total = 0
        for _ in range(n_blocks):
            d = client.read_block(block_bytes)
            assert d is not None, f"stream died after {total} bytes"
            a = np.frombuffer(d, np.uint8)
            if prev is None:
                # first block: find where the counter stream begins
                # (the queue may still hold pre-testmode source bytes)
                diffs = np.diff(a.astype(np.int16)) % 256
                starts = np.where(diffs != 1)[0]
                if len(starts):
                    a = a[starts[-1] + 1:]
                assert len(a) > 0
            else:
                assert a[0] == (prev + 1) % 256, f"gap at byte {total}"
            d8 = np.diff(a.astype(np.int16)) % 256
            assert (d8 == 1).all(), f"discontinuity inside block at {total}"
            prev = int(a[-1])
            total += block_bytes
        client.close()
    finally:
        srv.stop()
        t.join(timeout=3)
        sdr.close()
        fake.clear_fake_devices()
