"""Checkpoint/resume: stopping a streamer mid-stream, persisting its
carries, and resuming in a fresh process-equivalent object must be
bit-identical to an uninterrupted run — for the XLA, exact, stereo and
multimode streamers."""

import numpy as np
import pytest

from tpu_sdr.models import wbfm, wbfm_exact
from tpu_sdr.stream.checkpoint import load_stream_state, save_stream_state
from tpu_sdr.utils import synth


@pytest.fixture(scope="module")
def capture():
    u8, _ = synth.synth_wbfm_u8(130_560, capture_rate=1_020_000)
    return np.asarray(u8, dtype=np.uint8)


def _roundtrip(make, capture, tmp_path, split):
    a, b = capture[:split], capture[split:]

    ref = make()
    full = np.concatenate([ref.demodulate(a), ref.demodulate(b)])

    first = make()
    out1 = first.demodulate(a)
    ckpt = str(tmp_path / "state.npz")
    save_stream_state(ckpt, first)

    resumed = make()
    load_stream_state(ckpt, resumed)
    out2 = resumed.demodulate(b)
    got = np.concatenate([out1, out2])
    np.testing.assert_array_equal(got, full)


def test_xla_streamer_roundtrip(capture, tmp_path):
    _roundtrip(lambda: wbfm.WbfmStreamer(wbfm.WbfmConfig(filter_mode="fir")),
               capture, tmp_path, split=100_001)  # odd split -> pending bytes


def test_exact_streamer_roundtrip(capture, tmp_path):
    # the exact streamer consumes whole multiple-of-8 blocks (no pending)
    _roundtrip(wbfm_exact.WbfmExactStreamer, capture, tmp_path, split=77_776)


def test_class_mismatch_rejected(capture, tmp_path):
    s = wbfm.WbfmStreamer(wbfm.WbfmConfig(filter_mode="fir"))
    s.demodulate(capture[:12_000])
    ckpt = str(tmp_path / "state.npz")
    save_stream_state(ckpt, s)
    with pytest.raises(ValueError, match="checkpoint is for"):
        load_stream_state(ckpt, wbfm_exact.WbfmExactStreamer())


def test_stereo_streamer_roundtrip(tmp_path):
    from tpu_sdr.models import wbfm_stereo as ST

    u8, _, _ = synth.synth_wbfm_stereo_u8(510 * 400, capture_rate=1_020_000)
    u8 = np.asarray(u8, np.uint8)

    def make():
        return ST.WbfmStereoStreamer()

    ref = make()
    full = np.concatenate([ref.demodulate(u8[:100_001]),
                           ref.demodulate(u8[100_001:])], axis=1)
    first = make()
    out1 = first.demodulate(u8[:100_001])
    ckpt = str(tmp_path / "st.npz")
    save_stream_state(ckpt, first)
    resumed = make()
    load_stream_state(ckpt, resumed)
    out2 = resumed.demodulate(u8[100_001:])
    np.testing.assert_array_equal(np.concatenate([out1, out2], axis=1), full)


def test_multimode_streamer_roundtrip(tmp_path):
    from tpu_sdr.models import multimode as MM

    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, 510 * 300, dtype=np.uint8)

    def make():
        return MM.MultimodeStreamer(MM.MultimodeConfig(mode="usb"))

    ref = make()
    full = np.concatenate([ref.demodulate(u8[:70_003]),
                           ref.demodulate(u8[70_003:])])
    first = make()
    out1 = first.demodulate(u8[:70_003])
    ckpt = str(tmp_path / "mm.npz")
    save_stream_state(ckpt, first)
    resumed = make()
    load_stream_state(ckpt, resumed)
    out2 = resumed.demodulate(u8[70_003:])
    np.testing.assert_array_equal(np.concatenate([out1, out2]), full)


def test_checkpoint_detects_structure_drift(tmp_path):
    """A checkpoint whose captured attribute set or leaf structure no
    longer matches the live streamer must fail loudly, not silently skip
    state (round-trip completeness guard)."""
    import numpy as np
    import pytest

    from tpu_sdr.models import wbfm
    from tpu_sdr.stream import checkpoint as C

    s = wbfm.WbfmStreamer(wbfm.WbfmConfig(filter_mode="fir"))
    s.demodulate(np.zeros(510 * 8, np.uint8))
    path = str(tmp_path / "st.npz")
    C.save_stream_state(path, s)

    # leaf-structure drift: different config flattens to other leaf shapes
    other = wbfm.WbfmStreamer(wbfm.WbfmConfig(filter_mode="fir",
                                              fir_taps_per_phase=8))
    with pytest.raises(ValueError, match="shape|leaves"):
        C.load_stream_state(path, other)

    # attribute-set drift: live streamer grows a new carry attr
    fresh = wbfm.WbfmStreamer(wbfm.WbfmConfig(filter_mode="fir"))
    fresh.phases = np.zeros(3)  # name in _STATE_ATTRS, absent at save time
    with pytest.raises(ValueError, match="attrs"):
        C.load_stream_state(path, fresh)
