"""Stage-by-stage golden-vector conformance for the integer-exact WBFM path.

Mirrors the reference's test strategy (/root/reference/examples/
simple_fm.rs:461-556): each DSP stage must reproduce the rtl_fm capture
bit-for-bit.  Additional tests cover the carry/streaming behavior the
reference exercises implicitly (block-split invariance) and the u8 rotation.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_sdr.ops import exact
from tpu_sdr.models import wbfm_exact

from tpu_sdr.utils.golden import (
    BUF_SIGNED,
    DEMOD_EXPECTED,
    LOWPASS,
    RESULT,
    oracle_demodulate,
    rotate_90_numpy,
)

DOWNSAMPLE = 6  # optimal_settings(94.9M, 170k) -> (1_000_000/170_000)+1


def _pairs(v):
    a = np.asarray(v, dtype=np.int32)
    return a[0::2], a[1::2]


def test_lowpass_golden():
    re, im = _pairs(BUF_SIGNED)
    out_re, out_im, count, _ = exact.boxcar_decimate(
        jnp.asarray(re), jnp.asarray(im), exact.boxcar_init(), DOWNSAMPLE
    )
    count = int(count)
    exp_re, exp_im = _pairs(LOWPASS)
    assert count == len(exp_re)
    np.testing.assert_array_equal(np.asarray(out_re)[:count], exp_re)
    np.testing.assert_array_equal(np.asarray(out_im)[:count], exp_im)


def test_demod_golden():
    re, im = _pairs(LOWPASS)
    n = len(re)
    out, count, _ = exact.fm_discriminate(
        jnp.asarray(re), jnp.asarray(im), jnp.int32(n), exact.discriminator_init()
    )
    np.testing.assert_array_equal(np.asarray(out)[: int(count)], DEMOD_EXPECTED)


def test_lowpass_real_golden():
    x = jnp.asarray(DEMOD_EXPECTED, dtype=jnp.int16)
    out, count, _ = exact.boxcar_resample(
        x, jnp.int32(len(DEMOD_EXPECTED)), exact.resampler_init(),
        rate_out=170_000, rate_resample=32_000,
    )
    np.testing.assert_array_equal(np.asarray(out)[: int(count)], RESULT)


# ---------------------------------------------------------------------------
# Streaming invariance: splitting the input across blocks must not change any
# output sample (the reference guarantees this via its mutable carries;
# here via the explicit state pytree).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", [1, 5, 6, 7, 13])
def test_lowpass_block_split_invariance(split):
    re, im = _pairs(BUF_SIGNED)
    state = exact.boxcar_init()
    got_re, got_im = [], []
    for start in range(0, len(re), split):
        r = jnp.asarray(re[start : start + split])
        i = jnp.asarray(im[start : start + split])
        o_re, o_im, c, state = exact.boxcar_decimate(r, i, state, DOWNSAMPLE)
        got_re.extend(np.asarray(o_re)[: int(c)])
        got_im.extend(np.asarray(o_im)[: int(c)])
    exp_re, exp_im = _pairs(LOWPASS)
    np.testing.assert_array_equal(got_re, exp_re)
    np.testing.assert_array_equal(got_im, exp_im)


@pytest.mark.parametrize("split", [7, 11, 42])
def test_resampler_block_split_invariance(split):
    state = exact.resampler_init()
    got = []
    data = DEMOD_EXPECTED
    for start in range(0, len(data), split):
        chunk = data[start : start + split]
        x = jnp.asarray(chunk, dtype=jnp.int16)
        out, c, state = exact.boxcar_resample(
            x, jnp.int32(len(chunk)), state, rate_out=170_000, rate_resample=32_000
        )
        got.extend(np.asarray(out)[: int(c)])
    np.testing.assert_array_equal(got, RESULT)


# ---------------------------------------------------------------------------
# rotate_90: verify against a direct numpy port of the reference byte shuffle
# (simple_fm.rs:284-296).
# ---------------------------------------------------------------------------

def test_rotate_90_matches_reference_shuffle():
    rng = np.random.default_rng(0)
    buf = rng.integers(0, 256, size=512, dtype=np.uint8)
    got = np.asarray(exact.rotate_90_u8(jnp.asarray(buf)))
    np.testing.assert_array_equal(got, rotate_90_numpy(buf))


# ---------------------------------------------------------------------------
# Full chain: u8 blocks through the composed model vs a plain-python oracle
# implementing the reference loop verbatim.
# ---------------------------------------------------------------------------

def test_full_chain_vs_oracle():
    rng = np.random.default_rng(42)
    n_blocks, block = 4, 1024
    blocks = [rng.integers(0, 256, size=block, dtype=np.uint8) for _ in range(n_blocks)]

    streamer = wbfm_exact.WbfmExactStreamer()
    got = np.concatenate([streamer.demodulate(b) for b in blocks])
    expected = oracle_demodulate(blocks)
    np.testing.assert_array_equal(got, expected)
