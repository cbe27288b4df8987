"""Equivalence of the matmul-shaped ops against their reference formulations.

The banded-matmul decimator and frame-matmul resampler are pure layout
transformations of the same filters — they must match the conv/gather forms
to float precision on any aligned size, including streaming state.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_sdr.ops import fm as F
from tpu_sdr.utils import firdes


@pytest.mark.parametrize("n", [6 * 85 * 8, 6 * 85 * 32, 6 * 1024])
def test_banded_decim_matches_conv(n):
    rng = np.random.default_rng(0)
    D, tpp = 6, 12
    taps = firdes.decimating_lowpass(D, taps_per_phase=tpp)
    W = jnp.asarray(F.make_banded_decim_matrix(taps, D))
    re = rng.standard_normal(n).astype(np.float32)
    im = rng.standard_normal(n).astype(np.float32)
    st = F.fir_init(D * tpp)
    a1, b1, s1 = F.fir_decimate(jnp.asarray(re), jnp.asarray(im), jnp.asarray(taps), D, st)
    a2, b2, s2 = F.fir_decimate_mxu(jnp.asarray(re), jnp.asarray(im), W, D * tpp, D, st)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), atol=2e-5)
    np.testing.assert_allclose(np.asarray(b1), np.asarray(b2), atol=2e-5)
    np.testing.assert_array_equal(np.asarray(s1.hist_re), np.asarray(s2.hist_re))


def test_banded_decim_streaming_state():
    rng = np.random.default_rng(1)
    D, tpp, n = 6, 12, 6 * 256
    taps = firdes.decimating_lowpass(D, taps_per_phase=tpp)
    W = jnp.asarray(F.make_banded_decim_matrix(taps, D))
    x = rng.standard_normal(3 * n).astype(np.float32)
    one_re, one_im, _ = F.fir_decimate_mxu(
        jnp.asarray(x), jnp.asarray(x), W, D * tpp, D, F.fir_init(D * tpp))
    st = F.fir_init(D * tpp)
    outs = []
    for i in range(3):
        a, b, st = F.fir_decimate_mxu(
            jnp.asarray(x[i * n:(i + 1) * n]), jnp.asarray(x[i * n:(i + 1) * n]),
            W, D * tpp, D, st)
        outs.append(np.asarray(a))
    np.testing.assert_allclose(np.concatenate(outs), np.asarray(one_re), atol=2e-5)


def test_aligned_poly_resample_matches_gather():
    rng = np.random.default_rng(2)
    up, down, tpp = 16, 85, 48
    h = firdes.resampler_taps(up, down, taps_per_phase=tpp, cutoff_frac=0.8)
    hp = F.make_polyphase(h, up)
    V = jnp.asarray(F.make_aligned_poly_matrix(hp, up, down))
    x = rng.standard_normal(down * 64).astype(np.float32)
    y1, c1, rs1 = F.polyphase_resample(
        jnp.asarray(x), jnp.asarray(hp), up, down, F.resample_init(tpp))
    y2, rs2 = F.aligned_resample(jnp.asarray(x), V, up, down, F.aligned_resample_init(tpp))
    c1 = int(c1)
    assert c1 == y2.shape[0] == 64 * up
    np.testing.assert_allclose(np.asarray(y1)[:c1], np.asarray(y2), atol=2e-5)
    np.testing.assert_array_equal(np.asarray(rs1.hist), np.asarray(rs2.hist))
    assert int(rs1.t0) == 0  # phase stays locked on aligned sizes


def test_aligned_boxcar_matches_cumsum():
    rng = np.random.default_rng(3)
    V, up, down = F.make_aligned_boxcar_matrix(170_000, 32_000)
    x = rng.standard_normal(down * 40).astype(np.float32)
    y1, c1, st1 = F.boxcar_resample_f32(
        jnp.asarray(x), F.boxcar_resample_init(), 170_000, 32_000)
    y2, _ = F.aligned_resample(
        jnp.asarray(x), jnp.asarray(V), up, down,
        F.AlignedResampleState(jnp.zeros(0, jnp.float32)))
    c1 = int(c1)
    assert c1 == y2.shape[0] == 40 * up
    np.testing.assert_allclose(np.asarray(y1)[:c1], np.asarray(y2), atol=2e-5)
    # frame-exact consumption: no residue carried
    assert float(st1.now) == pytest.approx(0.0, abs=1e-4)
    assert int(st1.acc) == 0


def test_aligned_resample_streaming():
    rng = np.random.default_rng(4)
    up, down, tpp = 16, 85, 48
    h = firdes.resampler_taps(up, down, taps_per_phase=tpp, cutoff_frac=0.8)
    hp = F.make_polyphase(h, up)
    V = jnp.asarray(F.make_aligned_poly_matrix(hp, up, down))
    x = rng.standard_normal(down * 60).astype(np.float32)
    whole, _ = F.aligned_resample(jnp.asarray(x), V, up, down, F.aligned_resample_init(tpp))
    st = F.aligned_resample_init(tpp)
    parts = []
    for i in range(3):
        y, st = F.aligned_resample(jnp.asarray(x[i * down * 20:(i + 1) * down * 20]),
                                   V, up, down, st)
        parts.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(parts), np.asarray(whole), atol=1e-6)
