"""Tests for the fast float WBFM path: streaming invariance, resampler
correctness vs a numpy upfirdn oracle, and end-to-end demod fidelity on a
synthesized WBFM capture (the reference's capture.bin equivalent)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_sdr.ops import fm as F
from tpu_sdr.models import wbfm
from tpu_sdr.utils import firdes, synth


def test_fir_decimate_block_split_invariance():
    rng = np.random.default_rng(1)
    n, decim, tpp = 1200, 6, 8
    taps = jnp.asarray(firdes.decimating_lowpass(decim, taps_per_phase=tpp))
    re = rng.standard_normal(n).astype(np.float32)
    im = rng.standard_normal(n).astype(np.float32)

    st = F.fir_init(decim * tpp)
    one_re, one_im, _ = F.fir_decimate(jnp.asarray(re), jnp.asarray(im), taps, decim, st)

    st = F.fir_init(decim * tpp)
    got_re, got_im = [], []
    for s in range(0, n, 300):
        o_re, o_im, st = F.fir_decimate(
            jnp.asarray(re[s : s + 300]), jnp.asarray(im[s : s + 300]), taps, decim, st
        )
        got_re.append(np.asarray(o_re))
        got_im.append(np.asarray(o_im))
    np.testing.assert_allclose(np.concatenate(got_re), np.asarray(one_re), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.concatenate(got_im), np.asarray(one_im), rtol=1e-5, atol=1e-6)


def _upfirdn_oracle(x, h, up, down):
    """Plain numpy upsample-filter-downsample, causal-aligned like the op:
    y[m] = sum_k h[k] v[m*down - k] with v = zero-stuffed x."""
    n = len(x)
    v = np.zeros(n * up, dtype=np.float64)
    v[::up] = x
    full = np.convolve(v, h)  # full[i] = sum_k h[k] v[i-k]
    idx = np.arange(0, n * up, down)
    return full[idx]


def test_polyphase_resample_matches_upfirdn():
    rng = np.random.default_rng(2)
    up, down, tpp = 16, 85, 12
    n = 4000
    x = rng.standard_normal(n).astype(np.float32)
    h = firdes.resampler_taps(up, down, taps_per_phase=tpp)
    h_poly = jnp.asarray(F.make_polyphase(h, up))

    st = F.resample_init(tpp)
    y, count, _ = F.polyphase_resample(jnp.asarray(x), h_poly, up, down, st)
    got = np.asarray(y)[: int(count)]

    exp = _upfirdn_oracle(x, h, up, down)
    m = min(len(got), len(exp))
    np.testing.assert_allclose(got[:m], exp[:m], rtol=1e-4, atol=1e-5)


def test_polyphase_resample_block_split_invariance():
    rng = np.random.default_rng(3)
    up, down, tpp = 16, 85, 12
    n = 3400
    x = rng.standard_normal(n).astype(np.float32)
    h = firdes.resampler_taps(up, down, taps_per_phase=tpp)
    h_poly = jnp.asarray(F.make_polyphase(h, up))

    st = F.resample_init(tpp)
    y, c, _ = F.polyphase_resample(jnp.asarray(x), h_poly, up, down, st)
    whole = np.asarray(y)[: int(c)]

    st = F.resample_init(tpp)
    parts = []
    for s in range(0, n, 451):
        y, c, st = F.polyphase_resample(jnp.asarray(x[s : s + 451]), h_poly, up, down, st)
        parts.append(np.asarray(y)[: int(c)])
    np.testing.assert_allclose(np.concatenate(parts), whole, rtol=1e-5, atol=1e-6)


def test_rotate_fs4_matches_complex_multiply():
    rng = np.random.default_rng(4)
    n = 256
    re = rng.standard_normal(n).astype(np.float32)
    im = rng.standard_normal(n).astype(np.float32)
    o_re, o_im, st = F.rotate_fs4(jnp.asarray(re), jnp.asarray(im), F.rotator_init())
    c = (re + 1j * im) * (1j ** (np.arange(n) % 4))
    np.testing.assert_allclose(np.asarray(o_re), c.real, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(o_im), c.imag, rtol=1e-6)
    assert int(st.phase) == 0  # 256 % 4 == 0


def test_deemphasis_matches_sequential():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(500).astype(np.float32)
    alpha = F.deemph_alpha(170_000.0, 75e-6)
    y, _ = F.deemphasis(jnp.asarray(x), alpha, F.deemph_init())
    exp = np.zeros(len(x))
    prev = 0.0
    for i, v in enumerate(x):
        prev = prev + alpha * (v - prev)
        exp[i] = prev
    np.testing.assert_allclose(np.asarray(y), exp, rtol=1e-4, atol=1e-5)


BLOCK = 2 * 6 * 4096  # bytes; multiple of 2*decim


def _run_chain(u8, config):
    streamer = wbfm.WbfmStreamer(config)
    return np.concatenate(
        [streamer.demodulate(u8[s : s + BLOCK]) for s in range(0, len(u8) - BLOCK + 1, BLOCK)]
    )


def test_fir_chain_recovers_tone():
    """FIR quality mode: demodulate a synthesized 1 kHz WBFM tone; the
    recovered audio must fit the modulating tone at >= 45 dB (the input is
    8-bit quantized, which bounds the achievable figure near ~57 dB)."""
    config = wbfm.WbfmConfig(filter_mode="fir")
    u8, _ = synth.synth_wbfm_u8(245_760, capture_rate=config.capture_rate)
    got = _run_chain(u8, config)
    snr = synth.tone_snr(got, 1000.0, config.rate_resample, skip=300)
    assert snr >= 45.0, f"fir-chain tone SNR too low: {snr:.1f} dB"


def test_boxcar_chain_matches_exact_reference_output():
    """Float parity mode vs the bit-exact integer path (== reference
    simple_fm output): must agree to >= 60 dB (BASELINE.md fidelity target)."""
    from tpu_sdr.models import wbfm_exact

    config = wbfm.WbfmConfig(filter_mode="boxcar")
    u8, _ = synth.synth_wbfm_u8(245_760, capture_rate=config.capture_rate)
    got = _run_chain(u8, config)

    ex = wbfm_exact.WbfmExactStreamer()
    exact_audio = np.concatenate(
        [ex.demodulate(u8[s : s + BLOCK]) for s in range(0, len(u8) - BLOCK + 1, BLOCK)]
    ).astype(np.float64)

    snr, lag = synth.align_and_snr(exact_audio, got, max_lag=4, skip=50)
    assert lag == 0
    assert snr >= 60.0, f"boxcar-chain SNR vs reference too low: {snr:.1f} dB"


def test_split_bf16_decimator_matches_f32():
    """The split-precision bf16 decimator must agree with the f32 path
    to well above the 60 dB fidelity bound (samples x255 are exact in bf16;
    hi+lo taps give ~16-bit weight precision)."""
    u8, _ = synth.synth_wbfm_u8(245_760, capture_rate=1_020_000)
    got_f32 = _run_chain(u8, wbfm.WbfmConfig(filter_mode="fir", mxu_precision="f32"))
    got_bf16 = _run_chain(u8, wbfm.WbfmConfig(filter_mode="fir", mxu_precision="split_bf16"))
    assert got_f32.shape == got_bf16.shape
    err = got_bf16 - got_f32
    snr = 10 * np.log10(np.mean(got_f32**2) / max(np.mean(err**2), 1e-30))
    assert snr >= 80.0, f"split-bf16 vs f32 agreement too low: {snr:.1f} dB"


@pytest.mark.parametrize("mode", ["fir", "boxcar"])
def test_reference_block_size_streaming(mode):
    """Feeding the reference's DEFAULT_BUF_LENGTH (262144-byte) blocks —
    which are NOT multiples of the aligned-resampler quantum — must
    produce exactly the same audio as one full-capture call.  Round-3
    regression: a 2*decim streamer quantum let consecutive chunks flip
    between the aligned and polyphase resampler paths (incompatible
    carries), costing ~35 dB of tone SNR on every real device read."""
    from tpu_sdr.models import wbfm

    u8, _ = synth.synth_wbfm_u8(4 * 131072, capture_rate=1_020_000)
    buf = np.asarray(u8, np.uint8)
    one = wbfm.WbfmStreamer(wbfm.WbfmConfig(filter_mode=mode))
    full = one.demodulate(buf)
    two = wbfm.WbfmStreamer(wbfm.WbfmConfig(filter_mode=mode))
    split = np.concatenate([two.demodulate(buf[i:i + 262144])
                            for i in range(0, len(buf), 262144)])
    n = min(len(full), len(split))
    np.testing.assert_allclose(split[:n], full[:n], rtol=1e-5, atol=1e-6)
    snr = synth.tone_snr(split.astype(np.float64), 1_000.0, 32_000,
                         skip=1500)
    # fir is the quality chain; boxcar shares the reference integer
    # chain's inherent boxcar-resampler aliasing (~20 dB, same as the
    # exact mode's CLI floor)
    floor = 45.0 if mode == "fir" else 19.0
    assert snr >= floor, f"{mode} @ 262144-byte blocks: {snr:.1f} dB"
