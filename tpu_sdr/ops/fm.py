"""Fast float WBFM ops — the accelerator throughput path.

The reference's data plane is a per-sample integer loop on the CPU
(/root/reference/examples/simple_fm.rs:256-426).  These ops re-design each
stage for XLA: everything is vectorized, statically shaped, carried
across blocks by explicit state pytrees, and fusable under one ``jit``:

* u8 I/Q -> centered float32 (replacing simple_fm.rs:258-259),
* fs/4 rotation as a sign-pattern multiply, no byte shuffling
  (replacing simple_fm.rs:276-334 incl. the NEON path),
* decimating FIR as banded matmuls (or a strided convolution) replacing
  the boxcar sum (simple_fm.rs:337-352),
* quadrature discriminator ``angle(x · conj(prev))`` (simple_fm.rs:355-405),
* rational polyphase resampler replacing the boxcar resampler
  (simple_fm.rs:408-426),
* optional single-pole de-emphasis via associative scan (parallel-prefix,
  log-depth — no sequential loop).

Streaming carries mirror the reference's cross-block state (SURVEY.md §5
"long-context"): FIR history = taps-1 samples, discriminator = 1 sample,
resampler = window history + fractional phase.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def u8_to_f32(buf: jax.Array, scale: float = 1.0 / 127.5) -> tuple[jax.Array, jax.Array]:
    """u8 interleaved I/Q -> (re, im) float32 centered at 0, scaled to ~[-1, 1].

    Deinterleaving is done by bitcasting byte pairs to int16 and splitting
    the lo/hi bytes with integer ops instead of a stride-2 slice
    (``x[0::2]``) of the unpacked vector, so no strided gather is needed.
    """
    x16 = lax.bitcast_convert_type(buf.reshape(-1, 2), jnp.int16)
    xi = x16.astype(jnp.int32)  # sign-extends; the masks below undo it
    re = (xi & 0xFF).astype(jnp.float32) * scale - (127.5 * scale)
    im = ((xi >> 8) & 0xFF).astype(jnp.float32) * scale - (127.5 * scale)
    return re, im


# ---------------------------------------------------------------------------
# fs/4 rotation
# ---------------------------------------------------------------------------

class RotatorState(NamedTuple):
    """Phase index (0..3) of the first sample of the next block."""

    phase: jax.Array  # int32


def rotator_init() -> RotatorState:
    return RotatorState(jnp.int32(0))


def rotate_fs4(re: jax.Array, im: jax.Array, state: RotatorState):
    """Multiply sample k by ``j**(k+phase)`` — shifts the spectrum by fs/4,
    undoing capture offset tuning (ref rotate_90, simple_fm.rs:276-299).

    Pure sign-flip/swap — no multiplies; XLA fuses it into neighbors.
    """
    n = re.shape[0]
    k = (jnp.arange(n, dtype=jnp.int32) + state.phase) % 4
    # j**k: k=0 -> ( re,  im); k=1 -> (-im,  re); k=2 -> (-re, -im); k=3 -> ( im, -re)
    out_re = jnp.where(k == 0, re, jnp.where(k == 1, -im, jnp.where(k == 2, -re, im)))
    out_im = jnp.where(k == 0, im, jnp.where(k == 1, re, jnp.where(k == 2, -im, -re)))
    new_state = RotatorState((state.phase + n) % 4)
    return out_re, out_im, new_state


# ---------------------------------------------------------------------------
# Streaming decimating FIR
# ---------------------------------------------------------------------------

class FirState(NamedTuple):
    """Last ``taps-1`` input samples (re, im) — the overlap-save history."""

    hist_re: jax.Array
    hist_im: jax.Array


def fir_init(num_taps: int) -> FirState:
    z = jnp.zeros(num_taps - 1, jnp.float32)
    return FirState(z, z)


def fir_decimate(
    re: jax.Array, im: jax.Array, taps: jax.Array, decim: int, state: FirState
):
    """Streaming FIR + decimation: ``y[m] = sum_k h[k] x[mD + D-1 - k]``
    over the history-extended block.

    Block length must be a multiple of ``decim``; output length is exactly
    ``n // decim`` every block, so shapes stay static with no valid-count
    bookkeeping.  Implemented as a strided 1-D convolution (re/im batched),
    which XLA lowers to a library convolution.
    """
    n = re.shape[0]
    assert n % decim == 0, "block length must be a multiple of the decimation"
    num_taps = taps.shape[0]

    x = jnp.stack(
        [jnp.concatenate([state.hist_re, re]), jnp.concatenate([state.hist_im, im])]
    )[:, None, :]  # (batch=2, chan=1, time)
    # Cross-correlation: reverse taps to get convolution semantics.
    w = taps[::-1][None, None, :].astype(jnp.float32)  # (out_c=1, in_c=1, width)
    y = lax.conv_general_dilated(
        x, w, window_strides=(decim,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        # HIGHEST: an f32 conv may otherwise run in TF32 (~10 bits) on the GPU
        precision=lax.Precision.HIGHEST,
    )
    out_re = y[0, 0]
    out_im = y[1, 0]
    new_state = FirState(
        jnp.concatenate([state.hist_re, re])[-(num_taps - 1):],
        jnp.concatenate([state.hist_im, im])[-(num_taps - 1):],
    )
    return out_re, out_im, new_state


# ---------------------------------------------------------------------------
# Matmul-shaped streaming FIR decimation
# ---------------------------------------------------------------------------
#
# The decimating FIR as matmuls: block the output axis into chunks of 128
# and express each chunk as a matmul with a banded weight matrix
#
#     W[r*decim + j, r] = taps_rev[j]        (r < 128, j < L)
#
# so  y[c*128 + r] = (x_chunk_c . W[:, r]).  The overlapping input windows
# come from two reshapes of the same buffer (base frames + a rolled halo) —
# no gathers, no im2col materialization beyond one (L-decim)-column halo.

def make_banded_decim_matrix(taps: np.ndarray, decim: int, chunk_out: int = 128) -> np.ndarray:
    """Banded matrix W (chunk_out*decim + L - decim, chunk_out) such that
    chunked frames @ W computes the decimating FIR."""
    taps_rev = np.asarray(taps, dtype=np.float32)[::-1]
    L = len(taps_rev)
    step = chunk_out * decim
    W = np.zeros((step + L - decim, chunk_out), dtype=np.float32)
    for r in range(chunk_out):
        W[r * decim : r * decim + L, r] = taps_rev
    return W


def make_split_bf16(W: np.ndarray, scale: float = 255.0):
    """Split a weight matrix into (W_hi, W_lo) bfloat16 pair such that
    ``x @ W ≈ (x*scale) @ W_hi + (x*scale) @ W_lo`` to ~16-bit precision.

    The split-precision trick: samples scaled by 255 from the u8 path
    are *exact* 9-bit integers, hence exactly representable in bfloat16, so
    casting the data costs nothing in accuracy; the weights carry the
    rounding error, which the hi+lo pair reduces from 2^-8 to ~2^-16 —
    comfortably above the 60 dB fidelity bound with bf16 operands and f32
    accumulation.
    """
    Ws = np.asarray(W, dtype=np.float64) / scale
    W_hi = np.asarray(jnp.asarray(Ws, dtype=jnp.bfloat16))
    W_lo = np.asarray(
        jnp.asarray(Ws - np.asarray(W_hi, dtype=np.float64), dtype=jnp.bfloat16)
    )
    return jnp.asarray(W_hi), jnp.asarray(W_lo)


def _banded_frames(xext: jax.Array, row_len: int, decim: int, m: int,
                   chunk_out: int) -> jax.Array:
    """Overlapping stride-``decim`` windows via shifted reshapes (no
    gathers): frame c covers ``xp[c*step : c*step + row_len]``, built from
    ``ceil(row_len/step)`` step-shifted views (filters longer than one step
    just use more views)."""
    B = xext.shape[0]
    step = chunk_out * decim
    nchunks = -(-m // chunk_out)
    q = -(-row_len // step)
    pad = (nchunks + q) * step - xext.shape[1]
    xp = jnp.pad(xext, ((0, 0), (0, max(pad, 0))))
    parts = [
        xp[:, i * step : (i + nchunks) * step].reshape(B, nchunks, step)
        for i in range(q)
    ]
    return jnp.concatenate(parts, axis=2)[:, :, :row_len]


def banded_decim_apply(xext: jax.Array, W: jax.Array, decim: int, m: int,
                       chunk_out: int = 128,
                       W_split: tuple[jax.Array, jax.Array] | None = None) -> jax.Array:
    """Core of the banded-matmul decimator.

    ``xext``: (B, >= m*decim + L - decim) history-extended signals; returns
    (B, m) decimated outputs ``y[b, k] = sum_j taps_rev[j] xext[b, k*decim+j]``.

    With ``W_split=(W_hi, W_lo)`` (see :func:`make_split_bf16`) the matmul
    runs in split-precision bfloat16 (two bf16 passes with f32
    accumulation, ~16-bit effective weight precision).
    """
    B = xext.shape[0]
    step = chunk_out * decim
    row_len = (W_split[0] if W_split is not None else W).shape[0]
    nchunks = -(-m // chunk_out)
    frames = _banded_frames(xext, row_len, decim, m, chunk_out)
    dn = (((1,), (0,)), ((), ()))
    if W_split is not None:
        W_hi, W_lo = W_split
        fe = (frames.reshape(B * nchunks, row_len) * 255.0).astype(jnp.bfloat16)
        y = (
            jax.lax.dot_general(fe, W_hi, dn, preferred_element_type=jnp.float32)
            + jax.lax.dot_general(fe, W_lo, dn, preferred_element_type=jnp.float32)
        )
    else:
        # HIGHEST: a lower precision (bf16 passes, or TF32 on the GPU)
        # would silently cap the "f32" quality path
        y = jax.lax.dot_general(
            frames.reshape(B * nchunks, row_len), W, dn,
            preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST,
        )
    return y.reshape(B, nchunks * chunk_out)[:, :m]


def fir_decimate_mxu(
    re: jax.Array, im: jax.Array, W: jax.Array, num_taps: int, decim: int,
    state: FirState, chunk_out: int = 128,
    W_split: tuple[jax.Array, jax.Array] | None = None,
):
    """Streaming decimating FIR as chunked banded matmuls.

    Bit-compatible with :func:`fir_decimate` (same window alignment); block
    length must be a multiple of ``decim``.  ``W_split`` selects the
    split-precision bfloat16 path (see :func:`banded_decim_apply`).
    """
    n = re.shape[0]
    assert n % decim == 0
    m = n // decim
    x = jnp.stack([
        jnp.concatenate([state.hist_re, re]),
        jnp.concatenate([state.hist_im, im]),
    ])  # (2, n + L - 1)
    y = banded_decim_apply(x, W, decim, m, chunk_out, W_split=W_split)
    new_state = FirState(
        jnp.concatenate([state.hist_re, re])[n:],
        jnp.concatenate([state.hist_im, im])[n:],
    )
    return y[0], y[1], new_state


class DelayState(NamedTuple):
    """Last ``D`` samples — a streaming integer delay line."""

    hist: jax.Array


def delay_init(d: int) -> DelayState:
    return DelayState(jnp.zeros(d, jnp.float32))


def delay(x: jax.Array, state: DelayState):
    """``out[k] = x[k - D]`` across block boundaries (group-delay
    compensation for multi-arm filter graphs)."""
    d = state.hist.shape[0]
    xx = jnp.concatenate([state.hist, x])
    return xx[: x.shape[0]], DelayState(xx[xx.shape[0] - d:])


# ---------------------------------------------------------------------------
# Phase-aligned frame-matmul resampler
# ---------------------------------------------------------------------------
#
# When the block length is a multiple of ``down``, the rational resampler's
# emission pattern repeats every frame of ``down`` inputs -> exactly ``up``
# outputs, each a fixed window into the frame (+ a T-1 left halo).  The whole
# op becomes one (R, down+T-1) @ (down+T-1, up) matmul — no gathers, and the
# fractional phase state stays 0 forever.  The same structure covers both
# the polyphase FIR interpolator and the reference's boxcar resampler
# (simple_fm.rs:408-426): only the window matrix V differs.

def make_aligned_poly_matrix(h_poly: np.ndarray, up: int, down: int,
                             frames_per_row: int = 1) -> np.ndarray:
    """V for the polyphase resampler: V[(T-1) + o_s - t, s] = h_poly[p_s, t]
    with o_s = (s*down)//up, p_s = (s*down) % up.

    ``frames_per_row`` packs that many consecutive frames into each
    matmul row (shape (down*F + T - 1, up*F), column u + up*k = column u
    shifted by down*k): with up=32, F=4 gives 128 output columns instead
    of 32 — fewer, denser passes for the identical result."""
    hp = np.asarray(h_poly, dtype=np.float32)
    T = hp.shape[1]
    F_ = frames_per_row
    V = np.zeros((down * F_ + T - 1, up * F_), dtype=np.float32)
    for k in range(F_):
        for s in range(up):
            o = (s * down) // up
            p = (s * down) % up
            for t in range(T):
                V[(T - 1) + k * down + o - t, k * up + s] = hp[p, t]
    return V


def make_aligned_boxcar_matrix(rate_out: int, rate_resample: int) -> tuple[np.ndarray, int, int]:
    """V for the reference boxcar resampler + its (up, down) frame geometry.

    Emission j covers input samples (e_{j-1}, e_j] with
    e_j = ceil((j+1)*fast/slow) - 1, scaled by 1/(fast//slow)
    (simple_fm.rs:408-426).  Windows never cross the frame's left edge
    (e_{-1} + 1 == 0), so V has no halo rows: shape (down, up)."""
    import math

    g = math.gcd(rate_out, rate_resample)
    up, down = rate_resample // g, rate_out // g
    div = rate_out // rate_resample
    V = np.zeros((down, up), dtype=np.float32)
    fast, slow = rate_out, rate_resample
    for s in range(up):
        e = ((s + 1) * fast + slow - 1) // slow - 1
        e_prev = (s * fast + slow - 1) // slow - 1
        for i in range(e_prev + 1, e + 1):
            V[i, s] = 1.0 / div
    return V, up, down


class AlignedResampleState(NamedTuple):
    hist: jax.Array  # (T-1,) trailing inputs


def aligned_resample_init(T: int) -> AlignedResampleState:
    return AlignedResampleState(jnp.zeros(T - 1, jnp.float32))


def aligned_resample(x: jax.Array, V: jax.Array, up: int, down: int,
                     state: AlignedResampleState,
                     precision: lax.Precision = lax.Precision.HIGH):
    """Frame-matmul resampler: ``x`` length must be a multiple of the
    frame span (``down`` times V's frames-per-row packing); emits exactly
    ``len(x)//down * up`` samples.

    ``precision`` applies to the frame matmul: HIGH by default for the wbfm
    audio epilogue, whose fidelity gates (tests; ``chip_smoke.py`` GPU vs
    CPU) hold it; accuracy-critical callers (e.g. RDS bitstream recovery)
    pass HIGHEST."""
    F_ = V.shape[1] // up  # frames packed per matmul row (N-lane packing)
    span = down * F_
    Tm1 = V.shape[0] - span
    n = x.shape[0]
    assert n % span == 0, f"block of {n} not divisible by span={span}"
    R = n // span
    if Tm1 <= span:
        # Row-view construction: frame bodies are the FREE reshape of x
        # itself (row-major), and each frame's T-1 history is the tail of
        # the previous row (the carried hist for row 0) — no offset-slice
        # reshape of the concatenated buffer.
        zr = x.reshape(R, span)
        left = jnp.concatenate([state.hist[None, :],
                                zr[:-1, span - Tm1:]], axis=0)
        frames = jnp.concatenate([left, zr], axis=1)
        new_state = AlignedResampleState(x[n - Tm1:])
    else:  # very long windows: fall back to explicit slicing
        xe = jnp.concatenate([state.hist, x])  # (n + T - 1)
        idx = jnp.arange(span + Tm1)
        starts = jnp.arange(R) * span
        frames = xe[starts[:, None] + idx[None, :]]
        new_state = AlignedResampleState(xe[xe.shape[0] - Tm1:])
    y = jax.lax.dot_general(
        frames, V, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision,
    )  # (R, up*F)
    return y.reshape(R * up * F_), new_state


# ---------------------------------------------------------------------------
# Float boxcar stages (reference-parity filters, vectorized)
# ---------------------------------------------------------------------------

def boxcar_decimate_f32(re: jax.Array, im: jax.Array, decim: int):
    """Float twin of the reference's ``low_pass_complex`` boxcar
    (simple_fm.rs:337-352): sum each group of ``decim`` samples (gain =
    decim, like the reference — no divide).

    Requires ``len % decim == 0`` so the group phase never drifts and no
    carry is needed; one reshape+sum, the cheapest possible decimator.
    """
    n = re.shape[0]
    assert n % decim == 0
    return (
        re.reshape(n // decim, decim).sum(axis=1),
        im.reshape(n // decim, decim).sum(axis=1),
    )


def fast_atan2_f32(y: jax.Array, x: jax.Array) -> jax.Array:
    """Float twin of the reference's integer ``fast_atan2`` approximation
    (simple_fm.rs:383-405), returning radians.

    Using the *same approximation* (not true atan2) keeps the fast chain
    within the >=60 dB SNR bound of the reference output — and it is cheaper
    than a transcendental: one divide, no atan.
    """
    pi4 = jnp.float32(np.pi / 4)
    pi34 = jnp.float32(3 * np.pi / 4)
    yabs = jnp.abs(y)
    den_pos = x + yabs
    den_neg = yabs - x
    den_pos = jnp.where(den_pos == 0, 1.0, den_pos)
    den_neg = jnp.where(den_neg == 0, 1.0, den_neg)
    angle = jnp.where(
        x >= 0,
        pi4 - pi4 * (x - yabs) / den_pos,
        pi34 - pi4 * (x + yabs) / den_neg,
    )
    angle = jnp.where(y < 0, -angle, angle)
    return jnp.where((x == 0) & (y == 0), 0.0, angle)


class BoxcarResampleState(NamedTuple):
    """Float twin of the reference resampler carry (simple_fm.rs:235-236)."""

    now: jax.Array  # running sum (f32)
    acc: jax.Array  # fractional index accumulator (int32, [0, rate_out))


def boxcar_resample_init() -> BoxcarResampleState:
    return BoxcarResampleState(jnp.float32(0.0), jnp.int32(0))


def boxcar_resample_f32(
    x: jax.Array, state: BoxcarResampleState, rate_out: int, rate_resample: int
):
    """Float twin of the reference's ``low_pass_real`` (simple_fm.rs:408-426):
    accumulate ``slow`` per sample, emit mean (sum / (fast//slow)) on each
    ``fast`` crossing.  Same closed-form emission indices as the exact path
    — cumsum + gather, no scan.  Returns ``(y_padded, count, state)``.
    """
    fast = jnp.int32(rate_out)
    slow = jnp.int32(rate_resample)
    n = x.shape[0]
    m_max = (n * rate_resample) // rate_out + 1

    a = state.acc
    cs = state.now + jnp.cumsum(x.astype(jnp.float32))

    total_acc = a + n * slow
    out_count = total_acc // fast
    new_a = total_acc - out_count * fast

    j = jnp.arange(m_max, dtype=jnp.int32)
    e = (((j + 1) * fast - a) + slow - 1) // slow - 1
    e_cl = jnp.clip(e, 0, n - 1)
    cs_at_e = cs[e_cl]
    prev_cs = jnp.concatenate([jnp.zeros(1, jnp.float32), cs_at_e[:-1]])
    out = (cs_at_e - prev_cs) / jnp.float32(rate_out // rate_resample)

    consumed = jnp.where(out_count > 0, cs_at_e[jnp.maximum(out_count - 1, 0)], 0.0)
    new_now = cs[n - 1] - consumed
    return out, out_count.astype(jnp.int32), BoxcarResampleState(new_now, new_a.astype(jnp.int32))


# ---------------------------------------------------------------------------
# Quadrature discriminator
# ---------------------------------------------------------------------------

class QuadState(NamedTuple):
    """Previous complex sample (ref ``demod_pre``, simple_fm.rs:238)."""

    pre_re: jax.Array
    pre_im: jax.Array


def quad_init() -> QuadState:
    return QuadState(jnp.float32(1.0), jnp.float32(0.0))


def quadrature_demod(re: jax.Array, im: jax.Array, state: QuadState, gain: float = 1.0,
                     atan_mode: str = "exact"):
    """``y[k] = gain * angle(x[k] * conj(x[k-1])) / pi`` with carried prev
    (ref fm_demod, simple_fm.rs:355-367).

    ``atan_mode='exact'`` uses true atan2 (quality path); ``'fast'`` uses the
    reference's polynomial approximation (parity path, transcendental-free).
    """
    b_re = jnp.concatenate([state.pre_re[None], re[:-1]])
    b_im = jnp.concatenate([state.pre_im[None], im[:-1]])
    c_re = re * b_re + im * b_im
    c_im = im * b_re - re * b_im
    if atan_mode == "fast":
        ang = fast_atan2_f32(c_im, c_re)
    else:
        ang = jnp.arctan2(c_im, c_re)
    y = ang * jnp.float32(gain / np.pi)
    return y, QuadState(re[-1], im[-1])


# ---------------------------------------------------------------------------
# Rational polyphase resampler
# ---------------------------------------------------------------------------

class ResampleState(NamedTuple):
    """Window history (``taps_per_phase - 1`` inputs) + output phase ``t0``
    (position of the next output on the up-sampled time grid, relative to
    the start of the next block)."""

    hist: jax.Array
    t0: jax.Array  # int32, in upsampled-sample units


def resample_init(taps_per_phase: int) -> ResampleState:
    return ResampleState(jnp.zeros(taps_per_phase - 1, jnp.float32), jnp.int32(0))


def polyphase_resample(
    x: jax.Array, h_poly: jax.Array, up: int, down: int, state: ResampleState
):
    """Rational ``up/down`` resampler.

    ``h_poly`` is the ``(up, T)`` polyphase split of the prototype filter:
    ``h_poly[p, t] = h[p + t*up]``.  Output ``m`` lands at upsampled time
    ``t0 + m*down``; with ``q = time // up`` and phase ``p = time % up``::

        y[m] = sum_t h_poly[p, t] * x[q - t]

    Everything is a closed-form index computation — one gather + one
    contraction, no scan (the same static-shape trick as the exact-path
    resampler).  Returns ``(y_padded, count, new_state)``.
    """
    up_, T = h_poly.shape
    assert up_ == up
    n = x.shape[0]
    m_max = (n * up) // down + 1

    xx = jnp.concatenate([state.hist, x])  # (T-1+n,)
    t0 = state.t0

    m = jnp.arange(m_max, dtype=jnp.int32)
    tt = t0 + m * down
    q = tt // up
    p = tt % up

    count = jnp.maximum((n * up - t0 + down - 1) // down, 0)
    new_t0 = t0 + count * down - n * up

    # Gather windows: xx[q + (T-1) - t] for t in 0..T-1  -> (m_max, T)
    t_idx = jnp.arange(T, dtype=jnp.int32)
    win_idx = jnp.clip(q[:, None] + (T - 1) - t_idx[None, :], 0, xx.shape[0] - 1)
    windows = xx[win_idx]  # (m_max, T)
    coeffs = h_poly[p]  # (m_max, T)
    y = jnp.sum(windows * coeffs, axis=1)

    new_state = ResampleState(xx[xx.shape[0] - (T - 1):], new_t0.astype(jnp.int32))
    return y, count.astype(jnp.int32), new_state


def make_polyphase(h: np.ndarray, up: int) -> np.ndarray:
    """Split prototype taps into the (up, T) polyphase matrix."""
    L = len(h)
    T = -(-L // up)
    hp = np.zeros(up * T, dtype=np.float32)
    hp[:L] = h
    return hp.reshape(T, up).T.copy()  # h_poly[p, t] = h[p + t*up]


# ---------------------------------------------------------------------------
# De-emphasis (single-pole IIR) via parallel prefix
# ---------------------------------------------------------------------------

class DeemphState(NamedTuple):
    y_prev: jax.Array  # float32 scalar


def deemph_init() -> DeemphState:
    return DeemphState(jnp.float32(0.0))


def deemphasis(x: jax.Array, alpha: float, state: DeemphState):
    """``y[k] = y[k-1] + alpha*(x[k] - y[k-1])`` without a sequential loop.

    The first-order recurrence ``y[k] = a*y[k-1] + b[k]`` composes
    associatively — ``(a2,b2)∘(a1,b1) = (a1*a2, a2*b1 + b2)`` — so
    ``lax.associative_scan`` evaluates it in log depth.
    """
    a = jnp.float32(1.0 - alpha)
    b = x * jnp.float32(alpha)

    def combine(l, r):
        al, bl = l
        ar, br = r
        return al * ar, ar * bl + br

    a_vec = jnp.full_like(x, a)
    a_cum, b_cum = lax.associative_scan(combine, (a_vec, b))
    y = a_cum * state.y_prev + b_cum
    return y, DeemphState(y[-1])


def deemph_alpha(fs: float, tau: float = 75e-6) -> float:
    """De-emphasis coefficient for time constant ``tau`` at rate ``fs``."""
    return float(1.0 - np.exp(-1.0 / (fs * tau)))
