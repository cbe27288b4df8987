"""Polyphase filter-bank (PFB) channelizer.

The reference processes one station per process at one tuned frequency; a
single accelerator can instead split a wideband capture into K critically-sampled
channels in one shot (BASELINE.json configs #3/#5: "256-tap FIR x 64
channels, polyphase channelizer replacing direct FIR", and the 1024-channel
pod-scale variant).

Formulation: frame the stream into (m, K); each polyphase branch
is a T-tap FIR *down the frame axis* — expressed as T shifted elementwise
multiply-accumulates over the framed array (fully fused by XLA; no
gathers, T is small) — followed by one batched FFT across the channel axis
(K lanes).  Channel k of frame m is

    Y[m, k] = sum_p exp(-2j pi k p / K) * sum_t h[tK+p] * X[m-t, p]

yielding center frequencies f_k = k * fs / K (k interpreted mod K, so
k > K/2 are negative offsets).  Streaming state carries T-1 frames.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_sdr.utils import firdes


def design_pfb(num_channels: int, taps_per_branch: int = 8,
               atten_db: float = 70.0, cutoff_frac: float = 0.45) -> np.ndarray:
    """Prototype lowpass mapped to the (T+1, K) analysis branch matrix.

    Channel k of frame m is ``sum_i h[mK - i] x[i] exp(-2j pi k i / K)``;
    splitting i = qK + p gives per-branch taps ``g_p[t] = h[tK - p]`` (zero
    where the index falls outside the prototype) — hence T+1 rows.  Cutoff
    sits at ``cutoff_frac`` of the channel Nyquist (fs / (2K)).
    """
    K = num_channels
    T = taps_per_branch
    L = K * T
    h = firdes.lowpass(L, cutoff_frac / (2 * K), 1.0, atten_db) * K
    G = np.zeros((T + 1, K), dtype=np.float32)
    for t in range(T + 1):
        for p in range(K):
            j = t * K - p
            if 0 <= j < L:
                G[t, p] = h[j]
    return G


class PfbState(NamedTuple):
    """Last (branch_rows - 1) input frames (re, im), each of width K."""

    hist_re: jax.Array
    hist_im: jax.Array


def pfb_init(h_poly) -> PfbState:
    """State sized for the branch matrix returned by :func:`design_pfb`."""
    rows, K = np.shape(h_poly)
    z = jnp.zeros((rows - 1, K), jnp.float32)
    return PfbState(z, z)


def pfb_mxu_matrices(h_poly: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Fold branch filtering and the channel DFT into one weight matrix.

    ``M[t*K + p, k] = G[t, p] * exp(-2j pi p k / K)`` so that the whole
    channelizer is ``Y[m] = X_win[m] @ M`` with ``X_win[m, t*K+p] =
    X[m-t, p]`` — a single real matmul instead of shifted adds plus a
    complex FFT.  Returns (M_re, M_im).
    """
    G = np.asarray(h_poly, dtype=np.float64)
    rows, K = G.shape
    p = np.arange(K)
    k = np.arange(K)
    dft = np.exp(-2j * np.pi * np.outer(p, k) / K)  # (p, k)
    M = (G[:, :, None] * dft[None, :, :]).reshape(rows * K, K)
    return M.real.astype(np.float32), M.imag.astype(np.float32)


def pfb_conv_weights(h_poly: np.ndarray) -> np.ndarray:
    """Fused branch+DFT weights as a conv kernel (out=2K, in=2K, width=rows).

    Input channels are [re branches p | im branches p]; output channels
    [Y_re k | Y_im k].  Width position w corresponds to frame lag
    t = rows-1-w, so a VALID conv over the history-extended frame axis
    computes ``Y[m] = sum_t M_t X[m-t]`` for the complex product.
    """
    M_re, M_im = pfb_mxu_matrices(h_poly)
    rows, K = np.shape(h_poly)
    Mre_t = M_re.reshape(rows, K, K)  # [t, p, k]
    Mim_t = M_im.reshape(rows, K, K)
    W = np.zeros((2 * K, 2 * K, rows), dtype=np.float32)
    for w in range(rows):
        t = rows - 1 - w
        W[:K, :K, w] = Mre_t[t].T          # Y_re <- re
        W[:K, K:, w] = -Mim_t[t].T         # Y_re <- im
        W[K:, :K, w] = Mim_t[t].T          # Y_im <- re
        W[K:, K:, w] = Mre_t[t].T          # Y_im <- im
    return W


def pfb_analyze(re: jax.Array, im: jax.Array, h_poly: jax.Array, state: PfbState,
                W: jax.Array | None = None):
    """Channelize one block: input length must be a multiple of K.

    Returns ``(Y_re, Y_im, new_state)`` with Y of shape (m, K): frame m,
    channel k (critically sampled at fs/K; gain K at channel center).

    The branch filter + channel DFT collapse into one multi-channel
    convolution along the frame axis (2K in / 2K out channels, width
    ``rows``), one library call instead of shifted slices plus a complex
    FFT.
    """
    rows, K = h_poly.shape
    n = re.shape[0]
    assert n % K == 0, f"block of {n} not divisible by K={K}"
    m = n // K

    if W is None:  # trace-time constant; pass W explicitly under jit
        W = jnp.asarray(pfb_conv_weights(np.asarray(h_poly)))

    frames_re = jnp.concatenate([state.hist_re, re.reshape(m, K)], axis=0)
    frames_im = jnp.concatenate([state.hist_im, im.reshape(m, K)], axis=0)
    lhs = jnp.concatenate([frames_re.T, frames_im.T], axis=0)[None]  # (1, 2K, m+rows-1)
    Y = jax.lax.conv_general_dilated(
        lhs, W, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        # HIGHEST: an f32 conv may otherwise run in TF32 (~10 bits) on the GPU
        precision=jax.lax.Precision.HIGHEST,
    )[0]  # (2K, m)
    hist_re = frames_re[frames_re.shape[0] - (rows - 1):]
    hist_im = frames_im[frames_im.shape[0] - (rows - 1):]
    return Y[:K].T, Y[K:].T, PfbState(hist_re, hist_im)


def channel_frequencies(num_channels: int, fs: float) -> np.ndarray:
    """Center frequency of each channel (k > K/2 wrap negative)."""
    k = np.arange(num_channels)
    k = np.where(k <= num_channels // 2, k, k - num_channels)
    return k * fs / num_channels
