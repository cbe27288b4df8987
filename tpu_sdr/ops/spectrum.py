"""Streaming power-spectral-density estimation (Welch) on the device.

The data plane for the ``rtl_power``-style scanner (apps/rtl_power.py):
u8 I/Q blocks -> i16-bitcast unpack (ops/fm.u8_to_f32) -> windowed
segments -> complex FFT -> accumulated power bins, all under one ``jit``
with an explicit ``(carry, block) -> carry`` streaming shape like every
other op in this framework (SURVEY.md §5 long-context carry).  The FFT
rides XLA's FFT lowering; the accumulator stays on device across
blocks and is read back once per hop.

Beyond-reference: ccostes/rtl-sdr-rs has no spectrum tool; osmocom
``rtl_power`` is the model for the output format.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_sdr.ops.fm import u8_to_f32


class PsdState(NamedTuple):
    """Accumulated (power-sum, segment-count) across blocks."""

    acc: jax.Array    # (n_fft,) f32 — summed |X|^2 per bin, fftshifted
    count: jax.Array  # () f32 — segments accumulated


def psd_init(n_fft: int) -> PsdState:
    return PsdState(jnp.zeros(n_fft, jnp.float32), jnp.float32(0.0))


def hann(n_fft: int) -> np.ndarray:
    # periodic Hann (matches scipy.signal.welch's default family)
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
            ).astype(np.float32)


@partial(jax.jit, static_argnames=("n_fft",))
def psd_accumulate(buf: jax.Array, state: PsdState, window: jax.Array,
                   n_fft: int) -> PsdState:
    """Accumulate one u8 I/Q block into the PSD state.

    ``buf``: interleaved u8, length >= 2*n_fft; the trailing remainder
    that does not fill a segment is dropped (static shapes for XLA).
    """
    re, im = u8_to_f32(buf)
    n_seg = re.shape[0] // n_fft
    x = (re[: n_seg * n_fft] + 1j * im[: n_seg * n_fft]).reshape(
        n_seg, n_fft).astype(jnp.complex64)
    X = jnp.fft.fft(x * window, axis=-1)
    p = jnp.fft.fftshift(jnp.sum(jnp.abs(X) ** 2, axis=0))
    return PsdState(state.acc + p.astype(jnp.float32),
                    state.count + jnp.float32(n_seg))


def psd_db(state: PsdState, window: np.ndarray) -> np.ndarray:
    """Finalize: averaged, window-compensated power bins in dB (relative
    full scale; bin order is ascending frequency, -fs/2 .. +fs/2)."""
    acc = np.asarray(state.acc, np.float64)
    count = max(float(state.count), 1.0)
    scale = count * float(np.sum(np.asarray(window, np.float64) ** 2))
    return (10.0 * np.log10(np.maximum(acc / scale, 1e-20))).astype(
        np.float64)


class PsdStreamer:
    """Host wrapper: feed u8 blocks, read dB bins once at the end."""

    def __init__(self, n_fft: int = 1024):
        self.n_fft = n_fft
        self.window_np = hann(n_fft)
        self.window = jnp.asarray(self.window_np)
        self.state = psd_init(n_fft)
        self._pending = np.zeros(0, np.uint8)

    def accumulate(self, buf: np.ndarray) -> None:
        data = np.concatenate([self._pending,
                               np.asarray(buf, np.uint8).ravel()])
        quantum = 2 * self.n_fft
        usable = len(data) - (len(data) % quantum)
        self._pending = data[usable:]
        if usable:
            self.state = psd_accumulate(jnp.asarray(data[:usable]),
                                        self.state, self.window, self.n_fft)

    @property
    def segments(self) -> float:
        return float(self.state.count)

    def finalize_db(self) -> np.ndarray:
        return psd_db(self.state, self.window_np)
