"""FIR filter design (host-side, numpy).

The reference has no filter design — its "low pass" is a boxcar sum
(/root/reference/examples/simple_fm.rs:337-352).  The accelerator fast path
replaces the boxcar with proper windowed-sinc FIR filters (BASELINE.json
north star: "FIR low-pass + decimation recast as a polyphase/overlap-save
FFT filter"), designed here once on the host.
"""

from __future__ import annotations

import numpy as np


def kaiser_beta(atten_db: float) -> float:
    """Kaiser window beta for a target stopband attenuation (Kaiser's formula)."""
    if atten_db > 50:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21:
        return 0.5842 * (atten_db - 21) ** 0.4 + 0.07886 * (atten_db - 21)
    return 0.0


def lowpass(num_taps: int, cutoff: float, fs: float = 1.0, atten_db: float = 60.0) -> np.ndarray:
    """Kaiser-windowed-sinc lowpass; ``cutoff`` in Hz at sample rate ``fs``.

    Returns float32 taps normalized to unity DC gain.
    """
    assert 0 < cutoff < fs / 2, f"cutoff {cutoff} out of (0, {fs / 2})"
    beta = kaiser_beta(atten_db)
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    fc = cutoff / fs  # cycles/sample
    h = 2 * fc * np.sinc(2 * fc * n)
    h *= np.kaiser(num_taps, beta)
    h /= h.sum()
    return h.astype(np.float32)


def decimating_lowpass(decim: int, taps_per_phase: int = 12,
                       atten_db: float = 60.0, cutoff_frac: float = 0.45) -> np.ndarray:
    """Anti-alias lowpass for decimation by ``decim`` (input-rate normalized).

    ``cutoff_frac`` is the cutoff as a fraction of the *output* Nyquist
    (= 1/(2*decim) of the input rate).  Tap count is ``decim *
    taps_per_phase`` so the polyphase split is exact.
    """
    num_taps = decim * taps_per_phase
    cutoff = cutoff_frac / (2 * decim)  # in cycles/sample at the input rate
    return lowpass(num_taps, cutoff, 1.0, atten_db)


def resampler_taps(up: int, down: int, taps_per_phase: int = 16,
                   atten_db: float = 60.0, cutoff_frac: float = 0.47) -> np.ndarray:
    """Anti-imaging/anti-alias filter for a rational ``up/down`` resampler.

    Designed at the upsampled rate; cutoff at ``cutoff_frac`` of the tighter
    of the input/output Nyquists.  Gain ``up`` compensates zero-stuffing.
    Tap count ``up * taps_per_phase`` for an exact polyphase split.
    """
    num_taps = up * taps_per_phase
    cutoff = cutoff_frac / (2 * max(up, down))  # cycles/sample at upsampled rate
    h = lowpass(num_taps, cutoff, 1.0, atten_db)
    return (h * up).astype(np.float32)


def bandpass(num_taps: int, center: float, half_width: float, fs: float = 1.0,
             atten_db: float = 60.0) -> np.ndarray:
    """Kaiser-windowed-sinc bandpass: lowpass prototype modulated to
    ``center`` Hz, normalized to unity gain at the center frequency."""
    lp = lowpass(num_taps, half_width, fs, atten_db)
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    bp = 2.0 * lp * np.cos(2 * np.pi * center / fs * n)
    # normalize |H(center)| to 1
    w = np.exp(-2j * np.pi * center / fs * np.arange(num_taps))
    gain = abs(np.sum(bp * w))
    return (bp / gain).astype(np.float32)
