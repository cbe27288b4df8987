"""Multi-mode narrowband receiver: AM / NBFM / USB / LSB.

The reference implements WBFM only; the original C ``rtl_fm`` that its DSP
was ported from also serves AM, narrow FM, and SSB (rtl_fm's ``-M`` modes).
This model family restores those capabilities on the device, on the shared
front end (u8 -> rotate -> banded-matmul FIR decimation to the channel rate):

* **AM**: envelope detector ``sqrt(I² + Q²)`` with DC removal (block mean —
  the same carry-free estimator rtl_fm uses per block).
* **NBFM**: the quadrature discriminator at a narrow channel rate.
* **USB/LSB**: complex down/up-shift by half the audio bandwidth, lowpass,
  then the real part — the phasing method without a Hilbert pair (the
  shift+LPF selects one sideband; works because the front decimator
  already band-limited the channel).

Everything reuses tpu_sdr.ops.fm (streaming carries, matmul filters, aligned
polyphase resampler to the audio rate).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_sdr.ops import fm as F
from tpu_sdr.utils import firdes


@dataclass(frozen=True)
class MultimodeConfig:
    mode: str = "am"              # am | nbfm | usb | lsb
    capture_rate: int = 1_020_000
    decim: int = 6                # -> 170 kHz channel rate
    rate_out: int = 170_000
    rate_resample: int = 32_000
    fir_taps_per_phase: int = 12
    # narrowband channel selectivity applied at the channel rate
    channel_bw: float = 12_500.0  # Hz (AM/NBFM); SSB uses audio_bw
    audio_bw: float = 3_000.0     # Hz (SSB)
    channel_taps: int = 129
    resample_taps_per_phase: int = 48
    # Squelch: mute the block when mean channel power (after the channel
    # filter, full scale = 1.0) falls below this dBFS threshold.  None =
    # always open.  Per-block gate like the original rtl_fm's -l (which
    # the reference port dropped along with the -M modes); rtl_fm uses
    # raw linear units, here it is dBFS for sanity.
    squelch_db: float | None = None
    # SSB fine tuning (Hz, signed): software offset folded into the
    # sideband-select mixer — the R82xx PLL's SDM step is up to ~1 kHz,
    # far too coarse for SSB voice (every Hz of error shifts the audio
    # pitch by a Hz).  USB/LSB only; the FM/AM detectors are offset-
    # insensitive at that scale.
    fine_tune_hz: float = 0.0
    # NBFM de-emphasis time constant in seconds (the original rtl_fm's
    # `-E deemp`; 0 disables).  Applied at the audio rate after the
    # resampler, matching rtl_fm's deemph_filter placement.
    deemphasis_tau: float = 0.0

    @property
    def resample_up(self) -> int:
        return self.rate_resample // math.gcd(self.rate_out, self.rate_resample)

    @property
    def resample_down(self) -> int:
        return self.rate_out // math.gcd(self.rate_out, self.rate_resample)


class MultimodeState(NamedTuple):
    rot: F.RotatorState
    fir: F.FirState        # front decimator
    chan: F.FirState       # channel/sideband filter (complex pair)
    quad: F.QuadState      # NBFM discriminator
    resamp: F.AlignedResampleState     # audio (or SSB I) resampler
    resamp_q: F.AlignedResampleState   # SSB Q resampler
    ssb_phase: jax.Array   # shift phase index at rate_out
    ssb_phase2: jax.Array  # shift-back phase index at rate_resample
    deemph: F.DeemphState = F.DeemphState(jnp.float32(0.0))


@dataclass
class MultimodeParams:
    decim_W: jax.Array
    decim_W_split: tuple
    chan_W: jax.Array      # banded channel/audio filter at rate_out
    resamp_V: jax.Array


def make_params(config: MultimodeConfig) -> MultimodeParams:
    taps = firdes.decimating_lowpass(config.decim,
                                     taps_per_phase=config.fir_taps_per_phase,
                                     cutoff_frac=0.9)
    W = F.make_banded_decim_matrix(taps, config.decim)
    if config.mode in ("usb", "lsb"):
        # sideband-select at the audio rate, where the taps are sharp:
        # wanted band sits at [-bw/2, bw/2] after the shift
        ch = firdes.lowpass(config.channel_taps, config.audio_bw / 2,
                            config.rate_resample)
    else:
        ch = firdes.lowpass(config.channel_taps, config.channel_bw,
                            config.rate_out)
    chan_W = F.make_banded_decim_matrix(ch, 1)
    h = firdes.resampler_taps(config.resample_up, config.resample_down,
                              taps_per_phase=config.resample_taps_per_phase)
    hp = F.make_polyphase(h, config.resample_up)
    V = F.make_aligned_poly_matrix(hp, config.resample_up,
                                   config.resample_down)
    return MultimodeParams(jnp.asarray(W), F.make_split_bf16(np.asarray(W)),
                           jnp.asarray(chan_W), jnp.asarray(V))


def init_state(config: MultimodeConfig) -> MultimodeState:
    L = config.decim * config.fir_taps_per_phase
    return MultimodeState(
        F.rotator_init(), F.fir_init(L), F.fir_init(config.channel_taps),
        F.quad_init(),
        F.aligned_resample_init(config.resample_taps_per_phase),
        F.aligned_resample_init(config.resample_taps_per_phase),
        jnp.int32(0), jnp.int32(0), F.deemph_init(),
    )


@partial(jax.jit, static_argnames=("config",))
def demodulate_block(buf: jax.Array, state: MultimodeState,
                     params: MultimodeParams, config: MultimodeConfig):
    """u8 I/Q block -> (audio (m,), channel power (scalar), new state).
    Byte length must be a multiple of 2 * decim * resample_down."""
    L = config.decim * config.fir_taps_per_phase
    up, down = config.resample_up, config.resample_down

    re, im = F.u8_to_f32(buf)
    re, im, rot = F.rotate_fs4(re, im, state.rot)
    re, im, fir = F.fir_decimate_mxu(re, im, params.decim_W, L, config.decim,
                                     state.fir, W_split=params.decim_W_split)

    quad = state.quad
    ssb_phase = state.ssb_phase
    ssb_phase2 = state.ssb_phase2
    n = re.shape[0]
    if config.mode in ("usb", "lsb"):
        # Shift the wanted sideband to center: USB content [0, bw] moves to
        # [-bw/2, bw/2] (shift by -bw/2); LSB mirrored.  Select it with a
        # sharp LPF at the audio rate (129 taps at 32 kHz: ~1 kHz
        # transition), shift back, take the real part.  Both shifts carry
        # integer phase indices so blocks stay phase-continuous.  The
        # fine-tune offset rides the FIRST mixer only (it must move the
        # carrier, not the audio), so the shift-back stays at +-bw/2.
        shift = -config.audio_bw / 2 if config.mode == "usb" else config.audio_bw / 2
        # rounded to whole Hz: the wrapped phase index (mod rate_out)
        # keeps blocks phase-continuous only for integer-Hz shifts
        shift1 = shift - round(config.fine_tune_hz)
        k = state.ssb_phase + jnp.arange(n, dtype=jnp.float32)
        ph = 2 * np.pi * (shift1 / config.rate_out) * k
        c, s = jnp.cos(ph), jnp.sin(ph)
        sr = re * c - im * s
        si = re * s + im * c
        ssb_phase = (state.ssb_phase + n) % jnp.int32(config.rate_out)

        sr32, rs = F.aligned_resample(sr, params.resamp_V, up, down,
                                      state.resamp)
        si32, rs_q = F.aligned_resample(si, params.resamp_V, up, down,
                                        state.resamp_q)
        sr32, si32, chan = F.fir_decimate_mxu(
            sr32, si32, params.chan_W, config.channel_taps, 1, state.chan)
        m = sr32.shape[0]
        k2 = state.ssb_phase2 + jnp.arange(m, dtype=jnp.float32)
        ph2 = 2 * np.pi * (shift / config.rate_resample) * k2
        audio = sr32 * jnp.cos(ph2) + si32 * jnp.sin(ph2)
        ssb_phase2 = (state.ssb_phase2 + m) % jnp.int32(config.rate_resample)
        power = _channel_power(sr32, si32)
        audio = _squelch(audio, power, config)
        return audio, power, MultimodeState(rot, fir, chan, quad, rs, rs_q,
                                            ssb_phase, ssb_phase2,
                                            state.deemph)

    re, im, chan = F.fir_decimate_mxu(re, im, params.chan_W,
                                      config.channel_taps, 1, state.chan)
    if config.mode == "am":
        env = jnp.sqrt(re * re + im * im)
        audio_ch = env - jnp.mean(env)  # DC removal, rtl_fm-style
    elif config.mode == "nbfm":
        audio_ch, quad = F.quadrature_demod(re, im, state.quad)
    else:
        raise ValueError(f"unknown mode {config.mode}")

    audio, rs = F.aligned_resample(audio_ch, params.resamp_V, up, down,
                                   state.resamp)
    deemph = state.deemph
    if config.mode == "nbfm" and config.deemphasis_tau > 0:
        alpha = F.deemph_alpha(config.rate_resample, config.deemphasis_tau)
        audio, deemph = F.deemphasis(audio, alpha, state.deemph)
    power = _channel_power(re, im)
    audio = _squelch(audio, power, config)
    return audio, power, MultimodeState(rot, fir, chan, quad, rs,
                                        state.resamp_q, ssb_phase, ssb_phase2,
                                        deemph)


def _channel_power(ch_re, ch_im):
    """Mean filtered-channel power (linear, full scale 1.0) — the squelch
    measurement, also returned to the host for scan-mode hop decisions."""
    return jnp.mean(ch_re * ch_re + ch_im * ch_im)


def _squelch(audio, power, config: MultimodeConfig):
    """Mute the block when the filtered channel's mean power is below the
    configured dBFS threshold (no-op when squelch is off)."""
    if config.squelch_db is None:
        return audio
    open_ = power > jnp.float32(10.0 ** (config.squelch_db / 10.0))
    return jnp.where(open_, audio, jnp.zeros_like(audio))


jax.tree_util.register_pytree_node(
    MultimodeParams,
    lambda p: ((p.decim_W, p.decim_W_split, p.chan_W, p.resamp_V), None),
    lambda _, c: MultimodeParams(*c),
)


class MultimodeStreamer:
    """Host wrapper mirroring WbfmStreamer for the narrowband modes."""

    def __init__(self, config: MultimodeConfig | None = None):
        self.config = config or MultimodeConfig()
        self.params = make_params(self.config)
        self.state = init_state(self.config)
        self._quantum = 2 * self.config.decim * self.config.resample_down
        self._pending = np.zeros(0, dtype=np.uint8)
        # squelch observables for the host (rtl_fm scan-mode hop decisions).
        # n_measurements counts demodulate() calls that consumed >= one
        # quantum: last_power/last_squelch_open are only meaningful when it
        # advanced (a sub-quantum call leaves them stale).
        self.last_power: float | None = None
        self.last_squelch_open: bool = True
        self.n_measurements: int = 0

    def demodulate(self, buf: np.ndarray) -> np.ndarray:
        data = np.concatenate([self._pending, np.asarray(buf, np.uint8)])
        usable = len(data) - (len(data) % self._quantum)
        self._pending = data[usable:]
        if usable == 0:
            return np.zeros(0, np.float32)
        audio, power, self.state = demodulate_block(
            jnp.asarray(data[:usable]), self.state, self.params, self.config)
        self.last_power = float(power)
        self.last_squelch_open = (
            self.config.squelch_db is None
            or self.last_power > 10.0 ** (self.config.squelch_db / 10.0))
        self.n_measurements += 1
        return np.asarray(audio)

    def reset(self) -> None:
        """Drop all streaming carries (used on a scan-mode retune: samples
        before and after a hop are not continuous)."""
        self.state = init_state(self.config)
        self._pending = np.zeros(0, dtype=np.uint8)
        self.last_power = None
        self.last_squelch_open = True
        self.n_measurements = 0
