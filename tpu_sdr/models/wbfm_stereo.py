"""Stereo WBFM decoder — a capability the reference does not have.

The mono chain's discriminator output *is* the FM multiplex signal at the
demod rate (170 kHz): (L+R)/2 baseband, a 19 kHz pilot, and (L-R)/2 DSB-SC
around 38 kHz.  This model decodes it on the device on top of the existing
front end:

    y(t) ──LPF15k──────────────────────────► S = (L+R)/2 ─┐
      │                                                    ├─► L = S+D
      ├─BPF19k→ p ──square──BPF38k──/mean(p²)─► cos(2·θp)  ├─► R = S−D
      │                                   │                │
      └────────────── × ──────LPF15k── ×2 ┴──► D = (L−R)/2 ┘

followed by the aligned polyphase resampler (170k -> 32k) per channel.
Every filter is the banded matmul (ops/fm.banded_decim_apply with
decim=1); carrier amplitude is normalized per block by the pilot power
(narrowband ⇒ mean(p²) = A²/2).  Streaming carries: three FIR histories +
two resampler histories.

No reference equivalent — `simple_fm` is mono (simple_fm.rs:256-269).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_sdr.models import wbfm as M
from tpu_sdr.ops import fm as F
from tpu_sdr.utils import firdes


@dataclass(frozen=True)
class StereoConfig:
    """Defaults use a WIDEBAND front end: decimate 1.02 M by 3 to a 340 kHz
    demod rate instead of the mono chain's 170 kHz.  FM with 75 kHz
    deviation and a 53 kHz multiplex has a Carson bandwidth of ~256 kHz;
    the 170 kHz channel truncates it to +-76 kHz, and the resulting
    nonlinear distortion caps stereo separation near 26 dB.  At 340 kHz the
    same capture decodes to ~41 dB separation / ~60 dB tone SNR (measured,
    2026-08-20; decim=2/510 kHz gains 8 dB more separation for 2x compute —
    not the default).  Filter tap counts scale with fs to keep the same
    transition widths."""

    base: M.WbfmConfig = None  # front-end config (defaults to FIR, decim 3)
    audio_taps: int = 257      # 15 kHz LPF at 340 kHz
    pilot_taps: int = 513      # 19 kHz +-1.5 kHz BPF
    sub_taps: int = 513        # 38 kHz +-3 kHz BPF
    # Post-matrix de-emphasis per channel (75e-6 US / 50e-6 EU); 0 disables.
    # The reference has none (its chain is mono, boxcar); broadcast stereo
    # needs it to undo transmitter pre-emphasis.
    deemphasis_tau: float = 0.0
    # Also return the multiplex (discriminator output) — RDS rides the
    # same signal the stereo decoder consumes (simple_fm --mode stereo --rds).
    emit_mpx: bool = False

    def __post_init__(self):
        if self.base is None:
            object.__setattr__(self, "base", M.WbfmConfig(
                filter_mode="fir", decim=3, rate_out=340_000))


class StereoState(NamedTuple):
    front: M.WbfmState
    lpf_s: F.FirState      # mono LPF history
    bpf_p: F.FirState      # pilot BPF history
    bpf_c: F.FirState      # 38k carrier BPF history (on p^2)
    lpf_d: F.FirState      # difference LPF history
    dly_y: F.DelayState    # multiplex delay matching the carrier path
    dly_s: F.DelayState    # mono-arm delay matching the difference arm
    de_l: F.DeemphState    # per-channel de-emphasis carries
    de_r: F.DeemphState
    rs_l: F.AlignedResampleState
    rs_r: F.AlignedResampleState


@dataclass
class StereoParams:
    front: M.WbfmParams
    W_s: jax.Array   # banded 15k LPF
    W_p: jax.Array   # banded 19k BPF
    W_c: jax.Array   # banded 38k BPF
    W_d: jax.Array   # banded 15k LPF (difference arm)
    taps_len: tuple  # static lengths (s, p, c, d)


def make_params(config: StereoConfig) -> StereoParams:
    fs = config.base.rate_out  # 170 kHz
    lp = firdes.lowpass(config.audio_taps, 15_000.0, fs)
    bp_p = firdes.bandpass(config.pilot_taps, 19_000.0, 1_500.0, fs)
    bp_c = firdes.bandpass(config.sub_taps, 38_000.0, 3_000.0, fs)
    mk = lambda h: jnp.asarray(F.make_banded_decim_matrix(h, 1))
    return StereoParams(
        M.make_params(config.base), mk(lp), mk(bp_p), mk(bp_c), mk(lp),
        (config.audio_taps, config.pilot_taps, config.sub_taps,
         config.audio_taps),
    )


def carrier_delay(config: StereoConfig) -> int:
    """Group delay of the pilot->carrier recovery path (samples):
    (pilot_taps-1)/2 + (sub_taps-1)/2, exact for the symmetric designs."""
    return (config.pilot_taps - 1) // 2 + (config.sub_taps - 1) // 2


def init_state(config: StereoConfig) -> StereoState:
    T = config.base.resample_taps_per_phase
    return StereoState(
        M.init_state(config.base),
        F.fir_init(config.audio_taps),
        F.fir_init(config.pilot_taps),
        F.fir_init(config.sub_taps),
        F.fir_init(config.audio_taps),
        F.delay_init(carrier_delay(config)),
        F.delay_init(carrier_delay(config)),
        F.deemph_init(),
        F.deemph_init(),
        F.aligned_resample_init(T),
        F.aligned_resample_init(T),
    )


def _fir1(x, W, num_taps, state: F.FirState):
    """decim=1 streaming banded FIR on one row (re-using the complex-pair
    machinery with a dummy second row costs nothing at these sizes)."""
    out_re, _out_im, new = F.fir_decimate_mxu(
        x, jnp.zeros_like(x), W, num_taps, 1, state)
    return out_re, new


@partial(jax.jit, static_argnames=("config",))
def demodulate_block(buf: jax.Array, state: StereoState,
                     params: StereoParams, config: StereoConfig):
    """u8 I/Q block -> ((2, m) stereo audio [L, R], new state).

    Block byte length must be a multiple of 2*decim*down (the aligned
    resampler path).
    """
    cfg = config.base
    up, down = cfg.resample_up, cfg.resample_down

    # mono front end up to the discriminator output (the multiplex signal)
    re, im = F.u8_to_f32(buf)
    re, im, rot = F.rotate_fs4(re, im, state.front.rot)
    num_taps = cfg.decim * cfg.fir_taps_per_phase
    re, im, fir = F.fir_decimate_mxu(
        re, im, params.front.decim_W, num_taps, cfg.decim, state.front.fir,
        W_split=params.front.decim_W_split)
    y, quad = F.quadrature_demod(re, im, state.front.quad)

    # stereo multiplex decode.  The recovered carrier lags the multiplex by
    # the pilot+carrier filters' group delay; the product arm and the mono
    # arm are delayed to match, so both land at the same time base.
    ts, tp, tc, td = params.taps_len
    p, bpf_p = _fir1(y, params.W_p, tp, state.bpf_p)           # pilot
    p2 = p * p
    c_raw, bpf_c = _fir1(p2, params.W_c, tc, state.bpf_c)      # A²/2·cos2θ
    pilot_pow = jnp.maximum(jnp.mean(p2), 1e-12)               # = A²/2
    c38 = c_raw / pilot_pow

    y_d, dly_y = F.delay(y, state.dly_y)                       # match carrier
    d_raw, lpf_d = _fir1(y_d * c38, params.W_d, td, state.lpf_d)
    d = 2.0 * d_raw                                            # (L-R)/2

    s_raw, lpf_s = _fir1(y, params.W_s, ts, state.lpf_s)       # (L+R)/2
    s, dly_s = F.delay(s_raw, state.dly_s)                     # match D arm

    left = s + d
    right = s - d

    # Per-channel de-emphasis at the demod rate (before resampling, like
    # the mono chain's placement in wbfm.demodulate_block).
    if config.deemphasis_tau > 0:
        alpha = F.deemph_alpha(cfg.rate_out, config.deemphasis_tau)
        left, de_l = F.deemphasis(left, alpha, state.de_l)
        right, de_r = F.deemphasis(right, alpha, state.de_r)
    else:
        de_l, de_r = state.de_l, state.de_r

    audio_l, rs_l = F.aligned_resample(left, params.front.resamp_V, up, down,
                                       state.rs_l)
    audio_r, rs_r = F.aligned_resample(right, params.front.resamp_V, up, down,
                                       state.rs_r)

    front = M.WbfmState(rot, fir, quad, state.front.resamp,
                        state.front.box_resamp, state.front.deemph)
    new_state = StereoState(front, lpf_s, bpf_p, bpf_c, lpf_d, dly_y, dly_s,
                            de_l, de_r, rs_l, rs_r)
    if config.emit_mpx:
        return jnp.stack([audio_l, audio_r]), y, new_state
    return jnp.stack([audio_l, audio_r]), new_state


jax.tree_util.register_pytree_node(
    StereoParams,
    lambda p: ((p.front, p.W_s, p.W_p, p.W_c, p.W_d), p.taps_len),
    lambda aux, c: StereoParams(*c, aux),
)


class WbfmStereoStreamer:
    """Host wrapper: u8 blocks in, (2, m) float stereo audio out."""

    def __init__(self, config: StereoConfig | None = None):
        self.config = config or StereoConfig()
        self.params = make_params(self.config)
        self.state = init_state(self.config)
        base = self.config.base
        self._quantum = 2 * base.decim * base.resample_down
        self._pending = np.zeros(0, dtype=np.uint8)
        self.last_mpx: np.ndarray | None = None  # set when config.emit_mpx

    def demodulate(self, buf: np.ndarray) -> np.ndarray:
        data = np.concatenate([self._pending, np.asarray(buf, np.uint8)])
        usable = len(data) - (len(data) % self._quantum)
        self._pending = data[usable:]
        if usable == 0:
            if self.config.emit_mpx:
                self.last_mpx = np.zeros(0, np.float32)
            return np.zeros((2, 0), np.float32)
        if self.config.emit_mpx:
            audio, mpx, self.state = demodulate_block(
                jnp.asarray(data[:usable]), self.state, self.params,
                self.config)
            self.last_mpx = np.asarray(mpx)
        else:
            audio, self.state = demodulate_block(
                jnp.asarray(data[:usable]), self.state, self.params,
                self.config)
        return np.asarray(audio)
