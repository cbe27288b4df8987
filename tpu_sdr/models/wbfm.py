"""Fast float WBFM demodulator — the accelerator throughput path.

Same receive chain as the reference ``simple_fm``
(/root/reference/examples/simple_fm.rs:256-269) but redesigned for XLA:

    u8 I/Q -> f32 -> fs/4 rotate -> polyphase FIR decimate
           -> quadrature discriminator -> rational polyphase resample
           -> (optional de-emphasis) -> audio

One jitted pure function per block with an explicit carry pytree; the boxcar
filters are upgraded to real FIR anti-alias filtering (BASELINE.json north
star).  Fidelity versus the bit-exact path is asserted by an SNR bound in
tests rather than sample equality.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_sdr.ops import fm as F
from tpu_sdr.utils import firdes


@dataclass(frozen=True)
class WbfmConfig:
    """Fast-chain configuration.

    Defaults mirror the reference's ``optimal_settings(94.9M, 170k)``:
    capture 1.02 Msps, decimate by 6 to 170 kHz, resample to 32 kHz audio.
    """

    capture_rate: int = 1_020_000
    decim: int = 6
    rate_out: int = 170_000
    rate_resample: int = 32_000
    # "fir": proper anti-alias FIR decimation + polyphase audio resampler +
    #        true atan2 — best radio quality (the BASELINE.json north star).
    # "boxcar": float twins of the reference's boxcar filters and fast-atan2
    #        approximation — tracks the reference output to >=60 dB and is
    #        the cheapest chain (reshape-sum decimator, no transcendentals).
    filter_mode: str = "fir"
    fir_taps_per_phase: int = 12
    # WBFM occupies nearly the whole decimated band (Carson BW ~2*(75k+15k)
    # at 170 kHz out), so the anti-alias cutoff sits close to the output
    # Nyquist rather than the usual conservative fraction.
    fir_cutoff_frac: float = 0.9
    resample_taps_per_phase: int = 48
    resample_cutoff_frac: float = 0.8
    deemphasis_tau: float = 0.0  # seconds; 0 disables (reference has none)
    # Also return the 170 kHz multiplex (discriminator output) from each
    # block — the tap the RDS/stereo subcarrier decoders consume.
    emit_mpx: bool = False
    # "split_bf16": decimator matmuls in split-precision bfloat16 (the u8
    #   samples x255 are exact 9-bit integers, hence exact in bf16; taps are
    #   carried as a hi+lo bf16 pair for ~16-bit weight precision): two bf16
    #   passes with f32 accumulation, >90 dB agreement with f32.  "f32":
    #   plain float32 (Precision.HIGHEST).  Which is faster on the GPU is
    #   not measured yet.
    mxu_precision: str = "split_bf16"

    @property
    def resample_up(self) -> int:
        g = math.gcd(self.rate_out, self.rate_resample)
        return self.rate_resample // g

    @property
    def resample_down(self) -> int:
        g = math.gcd(self.rate_out, self.rate_resample)
        return self.rate_out // g


class WbfmState(NamedTuple):
    rot: F.RotatorState
    fir: F.FirState
    quad: F.QuadState
    resamp: F.ResampleState
    box_resamp: F.BoxcarResampleState
    deemph: F.DeemphState


@dataclass
class WbfmParams:
    """Precomputed filter banks (host-designed, device-resident).

    ``decim_W`` and ``resamp_V``/``box_V`` are the matmul forms
    of the same filters (see tpu_sdr.ops.fm banded/aligned ops).
    """

    decim_taps: jax.Array
    resamp_poly: jax.Array  # (up, T)
    decim_W: jax.Array  # (128*decim + L - decim, 128) banded decimator
    resamp_V: jax.Array  # (down + T - 1, up) aligned polyphase resampler
    box_V: jax.Array  # (down, up) aligned boxcar resampler
    decim_W_split: tuple[jax.Array, jax.Array] | None = None  # bf16 hi/lo
    # 4-frames-per-row packed resampler (N = 4*up output columns):
    # usable whenever the block length divides down*4
    resamp_V4: jax.Array | None = None


def make_params(config: WbfmConfig) -> WbfmParams:
    decim_taps = firdes.decimating_lowpass(
        config.decim, taps_per_phase=config.fir_taps_per_phase,
        cutoff_frac=config.fir_cutoff_frac,
    )
    h = firdes.resampler_taps(
        config.resample_up, config.resample_down,
        taps_per_phase=config.resample_taps_per_phase,
        cutoff_frac=config.resample_cutoff_frac,
    )
    h_poly = F.make_polyphase(h, config.resample_up)
    decim_W = F.make_banded_decim_matrix(decim_taps, config.decim)
    resamp_V = F.make_aligned_poly_matrix(h_poly, config.resample_up, config.resample_down)
    box_V, _, _ = F.make_aligned_boxcar_matrix(config.rate_out, config.rate_resample)
    W_split = (
        F.make_split_bf16(np.asarray(decim_W))
        if config.mxu_precision == "split_bf16" else None
    )
    resamp_V4 = F.make_aligned_poly_matrix(
        h_poly, config.resample_up, config.resample_down, frames_per_row=4)
    return WbfmParams(
        jnp.asarray(decim_taps), jnp.asarray(h_poly), jnp.asarray(decim_W),
        jnp.asarray(resamp_V), jnp.asarray(box_V), W_split,
        jnp.asarray(resamp_V4),
    )


def init_state(config: WbfmConfig) -> WbfmState:
    num_taps = config.decim * config.fir_taps_per_phase
    return WbfmState(
        F.rotator_init(),
        F.fir_init(num_taps),
        F.quad_init(),
        F.resample_init(_resamp_T(config)),
        F.boxcar_resample_init(),
        F.deemph_init(),
    )


def _resamp_T(config: WbfmConfig) -> int:
    L = config.resample_up * config.resample_taps_per_phase
    return -(-L // config.resample_up)


@partial(jax.jit, static_argnames=("config",))
def demodulate_block(buf: jax.Array, state: WbfmState, params: WbfmParams,
                     config: WbfmConfig):
    """One u8 I/Q block -> (audio_padded f32, count, new_state); with
    ``config.emit_mpx`` -> (audio_padded, count, mpx, new_state).

    Block byte length must satisfy ``len % (2*decim) == 0``.
    """
    re, im = F.u8_to_f32(buf)
    re, im, rot = F.rotate_fs4(re, im, state.rot)
    if config.filter_mode == "boxcar":
        re, im = F.boxcar_decimate_f32(re, im, config.decim)
        fir = state.fir
        y, quad = F.quadrature_demod(re, im, state.quad, atan_mode="fast")
    else:
        num_taps = config.decim * config.fir_taps_per_phase
        re, im, fir = F.fir_decimate_mxu(
            re, im, params.decim_W, num_taps, config.decim, state.fir,
            W_split=params.decim_W_split,
        )
        y, quad = F.quadrature_demod(re, im, state.quad)
    mpx = y  # pre-de-emphasis: the subcarriers must not be rolled off
    if config.deemphasis_tau > 0:
        alpha = F.deemph_alpha(config.rate_out, config.deemphasis_tau)
        y, deemph = F.deemphasis(y, alpha, state.deemph)
    else:
        deemph = state.deemph

    n_out = y.shape[0]
    up, down = config.resample_up, config.resample_down
    aligned = n_out % down == 0  # static: resolved at trace time
    if config.filter_mode == "boxcar":
        if aligned:
            # Stateless frame matmul (the boxcar emission pattern consumes
            # every frame exactly; see make_aligned_boxcar_matrix).
            audio, _ = F.aligned_resample(
                y, params.box_V, up, down,
                F.AlignedResampleState(jnp.zeros(0, jnp.float32)),
            )
            count = jnp.int32(audio.shape[0])
            box_resamp = state.box_resamp
        else:
            audio, count, box_resamp = F.boxcar_resample_f32(
                y, state.box_resamp, config.rate_out, config.rate_resample
            )
        resamp = state.resamp
    else:
        if aligned:
            # Frame-matmul path: valid while the stream sticks to aligned
            # block sizes (the fractional phase then stays 0 forever).
            # 4-frame N-lane packed V when the block divides down*4
            # (identical output to ~1e-7).
            V = (params.resamp_V4
                 if params.resamp_V4 is not None and n_out % (down * 4) == 0
                 else params.resamp_V)
            audio, rs = F.aligned_resample(
                y, V, up, down,
                F.AlignedResampleState(state.resamp.hist),
            )
            count = jnp.int32(audio.shape[0])
            resamp = F.ResampleState(rs.hist, state.resamp.t0)
        else:
            audio, count, resamp = F.polyphase_resample(
                y, params.resamp_poly, up, down, state.resamp
            )
        box_resamp = state.box_resamp
    new_state = WbfmState(rot, fir, quad, resamp, box_resamp, deemph)
    if config.emit_mpx:
        return audio, count, mpx, new_state
    return audio, count, new_state


jax.tree_util.register_pytree_node(
    WbfmParams,
    lambda p: ((p.decim_taps, p.resamp_poly, p.decim_W, p.resamp_V, p.box_V,
                p.decim_W_split, p.resamp_V4), None),
    lambda _, c: WbfmParams(*c),
)


def audio_to_s16(audio: np.ndarray, scale: float = 0.9) -> np.ndarray:
    """Float audio [-1, 1] -> s16 PCM (the reference emits s16-LE,
    simple_fm.rs:430-438)."""
    return np.clip(audio * (scale * 32767.0), -32768, 32767).astype(np.int16)


class WbfmStreamer:
    """Host wrapper: feed u8 blocks of any size, receive trimmed float audio.

    The jitted block transform consumes byte counts divisible by
    ``2*decim*resample_down`` (e.g. 1020 for decim=6, down=85) so every
    block stays on the aligned resampler path; arbitrary input sizes (e.g.
    the reference's 262144-byte blocks) are handled by carrying the
    residual bytes to the next call.  For a fixed input block size the
    usable length settles to a couple of distinct values, so jit
    recompilation is bounded.
    """

    def __init__(self, config: WbfmConfig | None = None):
        self.config = config or WbfmConfig()
        self.params = make_params(self.config)
        self.state = init_state(self.config)
        self._pending = np.zeros(0, dtype=np.uint8)
        self.last_mpx: np.ndarray | None = None  # set when config.emit_mpx

    def demodulate(self, buf: np.ndarray) -> np.ndarray:
        data = np.concatenate([self._pending, np.asarray(buf, dtype=np.uint8)])
        # Quantum 2*decim*down keeps every jitted block on the ALIGNED
        # resampler path (n_out % down == 0).  A 2*decim quantum let a
        # chunk sequence flip between the aligned frame matmul and the
        # unaligned polyphase path, whose carries are not interchangeable
        # — the reference's own 262144-byte blocks (131072 % 510 != 0)
        # alternated paths and cost ~35 dB of tone SNR (found round 3 by
        # the frequency-aware-source tests; regression:
        # test_fm_fast.test_reference_block_size_streaming).
        quantum = 2 * self.config.decim * self.config.resample_down
        usable = len(data) - (len(data) % quantum)
        self._pending = data[usable:]
        if usable == 0:
            if self.config.emit_mpx:
                self.last_mpx = np.zeros(0, np.float32)
            return np.zeros(0, dtype=np.float32)
        if self.config.emit_mpx:
            audio, count, mpx, self.state = demodulate_block(
                jnp.asarray(data[:usable]), self.state, self.params,
                self.config)
            self.last_mpx = np.asarray(mpx)
        else:
            audio, count, self.state = demodulate_block(
                jnp.asarray(data[:usable]), self.state, self.params,
                self.config)
        return np.asarray(audio)[: int(count)]
