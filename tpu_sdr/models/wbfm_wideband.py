"""Wideband multi-station WBFM: one capture -> K channels -> N audio streams.

The reference tunes ONE station per process (examples/simple_fm.rs); one
accelerator instead ingests a wideband capture, splits it with the PFB
channelizer (tpu_sdr.ops.channelizer — fused branch-filter + channel-DFT as
one convolution),
and runs the WBFM tail (quadrature discriminator + polyphase audio
resampler) on every selected channel in parallel (vmap over stations).
This is BASELINE.json config #3's receive topology.

Geometry: capture rate ``fs`` with K channels gives per-channel rate
``fs / K``; choose ``fs = K * 170 kHz`` so each channel matches the
reference's 170 kHz demod rate and the standard 170k -> 32k audio resampler
applies unchanged.  Block complex length must be a multiple of
``K * resample_down`` to stay on the aligned frame-matmul resampler path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_sdr.ops import channelizer as chan
from tpu_sdr.ops import fm as F
from tpu_sdr.utils import firdes


@dataclass(frozen=True)
class WidebandConfig:
    num_channels: int = 64
    taps_per_branch: int = 8
    # WBFM occupies nearly the whole critically-sampled channel (Carson BW
    # ~165 kHz in a 170 kHz channel), so the branch prototype cuts off near
    # the channel edge rather than the usual conservative fraction.
    pfb_cutoff_frac: float = 0.95
    channels: tuple[int, ...] = (0,)          # selected station channels
    channel_rate: int = 170_000               # = capture_rate / K
    rate_resample: int = 32_000
    resample_taps_per_phase: int = 48
    resample_cutoff_frac: float = 0.8
    # Also return every station's multiplex (discriminator output) — the
    # tap the per-station RDS decoders consume (multi_fm --rds).
    emit_mpx: bool = False

    @property
    def capture_rate(self) -> int:
        return self.num_channels * self.channel_rate

    @property
    def resample_up(self) -> int:
        g = math.gcd(self.channel_rate, self.rate_resample)
        return self.rate_resample // g

    @property
    def resample_down(self) -> int:
        g = math.gcd(self.channel_rate, self.rate_resample)
        return self.channel_rate // g


class WidebandState(NamedTuple):
    pfb: chan.PfbState
    quad: F.QuadState          # leaves stacked over stations
    resamp: F.AlignedResampleState  # hist stacked over stations


@dataclass
class WidebandParams:
    h_poly: jax.Array          # (rows, K) PFB branch matrix
    pfb_W: jax.Array           # fused branch+DFT conv weights
    resamp_V: jax.Array        # (down + T - 1, up) aligned resampler
    # 4-frames-per-row packed variant (4x wider matmul output, same
    # result) — selected at trace time when the channel block divides down*4
    resamp_V4: jax.Array | None = None


def make_params(config: WidebandConfig) -> WidebandParams:
    h_poly = chan.design_pfb(config.num_channels, config.taps_per_branch,
                             cutoff_frac=config.pfb_cutoff_frac)
    W = chan.pfb_conv_weights(h_poly)
    h = firdes.resampler_taps(
        config.resample_up, config.resample_down,
        taps_per_phase=config.resample_taps_per_phase,
        cutoff_frac=config.resample_cutoff_frac)
    hp = F.make_polyphase(h, config.resample_up)
    V = F.make_aligned_poly_matrix(hp, config.resample_up, config.resample_down)
    V4 = F.make_aligned_poly_matrix(hp, config.resample_up,
                                    config.resample_down, frames_per_row=4)
    return WidebandParams(jnp.asarray(h_poly), jnp.asarray(W),
                          jnp.asarray(V), jnp.asarray(V4))


def init_state(config: WidebandConfig, params: WidebandParams) -> WidebandState:
    n_st = len(config.channels)
    Tm1 = config.resample_taps_per_phase - 1
    return WidebandState(
        chan.pfb_init(params.h_poly),
        F.QuadState(jnp.ones(n_st, jnp.float32), jnp.zeros(n_st, jnp.float32)),
        F.AlignedResampleState(jnp.zeros((n_st, Tm1), jnp.float32)),
    )


@partial(jax.jit, static_argnames=("config",))
def demodulate_block(buf: jax.Array, state: WidebandState,
                     params: WidebandParams, config: WidebandConfig):
    """One wideband u8 block -> (audio (stations, m), new state).

    Block complex length must be a multiple of K * resample_down.
    """
    K = config.num_channels
    up, down = config.resample_up, config.resample_down
    re, im = F.u8_to_f32(buf)
    y_re, y_im, pfb = chan.pfb_analyze(re, im, params.h_poly, state.pfb,
                                       W=params.pfb_W)
    ch = jnp.asarray(config.channels)
    zr = y_re[:, ch].T  # (stations, m)
    zi = y_im[:, ch].T

    def tail(zr1, zi1, q_re, q_im, hist):
        z, quad = F.quadrature_demod(zr1, zi1, F.QuadState(q_re, q_im))
        V = (params.resamp_V4
             if params.resamp_V4 is not None and z.shape[0] % (down * 4) == 0
             else params.resamp_V)
        audio, rs = F.aligned_resample(
            z, V, up, down, F.AlignedResampleState(hist))
        return audio, z, quad, rs

    audio, mpx, quads, rss = jax.vmap(tail)(
        zr, zi, state.quad.pre_re, state.quad.pre_im, state.resamp.hist)
    new_state = WidebandState(
        pfb,
        F.QuadState(quads.pre_re, quads.pre_im),
        F.AlignedResampleState(rss.hist),
    )
    if config.emit_mpx:
        return audio, mpx, new_state
    return audio, new_state


jax.tree_util.register_pytree_node(
    WidebandParams,
    lambda p: ((p.h_poly, p.pfb_W, p.resamp_V, p.resamp_V4), None),
    lambda _, c: WidebandParams(*c),
)


class WidebandStreamer:
    """Host wrapper: feed wideband u8 blocks, get (stations, m) audio."""

    def __init__(self, config: WidebandConfig | None = None):
        self.config = config or WidebandConfig()
        self.params = make_params(self.config)
        self.state = init_state(self.config, self.params)
        self._pending = np.zeros(0, dtype=np.uint8)
        self._quantum = 2 * self.config.num_channels * self.config.resample_down
        self.last_mpx: np.ndarray | None = None  # set when config.emit_mpx

    def demodulate(self, buf: np.ndarray) -> np.ndarray:
        data = np.concatenate([self._pending, np.asarray(buf, np.uint8)])
        usable = len(data) - (len(data) % self._quantum)
        self._pending = data[usable:]
        emit_mpx = self.config.emit_mpx
        if usable == 0:
            if emit_mpx:
                self.last_mpx = np.zeros((len(self.config.channels), 0),
                                         np.float32)
            return np.zeros((len(self.config.channels), 0), np.float32)
        if emit_mpx:
            audio, mpx, self.state = demodulate_block(
                jnp.asarray(data[:usable]), self.state, self.params,
                self.config)
            self.last_mpx = np.asarray(mpx)
        else:
            audio, self.state = demodulate_block(
                jnp.asarray(data[:usable]), self.state, self.params,
                self.config)
        return np.asarray(audio)
