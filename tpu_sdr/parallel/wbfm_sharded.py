"""Multi-chip WBFM: stations x time sharded over a (dp, sp) mesh.

The device-mesh replacement for the reference's two host threads
(SURVEY.md §2 "parallelism components"): the unbounded sample stream is
blocked into large device arrays, sharded

* over ``dp`` by station (data parallelism — independent receivers on the
  same wideband block or different blocks), and
* over ``sp`` along time (sequence parallelism): each chip demodulates its
  time slice after pulling a small halo from its left neighbor
  (``lax.ppermute`` inside ``shard_map``) — the overlap-save analog of the
  serial chain's streaming carries (simple_fm.rs:232-239).

Halo sizes: FIR needs ``taps-1`` input samples, the discriminator 1
decimated sample, the audio resampler ``ceil(rate_out/rate_resample)`` (or
``T-1`` for the polyphase mode) demodulated samples.  Everything else is
embarrassingly parallel, so scaling efficiency is limited only by the halo
bytes — a few hundred per shard per block.

Audio emission counts are data-independent closed forms of the global shard
offset, so per-shard outputs are padded to a static maximum with a traced
valid count — no dynamic shapes anywhere.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple


import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_sdr.models.wbfm import WbfmConfig, make_params
from tpu_sdr.ops import fm as F
from tpu_sdr.parallel.halo import pull_left_halo


class XlaStreamCarry(NamedTuple):
    """Block-to-block streaming carry of the XLA sharded chain (per
    station row): the rotated-sample FIR history, the discriminator's
    previous decimated sample, and the demodulated resampler history —
    the sharded analog of the serial ``WbfmState`` minus the rotator
    phase (shard/block lengths are multiples of 4 samples, so the fs/4
    phase is always 0 at every boundary)."""

    fir_re: jax.Array   # (stations, num_taps - 1)
    fir_im: jax.Array
    quad_re: jax.Array  # (stations, 1)
    quad_im: jax.Array
    rs: jax.Array       # (stations, T - 1)


def initial_xla_carry(stations: int,
                      config: WbfmConfig | None = None) -> XlaStreamCarry:
    """Fresh-stream carry: zero histories, discriminator prev = 1 + 0j
    (the serial QuadState init)."""
    config = config or WbfmConfig(filter_mode="fir")
    L = config.decim * config.fir_taps_per_phase
    T = config.resample_taps_per_phase
    return XlaStreamCarry(
        jnp.zeros((stations, L - 1), jnp.float32),
        jnp.zeros((stations, L - 1), jnp.float32),
        jnp.ones((stations, 1), jnp.float32),
        jnp.zeros((stations, 1), jnp.float32),
        jnp.zeros((stations, T - 1), jnp.float32),
    )


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class ShardedWbfm:
    """A compiled sharded chain for fixed (stations, bytes) global shapes."""

    mesh: Mesh
    config: WbfmConfig
    fn: callable
    in_sharding: NamedSharding

    def __call__(self, blocks):
        """``blocks``: u8 (stations, bytes) — returns (audio_padded, counts)
        with audio (stations, sp*m_max_loc) and counts (sp,)."""
        return self.fn(blocks)

    def assemble(self, audio, counts) -> np.ndarray:
        """Trim per-shard padding and concatenate time shards on the host."""
        audio = np.asarray(audio)
        counts = np.asarray(counts)
        sp = counts.shape[0]
        m_max = audio.shape[1] // sp
        pieces = []
        for s in range(sp):
            pieces.append(audio[:, s * m_max : s * m_max + counts[s]])
        return np.concatenate(pieces, axis=1)


def make_sharded_wbfm(mesh: Mesh, config: WbfmConfig | None = None,
                      carry_io: bool = False) -> ShardedWbfm:
    """Build the jitted sharded chain for ``mesh`` with axes ('dp','sp').

    ``carry_io``: block-to-block streaming (FIR-mode only).  The jitted
    fn becomes ``fn(blocks, carry: XlaStreamCarry) -> (audio, counts,
    new_carry)``: the carry seeds shard 0's FIR/discriminator/resampler
    halos and the LAST time shard's end-of-block values come back — feed
    them forward and the sharded chain is sample-exact with one serial
    stream across blocks.  Use :func:`initial_xla_carry` to start."""
    config = config or WbfmConfig()
    params = make_params(config)
    decim = config.decim
    num_taps = config.decim * config.fir_taps_per_phase
    if carry_io:
        assert config.filter_mode == "fir", (
            "carry_io streaming is defined for the FIR chain")
    T_rs = config.resample_taps_per_phase

    def shard_fn(blocks_loc, carry=None):
        """Per-shard compute. blocks_loc: u8 (stations_loc, bytes_loc)."""
        st, nbytes = blocks_loc.shape
        n_loc = nbytes // 2
        assert n_loc % (4 * decim) == 0, (
            "local shard must be a multiple of 4 samples (rotation phase) "
            "and the decimation factor")
        n_out = n_loc // decim
        # Halos are pulled from the IMMEDIATE left neighbor only; a shard
        # shorter than the FIR halo would silently read zero-padding
        # (caught round 4 when the multichip dryrun gained its exactness
        # check).  The resampler-side halo is checked in resample_shard.
        if config.filter_mode != "boxcar":
            assert n_loc >= num_taps - 1, (
                f"time shard too small for the single-neighbor FIR halo: "
                f"n_loc={n_loc} needs >= {num_taps - 1} raw samples")

        # --- u8 -> centered float, fs/4 rotate (phase 0 on every shard
        # because shard lengths are multiples of 4 samples) ---------------
        x = blocks_loc.astype(jnp.float32) * jnp.float32(1 / 127.5) - 1.0
        re, im = x[:, 0::2], x[:, 1::2]
        k = jnp.arange(n_loc, dtype=jnp.int32) % 4
        rot_re = jnp.where(k == 0, re, jnp.where(k == 1, -im, jnp.where(k == 2, -re, im)))
        rot_im = jnp.where(k == 0, im, jnp.where(k == 1, re, jnp.where(k == 2, -im, -re)))

        # --- decimation ---------------------------------------------------
        if config.filter_mode == "boxcar":
            # Groups align with shard boundaries; zero halo.
            d_re = rot_re.reshape(st, n_out, decim).sum(axis=2)
            d_im = rot_im.reshape(st, n_out, decim).sum(axis=2)
        else:
            halo_re = pull_left_halo(
                rot_re.T, num_taps - 1, "sp",
                left_edge=None if carry is None else carry.fir_re.T).T
            halo_im = pull_left_halo(
                rot_im.T, num_taps - 1, "sp",
                left_edge=None if carry is None else carry.fir_im.T).T
            xr = jnp.concatenate([halo_re, rot_re], axis=1)
            xi = jnp.concatenate([halo_im, rot_im], axis=1)
            xext = jnp.concatenate([xr, xi], axis=0)  # (2*st, halo+n_loc)
            y = F.banded_decim_apply(xext, params.decim_W, decim, n_out)
            d_re, d_im = y[:st], y[st:]

        # --- discriminator: 1-sample halo at the decimated rate.  The
        # global left edge is seeded (1, 0) like the serial QuadState init,
        # so shard 0 reproduces the serial first sample exactly. ----------
        prev_re = pull_left_halo(
            d_re.T, 1, "sp",
            left_edge=(jnp.ones((1, st), jnp.float32) if carry is None
                       else carry.quad_re.T)).T
        prev_im = pull_left_halo(
            d_im.T, 1, "sp",
            left_edge=None if carry is None else carry.quad_im.T).T
        b_re = jnp.concatenate([prev_re, d_re[:, :-1]], axis=1)
        b_im = jnp.concatenate([prev_im, d_im[:, :-1]], axis=1)
        c_re = d_re * b_re + d_im * b_im
        c_im = d_im * b_re - d_re * b_im
        if config.filter_mode == "boxcar":
            ang = F.fast_atan2_f32(c_im, c_re)
        else:
            ang = jnp.arctan2(c_im, c_re)
        demod = ang * jnp.float32(1 / np.pi)

        if carry is None:
            return resample_shard(demod, config, params, "sp")
        audio, counts = resample_shard(demod, config, params, "sp",
                                       left_edge=carry.rs)
        # End-of-block carries: the LAST time shard's tails, broadcast to
        # every sp rank via a one-hot psum (a single tiny all-reduce).
        last = (lax.axis_index("sp")
                == lax.axis_size("sp") - 1).astype(jnp.float32)
        new_carry = XlaStreamCarry(
            lax.psum(rot_re[:, n_loc - (num_taps - 1):] * last, "sp"),
            lax.psum(rot_im[:, n_loc - (num_taps - 1):] * last, "sp"),
            lax.psum(d_re[:, n_out - 1:] * last, "sp"),
            lax.psum(d_im[:, n_out - 1:] * last, "sp"),
            lax.psum(demod[:, n_out - (T_rs - 1):] * last, "sp"),
        )
        return audio, counts, new_carry

    if carry_io:
        carry_spec = XlaStreamCarry(*([P("dp", None)] * 5))
        in_specs = (P("dp", "sp"), carry_spec)
        out_specs = (P("dp", "sp"), P("sp"), carry_spec)
    else:
        in_specs = P("dp", "sp")
        out_specs = (P("dp", "sp"), P("sp"))
    sharded = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
    )
    fn = jax.jit(sharded)

    return ShardedWbfm(
        mesh=mesh, config=config, fn=fn,
        in_sharding=NamedSharding(mesh, P("dp", "sp")),
    )


def _cdiv_traced(a, b):
    return (a + b - 1) // b


def resample_shard(demod, config: WbfmConfig, params, axis_name: str,
                   left_edge=None):
    """Per-shard audio resampler with global-phase closed forms.

    ``demod``: (stations_loc, n_out) discriminator output for this time
    shard.  Pulls the left-neighbor halo and emits
    ``(audio (stations_loc, m_max), count (1,))`` — emission counts are
    data-independent functions of the global shard offset, so shapes stay
    static.

    ``left_edge``: optional (stations_loc, halo) demod history injected as
    shard 0's halo — the previous block's global tail, for block-to-block
    streaming continuity (zeros = fresh stream, the legacy behavior).
    """
    st, n_out = demod.shape
    fast, slow = config.rate_out, config.rate_resample
    up, down = config.resample_up, config.resample_down
    h_poly = params.resamp_poly
    T = h_poly.shape[1]

    shard = lax.axis_index(axis_name)
    start = shard * n_out  # global index of our first demod sample

    aligned = n_out % down == 0  # static; both modes share (up, down)
    pack = 4 if (config.filter_mode != "boxcar"
                 and n_out % (down * 4) == 0) else 1
    # Single-neighbor halo bound (see make_sharded_wbfm): the widest
    # demod-side halo any path below pulls.
    max_halo = 0 if config.filter_mode == "boxcar" and aligned else (
        _cdiv(fast, slow) if config.filter_mode == "boxcar" else T - 1)
    assert n_out >= max_halo, (
        f"time shard too small for the single-neighbor resampler halo: "
        f"n_out={n_out} needs >= {max_halo} demodulated samples")
    if aligned:
        # Frame-matmul path: every shard starts on a frame boundary,
        # so the per-shard resample is the serial aligned op with the left
        # halo as history.
        if config.filter_mode == "boxcar":
            V = params.box_V
            halo = jnp.zeros((st, 0), jnp.float32)
        else:
            if pack > 1 and params.resamp_V4 is not None:
                # N-lane packed V (same -15% as the single-chip epilogue,
                # round 4); the T-1 halo is unchanged (window overlap
                # does not depend on the packing)
                V = params.resamp_V4
            else:
                V = params.resamp_V
            halo = pull_left_halo(
                demod.T, T - 1, axis_name,
                left_edge=None if left_edge is None else left_edge.T).T
        m_frames = n_out // down
        count = jnp.int32(m_frames * up)
        audio = jax.vmap(
            lambda row, h: F.aligned_resample(
                row, V, up, down, F.AlignedResampleState(h))[0]
        )(demod, halo)
        return audio, count[None]

    if config.filter_mode == "boxcar":
        halo_len = _cdiv(fast, slow)
        m_max = (n_out * slow) // fast + 1
        halo = pull_left_halo(
            demod.T, halo_len, axis_name,
            left_edge=None if left_edge is None else left_edge.T).T
        buf = jnp.concatenate([halo, demod], axis=1)
        cs = jnp.cumsum(buf, axis=1)

        j0 = (start * slow) // fast
        count = ((start + n_out) * slow) // fast - j0
        j = j0 + jnp.arange(m_max, dtype=jnp.int32)
        e = ((j + 1) * fast + slow - 1) // slow - 1  # global emission idx
        e_prev = (j * fast + slow - 1) // slow - 1
        le = jnp.clip(e - start + halo_len, 0, buf.shape[1] - 1)
        lp = jnp.clip(e_prev - start + halo_len, -1, buf.shape[1] - 1)
        cs_e = cs[:, le]
        cs_p = jnp.where(lp[None, :] >= 0, cs[:, jnp.maximum(lp, 0)], 0.0)
        audio = (cs_e - cs_p) / jnp.float32(fast // slow)
    else:
        halo_len = T - 1
        m_max = (n_out * up) // down + 1
        halo = pull_left_halo(
            demod.T, halo_len, axis_name,
            left_edge=None if left_edge is None else left_edge.T).T
        buf = jnp.concatenate([halo, demod], axis=1)

        j0 = _cdiv_traced(start * up, down)
        count = _cdiv_traced((start + n_out) * up, down) - j0
        m = j0 + jnp.arange(m_max, dtype=jnp.int32)
        tt = m * down
        q = tt // up  # global input index of newest window sample
        p = tt % up
        t_idx = jnp.arange(T, dtype=jnp.int32)
        win = jnp.clip(q[:, None] - t_idx[None, :] - start + halo_len,
                       0, buf.shape[1] - 1)
        windows = buf[:, win]  # (st, m_max, T)
        coeffs = h_poly[p]  # (m_max, T)
        audio = jnp.einsum("smt,mt->sm", windows, coeffs)

    return audio, count[None].astype(jnp.int32)


def sharded_wbfm_apply(chain: ShardedWbfm, blocks: np.ndarray):
    """Place ``blocks`` (stations, bytes) on the mesh and run the chain.

    Returns ``(audio (stations, sp*m_max), counts (sp,))`` device arrays.
    """
    x = jax.device_put(blocks, chain.in_sharding)
    return chain(x)


def expected_m_max(config: WbfmConfig, n_loc_out: int) -> int:
    if config.filter_mode == "boxcar":
        return (n_loc_out * config.rate_resample) // config.rate_out + 1
    return (n_loc_out * config.resample_up) // config.resample_down + 1
