"""Pod-scale channelized receiver: PFB + per-channel demod over a mesh.

BASELINE.json config #5 ("1024-channel channelizer + demod sharded over
N hosts with boundary halo collectives"), built with collectives:

1. the wideband stream is **time-sharded** over ``sp``; each chip pulls a
   (branch_rows-1) frame halo from its left neighbor (``ppermute`` over
   NVLink on one host) and runs the local PFB — identical math to the serial op,
2. one ``all_to_all`` re-shards the (frames, channels) matrix from
   time-sharded to **channel-sharded** — the classic FFT/transpose pattern;
   after it every chip owns all frames of K/S channels,
3. per-channel quadrature FM demod runs embarrassingly parallel on the
   channel shard.

The collective cost per block is the halo (tiny) plus one all_to_all of the
channelized matrix (1/K of the input rate x K channels = input-sized, once).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_sdr.ops import channelizer as CH
from tpu_sdr.parallel.halo import pull_left_halo


@dataclass(frozen=True)
class ShardedChannelizer:
    mesh: Mesh
    num_channels: int
    fn: callable
    in_sharding: NamedSharding

    def __call__(self, re, im):
        """(re, im): (n,) wideband f32 -> demod (K, n/K) channel-major."""
        x_re = jax.device_put(re, self.in_sharding)
        x_im = jax.device_put(im, self.in_sharding)
        return self.fn(x_re, x_im)


def make_sharded_channelizer(mesh: Mesh, num_channels: int,
                             taps_per_branch: int = 8) -> ShardedChannelizer:
    """Build the jitted sharded channelize+demod pipeline over axis 'sp'."""
    K = num_channels
    G_np = CH.design_pfb(K, taps_per_branch)
    G = jnp.asarray(G_np)
    rows = G_np.shape[0]
    sp = mesh.shape["sp"]
    assert K % sp == 0, f"{K} channels not divisible by {sp} shards"

    def shard_fn(re_loc, im_loc):
        n_loc = re_loc.shape[0]
        assert n_loc % K == 0
        m_loc = n_loc // K

        # --- local PFB with left frame-halo -------------------------------
        halo_re = pull_left_halo(re_loc, (rows - 1) * K, "sp")
        halo_im = pull_left_halo(im_loc, (rows - 1) * K, "sp")
        state = CH.PfbState(halo_re.reshape(rows - 1, K), halo_im.reshape(rows - 1, K))
        yr, yi, _ = CH.pfb_analyze(re_loc, im_loc, G, state)  # (m_loc, K)

        # --- reshard: time-sharded -> channel-sharded ---------------------
        # all_to_all splits the channel axis S ways and concatenates the
        # received pieces along the frame axis, so each shard ends up with
        # all frames of its K/S channels.
        yr = lax.all_to_all(yr, "sp", split_axis=1, concat_axis=0, tiled=True)
        yi = lax.all_to_all(yi, "sp", split_axis=1, concat_axis=0, tiled=True)
        # (m_loc * sp, K // sp)

        # --- per-channel FM demod (channel-parallel) ----------------------
        c_re, c_im = yr.T, yi.T  # (K/S, m)
        b_re = jnp.concatenate([jnp.ones((c_re.shape[0], 1), jnp.float32),
                                c_re[:, :-1]], axis=1)
        b_im = jnp.concatenate([jnp.zeros((c_im.shape[0], 1), jnp.float32),
                                c_im[:, :-1]], axis=1)
        d_re = c_re * b_re + c_im * b_im
        d_im = c_im * b_re - c_re * b_im
        demod = jnp.arctan2(d_im, d_re) * jnp.float32(1 / np.pi)
        return demod  # (K/S, m) per shard -> (K, m) global over 'sp'

    fn = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P("sp"), P("sp")), out_specs=P("sp"),
    ))
    return ShardedChannelizer(
        mesh=mesh, num_channels=K, fn=fn,
        in_sharding=NamedSharding(mesh, P("sp")),
    )
