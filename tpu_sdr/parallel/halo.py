"""Halo exchange primitives for time-sharded streaming DSP.

The streaming carries of the serial chain (FIR history, discriminator
previous sample — ref simple_fm.rs:232-239) become *halo exchanges* when
the time axis is sharded: each shard needs the trailing samples of its left
neighbor (overlap-save).  Implemented with ``lax.ppermute`` inside
``shard_map`` — a pure neighbor shift, the cheapest possible collective
(SURVEY.md §5), which XLA hands to NCCL on GPUs; no kernel is needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def pull_left_halo(x: jax.Array, halo: int, axis_name: str,
                   left_edge: jax.Array | None = None) -> jax.Array:
    """Return the last ``halo`` elements of the LEFT neighbor's shard.

    The leftmost shard receives ``left_edge`` (the global streaming carry)
    or zeros.  Non-circular: uses a right-shift permutation, so shard 0 gets
    no peer data.
    """
    n_shards = lax.axis_size(axis_name)
    tail = x[x.shape[0] - halo:]
    if n_shards == 1:
        received = jnp.zeros_like(tail)
    else:
        perm = [(i, i + 1) for i in range(n_shards - 1)]
        received = lax.ppermute(tail, axis_name, perm)
    if left_edge is not None:
        idx = lax.axis_index(axis_name)
        received = jnp.where(idx == 0, left_edge, received)
    return received


def push_right_edge(x_last: jax.Array, axis_name: str) -> jax.Array:
    """Give every shard its left neighbor's final element(s) — used to seed
    per-shard recurrences (e.g. the discriminator's previous sample)."""
    return pull_left_halo(x_last, x_last.shape[0], axis_name)
