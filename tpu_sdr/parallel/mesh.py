"""Mesh construction helpers.

The distributed runtime the reference never had (SURVEY.md §2): device
meshes with named axes — ``dp`` (stations / batch), ``sp`` (time-axis
sequence parallelism).  Collectives run inside ``shard_map`` (NCCL over
NVLink between the GPUs of one host; every card reaches every other at the
same rate, so the mesh follows the algorithm alone); across hosts
``jax.distributed.initialize`` extends the same mesh.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(dp: int = 1, sp: int | None = None, devices=None) -> Mesh:
    """Build a ``(dp, sp)`` mesh.  ``sp`` defaults to all remaining devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if sp is None:
        assert n % dp == 0, f"{n} devices not divisible by dp={dp}"
        sp = n // dp
    assert dp * sp <= n, f"mesh {dp}x{sp} needs {dp * sp} devices, have {n}"
    arr = np.array(devices[: dp * sp]).reshape(dp, sp)
    return Mesh(arr, ("dp", "sp"))


def time_sharding(mesh: Mesh) -> NamedSharding:
    """Shard (stations, time) arrays: stations over dp, time over sp."""
    return NamedSharding(mesh, P("dp", "sp"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
