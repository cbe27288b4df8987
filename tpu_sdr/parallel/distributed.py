"""Multi-host (DCN) distributed runtime — SURVEY.md §5's missing backend.

The reference is a single-process driver; its only "interconnects" are a
USB bulk endpoint and TCP (/root/reference/src/device/mod.rs:141-143,
examples/rtl_tcp.rs:92-96).  At multi-host scale the same receive chain spans
hosts: this module wires ``jax.distributed.initialize`` (the JAX
multi-process runtime), builds the ``(hosts, devices)`` mesh, and
fans the feeder out so each host supplies only its own stations' bytes.

Layout policy: stations shard over the HOST axis (``dp``) and time over
each host's local devices (``sp``).  Consequences:

* the overlap-save halo exchanges of the sharded chains
  (parallel/wbfm_sharded, ~100 B/shard/block along ``sp``) stay inside a
  host, never crossing the network;
* no sample bytes ever cross hosts — each host's feeder thread pins its
  own stations' blocks to its own chips
  (``jax.make_array_from_process_local_data`` moves host-local numpy
  straight to host-local devices);
* the only DCN traffic is XLA's compilation/launch consensus and whatever
  the caller explicitly gathers (e.g. ``fetch_global`` for validation).

On CPU backends the cross-process collectives use the gloo transport —
that is how the 2-process integration test runs on one machine
(tests/test_multihost.py), mirroring how the reference's register protocol
is tested against a mock USB backend (SURVEY.md §4).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_initialized = False


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None,
                     cpu_collectives: str = "gloo") -> None:
    """Initialize the JAX multi-process runtime (idempotent).

    With no arguments, auto-detects managed environments (e.g. SLURM)
    or degenerates to a single-process runtime.  ``cpu_collectives``
    selects the CPU cross-process collective transport (gloo by default;
    GPU collectives go through NCCL).
    """
    global _initialized
    if _initialized:
        return
    try:  # a launcher may already have initialized the runtime — but probe
        # via the distributed client, NOT jax.process_count(), which would
        # itself initialize the XLA backend and forbid initialize() forever
        from jax._src import distributed as _jd

        if _jd.global_state.client is not None:
            _initialized = True
            return
    except Exception:
        pass
    if cpu_collectives:
        try:
            jax.config.update("jax_cpu_collectives_implementation",
                              cpu_collectives)
        except Exception:
            pass  # older JAX: single-implementation CPU client
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    _initialized = True


def make_host_mesh(axis_names: tuple[str, str] = ("dp", "sp")) -> Mesh:
    """Build the ``(hosts, local chips)`` mesh.

    Host axis first: devices are grouped by owning process, so the minor
    axis (``sp`` — the time/halo axis of the sharded chains) stays inside
    each host and the major axis (``dp`` — stations) crosses hosts, where
    the chains exchange nothing.
    """
    n_proc = jax.process_count()
    per_host = jax.local_device_count()
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    assert len(devs) == n_proc * per_host, (
        f"uneven device placement: {len(devs)} devices over {n_proc} hosts")
    arr = np.array(devs).reshape(n_proc, per_host)
    return Mesh(arr, axis_names)


def put_host_local_blocks(sharding: NamedSharding,
                          local_blocks: np.ndarray) -> jax.Array:
    """Feeder fan-out: each process contributes its own stations' blocks.

    ``local_blocks``: this host's (local_stations, bytes) array.  Every
    dimension it owns in full must match the global extent — with the
    ``make_host_mesh`` layout that is the time axis (this host's chips
    cover all of ``sp``), while stations concatenate across hosts in
    process order.  Returns the global sharded array; no sample bytes
    cross hosts.
    """
    mesh = sharding.mesh
    dp = mesh.shape[sharding.spec[0]] if sharding.spec[0] else 1
    n_proc = jax.process_count()
    assert dp % n_proc == 0 or n_proc % dp == 0, (
        f"dp={dp} incompatible with {n_proc} processes")
    global_shape = (local_blocks.shape[0] * n_proc, local_blocks.shape[1])
    return jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(local_blocks), global_shape)


def fetch_global(x: jax.Array) -> np.ndarray:
    """Gather a (possibly multi-host sharded) array to every host as numpy.

    Validation/audio-sink helper — production streaming never calls this on
    the hot path.
    """
    try:
        return np.asarray(x)  # fully addressable (single process)
    except RuntimeError:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def multihost_wbfm_apply(chain, local_blocks: np.ndarray):
    """Run a sharded WBFM chain (parallel/wbfm_sharded) fed with this
    host's station blocks only.

    ``local_blocks``: u8 (local_stations, bytes).
    """
    x = put_host_local_blocks(chain.in_sharding, local_blocks)
    return chain(x)
