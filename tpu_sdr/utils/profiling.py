"""Tracing and per-block throughput metrics.

The reference's only instrumentation is a per-block wall-clock average in
the demod thread plus a buffer-latency log line
(/root/reference/examples/simple_fm.rs:101-104,143-168).  This framework
generalizes that into: (a) :class:`BlockStats`, a running samples/s /
latency meter with the same running-average semantics, and (b)
:func:`trace`, a context manager around ``jax.profiler`` so any streaming
run can emit a TensorBoard-loadable device trace (the device-side equivalent
of the `Instant::now()` pair the reference uses).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class BlockStats:
    """Running per-block processing stats (ref simple_fm.rs:143-168).

    ``update(n_samples)`` wraps one block's processing; use as::

        with stats.block(n):
            ... process ...
        log.info(stats.summary())
    """

    blocks: int = 0
    samples: int = 0
    busy_s: float = 0.0
    dropped_blocks: int = 0
    _t0: float = field(default=0.0, repr=False)
    _wall0: float = field(default_factory=time.monotonic, repr=False)

    @contextlib.contextmanager
    def block(self, n_samples: int):
        t = time.monotonic()
        yield
        self.busy_s += time.monotonic() - t
        self.blocks += 1
        self.samples += n_samples

    def drop(self, blocks: int = 1) -> None:
        self.dropped_blocks += blocks

    @property
    def avg_block_ms(self) -> float:
        return 1000.0 * self.busy_s / self.blocks if self.blocks else 0.0

    @property
    def busy_samples_per_sec(self) -> float:
        """Throughput while actually processing (the compute bound)."""
        return self.samples / self.busy_s if self.busy_s > 0 else 0.0

    @property
    def wall_samples_per_sec(self) -> float:
        """End-to-end throughput including feed/idle time (the real-time
        margin the reference's ~128 ms bound expresses)."""
        wall = time.monotonic() - self._wall0
        return self.samples / wall if wall > 0 else 0.0

    def summary(self) -> str:
        return (
            f"{self.blocks} blocks, avg {self.avg_block_ms:.2f} ms/block, "
            f"{self.busy_samples_per_sec / 1e6:.2f} Msps busy "
            f"({self.wall_samples_per_sec / 1e6:.2f} Msps wall), "
            f"{self.dropped_blocks} dropped"
        )


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Device + host trace via ``jax.profiler`` (no-op when ``log_dir`` is
    falsy).  View with TensorBoard's profile plugin or Perfetto."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the device trace (``jax.profiler.TraceAnnotation``)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield
