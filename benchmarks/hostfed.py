"""Host-fed end-to-end WBFM throughput on one GPU: the system number.

``bench.py`` measures the block transform on a device-resident block; the
reference's pipeline is host-fed end to end
(/root/reference/examples/simple_fm.rs:55-132: USB thread -> channel ->
demod loop).  This harness measures the equivalent here:

    capture file (TMPDIR) -> native C++ ring/pump (stream/feeder.py)
    -> ``jax.device_put`` (H2D) -> ``wbfm.demodulate_block``, carry threaded
    -> audio folded into an on-device accumulator, ONE readback at the end

and, with the same plumbing minus the compute, the H2D transport ceiling.
The headline is the pipeline/ceiling ratio from adjacent trial pairs in one
process, leg order alternating between pairs (1.0 = compute fully hidden
behind the copy).
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np

N_FILE_BLOCKS = 8          # distinct blocks in the looped capture file
TARGET_BLOCK_MB = 16
WINDOW = 6                 # in-flight device blocks (double-buffer depth)


def _make_harness(block_mb: float = TARGET_BLOCK_MB):
    """Shared plumbing for both legs: returns (run, block_bytes, cleanup)
    where ``run(n_blocks, compute)`` executes one feeder-fed pipeline pass
    and returns wall seconds."""
    import jax
    import jax.numpy as jnp

    from tpu_sdr.models import wbfm
    from tpu_sdr.stream.feeder import BlockFeeder, FileSource

    config = wbfm.WbfmConfig(filter_mode="fir")
    params = wbfm.make_params(config)
    quantum = 2 * config.decim * config.resample_down
    block_bytes = int(block_mb * (1 << 20)) // quantum * quantum

    path = os.path.join(tempfile.gettempdir(),
                        f"tpusdr_hostfed_{os.getpid()}.bin")
    rng = np.random.default_rng(0)
    with open(path, "wb") as f:
        f.write(rng.integers(0, 256, N_FILE_BLOCKS * block_bytes,
                             dtype=np.uint8).tobytes())

    @jax.jit
    def step(buf, state, acc):
        audio, _count, s2 = wbfm.demodulate_block(buf, state, params, config)
        return s2, acc + jnp.sum(audio)

    @jax.jit
    def step_ceiling(buf, acc):
        # Touch one element so the block is consumed and freed exactly like
        # the compute leg's (matched in-flight footprint).
        return acc + buf[0].astype(jnp.float32)

    def run(n_blocks: int, compute: bool) -> float:
        feeder = BlockFeeder(FileSource(path, loop=True),
                             block_bytes=block_bytes,
                             queue_blocks=16).start()
        try:
            state, acc = wbfm.init_state(config), jnp.float32(0)
            inflight = []
            t0 = time.perf_counter()
            for nb, blk in enumerate(feeder.blocks(), start=1):
                dev = jax.device_put(blk)
                if compute:
                    state, acc = step(dev, state, acc)
                else:
                    acc = step_ceiling(dev, acc)
                inflight.append(acc)
                if len(inflight) > WINDOW:
                    inflight.pop(0).block_until_ready()
                if nb >= n_blocks:
                    break
            float(acc)
            return time.perf_counter() - t0
        finally:
            feeder.stop()

    def cleanup():
        try:
            os.unlink(path)
        except OSError:
            pass

    return run, block_bytes, cleanup


def measure_host_fed_ratio(trial_pairs: int = 8, n_blocks: int = 24) -> dict:
    """Adjacent-pair pipeline-vs-ceiling measurement.  Keys:

    * ``ratio``: median per-pair pipeline/ceiling throughput ratio,
    * ``ratio_iqr``: [q1, q3] across pairs,
    * ``ratio_trials``: every per-pair ratio,
    * ``host_fed_msps`` / ``h2d_ceiling_msps``: median complex Msamples/s
      per leg, ``block_bytes``.
    """
    from tpu_sdr.utils import runtime

    runtime.require_gpu()
    run, block_bytes, cleanup = _make_harness()
    try:
        run(4, True)   # compile + feeder spin-up
        run(4, False)
        pipe_ts, ceil_ts = [], []
        for i in range(trial_pairs):
            legs = (True, False) if i % 2 == 0 else (False, True)
            for compute in legs:
                (pipe_ts if compute else ceil_ts).append(run(n_blocks, compute))
        ratios = [tc / tp for tp, tc in zip(pipe_ts, ceil_ts)]
        msps = lambda t: n_blocks * block_bytes / 2 / t / 1e6  # noqa: E731
        q1, q3 = np.percentile(ratios, (25, 75))
        return {
            "ratio": round(float(np.median(ratios)), 4),
            "ratio_iqr": [round(float(q1), 4), round(float(q3), 4)],
            "ratio_trials": [round(r, 4) for r in ratios],
            "host_fed_msps": round(msps(float(np.median(pipe_ts))), 1),
            "h2d_ceiling_msps": round(msps(float(np.median(ceil_ts))), 1),
            "block_bytes": block_bytes,
            "card": runtime.card_info(),
        }
    finally:
        cleanup()
