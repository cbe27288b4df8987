"""Scaling-efficiency benchmark: sharded WBFM throughput vs device count.

Measures the SP (time-sharded, halo-exchange) WBFM chain on meshes of
1, 2, 4, ... devices with CONSTANT per-device work (weak scaling), and
reports efficiency(n) = throughput(n) / (n * throughput(1)) — the
BASELINE.json north-star metric (target >= 85% at n >= 2).

Runs on the GPUs of one host (1, 2, 4 cards) and fails without a GPU; the
JSON names the device and each card's name and power limit.

Timing: iteration loop inside one jitted ``lax.scan``; the input is XORed
with a run-time-opaque function of the carry so no iteration can be
hoisted or dead-code-eliminated; two run lengths are differenced to cancel
dispatch+readback latency.

Usage: python -m benchmarks.bench_scaling
"""

from __future__ import annotations

import json
import time
from functools import partial

import numpy as np

N_COMPLEX_PER_SHARD = 6 * 85 * 4096  # ~2.1M complex samples per device
N_SHORT, N_LONG = 4, 16
MAX_ESCALATIONS = 3


def _diff_time(run) -> tuple[float, str]:
    n_s, n_l = N_SHORT, N_LONG
    run(n_s)
    t_l = run(n_l)
    for _ in range(MAX_ESCALATIONS):
        t_s = min(run(n_s) for _ in range(3))
        t_l = min(run(n_l) for _ in range(3))
        d = (t_l - t_s) / (n_l - n_s)
        if d > 0 and (t_l - t_s) >= t_s:
            return d, "differenced"
        n_s, n_l = n_l, n_l * 4
    return t_l / n_l, "upper_bound"


def bench_sp(sp: int) -> tuple[float, str]:
    """Msamples/s through the sp-way sharded chain (1 station)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from tpu_sdr.models.wbfm import WbfmConfig
    from tpu_sdr.parallel.mesh import make_mesh
    from tpu_sdr.parallel.wbfm_sharded import make_sharded_wbfm

    mesh = make_mesh(dp=1, sp=sp)
    config = WbfmConfig(filter_mode="fir")
    chain = make_sharded_wbfm(mesh, config)
    n_complex = N_COMPLEX_PER_SHARD * sp
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 256, size=(1, 2 * n_complex), dtype=np.uint8)
    x = jax.device_put(blocks, chain.in_sharding)

    @partial(jax.jit, static_argnames=("n",))
    def run_n(x, n):
        def step(acc, _):
            # runtime-opaque zero: keeps each iteration's input dependent
            # on the previous one (no hoisting, no DCE) without changing it
            opaque = (jnp.abs(acc) > jnp.float32(1e30)).astype(jnp.uint8)
            audio, _counts = chain.fn(jnp.bitwise_xor(x, opaque))
            return acc + jnp.sum(audio), ()

        acc, _ = lax.scan(step, jnp.float32(0), None, length=n)
        return acc

    def run(n: int) -> float:
        t0 = time.perf_counter()
        float(run_n(x, n))
        return time.perf_counter() - t0

    dt, flag = _diff_time(run)
    return n_complex / dt / 1e6, flag


def main() -> None:
    import argparse

    from tpu_sdr.utils import runtime

    runtime.configure_compile_cache()

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write the JSON record to FILE")
    args = ap.parse_args()

    devices = runtime.require_gpu()
    n_dev = len(devices)
    sps = [n for n in (1, 2, 4, 8, 16) if n <= n_dev]
    msps = {}
    flags = {}
    for sp in sps:
        msps[sp], flags[sp] = bench_sp(sp)
    base = msps[1]
    eff = {n: round(msps[n] / (n * base), 4) for n in sps}
    worst_multi = min((eff[n] for n in sps if n > 1), default=None)
    record = {
        "metric": "sp_weak_scaling_efficiency",
        "value": worst_multi if worst_multi is not None else 1.0,
        "unit": "fraction (worst n>1; target >=0.85)",
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": n_dev},
        "card": runtime.card_info(),
        "msps_per_mesh": {str(n): round(v, 1) for n, v in msps.items()},
        "efficiency": {str(n): eff[n] for n in sps},
        "timing": {str(n): flags[n] for n in sps},
    }
    line = json.dumps(record)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
