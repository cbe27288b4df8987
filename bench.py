"""Benchmark: WBFM block-transform throughput on one GPU.

Runs ``wbfm.demodulate_block`` (FIR mode) on one device-resident block of
``N_COMPLEX`` complex samples, with the decimator in split-bf16 and in
true f32, the carry threaded from each iteration into the next like a
stream.  Compilation is set-up time and is reported apart; each timed
iteration ends in ``block_until_ready``.

Prints ONE JSON line naming the device, the card and its power limit, and
per path the median ms per block and complex Msamples/s.  Fails (non-zero
exit, no JSON) without a GPU.

    python bench.py [--iters N]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

N_COMPLEX = 6 * 85 * 24576  # ~12.5M complex samples (~25 MB u8) per block


def bench_path(host_block, precision: str, iters: int) -> dict:
    import jax

    from tpu_sdr.models import wbfm

    config = wbfm.WbfmConfig(filter_mode="fir", mxu_precision=precision)
    params = wbfm.make_params(config)
    state = wbfm.init_state(config)
    buf = jax.device_put(host_block)
    t0 = time.perf_counter()
    step = wbfm.demodulate_block.lower(buf, state, params, config).compile()
    compile_s = time.perf_counter() - t0
    state = jax.block_until_ready(step(buf, state, params))[2]  # warm-up
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _audio, _count, state = jax.block_until_ready(
            step(buf, state, params))
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    return {"compile_s": round(compile_s, 3),
            "ms_per_block": round(1e3 * med, 4),
            "ms_per_block_iqr": [round(1e3 * float(q), 4)
                                 for q in np.percentile(times, (25, 75))],
            "msps": round(N_COMPLEX / med / 1e6, 1)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    from tpu_sdr.utils import runtime

    runtime.configure_compile_cache()
    devices = runtime.require_gpu()
    host_block = np.random.default_rng(0).integers(
        0, 256, size=2 * N_COMPLEX, dtype=np.uint8)
    paths = {p: bench_path(host_block, p, args.iters)
             for p in ("split_bf16", "f32")}
    print(json.dumps({
        "metric": "wbfm_block_throughput",
        "unit": "complex Msamples/s",
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
        "card": runtime.card_info(),
        "n_complex": N_COMPLEX,
        "paths": paths,
    }), flush=True)


if __name__ == "__main__":
    main()
