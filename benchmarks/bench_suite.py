"""Extended benchmark suite — all BASELINE.json configs, on one GPU.

Prints one JSON line per benchmark, each naming the device and the card
(name, power limit).  Fails without a GPU.

Configs covered (BASELINE.json):
  #1 simple_fm single-station chain (fir + boxcar modes)
  #2 batched WBFM, 16 stations vmapped
  #3 polyphase channelizer (64ch) + per-channel demod
  #4 rtl_tcp streaming ingest (loopback server -> feeder -> device chain)
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np

# importable when run as `python benchmarks/bench_suite.py`
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run(fn, *args, iters=20):
    """Median seconds per call, each call ended by block_until_ready;
    the first call (compilation) is not timed."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def report(metric, value, unit, **extra):
    import jax

    from tpu_sdr.utils import runtime

    d = jax.devices()[0]
    line = {"metric": metric, "value": round(value, 2), "unit": unit,
            "device": {"platform": d.platform, "kind": d.device_kind,
                       "count": len(jax.devices())},
            "card": runtime.card_info(), **extra}
    print(json.dumps(line), flush=True)


def bench_single_chain():
    import jax
    from tpu_sdr.models import wbfm

    n_complex = 6 * 85 * 24576
    buf = jax.device_put(
        np.random.default_rng(0).integers(0, 256, 2 * n_complex, dtype=np.uint8))
    for mode in ("fir", "boxcar"):
        config = wbfm.WbfmConfig(filter_mode=mode)
        params = wbfm.make_params(config)
        state = wbfm.init_state(config)

        def step(b, s):
            a, c, s2 = wbfm.demodulate_block(b, s, params, config)
            return a, s2

        dt = _run(lambda: step(buf, state))
        report(f"wbfm_{mode}_chain", n_complex / dt / 1e6,
               "complex Msamples/s")


def bench_batched():
    import jax
    from tpu_sdr.models import wbfm, wbfm_batched

    stations = 16
    n_complex = 6 * 85 * 2048
    config = wbfm.WbfmConfig(filter_mode="fir")
    params = wbfm.make_params(config)
    states = wbfm_batched.init_batch_state(config, stations)
    bufs = jax.device_put(np.random.default_rng(0).integers(
        0, 256, (stations, 2 * n_complex), dtype=np.uint8))

    def step():
        a, c, s = wbfm_batched.demodulate_batch(bufs, states, params, config)
        return a

    dt = _run(step)
    report("wbfm_batched_16st", stations * n_complex / dt / 1e6,
           "complex Msamples/s (aggregate)")


def bench_channelizer():
    import jax
    import jax.numpy as jnp
    from tpu_sdr.ops import channelizer as CH

    K, T = 64, 8
    n = K * 32768  # ~2M complex samples
    G = jnp.asarray(CH.design_pfb(K, T))
    state = CH.pfb_init(G)
    re = jax.device_put(np.random.standard_normal(n).astype(np.float32))
    im = jax.device_put(np.random.standard_normal(n).astype(np.float32))
    fn = jax.jit(lambda r, i: CH.pfb_analyze(r, i, G, state)[:2])
    dt = _run(lambda: fn(re, im))
    report("pfb_channelize_64ch", n / dt / 1e6, "complex Msamples/s")


def bench_ingest():
    """rtl_tcp loopback: fake device -> server -> socket -> feeder ->
    device blocks.  Reports sustained ingest rate; real-time target is
    2.4 Msps u8 I/Q (4.8 MB/s)."""
    import jax
    from tpu_sdr import api
    from tpu_sdr.control import fake
    from tpu_sdr.stream.feeder import BlockFeeder, RtlTcpClientSource
    from tpu_sdr.stream.rtl_tcp_server import RtlTcpServer

    fake.clear_fake_devices()
    fake.register_fake_device()
    sdr = api.RtlSdr.open_with_index(0)
    sdr.set_sample_rate(2_400_000)
    sdr.set_center_freq(100_000_000)
    srv = RtlTcpServer(sdr, "127.0.0.1", 0, queue_limit=64)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    while srv.bound_port is None:
        time.sleep(0.01)

    src = RtlTcpClientSource("127.0.0.1", srv.bound_port)
    feeder = BlockFeeder(src, block_bytes=262144, queue_blocks=16).start()
    n_blocks, n_bytes = 0, 0
    t0 = time.perf_counter()
    for dev_block in feeder.device_blocks():
        n_blocks += 1
        n_bytes += dev_block.shape[0]
        if n_blocks >= 100:
            break
    dt = time.perf_counter() - t0
    feeder.stop()
    srv.stop()
    sdr.close()
    fake.clear_fake_devices()
    msps = n_bytes / 2 / dt / 1e6
    report("rtl_tcp_ingest", msps, "complex Msamples/s sustained",
           realtime_msps=2.4)


def bench_host_fed():
    """Host-fed SYSTEM throughput (file -> native ring -> device_put ->
    block transform -> on-device accumulator) against the transport
    ceiling the same plumbing reaches without compute."""
    from benchmarks.hostfed import measure_host_fed_ratio

    r = measure_host_fed_ratio()
    report("host_fed_chain", r["host_fed_msps"],
           "complex Msamples/s sustained",
           ratio=r["ratio"], ratio_iqr=r["ratio_iqr"],
           h2d_ceiling_msps=r["h2d_ceiling_msps"])


if __name__ == "__main__":
    from tpu_sdr.utils import runtime

    runtime.configure_compile_cache()
    runtime.require_gpu()
    bench_single_chain()
    bench_batched()
    bench_channelizer()
    bench_ingest()
    bench_host_fed()
