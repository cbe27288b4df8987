"""Smoke run of the receive chain on an NVIDIA GPU, at full width.

    python chip_smoke.py             # one card: phases 0-7
    python chip_smoke.py --cards 4   # four cards: the sharded chains only

Phase 0 reports the device, the card's name and power limit, the JAX
version and flags, the native runtime, the compile cache and what each
matmul precision lowers to.  Phases 1-7 (``tpu_sdr/smoke.py``) each drive a
user path through its normal entry points on the card and compare it with
the repository's plain reference; every comparison is printed with its
tolerance and the matmul precision in force.  With ``--cards N`` only the
DP x SP sharded chain and the sharded channelizer run, on 1x4 and 2x2
meshes, against their serial versions.

Exits non-zero, printing no result, when JAX finds no GPU or any phase
fails.  On success the last line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def _print_phase(label, res) -> None:
    for c in res.checks:
        print(f"phase {label} {res.name} | {c} | precision {res.precision}",
              flush=True)
    for line in res.info:
        print(f"phase {label} {res.name} | info: {line}", flush=True)
    print(f"phase {label} {res.name} | {'PASS' if res.ok else 'FAIL'}",
          flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, default=1,
                   help="run the sharded chains on this many GPUs (4) "
                        "instead of the one-card phases")
    args = p.parse_args(argv)

    from tpu_sdr.utils import runtime

    runtime.keep_cpu_backend()
    import jax

    from tpu_sdr import native, smoke

    try:
        devices = runtime.require_gpu(args.cards)
    except runtime.NoGpuError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    card = runtime.card_info()
    print(f"phase 0 device | {devices[0].device_kind} x{len(devices)} "
          f"({devices[0].platform})", flush=True)
    print(f"phase 0 device | nvidia-smi: {card}", flush=True)
    print(f"phase 0 device | jax {jax.__version__}, "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    print(f"phase 0 device | native C++ runtime loaded: "
          f"{native.available()}", flush=True)
    print(f"phase 0 device | compile cache: "
          f"{runtime.configure_compile_cache()}", flush=True)

    if args.cards > 1:
        phases = [("sharded", lambda: smoke.sharded(devices[:args.cards]))]
    else:
        cpu = jax.devices("cpu")[0]
        phases = [("precision", lambda: smoke.precision_probe(devices[0]))]
        phases += [(name, lambda f=f: f(devices[0], cpu))
                   for name, f in smoke.PHASES.items()]

    failed = []
    for index, (name, run) in enumerate(phases):
        if args.cards > 1:
            index = name
        t0 = time.perf_counter()
        try:
            res = run()
        except Exception:  # report the phase as failed, run the others
            traceback.print_exc()
            print(f"phase {index} {name} | FAIL (raised)", flush=True)
            failed.append(name)
            continue
        _print_phase(index, res)
        print(f"phase {index} {name} | wall {time.perf_counter() - t0:.1f} s",
              flush=True)
        if not res.ok:
            failed.append(name)

    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(f"card: {card}", flush=True)
    print(result_line(devices[:args.cards]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
