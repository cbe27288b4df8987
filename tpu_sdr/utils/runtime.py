"""Process set-up shared by ``chip_smoke.py``, the benchmarks and the tests:
where JAX's persistent compile cache lives, and which accelerator runs.

Compile cache: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing here overrides it; otherwise the cache sits at the
fixed ``<repo>/.jax_cache`` (the path is part of the cache key, so a
directory that moved would never hit).
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(environ=None) -> str:
    """The directory the persistent compile cache uses."""
    environ = os.environ if environ is None else environ
    return environ.get(CACHE_ENV) or str(DEFAULT_CACHE_DIR)


def configure_compile_cache() -> str:
    """Point JAX at :func:`compile_cache_dir` (a no-op when the environment
    already names one) and return the directory in use."""
    import jax

    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return compile_cache_dir()


def keep_cpu_backend() -> None:
    """CPU references run in the same process as the card: keep JAX's CPU
    backend alive when ``JAX_PLATFORMS`` names only accelerators.  Call
    before JAX starts a backend."""
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
        if "jax" in sys.modules:  # JAX read the variable when imported
            sys.modules["jax"].config.update("jax_platforms", plats + ",cpu")


class NoGpuError(RuntimeError):
    """JAX's default backend is not an NVIDIA GPU."""


def require_gpu(count: int = 1) -> list:
    """JAX's devices, or :class:`NoGpuError` unless they are at least
    ``count`` GPUs.  A measurement never falls back to the CPU."""
    import jax

    devices = jax.devices()
    d = devices[0]
    if d.platform != "gpu":
        raise NoGpuError(f"needs an NVIDIA GPU; JAX found {d.platform} "
                         f"({d.device_kind}) x{len(devices)}")
    if len(devices) < count:
        raise NoGpuError(f"needs {count} GPUs; JAX found {len(devices)}")
    return devices


def card_info() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one line
    each: the card name and power limit every device number is quoted with."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or f"nvidia-smi rc={out.returncode}: " + (
        out.stderr.strip())
