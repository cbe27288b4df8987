"""Test configuration: two tiers.

Default tier — force CPU JAX with a virtual 8-device mesh.  The reference
had no multi-device tests; here sharded paths are validated on
``xla_force_host_platform_device_count=8`` CPU devices (SURVEY.md §4).  x64
is enabled so the exact-atan2 conformance path matches the reference's f64
math.  Tests marked ``gpu`` skip in this tier.

GPU tier — ``TPU_SDR_TEST_PLATFORM=gpu python -m pytest tests/ -m gpu`` on
a machine with an NVIDIA GPU keeps JAX's default backend and runs the
``@pytest.mark.gpu`` tests, which call the same checks ``chip_smoke.py``
runs.  Whether a card is present is decided inside the ``_device_tier``
fixture, never at import or collection time: every xdist worker must
collect the same tests.
"""

import os

import pytest

from tpu_sdr.utils import runtime

GPU_TIER = os.environ.get("TPU_SDR_TEST_PLATFORM", "").lower() == "gpu"

if GPU_TIER:
    runtime.keep_cpu_backend()
else:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not GPU_TIER:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

runtime.configure_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; runs in the GPU tier "
        "(TPU_SDR_TEST_PLATFORM=gpu python -m pytest tests/ -m gpu)")
    config.addinivalue_line(
        "markers", "slow: multi-process / long-running integration test")


@pytest.fixture(autouse=True)
def _device_tier(request):
    """Skip ``gpu`` tests without a card, and CPU-tier tests in the GPU
    tier (they assume the virtual CPU mesh and x64)."""
    wants_gpu = request.node.get_closest_marker("gpu") is not None
    if wants_gpu and not GPU_TIER:
        pytest.skip("needs an NVIDIA GPU: run with TPU_SDR_TEST_PLATFORM=gpu")
    if GPU_TIER and not wants_gpu:
        pytest.skip("GPU tier runs only @pytest.mark.gpu tests")
    if wants_gpu and jax.devices()[0].platform != "gpu":
        pytest.skip(f"no GPU: JAX's backend is {jax.devices()[0].platform}")
