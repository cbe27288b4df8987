"""The GPU tier: the same checks chip_smoke.py runs, at full width, on the
card.  Run with ``TPU_SDR_TEST_PLATFORM=gpu python -m pytest tests/ -m gpu``
on a machine with an NVIDIA GPU; skipped elsewhere (see conftest.py)."""

import jax
import pytest

from tpu_sdr import smoke

pytestmark = pytest.mark.gpu


def _fail_msg(res) -> str:
    return "\n".join(str(c) for c in res.checks)


def test_precision_probe_gpu():
    res = smoke.precision_probe(jax.devices()[0])
    assert res.ok, _fail_msg(res)


@pytest.mark.parametrize("name", list(smoke.PHASES))
def test_phase_gpu(name):
    res = smoke.PHASES[name](jax.devices()[0], jax.devices("cpu")[0])
    assert res.ok, _fail_msg(res)


def test_sharded_gpu():
    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip(f"needs 4 GPUs, have {len(devices)}")
    res = smoke.sharded(devices[:4])
    assert res.ok, _fail_msg(res)
