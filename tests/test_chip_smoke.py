"""chip_smoke.py and its phases (tpu_sdr/smoke.py) on the CPU: every phase
at tiny size against its reference, the four-card sharded phase on virtual
CPU devices, the device gate, and the result-line contract."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

import chip_smoke
from tpu_sdr import smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", list(smoke.PHASES))
def test_phase_tiny_on_cpu(name):
    cpu = jax.devices("cpu")[0]
    res = smoke.PHASES[name](cpu, cpu, smoke.TINY)
    assert res.checks, name
    assert res.ok, "\n".join(str(c) for c in res.checks)
    assert "jax_default_matmul_precision=" in res.precision


def test_precision_probe_on_cpu():
    res = smoke.precision_probe(jax.devices("cpu")[0], n=128)
    assert res.ok and len(res.info) == 3
    assert all("f32-class" in line for line in res.info)


@pytest.mark.parametrize("mesh", smoke.MESHES)
def test_sharded_phase_on_four_virtual_devices(mesh):
    res = smoke.sharded(jax.devices("cpu")[:4], smoke.TINY, meshes=(mesh,))
    assert len(res.checks) == 3
    assert res.ok, "\n".join(str(c) for c in res.checks)


@pytest.mark.parametrize("argv", [[], ["--cards", "4"]])
def test_no_gpu_exits_nonzero_without_result(argv, capsys):
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_exits_nonzero_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_result_line_contract():
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
            ] * 4
    line = chip_smoke.result_line(devs)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 4}}')


@pytest.mark.parametrize("value,op,limit,ok", [
    (61.0, ">=", 60.0, True), (60.0, ">", 60.0, False),
    (float("inf"), ">=", 60.0, True), (2, "<=", 1, False), (0, "==", 0, True),
])
def test_check_semantics(value, op, limit, ok):
    c = smoke.Check("x", value, op, limit)
    assert c.ok is ok
    assert ("FAIL" in str(c)) is (not ok)


def test_err_db():
    assert smoke.err_db([1.0, 2.0], [1.0, 2.0]) == float("inf")
    assert abs(smoke.err_db([1.0, 0.0], [1.1, 0.0]) - 20.0) < 1e-9


def test_phase_failure_makes_the_run_fail(monkeypatch, capsys):
    """A failing phase is reported and turns the exit code, with no
    result line — the phase loop never swallows a failure."""
    cpu = jax.devices("cpu")
    from tpu_sdr.utils import runtime

    monkeypatch.setattr(runtime, "require_gpu", lambda count=1: cpu)
    monkeypatch.setattr(runtime, "card_info", lambda: "test card, 1 W")

    def boom(device, ref_device, sizes=smoke.TINY):
        raise RuntimeError("phase broke")

    def bad(device, ref_device, sizes=smoke.TINY):
        return smoke.PhaseResult("bad", [smoke.Check("x", 1, "==", 0)], "p")

    monkeypatch.setattr(smoke, "PHASES", {"boom": boom, "bad": bad})
    monkeypatch.setattr(smoke, "precision_probe",
                        lambda d: smoke.PhaseResult(
                            "precision", [smoke.Check("y", 0, "==", 0)], "p"))
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr().out
    assert "boom | FAIL (raised)" in out and "bad | FAIL" in out
    assert '"ok"' not in out
