"""Process set-up helpers: compile-cache placement and the GPU gate."""

import os
import sys
from types import SimpleNamespace

import jax
import pytest

from tpu_sdr.utils import runtime


def test_cache_dir_honours_the_environment():
    env = {runtime.CACHE_ENV: "/somewhere/cache"}
    assert runtime.compile_cache_dir(env) == "/somewhere/cache"


def test_cache_dir_defaults_to_the_repo():
    assert runtime.compile_cache_dir({}) == str(runtime.DEFAULT_CACHE_DIR)
    assert runtime.DEFAULT_CACHE_DIR == runtime.REPO_ROOT / ".jax_cache"
    assert (runtime.REPO_ROOT / "chip_smoke.py").exists()


def test_configure_sets_nothing_when_the_environment_names_a_dir(
        monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path))
    assert runtime.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_configure_uses_the_repo_dir_when_unset(monkeypatch):
    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    assert runtime.configure_compile_cache() == str(runtime.DEFAULT_CACHE_DIR)
    assert jax.config.jax_compilation_cache_dir == str(
        runtime.DEFAULT_CACHE_DIR)


@pytest.mark.parametrize("count", [1, 4])
def test_require_gpu_refuses_the_cpu(count):
    with pytest.raises(runtime.NoGpuError, match="needs"):
        runtime.require_gpu(count)


def test_card_info_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert "nvidia-smi" in runtime.card_info()


@pytest.mark.parametrize("before,after", [
    ("cuda", "cuda,cpu"), ("cpu", "cpu"), ("cuda,cpu", "cuda,cpu"),
    (None, None),
])
def test_keep_cpu_backend(monkeypatch, before, after):
    updates = []
    fake_jax = SimpleNamespace(config=SimpleNamespace(
        update=lambda k, v: updates.append((k, v))))
    monkeypatch.setitem(sys.modules, "jax", fake_jax)
    if before is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", before)
    runtime.keep_cpu_backend()
    assert os.environ.get("JAX_PLATFORMS") == after
    assert updates == ([("jax_platforms", after)] if after != before else [])
