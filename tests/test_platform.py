"""Platform setup (backend check, compile-cache rule), device-derived
memory budgets, and chip_smoke.py's refusal to run without a GPU."""

import json
import os
import subprocess
import sys

import jax
import pytest

from voronoirt_tpu import memory
from voronoirt_tpu.platform import compile_cache_dir, setup

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_PRINT_CACHE = ("from voronoirt_tpu.platform import setup; setup(); "
                "import jax; print(jax.config.jax_compilation_cache_dir)")


def _run(code, **env):
    base = {k: v for k, v in os.environ.items()
            if k != "JAX_COMPILATION_CACHE_DIR"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(base, JAX_PLATFORMS="cpu", **env))
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.strip().splitlines()[-1]


def test_cache_dir_rule():
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) == "/x/y"
    assert compile_cache_dir({}) == os.path.join(REPO, ".cache", "jax")


def test_setup_uses_checkout_cache_without_env():
    assert _run(_PRINT_CACHE) == os.path.join(REPO, ".cache", "jax")


def test_setup_keeps_env_cache_dir(tmp_path):
    d = str(tmp_path / "jaxcache")
    assert _run(_PRINT_CACHE, JAX_COMPILATION_CACHE_DIR=d) == d


def test_setup_raises_on_platform_mismatch():
    jax.devices()                       # the CPU backend is up
    before = jax.config.jax_platforms
    with pytest.raises(RuntimeError, match="active backend is 'cpu'"):
        setup(platform="gpu")
    assert jax.config.jax_platforms == before
    with pytest.raises(ValueError):
        setup(platform="metal")


@pytest.mark.parametrize("n_lanes,itemsize", [(91, 4), (16, 8)])
def test_budgets_scale_with_bytes_limit(n_lanes, itemsize):
    small = memory.budgets(n_lanes, itemsize, limit=16 << 30)
    big = memory.budgets(n_lanes, itemsize, limit=80 << 30)
    for key in ("group_stack_bytes", "inflight_bytes", "hoist_bytes",
                "lean_chunk_rows"):
        assert big[key] == pytest.approx(5 * small[key], rel=1e-6), key
    assert big["lean_chunk_rows"] * 3 * n_lanes * itemsize <= (80 << 30) // 32
    assert memory.bytes_limit() > 0     # host memory on the CPU backend


def test_chip_smoke_refuses_cpu():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    if lines:
        try:
            last = json.loads(lines[-1])
        except ValueError:
            last = {}
        assert last.get("ok") is not True
