"""The GPU entry points refuse to run without a GPU, the compile cache goes
where it should, and the product form follows the platform. The GPU checks
themselves are `chip_smoke.py`'s phases; `test_chip_smoke_on_gpu` runs them
where a card is present."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from torus_fhe_tpu.ops import poly
from torus_fhe_tpu.utils import device

REPO = device.REPO_ROOT


def _run(args, cwd=REPO, timeout=300, **env):
    """Run a script in a child whose JAX sees only the CPU."""
    child_env = {**os.environ, "JAX_PLATFORMS": "cpu", **env}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=child_env,
                          capture_output=True, text=True, timeout=timeout)


def test_require_gpu_refuses_cpu():
    import chip_smoke

    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu()


def test_chip_smoke_refuses_cpu_process():
    res = _run(["chip_smoke.py"])
    assert res.returncode != 0
    assert "needs a GPU" in res.stderr
    assert '"ok"' not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run(["chip_smoke.py"], cwd=tmp_path, PYTHONPATH="")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_bench_refuses_cpu_process():
    res = _run(["bench.py", "8"])
    assert res.returncode != 0
    assert "needs a GPU" in res.stderr


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR is used as it is when set; otherwise the
    cache lives at <repo>/.cache/jax."""
    before = jax.config.jax_compilation_cache_dir
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = device.configure_compile_cache()
        if env_dir:
            assert path == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            assert path == os.path.join(REPO, ".cache", "jax")
            assert jax.config.jax_compilation_cache_dir == path
            assert os.path.isdir(path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_product_form_follows_platform(monkeypatch):
    """Integer convolutions elsewhere, the circulant matmul on GPUs (XLA:GPU
    refuses the convolution), and an explicit choice wins over both."""
    assert poly.get_backend() is None
    assert poly.resolve_backend() == "conv"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert poly.resolve_backend() == "matmul"
    poly.set_backend("conv")
    try:
        assert poly.resolve_backend() == "conv"
    finally:
        poly.set_backend(None)


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_card):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stdout + res.stderr
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
