"""Process-level behaviour: the compile-cache location the package picks, and
the on-card smoke script refusing to run without a GPU."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


@pytest.mark.parametrize("cache_env", ["set", "unset"])
def test_compile_cache_dir(tmp_path, cache_env):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX; otherwise the
    cache is the checkout's fixed .jax_cache/."""
    extra = {}
    want = os.path.join(REPO, ".jax_cache")
    if cache_env == "set":
        want = str(tmp_path / "cache")
        extra["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, linearsfm_tpu; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=_cpu_env(**extra), capture_output=True, text=True,
        timeout=120, check=True).stdout
    assert out.strip().splitlines()[-1] == want


def test_chip_smoke_refuses_cpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
