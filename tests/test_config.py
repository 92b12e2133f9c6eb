"""Runtime configuration (ops/_config.py): where the persistent
compilation cache lives."""

import os
import subprocess
import sys

import pytest

from conftest import REPO_ROOT


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR when set, else the checkout's fixed,
    git-ignored .jax_cache/ (whatever the working directory)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO_ROOT)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO_ROOT, ".jax_cache")
    if from_env:
        want = str(tmp_path / "cc")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    else:
        with open(os.path.join(REPO_ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax, rabbitkssd.ops._config;"
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == want
