"""Test configuration.

The suite runs on the CPU backend (``JAX_PLATFORMS=cpu``).  Multi-device
sharding tests need N devices; they run their code in a subprocess with
a virtual N-device CPU backend (see ``cpu_mesh_env``).  Tests that need
a GPU are marked ``gpu`` and take the ``gpu_device`` fixture, which
skips them where there is none; run them on a GPU machine with
``python -m pytest -m gpu tests/``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; the backend is {jax.default_backend()}")
    return jax.devices()[0]


def cpu_mesh_env(n_devices: int = 8) -> dict:
    """Environment forcing a virtual n-device CPU backend, with the
    repository importable."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n_devices}"
    ).strip()
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO_ROOT, env.get("PYTHONPATH")) if p)
    return env


def run_in_cpu_mesh(code: str, n_devices: int = 8, timeout: int = 600) -> str:
    """Run a python snippet under the virtual CPU mesh; returns stdout."""
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env=cpu_mesh_env(n_devices),
        capture_output=True,
        text=True,
        timeout=timeout,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout
