"""chip_smoke.py off the GPU: it refuses to run, and its golden phase
holds on the CPU at the goldens' own size."""

import importlib.util
import os
import subprocess
import sys

from conftest import REPO_ROOT

SCRIPT = os.path.join(REPO_ROOT, "chip_smoke.py")


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, SCRIPT], env=env, cwd=REPO_ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_golden_phase_on_cpu(tmp_path):
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.phase_goldens(str(tmp_path))
    assert (tmp_path / "fa.sketch.index").exists()
