"""Engine-level sharded distance: full alldist text on an 8-dev CPU mesh."""

import os

from conftest import run_in_cpu_mesh

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def test_alldist_on_cpu_mesh_matches_golden(tmp_path):
    out = str(tmp_path / "mesh.alldist")
    run_in_cpu_mesh(
        f"""
import sys
import jax
assert len(jax.devices()) == 8
from rabbitkssd.formats import read_sketches
from rabbitkssd.engine.dist_engine import run_alldist
sk = read_sketches({os.path.join(GOLDEN, 'fa_k8s4l1.sketch')!r})
run_alldist(sk, {out!r}, max_dist=1.0, containment=False)
print('MESH ALLDIST DONE')
"""
    )
    with open(out) as f:
        got = f.readlines()
    with open(os.path.join(GOLDEN, "fa_k8s4l1.alldist")) as f:
        want = f.readlines()
    assert got[0] == want[0]
    assert sorted(got[1:]) == sorted(want[1:])
