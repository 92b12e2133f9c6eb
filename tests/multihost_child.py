"""Child program for the 2-process jax.distributed test (CPU backend).

Launched twice by tests/test_multihost.py with JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID / KSSD_CPU_DEVICES set — the same
environment contract the CLI's multi-host entry uses (cli.py main ->
parallel/multihost.py init_multihost).  Each process drives 4 virtual
CPU devices; the global mesh spans 8.

Everything here must be deterministic and identical across processes:
results are printed as digests that the parent compares against its own
single-process computation.
"""

import hashlib
import sys

import numpy as np

from rabbitkssd.parallel.multihost import global_mesh, init_multihost

init_multihost()

import jax  # noqa: E402  (backend configured by init_multihost)

assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, jax.devices()
assert jax.local_device_count() == 4

mesh = global_mesh()
assert mesh.devices.shape == (2, 4), mesh.devices.shape
# the distance psum rides the vp axis: every vp row must be the chips of
# ONE process (ICI, not DCN)
for row in mesh.devices:
    procs = {d.process_index for d in row}
    assert len(procs) == 1, f"vp row spans processes {procs}"

# the production default (engine _counts / MeshSketcher) must get the
# SAME host-local layout: make_mesh delegates to global_mesh under
# jax.distributed instead of factorizing locality-blind
from rabbitkssd.parallel.sharded import make_mesh  # noqa: E402

auto = make_mesh()
assert auto.devices.shape == mesh.devices.shape, auto.devices.shape
for row in auto.devices:
    procs = {d.process_index for d in row}
    assert len(procs) == 1, f"auto mesh vp row spans processes {procs}"

# --- sharded distance counts vs numpy oracle -----------------------------
from rabbitkssd.parallel.sharded import sharded_common_counts  # noqa: E402

rng = np.random.default_rng(7)
hashes0 = [np.unique(rng.integers(0, 5000, size=n).astype(np.uint32))
           for n in (400, 90, 800, 250, 640)]
hashes1 = [np.unique(rng.integers(0, 5000, size=n).astype(np.uint32))
           for n in (300, 512, 77)]

got_rq = sharded_common_counts(hashes0, hashes1, mesh)
oracle_rq = np.array(
    [[len(np.intersect1d(a, b)) for b in hashes1] for a in hashes0],
    np.int32,
)
np.testing.assert_array_equal(got_rq, oracle_rq)

got_all = sharded_common_counts(hashes0, None, mesh)
oracle_all = np.array(
    [[len(np.intersect1d(a, b)) for b in hashes0] for a in hashes0],
    np.int32,
)
np.testing.assert_array_equal(got_all, oracle_all)
print("COUNTS-OK", flush=True)

# --- sharded sketch window ------------------------------------------------
from rabbitkssd.engine.sketcher import ShardedSketcher  # noqa: E402
from rabbitkssd.params import KssdParams  # noqa: E402
from rabbitkssd.shuffle import generate_shuffle  # noqa: E402

shuf = generate_shuffle(8, 6, 3)
params = KssdParams(half_k=8, half_subk=6, drlevel=3)
g_rng = np.random.default_rng(21)
genomes = [g_rng.integers(0, 4, size=n).astype(np.int8)
           for n in (20000, 3000, 45000, 12000)]
genomes[1][100:160] = -1

sk = ShardedSketcher(params, shuf.shuffled_dim, mesh=mesh, n_blocks=2,
                     block=2048)
hashes, n = sk.sketch_codes(iter([g.copy() for g in genomes]))
assert n == len(genomes)
digest = hashlib.sha256()
for h in hashes:
    digest.update(np.ascontiguousarray(h).tobytes())
print(f"SKETCH-DIGEST {digest.hexdigest()}", flush=True)
sys.exit(0)
