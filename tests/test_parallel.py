"""Multi-chip sharding tests on a virtual 8-device CPU mesh (subprocess)."""

from conftest import run_in_cpu_mesh


def test_dryrun_multichip_8():
    out = run_in_cpu_mesh(
        "import sys;"
        "import __graft_entry__ as g; g.dryrun_multichip(8); print('DRYRUN OK')"
    )
    assert "DRYRUN OK" in out


def test_sharded_common_matches_single_chip():
    out = run_in_cpu_mesh(
        """
import sys
import numpy as np
from rabbitkssd.parallel.sharded import make_mesh, sharded_common_counts
from rabbitkssd.ops.distance import common_counts

rng = np.random.default_rng(5)
hashes = [np.unique(rng.integers(0, 20000, rng.integers(10, 900)).astype(np.uint64))
          for _ in range(13)]
mesh = make_mesh(8)
a = sharded_common_counts(hashes, None, mesh)
b = common_counts(hashes, None)
np.testing.assert_array_equal(a, b)
qry = hashes[:3]
a = sharded_common_counts(qry, hashes, mesh)
b = common_counts(qry, hashes)
np.testing.assert_array_equal(a, b)
print('SHARDED MATCH OK')
"""
    )
    assert "SHARDED MATCH OK" in out


def test_sharded_ring_device_path():
    """Force the DEVICE ring path (side 1 rotating over dp via ppermute)
    past the small-join host shortcut and check exactness, including
    n0/n1 not divisible by dp and multiple vocab chunks."""
    out = run_in_cpu_mesh(
        """
import os, sys
os.environ['KSSD_HOST_JOIN_MAX'] = '0'      # no host fast path
os.environ['KSSD_DIST_MEM_BYTES'] = '200000'  # force >1 vocab chunk
import numpy as np
from rabbitkssd.parallel.sharded import make_mesh, sharded_common_counts
from rabbitkssd.ops.distance import common_counts

rng = np.random.default_rng(17)
hashes = [np.unique(rng.integers(0, 30000, rng.integers(50, 1200)).astype(np.uint64))
          for _ in range(11)]
mesh = make_mesh(8)
a = sharded_common_counts(hashes, None, mesh)
oracle = np.array([[len(np.intersect1d(x, y)) for y in hashes] for x in hashes], np.int32)
np.testing.assert_array_equal(a, oracle)
qry = hashes[:5]
a = sharded_common_counts(qry, hashes, mesh)
np.testing.assert_array_equal(a, oracle[:5])
print('RING MATCH OK')
"""
    )
    assert "RING MATCH OK" in out


def test_sharded_ring_dp4():
    """The ring at dp = 4, vp = 1: each of the four rotations lands in
    its own column block, so a ring turning the wrong way miscounts (at
    dp = 2 the two directions coincide)."""
    out = run_in_cpu_mesh(
        """
import os
os.environ['KSSD_HOST_JOIN_MAX'] = '0'      # no host fast path
import numpy as np, jax
from jax.sharding import Mesh
from rabbitkssd.parallel.sharded import sharded_common_counts

rng = np.random.default_rng(23)
hashes = [np.unique(rng.integers(0, 5000, rng.integers(50, 600)).astype(np.uint64))
          for _ in range(10)]
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4, 1), ('dp', 'vp'))
oracle = np.array([[len(np.intersect1d(x, y)) for y in hashes] for x in hashes], np.int32)
np.testing.assert_array_equal(sharded_common_counts(hashes, None, mesh), oracle)
np.testing.assert_array_equal(sharded_common_counts(hashes[:6], hashes, mesh), oracle[:6])
print('RING DP4 OK')
""",
        n_devices=4,
    )
    assert "RING DP4 OK" in out


def test_sharded_sketch_matches_oracle():
    out = run_in_cpu_mesh(
        """
import sys
import numpy as np, jax
import jax.numpy as jnp
from rabbitkssd.params import KssdParams
from rabbitkssd.shuffle import generate_shuffle
from rabbitkssd.parallel.sharded import make_mesh, make_sharded_sketch_step
from rabbitkssd.oracle import sketch_records_oracle
from rabbitkssd.ops.kmer import encode_concat

params = KssdParams(half_k=8, half_subk=4, drlevel=1)
shuf = generate_shuffle(8, 4, 1)
mesh = make_mesh(8)
n_shards = 8
nb, block, cap = 2, 1024, 4096
rng = np.random.default_rng(3)
seq = bytes(rng.choice(np.frombuffer(b'ACGT', np.uint8), n_shards*nb*block))
codes = encode_concat([(seq, None)])
halo = params.kmer_size - 1
rows = np.full((n_shards*nb, block+halo), -1, np.int8)
flat = np.concatenate([np.full(halo, -1, np.int8), codes])
for b in range(n_shards*nb):
    seg = flat[b*block : b*block+block+halo]
    rows[b, :len(seg)] = seg
step = make_sharded_sketch_step(params, mesh, nb, block, cap)
h_lo, h_hi, pos, total = step(rows, jnp.asarray(shuf.shuffled_dim.astype(np.int32)))
h_lo, total = np.asarray(h_lo), np.asarray(total)
got = np.sort(np.unique(np.concatenate(
    [h_lo[s, :total[s]] for s in range(n_shards)]))).astype(np.uint32)
want = sketch_records_oracle([(seq, None)], params, shuf.shuffled_dim)
np.testing.assert_array_equal(got, want)
print('SHARDED SKETCH OK')
"""
    )
    assert "SHARDED SKETCH OK" in out


def test_global_mesh_single_process():
    out = run_in_cpu_mesh(
        "import sys;"
        "from rabbitkssd.parallel.multihost import init_multihost, global_mesh;"
        "init_multihost();"
        "m = global_mesh();"
        "print('MESH', m.devices.shape, m.axis_names)"
    )
    assert "MESH (1, 8) ('dp', 'vp')" in out
