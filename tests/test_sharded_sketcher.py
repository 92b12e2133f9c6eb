"""Engine-level mesh-parallel sketcher on the virtual CPU mesh."""

from conftest import run_in_cpu_mesh


def test_sharded_sketcher_matches_oracle():
    out = run_in_cpu_mesh(
        """
import sys
import numpy as np, jax
assert len(jax.devices()) == 8
from rabbitkssd.params import KssdParams
from rabbitkssd.shuffle import generate_shuffle
from rabbitkssd.engine.sketcher import ShardedSketcher, DeviceSketcher
from rabbitkssd.ops.kmer import encode_concat
from rabbitkssd.oracle import sketch_records_oracle

rng = np.random.default_rng(9)
params = KssdParams(8, 4, 1)
shuf = generate_shuffle(8, 4, 1)
seqs = [bytes(rng.choice(np.frombuffer(b'ACGTN', np.uint8),
                         p=[.24,.24,.24,.24,.04], size=n))
        for n in (900, 150000, 37, 80000, 12345)]
codes = [encode_concat([(s, None)]) for s in seqs]

sk = ShardedSketcher(params, shuf.shuffled_dim, n_blocks=2, block=4096)
got, n = sk.sketch_codes(iter(list(codes)))
assert n == len(seqs)
for i, s in enumerate(seqs):
    want = sketch_records_oracle([(s, None)], params, shuf.shuffled_dim)
    np.testing.assert_array_equal(got[i], want, err_msg=f'genome {i}')
print('SHARDED SKETCHER OK')

# drlevel-3 config exercises the sparse compaction under shard_map
params3 = KssdParams(10, 6, 3)
shuf3 = generate_shuffle(10, 6, 3)
seq = bytes(rng.choice(np.frombuffer(b'ACGT', np.uint8), size=400000))
c3 = [encode_concat([(seq, None)])]
sk3 = ShardedSketcher(params3, shuf3.shuffled_dim, n_blocks=1, block=8192)
got3, _ = sk3.sketch_codes(iter(c3))
want3 = sketch_records_oracle([(seq, None)], params3, shuf3.shuffled_dim)
np.testing.assert_array_equal(got3[0], want3)
print('SHARDED SPARSE OK')
""",
        timeout=900,
    )
    assert "SHARDED SKETCHER OK" in out
    assert "SHARDED SPARSE OK" in out


def test_sketch_file_list_auto_mesh(tmp_path):
    """sketch_file_list transparently uses the mesh sketcher on
    multi-device backends; sketches match the golden artifacts."""
    import os

    golden = os.path.join(os.path.dirname(__file__), "golden")
    out = run_in_cpu_mesh(
        f"""
import sys, os
os.chdir({golden!r})
import numpy as np, jax
assert len(jax.devices()) == 8
from rabbitkssd.engine.sketcher import sketch_file_list
from rabbitkssd.shuffle import read_shuffle_file
from rabbitkssd.formats import read_sketches
ours = sketch_file_list('fa.list', read_shuffle_file('k8s4l1.shuf'))
ref = {{s.name: np.sort(s.hashes) for s in read_sketches('fa_k8s4l1.sketch').sketches}}
assert len(ours.sketches) == len(ref)
for s in ours.sketches:
    np.testing.assert_array_equal(s.hashes, ref[s.name])
print('AUTO MESH SKETCH OK')
""",
        timeout=900,
    )
    assert "AUTO MESH SKETCH OK" in out
