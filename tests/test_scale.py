"""Config-5 scale: 100k-genome all-vs-all with bounded memory.

SURVEY/BASELINE config 5 demands pod-scale all-vs-all (100k genomes).
The reference's posting-list walk is O(nnz) per row with a streamed
index (/root/reference/src/dist.cpp:174-204); our two-axis-tiled
engine must complete at that genome count without materializing any
[N_all, vocab_chunk] membership matrix (which would be ~hundreds of
GB) and with host memory bounded by the tile size, not N^2.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import cpu_mesh_env

N_GENOMES = 100_000
POOL = 200_000          # hash-value pool -> realistic posting overlap
N_PLANTED = 500         # near-duplicate pairs that MUST emit
MAX_DIST = 0.05
HALF_K = 8              # kmer_size 16, 32-bit hashes (half_k-drlevel<=8)
DRLEVEL = 1


def _make_sketches(rng):
    """100k tiny sketches + planted near-duplicate pairs (2i, 2i+1)."""
    sizes = rng.integers(8, 25, size=N_GENOMES)
    hashes = []
    pool = rng.permutation(np.arange(1, POOL + 1, dtype=np.uint32) * 977)
    for g in range(N_GENOMES):
        h = np.unique(pool[rng.integers(0, POOL, size=sizes[g])])
        hashes.append(np.sort(h).astype(np.uint32))
    # planted pairs: genome 2i+1 copies 2i (jaccard 1 -> mashD 0)
    for p in range(N_PLANTED):
        hashes[2 * p + 1] = hashes[2 * p].copy()
    return hashes


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from rabbitkssd.formats import (Sketch, SketchInfo, SketchSet,
                                        save_sketches)

    rng = np.random.default_rng(7)
    hashes = _make_sketches(rng)
    info = SketchInfo(id=(HALF_K << 8) + (4 << 4) + DRLEVEL, half_k=HALF_K,
                      half_subk=4, drlevel=DRLEVEL,
                      genome_number=N_GENOMES)
    sk = SketchSet(info=info, sketches=[
        Sketch(name=f"g{g:06d}", hashes=h) for g, h in enumerate(hashes)
    ])
    path = str(tmp_path_factory.mktemp("scale") / "big.sketch")
    save_sketches(sk, path)
    return path, hashes


def test_100k_alldist_bounded_memory(corpus, tmp_path):
    """100k-genome alldist completes on the virtual 8-device CPU mesh
    with peak RSS far below any [N, vocab] materialization."""
    sketch_path, hashes = corpus
    out = str(tmp_path / "big.alldist")
    code = f"""
import resource, sys
sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
import jax
assert len(jax.devices()) == 8
from rabbitkssd.formats import read_sketches
from rabbitkssd.engine.dist_engine import run_alldist
sk = read_sketches({sketch_path!r})
assert len(sk.sketches) == {N_GENOMES}
run_alldist(sk, {out!r}, max_dist={MAX_DIST}, containment=False)
# NB ru_maxrss survives execve (the high-water mark is inherited from
# the forking parent), so a child spawned by a large pytest process
# would report the PARENT's peak; VmHWM belongs to this process's mm.
with open("/proc/self/status") as st:
    hwm_kb = next(int(l.split()[1]) for l in st if l.startswith("VmHWM"))
peak_gb = hwm_kb / 1e6
print(f"PEAK_RSS_GB {{peak_gb:.2f}}")
assert peak_gb < 8.0, f"unbounded memory: {{peak_gb:.1f}} GB"
"""
    env = cpu_mesh_env()
    env["KSSD_DIST_BLOCK"] = "4096"  # strip = 4096 x N int32 = 1.6 GB
    # deterministic small device-memory budget: membership matrices per
    # vocab chunk stay ~0.5 GB so the RSS bound below tests tiling, not
    # the XLA CPU allocator's temp-pool mood
    env["KSSD_DIST_MEM_BYTES"] = str(1 << 30)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=1500)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "PEAK_RSS_GB" in proc.stdout

    with open(out) as f:
        lines = f.readlines()
    assert lines[0].startswith(" genome0\t")
    rows = {}
    for line in lines[1:]:
        g0, g1, csz, j, d = line.rstrip("\n").split("\t")
        rows[(g0, g1)] = (csz, j, d)

    # every planted duplicate pair must emit with jaccard 1, mashD 0
    for p in range(N_PLANTED):
        a, b = f"g{2*p:06d}", f"g{2*p+1:06d}"
        got = rows.get((a, b)) or rows.get((b, a))
        assert got is not None, f"planted pair {p} missing"
        sz = hashes[2 * p].size
        assert got == (f"{sz}|{sz}|{sz}", "1.000000", "0.000000")

    # every emitted row must match the exact set-intersection oracle
    import math
    checked = 0
    for (g0, g1), (csz, j, d) in list(rows.items())[:2000]:
        i1, i0 = int(g0[1:]), int(g1[1:])  # row is "name_j \t name_i"
        common = int(np.intersect1d(hashes[i0], hashes[i1]).size)
        s0, s1 = hashes[i0].size, hashes[i1].size
        assert csz == f"{common}|{s0}|{s1}", (g0, g1)
        jac = common / (s0 + s1 - common)
        mash = (0.0 if jac == 1.0 else
                (-1.0 / (2 * HALF_K)) * math.log(2 * jac / (1 + jac)))
        assert j == f"{jac:.6f}" and d == f"{mash:.6f}", (g0, g1)
        assert mash < MAX_DIST
        checked += 1
    assert checked >= N_PLANTED


def test_100k_tile_counts_match_oracle(corpus):
    """Sampled cross-tiles of the blocked counting equal the numpy
    set-intersection oracle (VERDICT round-1 'done' criterion)."""
    from rabbitkssd.ops.distance import common_counts

    _, hashes = corpus
    rng = np.random.default_rng(3)
    for _ in range(3):
        a = int(rng.integers(0, N_GENOMES - 40))
        b = int(rng.integers(0, N_GENOMES - 40))
        got = common_counts(hashes[a : a + 40], hashes[b : b + 40])
        want = np.array(
            [[np.intersect1d(hashes[a + i], hashes[b + j]).size
              for j in range(40)] for i in range(40)], np.int32)
        np.testing.assert_array_equal(got, want)
