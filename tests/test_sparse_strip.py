"""Sparse strip counting (collect_triples + _alldist_triples_rows) must
emit byte-identical output to the dense walk path.

The sparse path replaces the dense [block, n] strip (memset + walk +
full emission scan — O(block * n) traffic per strip, reference
dist.cpp:174-256 does the dense equivalent) with an expand/radix-sort/
run-length pipeline whose traffic is O(join).  Equality here is the
whole contract: same rows, same order, same text.
"""

import os

import numpy as np
import pytest

from rabbitkssd.formats import Sketch, SketchInfo, SketchSet


def _sketchset(rng, n_genomes, pool, cluster=4):
    # clusters of ``cluster`` genomes share a core (jaccard ~0.5 within
    # a cluster -> rows pass even D=0.05; cross-cluster overlap is
    # incidental small-jaccard noise that only the D=0.5 case emits)
    hashes = []
    for c in range(n_genomes // cluster):
        core = np.unique(rng.integers(0, pool, size=20).astype(np.uint32))
        for g in range(cluster):
            own = rng.integers(0, pool, size=10).astype(np.uint32)
            hashes.append(np.unique(np.concatenate([core, own])))
    # planted duplicates exercise jaccard == 1 (mash 0) rows
    hashes[3] = hashes[2].copy()
    info = SketchInfo(id=(8 << 8) + (4 << 4) + 1, half_k=8, half_subk=4,
                      drlevel=1, genome_number=n_genomes)
    return SketchSet(info=info, sketches=[
        Sketch(name=f"g{g:05d}", hashes=h) for g, h in enumerate(hashes)
    ])


@pytest.mark.parametrize("max_dist", [0.05, 0.5])
def test_sparse_equals_dense_blocked_alldist(tmp_path, monkeypatch,
                                             max_dist):
    from rabbitkssd.engine.dist_engine import run_alldist

    rng = np.random.default_rng(11)
    sk = _sketchset(rng, 600, 220)  # small pool -> real jaccard overlap
    monkeypatch.setenv("KSSD_DIST_BLOCK", "64")  # force 10 strips
    outs = {}
    for mode in ("dense", "sparse"):
        monkeypatch.setenv("KSSD_STRIP_MODE", mode)
        out = tmp_path / f"{mode}.dist"
        run_alldist(sk, str(out), max_dist=max_dist, containment=False)
        outs[mode] = out.read_bytes()
    assert outs["sparse"] == outs["dense"]
    assert outs["dense"].count(b"\n") > 10  # non-trivial corpus


def test_sparse_auto_dispatch_points(monkeypatch):
    """The cost model: sparse only for clearly sparse strips, never for
    include-zero emission."""
    from rabbitkssd.engine.dist_engine import _use_sparse_strip

    # layout_pack = (g0, (..., total_join)); only layout[-1] is read
    def lp(total):
        return (None, (None, None, None, None, None, total))

    monkeypatch.delenv("KSSD_STRIP_MODE", raising=False)
    assert _use_sparse_strip(lp(1000), 128, 1_000_000, 0, False)
    assert not _use_sparse_strip(lp(10_000_000), 128, 100_000, 0, False)
    # include_zero (max_dist >= 1) needs every in-triangle cell
    assert not _use_sparse_strip(lp(1000), 128, 1_000_000, 0, True)
    monkeypatch.setenv("KSSD_STRIP_MODE", "dense")
    assert not _use_sparse_strip(lp(1000), 128, 1_000_000, 0, False)
    monkeypatch.setenv("KSSD_STRIP_MODE", "sparse")
    assert _use_sparse_strip(lp(10_000_000), 128, 100_000, 0, False)


def test_collect_triples_matches_dense_walk():
    """collect_triples' (row, col, count) triples == the dense strip's
    in-triangle nonzeros, including the col_lo/diag trim semantics."""
    from rabbitkssd.engine.dist_engine import _CsrIndex
    from rabbitkssd.native import load_native

    if load_native() is None:
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(5)
    n = 400
    hashes = [np.sort(np.unique(
        rng.integers(0, 1500, size=rng.integers(5, 30)).astype(np.uint32)))
        for _ in range(n)]
    csr = _CsrIndex.from_hashes(hashes)
    block = 96
    g_all, c_all, sbounds = csr.strip_runs(block, n)
    for k in range(-(-n // block)):
        i0 = k * block
        bi = min(block, n - i0)
        sl = slice(sbounds[k], sbounds[k + 1])
        row_pairs = ((g_all[sl] - i0).astype(np.int32), c_all[sl])
        lp = csr.walk_layout(row_pairs)
        blk = np.zeros((bi, n), np.int32)
        csr.walk(blk, lp, col_lo=i0)
        # dense in-triangle nonzeros (j > i0 + r)
        r_nz, j_nz = np.nonzero(blk)
        tri = j_nz > i0 + r_nz
        r_nz, j_nz = r_nz[tri], j_nz[tri]
        want = (r_nz, j_nz, blk[r_nz, j_nz])
        got = csr.collect_triples(lp, bi, n, diag=i0)
        assert got is not None
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
