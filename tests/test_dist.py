"""Distance engine vs golden reference-binary outputs (text-exact)."""

import os

import numpy as np
import pytest

from rabbitkssd.engine.dist_engine import run_alldist, run_dist
from rabbitkssd.formats import read_sketches
from rabbitkssd.ops.distance import common_counts

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _sorted_rows(path):
    with open(path) as f:
        lines = f.readlines()
    assert lines[0].startswith(" genome0\t") or lines[0].startswith(" referenceGenome\t")
    return lines[0], sorted(lines[1:])


@pytest.mark.parametrize(
    "sketch,golden,kw",
    [
        ("fa_k8s4l1.sketch", "fa_k8s4l1.alldist",
         dict(max_dist=1.0, containment=False)),
        ("fa_k10s4l1.sketch", "fa_k10s4l1.alldist",
         dict(max_dist=0.5, containment=False)),
        ("fa_k8s4l1.sketch", "fa_k8s4l1.allcont",
         dict(max_dist=1.0, containment=True)),
    ],
)
def test_alldist_golden(tmp_path, sketch, golden, kw):
    sk = read_sketches(os.path.join(GOLDEN, sketch))
    out = str(tmp_path / "out.dist")
    run_alldist(sk, out, **kw)
    got_h, got = _sorted_rows(out)
    want_h, want = _sorted_rows(os.path.join(GOLDEN, golden))
    assert got_h == want_h
    assert got == want


@pytest.mark.parametrize(
    "golden,kw",
    [
        ("fa_k8s4l1.dist", dict(max_dist=1.0, containment=False)),
        ("fa_k8s4l1.distN2",
         dict(max_dist=1.0, containment=False, max_neighbor=2)),
    ],
)
def test_dist_golden(tmp_path, golden, kw):
    ref = read_sketches(os.path.join(GOLDEN, "fa_k8s4l1.sketch"))
    query = read_sketches(os.path.join(GOLDEN, "faq_k8s4l1.sketch"))
    out = str(tmp_path / "out.dist")
    run_dist(ref, query, out, **kw)
    got_h, got = _sorted_rows(out)
    want_h, want = _sorted_rows(os.path.join(GOLDEN, golden))
    assert got_h == want_h
    assert got == want


def test_common_counts_vs_numpy(rng):
    """Device matmul counting == np.intersect1d on random sketches."""
    hashes = [
        np.unique(rng.integers(0, 5000, size=rng.integers(0, 800)).astype(np.uint32))
        for _ in range(23)
    ]
    common = common_counts(hashes, None)
    for i in range(23):
        for j in range(23):
            if i == j:
                continue
            want = np.intersect1d(hashes[i], hashes[j]).size
            assert common[i, j] == want, (i, j)


def test_common_counts_refquery(rng):
    ref = [np.unique(rng.integers(0, 3000, size=500).astype(np.uint64))
           for _ in range(9)]
    qry = [np.unique(rng.integers(0, 3000, size=200).astype(np.uint64))
           for _ in range(4)]
    common = common_counts(qry, ref)
    assert common.shape == (4, 9)
    for i in range(4):
        for j in range(9):
            assert common[i, j] == np.intersect1d(qry[i], ref[j]).size


def test_common_counts_chunked(rng):
    """Chunking over the vocab must not change counts."""
    hashes = [
        np.unique(rng.integers(0, 100000, size=3000).astype(np.uint32))
        for _ in range(6)
    ]
    a = common_counts(hashes, None)
    b = common_counts(hashes, None, chunk=1024)
    np.testing.assert_array_equal(a, b)


def test_host_join_native_and_fallback(rng, monkeypatch):
    """The native posting-list walk and the chunked numpy expansion
    must agree with brute force (the chunk boundary math splits columns
    mid-run)."""
    import rabbitkssd.ops.distance as D

    hashes0 = [np.unique(rng.integers(0, 3000, size=400).astype(np.uint32))
               for _ in range(7)]
    hashes1 = [np.unique(rng.integers(0, 3000, size=300).astype(np.uint32))
               for _ in range(5)]
    vocab = np.unique(np.concatenate(hashes0 + hashes1))
    g0, c0 = D._memberships(hashes0, vocab)
    g1, c1 = D._memberships(hashes1, vocab)
    oracle = np.array(
        [[len(np.intersect1d(a, b)) for b in hashes1] for a in hashes0],
        np.int32)

    native = D._pair_counts_host(g0, c0, g1, c1, 7, 5)
    np.testing.assert_array_equal(native, oracle)

    import rabbitkssd.native as N

    monkeypatch.setattr(N, "pair_count_native", lambda *a, **k: False)
    # tiny chunk: force many passes with mid-column splits
    monkeypatch.setattr(D, "_HOST_JOIN_CHUNK", 37)
    fallback = D._pair_counts_host(g0, c0, g1, c1, 7, 5)
    np.testing.assert_array_equal(fallback, oracle)


def test_mem_budget_cpu_and_override(monkeypatch):
    """The CPU client reports no memory limit: it gets the fixed host
    budget; KSSD_DIST_MEM_BYTES overrides on any device."""
    import rabbitkssd.ops.distance as D

    monkeypatch.delenv("KSSD_DIST_MEM_BYTES", raising=False)
    assert D.mem_budget() == D._CPU_MEM_BUDGET
    monkeypatch.setenv("KSSD_DIST_MEM_BYTES", "12345")
    assert D.mem_budget() == 12345


@pytest.mark.gpu
def test_mem_budget_gpu_limit(gpu_device, monkeypatch):
    """On a GPU the budget is a quarter of the device's memory limit."""
    import rabbitkssd.ops.distance as D

    monkeypatch.delenv("KSSD_DIST_MEM_BYTES", raising=False)
    limit = gpu_device.memory_stats()["bytes_limit"]
    assert D.mem_budget() == limit // 4


def test_write_rows_4gb_split(tmp_path, monkeypatch):
    """Outputs beyond the split threshold land in <out>.dir + <out>.index
    (reference dist.cpp:276-341)."""
    import rabbitkssd.engine.dist_engine as de

    monkeypatch.setattr(de, "MAX_SINGLE_FILE", 64)
    out = str(tmp_path / "big.dist")
    rows = [f"g{i}\tg{j}\t1|2|3\t0.100000\t0.200000\n"
            for i in range(6) for j in range(i)]
    de._write_rows(iter(rows), [f"g{i}" for i in range(6)], out)
    assert not os.path.exists(out)
    part = os.path.join(out + ".dir", "big.dist.0")
    assert os.path.exists(part)
    with open(part) as f:
        assert f.readlines() == rows
    with open(out + ".index") as f:
        idx = f.readlines()
    assert idx[0] == "genomeName\tdistFileName\n"
    assert len(idx) == 7


def test_write_rows_multipart(tmp_path, monkeypatch):
    """With genome markers, oversized outputs roll to a NEW part at a
    genome boundary so no part exceeds the threshold, and the .index
    maps each genome to the part holding its rows."""
    import rabbitkssd.engine.dist_engine as de

    row = "gA\tgB\t1|2|3\t0.100000\t0.200000\n"   # 28 bytes
    monkeypatch.setattr(de, "MAX_SINGLE_FILE", 4 * len(row) + 1)

    def gen():
        for g in range(4):
            yield g
            for _ in range(2):  # 2 rows per genome, 2 genomes per part
                yield row

    out = str(tmp_path / "big.dist")
    de._write_rows(gen(), [f"g{i}" for i in range(4)], out)
    assert not os.path.exists(out)
    p0 = os.path.join(out + ".dir", "big.dist.0")
    p1 = os.path.join(out + ".dir", "big.dist.1")
    for p in (p0, p1):
        with open(p) as f:
            assert f.readlines() == [row] * 4  # no header in any part
    with open(out + ".index") as f:
        idx = f.readlines()
    assert idx == ["genomeName\tdistFileName\n",
                   f"g0\t{p0}\n", f"g1\t{p0}\n",
                   f"g2\t{p1}\n", f"g3\t{p1}\n"]


def test_write_rows_single_pass_merge(tmp_path):
    """Small outputs are written once and renamed (no spool-then-copy):
    the .dir is gone and the file is header + rows."""
    import rabbitkssd.engine.dist_engine as de

    out = str(tmp_path / "small.dist")
    rows = ["gA\tgB\t1|2|3\t0.100000\t0.200000\n"]

    def gen():
        yield 0
        yield rows[0]
        yield 1

    de._write_rows(gen(), ["gA", "gB"], out)
    assert not os.path.exists(out + ".dir")
    assert not os.path.exists(out + ".index")
    with open(out) as f:
        assert f.readlines() == [de.HEADER] + rows


def test_alldist_two_axis_blocked(tmp_path, monkeypatch):
    """The two-axis-tiled path must emit identical rows to the
    monolithic one (config-5 bounded-memory tiling)."""
    monkeypatch.setenv("KSSD_DIST_BLOCK", "128")  # floor is 128
    sk = read_sketches(os.path.join(GOLDEN, "fa_k8s4l1.sketch"))
    # duplicate sketches past one block so multiple tiles really run
    import dataclasses

    reps = []
    for r in range(40):
        for s in sk.sketches:
            reps.append(dataclasses.replace(s, name=f"{s.name}#{r}"))
    big = dataclasses.replace(sk, sketches=reps)
    out = str(tmp_path / "blk.dist")
    run_alldist(big, out, max_dist=0.6, containment=False)
    got_h, got = _sorted_rows(out)
    monkeypatch.setenv("KSSD_DIST_BLOCK", str(len(reps)))
    out2 = str(tmp_path / "mono.dist")
    run_alldist(big, out2, max_dist=0.6, containment=False)
    want_h, want = _sorted_rows(out2)
    assert got_h == want_h
    assert got == want


def test_dist_query_blocked(tmp_path, monkeypatch):
    """Blocked ref-vs-query equals the monolithic path, with and
    without top-N."""
    import dataclasses

    from rabbitkssd.engine.dist_engine import run_dist

    ref = read_sketches(os.path.join(GOLDEN, "fa_k8s4l1.sketch"))
    reps = []
    for r in range(50):
        for s in ref.sketches:
            # PERTURBED queries (drop r leading hashes): the blocked
            # path must consume the REFERENCE side for columns — with
            # query == ref replicas a ref/query axis swap is invisible
            reps.append(dataclasses.replace(
                s, name=f"{s.name}#{r}",
                hashes=s.hashes[min(r + 1, max(0, s.hashes.size - 2)):]))
    query = dataclasses.replace(ref, sketches=reps)
    for n_top in (0, 2):
        outs = []
        for blk in ("128", str(max(len(reps), len(ref.sketches)))):
            monkeypatch.setenv("KSSD_DIST_BLOCK", blk)
            out = str(tmp_path / f"d_{n_top}_{blk}.dist")
            run_dist(ref, query, out, max_dist=1.0, containment=False,
                     max_neighbor=n_top)
            outs.append(open(out).read())
        # same block structure per query row order: byte equality
        assert outs[0] == outs[1], f"top-N={n_top}"


def test_topn_matches_scalar_reference(rng):
    """The candidate-jump top-N heap replays the reference's scalar
    push/pop sequence exactly (incl. ties and the fill phase)."""
    from rabbitkssd.engine.dist_engine import (
        _bulk_dist, _jaccard_mash, _topn_heap,
    )
    from rabbitkssd.utils.stdheap import StdPriorityQueue
    from rabbitkssd.engine.dist_engine import _Neighbor

    nr = 500
    kmer = 16
    for trial in range(20):
        rsizes = rng.integers(1, 2000, size=nr).astype(np.int64)
        size1 = int(rng.integers(1, 2000))
        crow = np.minimum(rng.integers(0, 600, size=nr), rsizes)
        # inject exact ties and degenerate rows
        crow[rng.integers(0, nr, 30)] = 0
        crow[rng.integers(0, nr, 10)] = crow[int(rng.integers(0, nr))]
        bulk = _bulk_dist(crow, rsizes, size1, kmer, False)
        max_dist = float(rng.choice([0.05, 0.3, 1.0]))
        n_top = int(rng.choice([1, 3, 7]))

        got = _topn_heap(crow, bulk, [f"r{j}" for j in range(nr)], rsizes,
                         size1, kmer, max_dist, _jaccard_mash, n_top)

        want: StdPriorityQueue = StdPriorityQueue(
            lambda a, b: a.dist < b.dist)
        for j in range(nr):
            jorc, d = _jaccard_mash(int(crow[j]), int(rsizes[j]), size1,
                                    kmer)
            if d <= max_dist:
                nb = _Neighbor(f"r{j}", int(crow[j]), int(rsizes[j]),
                               jorc, d)
                if len(want) < n_top:
                    want.push(nb)
                elif d < want.top().dist:
                    want.push(nb)
                    want.pop()
        got_rows = []
        while len(got):
            got_rows.append(got.pop())
        want_rows = []
        while len(want):
            want_rows.append(want.pop())
        assert got_rows == want_rows, f"trial {trial}"


# --------------------------------------------------------------------------
# distance consuming the persisted .index/.dict (reference dist.cpp:83-130)
# --------------------------------------------------------------------------

@pytest.mark.parametrize(
    "stem,kw",
    [
        ("fa_k5s4l1", dict(max_dist=1.0, containment=False)),   # 32-bit dense
        ("fa_k10s4l1", dict(max_dist=0.5, containment=False)),  # 64-bit sparse
    ],
)
def test_alldist_from_reference_built_index(tmp_path, stem, kw):
    """alldist fed by the index the REFERENCE BINARY wrote (including
    the 64-bit robin_hood iteration order) matches the golden text."""
    sketch = os.path.join(GOLDEN, f"{stem}.sketch")
    sk = read_sketches(sketch)
    out = str(tmp_path / "idx.dist")
    run_alldist(sk, out, index_path=sketch, **kw)
    got_h, got = _sorted_rows(out)
    want_h, want = _sorted_rows(os.path.join(GOLDEN, f"{stem}.alldist"))
    assert got_h == want_h
    assert got == want


def test_alldist_index_path_used(tmp_path, monkeypatch):
    """The CSR path must actually consume the index files: corrupting
    the .dict must change the result (guards against a silent fallback
    to recompute-from-sketch)."""
    import shutil

    src = os.path.join(GOLDEN, "fa_k5s4l1.sketch")
    sketch = str(tmp_path / "c.sketch")
    shutil.copy(src, sketch)
    shutil.copy(src + ".index", sketch + ".index")
    post = np.fromfile(src + ".dict", dtype="<u4")
    post[:] = post[0]  # all postings point at genome 0
    post.tofile(sketch + ".dict")
    sk = read_sketches(sketch)
    out = str(tmp_path / "bad.dist")
    # force the CSR path: auto skips it on multi-device backends (the
    # virtual 8-device CPU mesh) where the sharded matmul path wins
    monkeypatch.setenv("KSSD_USE_INDEX", "1")
    run_alldist(sk, out, max_dist=1.0, containment=False, index_path=sketch)
    _, got = _sorted_rows(out)
    _, want = _sorted_rows(os.path.join(GOLDEN, "fa_k5s4l1.alldist"))
    assert got != want


def test_dist_from_index_matches_golden(tmp_path):
    """ref-vs-query (incl. top-N) counting from a persisted ref index."""
    import shutil

    from rabbitkssd.formats import write_index

    ref_sketch = str(tmp_path / "ref.sketch")
    shutil.copy(os.path.join(GOLDEN, "fa_k8s4l1.sketch"), ref_sketch)
    ref = read_sketches(ref_sketch)
    write_index(ref, ref_sketch + ".dict", ref_sketch + ".index")
    query = read_sketches(os.path.join(GOLDEN, "faq_k8s4l1.sketch"))
    for golden, n_top in (("fa_k8s4l1.dist", 0), ("fa_k8s4l1.distN2", 2)):
        out = str(tmp_path / f"q{n_top}.dist")
        run_dist(ref, query, out, max_dist=1.0, containment=False,
                 max_neighbor=n_top, ref_index_path=ref_sketch)
        with open(out) as f:
            got = sorted(f.readlines()[1:])
        with open(os.path.join(GOLDEN, golden)) as f:
            want = sorted(f.readlines()[1:])
        assert got == want, golden


def test_alldist_from_index_blocked(tmp_path, monkeypatch):
    """Index-fed counting composes with two-axis tiling."""
    import dataclasses
    import shutil

    from rabbitkssd.formats import save_sketches, write_index

    monkeypatch.setenv("KSSD_DIST_BLOCK", "128")
    sk = read_sketches(os.path.join(GOLDEN, "fa_k8s4l1.sketch"))
    reps = []
    for r in range(40):
        for s in sk.sketches:
            reps.append(dataclasses.replace(s, name=f"{s.name}#{r}"))
    big = dataclasses.replace(sk, sketches=reps)
    sketch = str(tmp_path / "big.sketch")
    save_sketches(big, sketch)
    write_index(big, sketch + ".dict", sketch + ".index")
    out = str(tmp_path / "idx.dist")
    # force: k8's dense index dwarfs this payload, auto would skip it
    monkeypatch.setenv("KSSD_USE_INDEX", "1")
    run_alldist(big, out, max_dist=0.6, containment=False,
                index_path=sketch)
    got_h, got = _sorted_rows(out)
    monkeypatch.setenv("KSSD_USE_INDEX", "0")
    out2 = str(tmp_path / "re.dist")
    run_alldist(big, out2, max_dist=0.6, containment=False,
                index_path=sketch)
    want_h, want = _sorted_rows(out2)
    assert got_h == want_h
    assert got == want
