"""Guards on persisted-index consumption (.index/.dict).

The reference TRUSTS whatever .index/.dict sit next to a sketch
(/root/reference/src/dist.cpp:83-130); combined with its
nondeterministic union/merge hash order this can silently miscount
(observed round 4: jaccard > 1 from a stale index).  Our loader instead
(a) rejects an index whose posting payload no longer matches the sketch
nnz and rebuilds in memory (dist_engine._load_csr), (b) normalizes
non-ascending genome-id runs an external .dict might carry
(formats.read_index_csr), and (c) raises on truncated files instead of
returning garbage.  These tests fail if any guard is deleted.
"""

import struct

import numpy as np
import pytest

from rabbitkssd.engine.dist_engine import _load_csr, run_alldist
from rabbitkssd.formats import (Sketch, SketchInfo, SketchSet,
                                    read_index_csr, save_sketches,
                                    write_index)


def _tiny_set(n=6, per=40, seed=7) -> SketchSet:
    """Small 32-bit sketch set (half_k=5, drlevel=1: hash space 16^4)."""
    rng = np.random.default_rng(seed)
    info = SketchInfo(id=(5 << 8) + (4 << 4) + 1, half_k=5, half_subk=4,
                      drlevel=1, genome_number=n)
    sketches = []
    for i in range(n):
        # draw from a small sub-space so genomes share hashes (real
        # corpora overlap; a collision-free corpus has no pair counts)
        h = np.unique(rng.integers(0, 300, size=per).astype(np.uint32))
        sketches.append(Sketch(name=f"g{i}", hashes=h))
    return SketchSet(info=info, sketches=sketches)


def _write_artifacts(sk: SketchSet, tmp_path) -> str:
    base = str(tmp_path / "t.sketch")
    save_sketches(sk, base)
    write_index(sk, base + ".dict", base + ".index")
    return base


def _rows(sk, out, index_path=None):
    run_alldist(sk, out, max_dist=1.0, containment=False,
                index_path=index_path)
    with open(out) as f:
        return sorted(f.readlines()[1:])


@pytest.fixture
def force_index(monkeypatch):
    """Force persisted-index consumption regardless of backend/device
    count (auto mode skips it on multi-device and on dense indexes much
    larger than the payload — not what these guards test)."""
    monkeypatch.setenv("KSSD_USE_INDEX", "1")


def test_load_csr_staleness_rejects_mismatched_nnz(tmp_path, force_index):
    sk = _tiny_set()
    base = _write_artifacts(sk, tmp_path)
    nnz = sum(s.size for s in sk.sketches)
    assert _load_csr(base, False, payload_nnz=nnz) is not None
    # a hand-edited/stale sketch desyncs the nnz -> loader must reject
    assert _load_csr(base, False, payload_nnz=nnz - 1) is None
    assert _load_csr(base, False, payload_nnz=nnz + 5) is None


def test_alldist_stale_dict_falls_back_to_rebuild(tmp_path, force_index):
    """A .dict whose payload mismatches the sketch nnz (one posting
    chopped, .index patched so the files still parse) must NOT be
    consumed: alldist output equals the index-free ground truth."""
    sk = _tiny_set()
    base = _write_artifacts(sk, tmp_path)
    truth = _rows(sk, str(tmp_path / "truth.dist"))

    postings = np.fromfile(base + ".dict", dtype="<u4")
    postings[:-1].tofile(base + ".dict")
    with open(base + ".index", "r+b") as f:
        (hash_size,) = struct.unpack("<Q", f.read(8))
        (total,) = struct.unpack("<Q", f.read(8))
        counts = np.frombuffer(f.read(4 * hash_size), dtype="<u4").copy()
        last = np.nonzero(counts)[0][-1]
        counts[last] -= 1
        f.seek(8)
        f.write(struct.pack("<Q", total - 1))
        f.write(counts.astype("<u4").tobytes())
    # files parse fine on their own...
    assert read_index_csr(base, use64=False) is not None
    # ...but the nnz guard rejects them and alldist rebuilds in memory
    assert _rows(sk, str(tmp_path / "stale.dist"), index_path=base) == truth


def test_alldist_consumes_persisted_index_when_nnz_matches(tmp_path,
                                                           force_index):
    """Matching nnz keeps the persisted path: a content-tweaked .dict of
    the SAME size (two genome ids swapped across different posting runs)
    visibly changes the alldist output, proving the rows came from the
    .dict rather than an in-memory rebuild."""
    sk = _tiny_set()
    base = _write_artifacts(sk, tmp_path)
    truth = _rows(sk, str(tmp_path / "truth.dist"))

    postings = np.fromfile(base + ".dict", dtype="<u4")
    # mutate a SHARED posting run (count >= 2): reassign one member to a
    # genome outside the run, changing a pair count.  (Swapping two
    # singleton runs would change nothing observable — a singleton hash
    # contributes to no pair.)
    with open(base + ".index", "rb") as f:
        (hash_size,) = struct.unpack("<Q", f.read(8))
        f.read(8)
        counts = np.frombuffer(f.read(4 * hash_size), dtype="<u4")
    offsets = np.zeros(hash_size + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    shared = np.nonzero(counts >= 2)[0]
    assert shared.size, "corpus produced no shared hash; grow per/seed"
    run = postings[offsets[shared[0]]: offsets[shared[0] + 1]]
    outside = next(g for g in range(len(sk.sketches)) if g not in run)
    postings[offsets[shared[0]]] = outside
    postings.tofile(base + ".dict")

    rows = _rows(sk, str(tmp_path / "tweak.dist"), index_path=base)
    assert rows != truth


def test_read_index_csr_normalizes_nonascending_runs(tmp_path):
    """Our builds and the reference's transSketches both emit ascending
    genome ids per posting run, but an external .dict might not — and
    the native walk's col_lo lower_bound silently undercounts on a
    violated invariant (formats.py run check).  Feed a permuted .dict."""
    base = str(tmp_path / "x.sketch")
    hash_space = 1 << 16
    counts = np.zeros(hash_space, np.uint32)
    counts[5] = 3
    counts[9] = 2
    postings = np.array([3, 1, 2, 0, 2], np.uint32)  # run(5) descends
    with open(base + ".index", "wb") as f:
        f.write(struct.pack("<Q", hash_space))
        f.write(struct.pack("<Q", int(postings.size)))
        f.write(counts.astype("<u4").tobytes())
    postings.astype("<u4").tofile(base + ".dict")

    vocab, offsets, post = read_index_csr(base, use64=False)
    np.testing.assert_array_equal(vocab, [5, 9])
    np.testing.assert_array_equal(np.diff(offsets), [3, 2])
    np.testing.assert_array_equal(post, [1, 2, 3, 0, 2])


def test_truncated_index_raises(tmp_path):
    sk = _tiny_set()
    base = _write_artifacts(sk, tmp_path)
    with open(base + ".index", "rb") as f:
        raw = f.read()
    with open(base + ".index", "wb") as f:
        f.write(raw[: len(raw) - 6])
    with pytest.raises(IOError):
        read_index_csr(base, use64=False)


def test_truncated_dict_raises(tmp_path):
    sk = _tiny_set()
    base = _write_artifacts(sk, tmp_path)
    postings = np.fromfile(base + ".dict", dtype="<u4")
    postings[:-3].tofile(base + ".dict")  # .index still claims full size
    with pytest.raises(IOError):
        read_index_csr(base, use64=False)


def test_truncated_index64_raises(tmp_path):
    """64-bit sparse header claims more hash slots than the file holds."""
    base = str(tmp_path / "y.sketch")
    vocab = np.array([3, 5, 900], np.uint64)
    counts = np.array([1, 1, 1], np.uint32)
    with open(base + ".index", "wb") as f:
        f.write(struct.pack("<Q", 5))  # lies: only 3 present
        f.write(vocab.astype("<u8").tobytes())
        f.write(counts.astype("<u4").tobytes())
    np.array([0, 1, 2], np.uint32).astype("<u4").tofile(base + ".dict")
    with pytest.raises(IOError):
        read_index_csr(base, use64=True)
