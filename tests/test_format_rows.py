"""Native row formatter vs the scalar-Python emission semantics.

kssd_format_rows (native/src/format_rows.cpp) replays the reference's
per-pair recompute + fprintf (/root/reference/src/dist.cpp:206-256,
591-686); these tests pin it byte-for-byte against the Python fallback
across both row formats, both distance formulas, both threshold modes,
and the group-chunked emission paths."""

import dataclasses
import os

import numpy as np
import pytest

from rabbitkssd.engine import dist_engine
from rabbitkssd.engine.dist_engine import (_containment_aaf, _d6,
                                               _jaccard_mash, dist_rows)
from rabbitkssd.formats import read_sketches
from rabbitkssd.native import NameBlob, format_rows, load_native

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def native():
    if load_native() is None:
        pytest.skip("native toolchain unavailable")


def _python_rows(ii, jj, cc, sizes_i, sizes_j, names_i, names_j,
                 kmer_size, max_dist, containment, strict, order):
    f = _containment_aaf if containment else _jaccard_mash
    rows = []
    for i, j, c in zip(ii, jj, cc):
        si, sj = int(sizes_i[i]), int(sizes_j[j])
        jorc, d = f(int(c), si, sj, kmer_size)
        if (d < max_dist) if strict else (d <= max_dist):
            if order:
                rows.append(f"{names_i[i]}\t{names_j[j]}\t{c}|{sj}|{si}"
                            f"\t{_d6(jorc)}\t{_d6(d)}\n")
            else:
                rows.append(f"{names_j[j]}\t{names_i[i]}\t{c}|{si}|{sj}"
                            f"\t{_d6(jorc)}\t{_d6(d)}\n")
        else:
            rows.append("")
    return rows


@pytest.mark.parametrize("containment", [False, True])
@pytest.mark.parametrize("strict,order", [(True, 0), (False, 1)])
def test_format_rows_matches_python(native, containment, strict, order):
    rng = np.random.default_rng(42 + order + 2 * containment)
    ni, nj, n = 37, 53, 4000
    names_i = [f"/d/q{k}.fa" for k in range(ni)]
    names_j = [f"/d/ref_{k}.fna.gz" for k in range(nj)]
    sizes_i = rng.integers(1, 3000, ni).astype(np.int64)
    sizes_j = rng.integers(1, 3000, nj).astype(np.int64)
    ii = rng.integers(0, ni, n).astype(np.int32)
    jj = rng.integers(0, nj, n).astype(np.int32)
    # counts hugging the threshold + exact 0 / min / equal-size corners
    cc = np.minimum(sizes_i[ii], sizes_j[jj])
    cc = (cc * rng.random(n) ** 3).astype(np.int32)
    cc[: n // 8] = 0
    cc[n // 8 : n // 4] = np.minimum(sizes_i[ii], sizes_j[jj])[
        n // 8 : n // 4].astype(np.int32)
    for max_dist in (0.05, 0.3, 1.0, 2.0):
        got = format_rows(ii, jj, cc, sizes_i, sizes_j,
                          NameBlob(names_i), NameBlob(names_j),
                          kmer_size=16, max_dist=max_dist,
                          containment=containment, strict=strict,
                          order=order)
        assert got is not None
        buf, row_len = got
        want = _python_rows(ii, jj, cc, sizes_i, sizes_j, names_i,
                            names_j, 16, max_dist, containment, strict,
                            order)
        cum = np.zeros(n + 1, np.int64)
        np.cumsum(row_len, out=cum[1:])
        assert buf.decode() == "".join(want)
        for t in (0, n // 3, n - 1):
            assert buf[cum[t]:cum[t + 1]].decode() == want[t]


def _collect(gen):
    """Split a row-generator stream into (markers, text)."""
    marks, rows = [], []
    for x in gen:
        (marks if isinstance(x, int) else rows).append(x)
    return marks, "".join(rows)


@pytest.mark.parametrize("max_dist", [0.6, 1.0])
def test_dist_rows_chunked_matches_scalar(native, monkeypatch, max_dist):
    """Group-chunked native dist emission == the per-row Python path,
    across a forced chunk boundary and with the j==0 -> d=1.0 rows in
    (max_dist=1.0, dist's ``<=`` keeps them)."""
    ref = read_sketches(os.path.join(GOLDEN, "fa_k8s4l1.sketch"))
    reps = []
    for r in range(9):
        for s in ref.sketches:
            reps.append(dataclasses.replace(
                s, name=f"{s.name}#{r}",
                hashes=s.hashes[min(r, max(0, s.hashes.size - 2)):]))
    query = dataclasses.replace(ref, sketches=reps)
    qh = [s.hashes for s in query.sketches]
    rh = [s.hashes for s in ref.sketches]
    common = dist_engine._counts(qh, rh)
    k = 2 * ref.info.half_k

    monkeypatch.setattr(dist_engine, "_ROWGROUP_CELLS", 16)  # ~3 rows/grp
    got = _collect(dist_rows(ref, query, common, k, max_dist, False))
    # scalar fallback: pretend the toolchain is gone (dist_rows gates
    # the native path on load_native() ONCE, before any group — a
    # mid-loop fallback would duplicate already-yielded rows)
    import rabbitkssd.native as native_mod

    monkeypatch.setattr(native_mod, "load_native", lambda: None)
    monkeypatch.setattr(native_mod, "format_rows",
                        lambda *a, **kw: None)
    want = _collect(dist_rows(ref, query, common, k, max_dist, False))
    assert got == want
    assert got[0] == list(range(len(reps)))


def test_alldist_rows_chunked_matches_scalar(native, monkeypatch):
    ref = read_sketches(os.path.join(GOLDEN, "fa_k8s4l1.sketch"))
    reps = []
    for r in range(7):
        for s in ref.sketches:
            reps.append(dataclasses.replace(s, name=f"{s.name}#{r}"))
    big = dataclasses.replace(ref, sketches=reps)
    common = dist_engine._counts([s.hashes for s in big.sketches],
                                 [s.hashes for s in big.sketches])
    k = 2 * ref.info.half_k

    monkeypatch.setattr(dist_engine, "_ROWGROUP_CELLS", 16)
    got = _collect(dist_engine.alldist_rows(big, common, k, 0.8, False))
    import rabbitkssd.native as native_mod

    monkeypatch.setattr(native_mod, "format_rows",
                        lambda *a, **kw: None)
    want = _collect(dist_engine.alldist_rows(big, common, k, 0.8, False))
    assert got == want
    assert got[0] == list(range(len(reps)))
