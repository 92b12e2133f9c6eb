"""Distance pipelines: all-vs-all and ref-vs-query with exact reference output.

Re-design of ``index_tridist`` / ``index_dist``
(reference dist.cpp:22-343, 429-776).  The posting-list
intersection counting runs on device as chunked membership matmuls
(ops/distance.py) or on host as the native posting walk, by a cost
model (_use_walk); the float math + text emission run on host with the
reference's exact double semantics:

* jaccard = common / (size0 + size1 - common); containment uses
  min(size0, size1)  (dist.cpp:218-253)
* mashD = -1/kmer_size * log(2j / (1+j)); aafD = -1/kmer_size * log(c);
  the 0/1 special cases short-circuit (dist.cpp:225-231)
* emitted with C++ ``std::to_string`` 6-decimal fixed formatting, rows
  ``genome_j\\tgenome_i\\tcommon|size0|size1\\t...`` (dist.cpp:233-235);
  header has a leading space (dist.cpp:291,725)
* alldist threshold is strict ``< maxDist`` (dist.cpp:232); dist is
  ``<= maxDist`` (dist.cpp:624) — an intentional reference quirk
* top-N nearest neighbors replicate std::priority_queue pop order
  exactly (utils/stdheap.py)
* outputs > 4 GiB are left as an ``<out>.dir/`` directory of part files
  plus an ``<out>.index`` genome->file map (dist.cpp:276-341)

Bulk rows are pre-filtered with vectorized float64 numpy (with an ulp
safety margin), then each surviving row is recomputed with scalar
``math.log`` — the same glibc libm call the reference makes — so emitted
text is bit-identical.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys

import numpy as np

from ..formats import SketchSet
from ..ops.distance import common_counts
from ..utils.stdheap import StdPriorityQueue

MAX_SINGLE_FILE = 1 << 32  # 4 GiB split threshold (dist.cpp:277,711)
# cells (count entries) per vectorized emission group: bounds the
# candidate-mask / format-buffer temporaries in the row generators to
# ~128 MB regardless of corpus width (tests shrink it to force chunking)
_ROWGROUP_CELLS = 1 << 24
HEADER = " genome0\tgenome1\tcommon|size0|size1\tjaccard\tmashD\n"


def _d6(x: float) -> str:
    """C++ std::to_string(double): fixed 6 decimals."""
    return f"{x:.6f}"


def _jaccard_mash(common: int, size0: int, size1: int, kmer_size: int
                  ) -> tuple[float, float]:
    denom = size0 + size1 - common
    jaccard = 0.0 if (size0 == 0 or size1 == 0) else common / denom
    if jaccard == 1.0:
        mash = 0.0
    elif jaccard == 0.0:
        mash = 1.0
    else:
        mash = (-1.0 / kmer_size) * math.log((2 * jaccard) / (1.0 + jaccard))
    return jaccard, mash


def _containment_aaf(common: int, size0: int, size1: int, kmer_size: int
                     ) -> tuple[float, float]:
    denom = min(size0, size1)
    cont = 0.0 if (size0 == 0 or size1 == 0) else common / denom
    if cont == 1.0:
        aaf = 0.0
    elif cont == 0.0:
        aaf = 1.0
    else:
        aaf = (-1.0 / kmer_size) * math.log(cont)
    return cont, aaf


def _bulk_dist(common_row: np.ndarray, size0, size1, kmer_size: int,
               containment: bool) -> np.ndarray:
    """Vectorized float64 distances for pre-filtering (not for emission)."""
    c = common_row.astype(np.float64)
    s0 = np.asarray(size0, np.float64)
    s1 = np.asarray(size1, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        if containment:
            j = np.where((s0 == 0) | (s1 == 0), 0.0, c / np.minimum(s0, s1))
            d = (-1.0 / kmer_size) * np.log(np.maximum(j, 1e-300))
        else:
            j = np.where((s0 == 0) | (s1 == 0), 0.0,
                         c / (s0 + s1 - c))
            d = (-1.0 / kmer_size) * np.log(
                np.maximum((2 * j) / (1.0 + j), 1e-300)
            )
    d = np.where(j == 1.0, 0.0, d)
    d = np.where(j == 0.0, 1.0, d)
    return d


# safety margin for the ulp difference between np.log and math.log
_EPS = 1e-9


def _candidate_mask(cblk: np.ndarray, s0, s1, kmer_size: int,
                    max_dist: float, containment: bool,
                    strict: bool = True) -> np.ndarray:
    """Vectorized candidate SUPERSET of ``dist {<,<=} max_dist``.

    mashD/aafD are strictly decreasing in jaccard/containment, so the
    float test inverts to one integer-count comparison per pair — no
    logs on the hot prefilter (surviving candidates are recomputed with
    the exact scalar libm semantics before emission):

      mash: d < D  <=>  j > jt,  jt = e^{-kD} / (2 - e^{-kD})
            c/(s0+s1-c) > jt     <=>  c*(1+jt) > jt*(s0+s1)
      aaf:  c/min(s0,s1) > e^{-kD}

    jt is slackened low so boundary/ulp cases stay in the superset.
    The ``j == 0 -> d := 1.0`` special case (dist.cpp:227-231) breaks
    monotonicity: zero-count pairs emit iff ``1.0 {<,<=} max_dist``
    (exact f64, no slack needed — d is exactly 1.0 by construction;
    ``strict`` selects alldist's ``<`` vs dist's ``<=``, dist.cpp:232
    vs :624).
    """
    ekd = math.exp(-kmer_size * max_dist) * (1.0 - 1e-9)
    c = cblk.astype(np.float64)
    if containment:
        mask = c >= ekd * np.minimum(s0, s1)
    else:
        jt = ekd / (2.0 - ekd)
        mask = c * (1.0 + jt) >= jt * (s0 + s1)
    if (1.0 < max_dist) if strict else (1.0 <= max_dist):
        mask |= cblk == 0
    return mask


def _alldist_block_rows(names, sizes, common_blk: np.ndarray, i0: int,
                        kmer_size: int, max_dist: float,
                        containment: bool, step: int, blob=None):
    """Upper-triangle rows for global genomes [i0, i0+R) given their
    count rows vs ALL genomes (common_blk [R, n]).

    The ``< maxDist`` prefilter is vectorized over row GROUPS of the
    strip (a per-row loop costs minutes at 100k genomes; the group
    height bounds temporaries to ~128 MB), and ``np.nonzero``'s
    row-major order makes emission i-major with j ascending — the
    reference's deterministic row order (dist.cpp:206-256).  Surviving
    candidates are recomputed with the exact libm semantics — by the
    native formatter (one call per group, same glibc log/printf the
    reference binary uses) or the scalar-Python fallback.

    Yields an int genome marker before each genome's rows — the
    :func:`_write_rows` part-index protocol (every genome in [i0,
    i0+R) yields exactly one marker, rows or not)."""
    n = len(names)
    R = common_blk.shape[0]
    f = _containment_aaf if containment else _jaccard_mash
    include_zero = 1.0 < max_dist  # j==0 -> d := 1.0 emits iff 1.0 < D
    rg = max(1, _ROWGROUP_CELLS // max(n, 1))  # rows per group
    for g0 in range(0, R, rg):
        g1 = min(R, g0 + rg)
        cblk = common_blk[g0:g1]
        if include_zero:
            bi_nz, j_nz = np.nonzero(
                np.arange(n)[None, :]
                > i0 + g0 + np.arange(g1 - g0)[:, None]
            )
        else:
            # candidates need common > 0: gather only the in-triangle
            # nonzero entries (j > i0 + g0 + row; also keeps the scan
            # off the j < i0 strip region the col_lo-trimmed walk
            # leaves stale).  Native: one multithreaded two-pass scan
            # emitting (row, j, count) triples i-major / j-ascending;
            # numpy nonzero + triangle filter is the fallback.
            from ..native import scan_nonzero

            got = (scan_nonzero(cblk, i0 + g0)
                   if cblk.dtype == np.int32
                   and cblk.flags["C_CONTIGUOUS"] else None)
            if got is not None:
                bi_nz, j_nz, vals = got
            else:
                jmin = i0 + g0 + 1
                bi_nz, j_nz = np.nonzero(cblk[:, jmin:])
                j_nz += jmin
                tri = j_nz > i0 + g0 + bi_nz
                bi_nz, j_nz = bi_nz[tri], j_nz[tri]
                vals = cblk[bi_nz, j_nz]
        if include_zero:
            vals = cblk[bi_nz, j_nz]
        yield from _emit_candidate_rows(names, sizes, bi_nz, j_nz, vals,
                                        i0 + g0, g1 - g0, kmer_size,
                                        max_dist, containment, step,
                                        blob, f)


def _emit_candidate_rows(names, sizes, bi_nz, j_nz, vals, gbase: int,
                         nrows: int, kmer_size: int, max_dist: float,
                         containment: bool, step: int, blob, f):
    """The _write_rows marker/row protocol for global genome rows
    [gbase, gbase + nrows) given their in-triangle nonzero count
    triples (``bi_nz`` row-local to gbase, ``j_nz`` global, i-major /
    j-ascending) — the shared emission tail of the dense-strip scan and
    the sparse collect path."""
    from ..native import NameBlob, format_rows

    sel = _candidate_mask(vals, sizes[gbase + bi_nz], sizes[j_nz],
                          kmer_size, max_dist, containment,
                          strict=True)
    bi_s, j_s, v_s = bi_nz[sel], j_nz[sel], vals[sel]
    # candidate run boundaries per row (bi_s is sorted: row-major)
    bounds = np.searchsorted(bi_s, np.arange(nrows + 1))
    if blob is None:
        blob = NameBlob(names)
    fmt = format_rows((gbase + bi_s).astype(np.int32), j_s, v_s,
                      sizes, sizes, blob, blob, kmer_size, max_dist,
                      containment, strict=True, order=0)
    if fmt is not None:
        buf, row_len = fmt
        cum = np.zeros(row_len.size + 1, np.int64)
        np.cumsum(row_len, out=cum[1:])
        for r in range(nrows):
            i = gbase + r
            if i % step == 0:
                print(f"=====finish: {i}", file=sys.stderr)
            yield i
            blo = int(cum[bounds[r]])
            bhi = int(cum[bounds[r + 1]])
            if bhi > blo:
                yield buf[blo:bhi].decode("utf-8")
        return
    for r in range(nrows):
        i = gbase + r
        if i % step == 0:
            print(f"=====finish: {i}", file=sys.stderr)
        yield i
        si = int(sizes[i])
        for t in range(int(bounds[r]), int(bounds[r + 1])):
            j = int(j_s[t])
            c = int(v_s[t])
            jorc, d = f(c, si, int(sizes[j]), kmer_size)
            if d < max_dist:
                yield (
                    f"{names[j]}\t{names[i]}\t{c}|"
                    f"{si}|{int(sizes[j])}\t{_d6(jorc)}\t{_d6(d)}\n"
                )


def _alldist_triples_rows(names, sizes, triples, nrows: int, i0: int,
                          n: int, kmer_size: int, max_dist: float,
                          containment: bool, step: int, blob):
    """Strip emission from precomputed sparse triples (collect_triples):
    the dense scan's row grouping is kept only to bound format_rows
    temporaries; the triples are already i-major / j-ascending /
    upper-triangle."""
    bi, j, v = triples
    f = _containment_aaf if containment else _jaccard_mash
    rg = max(1, _ROWGROUP_CELLS // max(n, 1))
    for g0 in range(0, nrows, rg):
        g1 = min(nrows, g0 + rg)
        lo, hi = np.searchsorted(bi, [g0, g1])
        yield from _emit_candidate_rows(names, sizes, bi[lo:hi] - g0,
                                        j[lo:hi], v[lo:hi], i0 + g0,
                                        g1 - g0, kmer_size, max_dist,
                                        containment, step, blob, f)


def alldist_rows(sk: SketchSet, common: np.ndarray, kmer_size: int,
                 max_dist: float, containment: bool):
    """Yield exact output rows of index_tridist (upper triangle, i-major)."""
    from ..utils.timers import progress_bar_size

    names = [s.name for s in sk.sketches]
    sizes = np.array([s.size for s in sk.sketches], np.int64)
    n = len(names)
    step = progress_bar_size(n)
    print(f"=====total: {n}", file=sys.stderr)
    yield from _alldist_block_rows(names, sizes, common, 0, kmer_size,
                                   max_dist, containment, step)


@dataclasses.dataclass
class _Neighbor:
    ref_name: str
    common: int
    ref_size: int
    jorc: float
    dist: float


def _topn_heap(crow, bulk, rnames, rsizes, size1, kmer_size, max_dist,
               f, max_neighbor: int) -> StdPriorityQueue:
    """Exact replay of the reference's bounded top-N heap
    (dist.cpp:599,633-639,669-675) without the O(n_ref) Python loop.

    Two phases, both restricted to vectorized candidate sets:
    1. fill — only rows passing the ``<= maxDist`` filter can be pushed;
    2. replace — once full, the heap max ``v`` only ever DECREASES, so
       every future participant satisfies ``d < v_at_fill``; one
       ``nonzero`` over the bulk distances yields a candidate superset
       (with an ulp margin, since bulk uses np.log and emission
       math.log) replayed in arrival order with the exact scalar test.
    """
    queue: StdPriorityQueue[_Neighbor] = StdPriorityQueue(
        lambda a, b: a.dist < b.dist
    )

    def push_j(j: int) -> bool:
        c = int(crow[j])
        size0 = int(rsizes[j])
        jorc, d = f(c, size0, size1, kmer_size)
        if d > max_dist:
            return False
        if len(queue) < max_neighbor:
            queue.push(_Neighbor(rnames[j], c, size0, jorc, d))
            return True
        if d < queue.top().dist:
            queue.push(_Neighbor(rnames[j], c, size0, jorc, d))
            queue.pop()
            return True
        return False

    pass_j = np.nonzero(bulk <= max_dist + _EPS)[0]
    k = 0
    while k < pass_j.size and len(queue) < max_neighbor:
        push_j(int(pass_j[k]))
        k += 1
    if k < pass_j.size and len(queue) == max_neighbor:
        rest = pass_j[k:]
        v_fill = queue.top().dist
        for j in rest[bulk[rest] < v_fill + _EPS]:
            push_j(int(j))
    return queue


def dist_rows(ref: SketchSet, query: SketchSet, common: np.ndarray,
              kmer_size: int, max_dist: float, containment: bool,
              max_neighbor: int = 0, progress_offset: int = 0,
              progress_total: int | None = None):
    """Yield exact output rows of index_dist (query-major full rows).

    common: int32 [n_query, n_ref].  progress_offset/progress_total
    carry the global query numbering when called per query block
    (run_dist's two-axis-blocked path).
    """
    rnames = [s.name for s in ref.sketches]
    rsizes = np.array([s.size for s in ref.sketches], np.int64)
    qnames = [s.name for s in query.sketches]
    qsizes = np.array([s.size for s in query.sketches], np.int64)
    from ..utils.timers import progress_bar_size

    is_neighbor = max_neighbor > 0
    total = progress_total if progress_total is not None else len(qnames)
    step = progress_bar_size(total)
    if progress_offset == 0:
        print(f"=====total: {total}", file=sys.stderr)
    f = _containment_aaf if containment else _jaccard_mash

    if not is_neighbor:
        # vectorized emission over query-row GROUPS of the block (the
        # same ~128 MB temporary bound as _alldist_block_rows — one
        # whole-block mask + format buffer is unbounded when maxDist
        # admits everything): candidate mask -> i-major pairs -> one
        # native format call per group (dist's threshold is
        # ``<= maxDist``, strict=False; query name prints first with
        # size0 = ref size, order=1)
        from ..native import NameBlob, format_rows, load_native

        nr = len(rnames)
        qblob, rblob = NameBlob(qnames), NameBlob(rnames)
        rg = max(1, _ROWGROUP_CELLS // max(nr, 1))
        # native availability is decided ONCE, before any group is
        # emitted: a mid-loop fallback to the scalar path would restart
        # at query 0 and duplicate already-yielded markers/rows
        native_ok = load_native() is not None
        for g0 in range(0, len(qnames), rg) if native_ok else ():
            g1 = min(len(qnames), g0 + rg)
            mask = _candidate_mask(common[g0:g1], rsizes[None, :],
                                   qsizes[g0:g1, None], kmer_size,
                                   max_dist, containment, strict=False)
            ii, jj = np.nonzero(mask)
            vals = common[g0 + ii, jj]
            buf, row_len = format_rows(
                (g0 + ii).astype(np.int32),
                jj.astype(np.int32), vals, qsizes, rsizes,
                qblob, rblob, kmer_size, max_dist,
                containment, strict=False, order=1)
            cum = np.zeros(row_len.size + 1, np.int64)
            np.cumsum(row_len, out=cum[1:])
            bounds = np.searchsorted(ii, np.arange(g1 - g0 + 1))
            for r in range(g1 - g0):
                i = g0 + r
                if (progress_offset + i) % step == 0:
                    print(f"=====finish: {progress_offset + i}",
                          file=sys.stderr)
                yield progress_offset + i
                blo = int(cum[bounds[r]])
                bhi = int(cum[bounds[r + 1]])
                if bhi > blo:
                    yield buf[blo:bhi].decode("utf-8")
        if native_ok:
            return

    for i in range(len(qnames)):
        if (progress_offset + i) % step == 0:
            print(f"=====finish: {progress_offset + i}", file=sys.stderr)
        yield progress_offset + i  # _write_rows part-index marker
        size1 = int(qsizes[i])
        crow = common[i]
        if is_neighbor:
            bulk = _bulk_dist(crow, rsizes, size1, kmer_size, containment)
            queue = _topn_heap(crow, bulk, rnames, rsizes, size1,
                               kmer_size, max_dist, f, max_neighbor)
            while len(queue):
                t = queue.pop()
                yield (
                    f"{qnames[i]}\t{t.ref_name}\t{t.common}|{t.ref_size}|"
                    f"{size1}\t{_d6(t.jorc)}\t{_d6(t.dist)}\n"
                )
            continue
        cand = _candidate_mask(crow, rsizes, size1, kmer_size, max_dist,
                               containment, strict=False)
        for j in np.nonzero(cand)[0]:
            j = int(j)
            c = int(crow[j])
            size0 = int(rsizes[j])
            jorc, d = f(c, size0, size1, kmer_size)
            if d <= max_dist:
                yield (
                    f"{qnames[i]}\t{rnames[j]}\t{c}|{size0}|{size1}\t"
                    f"{_d6(jorc)}\t{_d6(d)}\n"
                )


def _strip_part0_header(path: str) -> None:
    """Drop the HEADER bytes written at part-0 open (the reference's
    part files carry no header, dist.cpp:153-156) — a one-time copy of
    at most one part, paid only on >4 GiB outputs."""
    tmp = path + ".strip"
    with open(path, "rb") as src, open(tmp, "wb") as dst:
        src.seek(len(HEADER))
        while True:
            buf = src.read(1 << 24)
            if not buf:
                break
            dst.write(buf)
    os.replace(tmp, path)


def _write_rows(rows, names: list[str], output_file: str) -> None:
    """Single-pass writer with the reference's 4 GiB split contract
    (dist.cpp:276-341).

    ``rows`` yields str rows interleaved with int genome markers (the
    global index of the genome whose rows follow; every processed
    genome yields exactly one marker).  Rows stream straight into part
    files under ``<out>.dir/`` — part 0 opens with the header so the
    common (<= 4 GiB) outcome is a rename, not a copy — rolling to a
    new part at a genome boundary whenever the current part would
    exceed 4 GiB, so no part file ever does (unless a single genome's
    rows alone do).  Oversized outputs are left as the part directory
    plus an ``<out>.index`` mapping each genome to the part holding
    its rows (reference dist.cpp:178,316-338: one index line per
    genome, pointing at the subfile its thread owned).  Markerless
    streams are accepted (single part; every genome maps to it).
    """
    folder = output_file + ".dir"
    base = os.path.basename(output_file)
    os.makedirs(folder, exist_ok=True)
    parts: list[str] = []
    fp = None
    cur = 0    # row bytes in the current part (part 0's header excluded)
    total = 0  # row bytes overall — the reference's merge test input
    owner: dict[int, int] = {}  # genome index -> part index
    buf: list[str] = []
    bb = 0
    pending: int | None = None

    def open_part() -> None:
        nonlocal fp, cur
        if fp is not None:
            fp.close()
        path = os.path.join(folder, f"{base}.{len(parts)}")
        parts.append(path)
        fp = open(path, "w")
        if len(parts) == 1:
            fp.write(HEADER)  # stripped again iff the output splits
        cur = 0

    open_part()

    def flush() -> None:
        """Write the pending genome's buffered rows (rolling parts at
        this genome boundary if needed) and record its part."""
        nonlocal bb, cur, total, buf, pending
        if bb and cur and cur + bb > MAX_SINGLE_FILE:
            open_part()
        if buf:
            fp.write("".join(buf))
            cur += bb
            total += bb
            buf = []
            bb = 0
        if pending is not None:
            owner[pending] = len(parts) - 1
            pending = None

    for item in rows:
        if type(item) is str:
            buf.append(item)
            bb += len(item)
        else:
            flush()
            pending = item
    flush()
    fp.close()

    if total <= MAX_SINGLE_FILE and len(parts) == 1:
        os.replace(parts[0], output_file)
        os.rmdir(folder)
        return
    _strip_part0_header(parts[0])
    with open(output_file + ".index", "w") as f:
        f.write("genomeName\tdistFileName\n")
        for gi, name in enumerate(names):
            f.write(f"{name}\t{parts[owner.get(gi, 0)]}\n")


def _counts(hashes0, hashes1, vocab0=None):
    """Intersection counts, sharded over the device mesh when more than
    one device is attached (dp rows x vp vocabulary, psum over vp)."""
    import jax

    if len(jax.devices()) > 1:
        from ..parallel.sharded import make_mesh, sharded_common_counts

        return sharded_common_counts(hashes0, hashes1, make_mesh(),
                                     vocab0=vocab0)
    return common_counts(hashes0, hashes1, vocab0=vocab0)


def _sort_postings(allh: np.ndarray, gids: np.ndarray):
    """Stable sort of (hash, genome) pairs by hash — the inverted-index
    build's only super-linear step.  Native multithreaded radix sort
    when the toolchain is available (hashes < 2^32 pack the gid into the
    key's payload bits; wider hashes permute the gid as a value);
    np.argsort otherwise.  Returns (sorted_hashes, permuted_gids)."""
    if allh.size == 0:
        return allh, gids
    from ..native import radix_sort_kv64, radix_sort_u64

    hmax = int(allh.max())
    bits = max(1, hmax.bit_length())
    if hmax < (1 << 32):
        keys = (allh.astype(np.uint64) << np.uint64(32)) | gids.astype(
            np.uint64)
        got = radix_sort_u64(keys, 32, 32 + bits)
        if got is not None:
            return ((got >> np.uint64(32)).astype(allh.dtype),
                    (got & np.uint64(0xFFFFFFFF)).astype(np.int32))
    else:
        got = radix_sort_kv64(allh.astype(np.uint64),
                              gids.astype(np.uint64), 0, bits)
        if got is not None:
            sk, sv = got
            return sk.astype(allh.dtype, copy=False), sv.astype(np.int32)
    order = np.argsort(allh, kind="stable")
    return allh[order], gids[order]


class _CsrIndex:
    """A loaded ``.index``/``.dict`` inverted index, flattened to
    column-major (genome, column) membership pairs.

    Consuming the persisted index (reference dist.cpp:83-130) skips the
    ref-side vocabulary rebuild (np.unique over every hash) on repeat
    distance runs; tiles are genome-range filters of the global pair
    list, then remapped onto the tile's shared-column vocabulary and fed
    to the same chunked matmul loop as the recompute path.

    Memory envelope: the resident pair arrays (gids + cols) cost
    ~8 bytes/nnz, i.e. ~1.2 GB at config-5 scale (100k genomes x
    ~1.5k hashes = 150M nnz) and ~12 GB at 1M genomes — host RAM, not
    device memory.  There is deliberately no disk-spill path: the reference
    streams its whole .dict into RAM too (dist.cpp:107-130), so parity
    holds, and a corpus whose nnz outgrows host RAM should shard
    genomes across hosts (parallel/sharded.py) rather than thrash one.
    """

    def __init__(self, vocab, offsets, postings, cols=None):
        self.vocab = vocab
        # int32 throughout while it fits: vocab positions, genome ids
        # and (usually) posting offsets are < 2^31 — these arrays
        # dominate the index's host footprint at config-5 scale
        odt = np.int64 if postings.size > (1 << 31) - 1 else np.int32
        self.offsets = np.asarray(offsets, odt)
        self.cols = (cols if cols is not None else np.repeat(
            np.arange(len(vocab), dtype=np.int32), np.diff(offsets)
        ))
        self.gids = postings.astype(np.int32, copy=False)

    @classmethod
    def from_hashes(cls, hashes: list[np.ndarray]) -> "_CsrIndex":
        """Build the inverted index in memory from per-genome sorted
        hash sets — the reference's transSketches (sketch.cpp:894-1021)
        as one stable sort: postings grouped by hash value, genome ids
        ascending within a hash (stable sort over genome-major input).

        The sort is the config-5 hot build (nnz ~1.5e8 pairs), so it
        runs as the native multithreaded radix sort when available —
        hashes < 2^32 pack (hash << 32 | gid) into one u64 keystream
        sorted by its hash bits only (gid rides in the payload bits);
        true 64-bit hashes take the key/value variant.  np.argsort is
        the toolchain-free fallback.
        """
        sizes = np.fromiter((h.size for h in hashes), np.int64,
                            len(hashes))
        allh = (np.concatenate(hashes) if len(hashes)
                else np.empty(0, np.uint64))
        if allh.size:
            from ..native import build_postings

            bits = max(1, int(allh.max()).bit_length())
            got = build_postings(allh, sizes, bits)
            if got is not None:
                sh, sg, cols, offsets = got
                # the native build narrows <=32-bit hashes to uint32;
                # keep the caller's dtype so query_pairs' searchsorted
                # never promotes+copies the vocab per call
                vocab = sh[offsets[:-1]].astype(allh.dtype, copy=False)
                return cls(vocab, offsets, sg, cols=cols)
        gids = np.repeat(np.arange(len(hashes), dtype=np.int32), sizes)
        sh, sg = _sort_postings(allh, gids)
        del allh, gids
        # run boundaries of the SORTED hashes (np.unique would sort a
        # second time)
        if sh.size:
            flags = np.empty(sh.size, bool)
            flags[0] = True
            np.not_equal(sh[1:], sh[:-1], out=flags[1:])
            starts = np.flatnonzero(flags)
            vocab = sh[starts]
            offsets = np.empty(len(starts) + 1, np.int64)
            offsets[:-1] = starts
            offsets[-1] = sh.size
        else:
            vocab = sh
            offsets = np.zeros(1, np.int64)
        return cls(vocab, offsets, sg)

    def side_pairs(self, j0: int, j1: int):
        """Pairs for genomes [j0, j1) (cols stay globally sorted)."""
        m = (self.gids >= j0) & (self.gids < j1)
        return (self.gids[m] - j0).astype(np.int32), self.cols[m]

    def strip_runs(self, block: int, n_genomes: int):
        """All strips' pairs from ONE stable counting-sort pass by strip
        id (a boolean scan of the full pair list per strip costs ~2
        passes/strip — minutes at config-5 scale).  Stability keeps
        cols sorted within each strip (the global order is
        column-major).  Returns (g, c, bounds): strip k's pairs are
        ``g[bounds[k]:bounds[k+1]]`` (GLOBAL genome ids), same for c."""
        from ..native import partition_pairs

        n_strips = -(-n_genomes // block)
        got = partition_pairs(self.gids, self.cols, block, n_strips)
        if got is not None:
            return got
        strip = self.gids // block
        order = np.argsort(strip, kind="stable")
        g = self.gids[order]
        c = self.cols[order]
        bounds = np.searchsorted(strip[order], np.arange(n_strips + 1))
        return g, c, bounds

    def walk_layout(self, row_pairs):
        """Join layout of row-side pairs vs ALL this index's genomes:
        the reference's per-row posting walk (dist.cpp:174-204)
        prepared for the native kernel — side-1 runs come straight
        from the index offsets (no per-strip unique over the full
        posting list).  row_pairs: (local row ids int32, vocab column
        ids, column-sorted)."""
        g0, c0 = row_pairs
        # c0 is already column-sorted (strip_runs / _memberships both
        # guarantee it): run boundaries via flag-diff instead of
        # np.unique's second sort
        if c0.size:
            flags = np.empty(c0.size, bool)
            flags[0] = True
            np.not_equal(c0[1:], c0[:-1], out=flags[1:])
            s0 = np.flatnonzero(flags)
            u0 = c0[s0]
            k0 = np.diff(np.append(s0, c0.size))
        else:
            u0 = np.empty(0, c0.dtype)
            s0 = np.empty(0, np.int64)
            k0 = np.empty(0, np.int64)
        s1 = self.offsets[u0]
        k1 = self.offsets[u0 + 1] - s1
        total = int(np.sum(k0 * k1, dtype=np.int64))
        return g0, (u0, s0, k0.astype(np.int64), s1, k1, total)

    def collect_triples(self, layout_pack, n_rows: int, n1: int,
                        diag: int):
        """Sparse strip counting: the same join the dense walk performs,
        but expanded to packed i*n1+j keys, radix-sorted, and
        run-length-counted into (row, col, count) triples — i-major,
        j-ascending, upper-triangle (j > diag + i) only.

        Memory traffic is O(join) instead of the walk's O(n_rows * n1)
        strip memset + emission scan; at 1M genomes the dense traffic is
        ~4 TB across the run while the join is ~2G pairs.  Returns None when the native toolchain
        is unavailable (callers fall back to the dense walk)."""
        from ..native import pair_collect, radix_sort_u64

        g0, (u0, s0, k0, s1, k1, total) = layout_pack
        keys = pair_collect(g0, s0, k0, self.gids, s1, k1, n1, diag)
        if keys is None:
            return None
        empty = (np.empty(0, np.int32), np.empty(0, np.int32),
                 np.empty(0, np.int32))
        if keys.size == 0:
            return empty
        bits = max(1, int(n_rows * n1 - 1).bit_length())
        skeys = radix_sort_u64(keys.view(np.uint64), 0, bits)
        if skeys is None:  # toolchain raced away mid-call
            skeys = np.sort(keys.view(np.uint64))
        flags = np.empty(skeys.size, bool)
        flags[0] = True
        np.not_equal(skeys[1:], skeys[:-1], out=flags[1:])
        starts = np.flatnonzero(flags)
        v = np.diff(np.append(starts, skeys.size)).astype(np.int32)
        uk = skeys[starts]
        bi = (uk // np.uint64(n1)).astype(np.int32)
        j = (uk % np.uint64(n1)).astype(np.int32)
        return bi, j, v

    def walk(self, blk: np.ndarray, layout_pack, col_lo: int = 0) -> None:
        """Count the layout's rows vs all genomes into blk int32[bi, n]
        (native posting walk; numpy expansion fallback).  col_lo > 0
        restricts counting + zeroing to columns >= col_lo — the
        upper-triangle trim (blk[:, :col_lo] keeps stale contents)."""
        from ..ops.distance import _pair_counts_host

        g0, layout = layout_pack
        _pair_counts_host(g0, None, self.gids, None, blk.shape[0],
                          blk.shape[1], layout=layout, out=blk,
                          col_lo=col_lo)

    def query_pairs(self, q_hashes: list[np.ndarray]):
        """Membership pairs of query hash arrays against the index vocab."""
        from ..ops.distance import _memberships

        return _memberships(q_hashes, self.vocab)

    @staticmethod
    def counts(pairs0, pairs1, n0: int, n1: int) -> np.ndarray:
        """Tile counts over the two sides' shared columns."""
        from ..ops.distance import pair_counts

        g0, c0 = pairs0
        g1, c1 = pairs1
        shared = np.intersect1d(np.unique(c0), np.unique(c1))
        if shared.size == 0:
            return np.zeros((n0, n1), np.int32)

        def remap(g, c):
            idx = np.searchsorted(shared, c)
            idx = np.minimum(idx, shared.size - 1)
            m = shared[idx] == c
            return g[m], idx[m]

        g0, c0 = remap(g0, c0)
        g1, c1 = remap(g1, c1)
        return pair_counts(g0, c0, g1, c1, n0, n1, shared.size)


def _load_csr(sketch_path: str | None, use64: bool,
              payload_nnz: int = 0) -> _CsrIndex | None:
    """Load the persisted index for single-device runs (the sharded
    mesh path keeps its own vocabulary partitioning).

    KSSD_USE_INDEX: ``0`` never, ``1`` always, unset = auto.  Auto
    consumes the index unless it is a 32-bit DENSE index (one slot per
    hash in the 16^(half_k-drlevel) space, reference sketch.cpp:971)
    far larger than the actual posting payload — scanning a 1 GiB
    counts array to save a sort over a few-MB sketch loses; the
    sparse 64-bit index is always proportional to the data.
    """
    mode = os.environ.get("KSSD_USE_INDEX", "auto")
    if sketch_path is None or mode == "0":
        return None
    import jax

    if mode != "1" and len(jax.devices()) > 1:
        return None
    if mode != "1" and not use64:
        try:
            index_bytes = os.path.getsize(sketch_path + ".index")
        except OSError:
            return None
        if index_bytes > max(1 << 26, 32 * payload_nnz):
            return None
    from ..formats import read_index_csr

    got = read_index_csr(sketch_path, use64)
    if got is None:
        return None
    csr = _CsrIndex(*got)
    # staleness guard: the reference TRUSTS whatever .index/.dict sit
    # next to the sketch (dist.cpp:83-130) — combined with its
    # nondeterministic union/merge hash order, a stale index silently
    # miscounts (observed: jaccard > 1).  Our artifacts are
    # deterministic so ours never go stale by rerunning, but a
    # hand-edited sketch would still desync: reject when the posting
    # payload no longer matches the sketch nnz and rebuild in memory.
    if payload_nnz and csr.gids.size != payload_nnz:
        return None
    return csr


def _small_n_walk(hashes, n: int) -> bool:
    """Whether the below-one-block path should build an in-memory index
    and let _use_walk cost-dispatch (single-device backends only: on a
    mesh the small-n path stays on sharded_common_counts, which is the
    multi-process distance contract the multihost tests pin)."""
    import jax

    if len(jax.devices()) > 1:
        return False
    return os.environ.get("KSSD_DIST_PATH", "auto") != "matmul"


def _use_sparse_strip(layout_pack, bi: int, n1: int, col_lo: int,
                      include_zero: bool) -> bool:
    """Dispatch between dense strip counting (walk/matmul into a
    [bi, n1] buffer + full scan) and the sparse expand/sort/run-length
    path (collect_triples).

    Dense costs ~8 bytes of memory traffic per strip CELL (memset +
    emission scan); sparse costs ~20-30 bytes per JOINED PAIR (append +
    2-3 radix passes + run-length).  The crossover is join ~ cells/4;
    dispatch at cells/8 to keep the well-measured dense path for
    everything but clearly sparse strips (1M-genome regime: join is
    ~0.02% of cells).  include_zero (max_dist >= 1) must stay dense —
    emission then needs every in-triangle cell, not just nonzeros.
    KSSD_STRIP_MODE in {auto, dense, sparse} overrides."""
    mode = os.environ.get("KSSD_STRIP_MODE", "auto")
    if mode == "dense" or include_zero:
        return False
    if mode == "sparse":
        return True
    _, layout = layout_pack
    join = layout[-1] * (n1 - col_lo) / max(n1, 1)
    cells = bi * max(n1 - col_lo, 1)
    return join * 8 < cells


# Cost model of _use_walk, fitted with scripts/perf_probe.py --rates on
# an NVIDIA H100 80GB HBM3 at its 700 W power limit (host: 16 cores) over
# seven all-vs-all strips, from an 8-genome tile to a config-5 tile
# (PERF.md):
#   walk   = _WALK_FIXED_S + join / _WALK_RATE
#   matmul = _MATMUL_FIXED_S + vocab * _MATMUL_COL_S + flop / _MATMUL_RATE
# The per-column term is the membership build and transfer, which
# dominates the device matmul unless the genomes share most of their
# sketch (outbreak isolates: 256 or 1024 genomes sharing 98 %, where it
# measured 1.35-1.7x faster than the walk).
_WALK_FIXED_S = 1.8e-3
_WALK_RATE = 9.1e9
_MATMUL_FIXED_S = 1.7e-3
_MATMUL_COL_S = 3.8e-7
_MATMUL_RATE = 8.0e11


def _use_walk(layout_pack, bi: int, n1: int, col_lo: int = 0) -> bool:
    """Cost-model dispatch between the native posting walk (the
    reference's dist.cpp:174-204 algorithm) and the device membership
    matmuls for one strip.

    The walk costs O(join) memory-speed increments; the matmul costs a
    membership build per vocabulary column plus O(bi * n1 * vocab)
    flops, each on top of a fixed cost.  KSSD_DIST_PATH in {auto, walk,
    matmul} overrides; the rates are overridden by KSSD_WALK_RATE and
    KSSD_MATMUL_RATE.  CPU backends always walk (the matmul pays the
    same flops at scalar speed).
    """
    mode = os.environ.get("KSSD_DIST_PATH", "auto")
    if mode == "walk":
        return True
    if mode == "matmul":
        return False
    import jax

    if jax.default_backend() == "cpu":
        return True
    _, layout = layout_pack
    # col_lo trims side-1 postings below it inside the walk; scale the
    # join estimate by the surviving column fraction (uniform approx)
    join = layout[-1] * (n1 - col_lo) / max(n1, 1)
    width = len(layout[0])  # strip vocab size
    walk_s = _WALK_FIXED_S + join / float(
        os.environ.get("KSSD_WALK_RATE", _WALK_RATE))
    matmul_s = (_MATMUL_FIXED_S + width * _MATMUL_COL_S
                + 2.0 * bi * (n1 - col_lo) * width
                / float(os.environ.get("KSSD_MATMUL_RATE", _MATMUL_RATE)))
    return walk_s < matmul_s


def _auto_block(n_cols: int = 0) -> int:
    """Genome-axis block size bounding device AND host strip memory.

    The membership matmul for a (B0, B1) tile over a W-column vocab
    chunk holds (B0p + B1p) * W bf16 + B0p * B1p int32 on device —
    pair_counts additionally caps W by ops.distance.mem_budget(), so
    the default block never runs the device out of memory.  The HOST
    side holds two
    [block, n_cols] int32 strips (double-buffered counting/emission),
    so the block also shrinks to keep those under ~2 GiB total at
    million-genome column counts (KSSD_STRIP_BYTES).  Overridable via
    KSSD_DIST_BLOCK.
    """
    env = os.environ.get("KSSD_DIST_BLOCK")
    if env:
        return max(128, int(env))
    block = 8192
    if n_cols:
        strip_budget = int(os.environ.get("KSSD_STRIP_BYTES", 1 << 29))
        block = min(block, max(128, strip_budget // (4 * n_cols)))
    return block


def _tile_counts(common_blk: np.ndarray, row_hashes, col_hashes, i0: int,
                 bi: int, j_start: int, n: int, block: int) -> None:
    """Fill common_blk[:, j_start:] by (row, col)-blocked tiles.

    ``row_hashes`` provides rows i0..i0+bi; ``col_hashes`` the column
    genomes (the same list for alldist, the reference side for dist).
    Both genome axes are blocked so no membership matrix wider than
    ``block`` genomes ever materializes — the O(nnz)-style bounded
    footprint of the reference's posting-list walk
    (reference dist.cpp:174-204) — while each tile's counting
    still runs as matmuls over the tile pair's shared vocabulary.
    """
    blk = row_hashes[i0 : i0 + bi]
    # the row block's hash union is identical across all column tiles —
    # compute it once per strip instead of inside every _counts call
    row_vocab = (np.unique(np.concatenate(blk)) if blk
                 else np.empty(0, np.uint64))
    for j0 in range(j_start, n, block):
        j1 = min(n, j0 + block)
        common_blk[:, j0:j1] = _counts(blk, col_hashes[j0:j1],
                                       vocab0=row_vocab)


def run_alldist(sk: SketchSet, output_file: str, max_dist: float,
                containment: bool, index_path: str | None = None) -> None:
    """command_alldist engine (reference subCommand.cpp:149-200).

    Beyond one block the computation tiles BOTH genome axes: row-block
    I's counts against upper-triangle column blocks J >= I are computed
    tile-by-tile into a host [B, n] strip, then its rows emit before
    the next strip — neither an NxN counts matrix nor any [N, chunk]
    membership ever materializes (the 100k-genome config 5).

    index_path: a ``.sketch`` path whose ``.index``/``.dict`` exist —
    counting then consumes the persisted inverted index (both tile
    sides are genome-range filters of its posting lists; reference
    dist.cpp:83-130) instead of rebuilding membership from raw hashes.
    """
    hashes = [s.hashes for s in sk.sketches]
    kmer_size = 2 * sk.info.half_k
    names = [s.name for s in sk.sketches]
    n = len(hashes)
    block = _auto_block(n)
    csr = _load_csr(index_path, sk.use64,
                    payload_nnz=int(sum(h.size for h in hashes)))
    if n <= block:
        if csr is None and _small_n_walk(hashes, n):
            # cost-dispatch even below one block: the membership
            # matmul pays O(n^2 * vocab) flops + a [n, vocab] bf16
            # build — at low-drlevel configs the vocab is millions
            # wide while the posting-walk join is tens of millions of
            # memory-speed increments.  Build the in-memory index (one
            # nnz-sized sort) and let _use_walk choose.
            csr = _CsrIndex.from_hashes(hashes)
        if csr is not None:
            pairs = csr.side_pairs(0, n)
            lp = csr.walk_layout(pairs)
            walk = _use_walk(lp, n, n)
            if walk:
                common = np.empty((n, n), np.int32)
                csr.walk(common, lp)
            else:
                common = csr.counts(pairs, pairs, n, n)
        else:
            walk = False
            common = _counts(hashes, None)
        # auditable dispatch, like the blocked path's "strips:" line
        print(f"counting: {'walk' if walk else 'matmul'}", file=sys.stderr)
        rows = alldist_rows(sk, common, kmer_size, max_dist, containment)
        _write_rows(rows, names, output_file)
        return

    from ..utils.timers import phase, progress_bar_size

    sizes = np.array([s.size for s in sk.sketches], np.int64)
    step = progress_bar_size(n)
    print(f"=====total: {n}", file=sys.stderr)

    if csr is None:
        # build the inverted index in memory (the reference builds and
        # persists it before every alldist, subCommand.cpp:165-169) —
        # one argsort over the nnz; each strip is then one posting walk
        # or one set of matmul tiles, never per-tile re-deduplication
        with phase("transSketches (in-memory)"):
            csr = _CsrIndex.from_hashes(hashes)

    with phase("strip partition"):
        g_all, c_all, sbounds = csr.strip_runs(block, n)

    include_zero = 1.0 < max_dist

    def count_strip(strip, i0):
        bi = min(block, n - i0)
        sl = slice(sbounds[i0 // block], sbounds[i0 // block + 1])
        row_pairs = ((g_all[sl] - i0).astype(np.int32), c_all[sl])
        lp = csr.walk_layout(row_pairs)
        if _use_sparse_strip(lp, bi, n, i0, include_zero):
            # sparse strips: the dense walk + emission scan pay
            # O(bi * n) memory traffic per strip regardless of the join
            # size — at 1M genomes that is ~4 TB across the run for a
            # ~2G-pair join.  Expand/sort/run-length the join instead:
            # traffic O(join).  (include_zero needs every in-triangle
            # cell, nonzero or not -> dense only.)
            triples = csr.collect_triples(lp, bi, n, diag=i0)
            if triples is not None:
                return ("sparse", triples, bi)
        common_blk = strip[:bi]
        if _use_walk(lp, bi, n, col_lo=i0):
            # emission only reads j > i >= i0: the walk + memset skip
            # columns < i0 entirely (strictly upper-triangle work;
            # stale strip contents there are never read)
            csr.walk(common_blk, lp, col_lo=i0)
            return ("dense", common_blk, bi)
        # emission reads columns j > i >= i0 only, so tiles with
        # J < I are never needed: strictly upper-triangle work
        for j0 in range(i0, n, block):
            j1 = min(n, j0 + block)
            common_blk[:, j0:j1] = csr.counts(
                row_pairs, csr.side_pairs(j0, j1), bi, j1 - j0)
        return ("dense", common_blk, bi)

    strip_kinds = {"dense": 0, "sparse": 0}

    def row_gen():
        # double-buffered strips: strip i0+block counts (device matmuls)
        # while strip i0's rows emit (host text work) — the reference
        # overlaps these with per-thread row ownership (dist.cpp:174);
        # here one prefetch thread owns the counting
        from concurrent.futures import ThreadPoolExecutor

        from ..native import NameBlob

        blob = NameBlob(names)
        strips = [np.empty((min(block, n), n), np.int32) for _ in range(2)]
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(count_strip, strips[0], 0)
            for k, i0 in enumerate(range(0, n, block)):
                kind, data, bi = fut.result()
                strip_kinds[kind] += 1
                nxt = i0 + block
                if nxt < n:
                    fut = ex.submit(count_strip, strips[(k + 1) % 2], nxt)
                if kind == "sparse":
                    yield from _alldist_triples_rows(
                        names, sizes, data, bi, i0, n, kmer_size,
                        max_dist, containment, step, blob)
                else:
                    yield from _alldist_block_rows(names, sizes, data,
                                                   i0, kmer_size,
                                                   max_dist, containment,
                                                   step, blob=blob)

    with phase("distance computing and save"):
        _write_rows(row_gen(), names, output_file)
    # auditable dispatch: the sparse path exists for the 1M-genome
    # regime — a scaling run must be able to SEE it was selected
    print(f"strips: {strip_kinds['dense']} dense / "
          f"{strip_kinds['sparse']} sparse", file=sys.stderr)


LEGACY_HEADER_TRI = HEADER
LEGACY_HEADER_RQ = (" referenceGenome\tqueryGenome\tcommon|size0|size1\t"
                    "jaccard\tmashD\n")


def _legacy_mash(common: int, size0: int, size1: int, kmer_size: int
                 ) -> tuple[float, float]:
    """Legacy-path jaccard/mash (dist.cpp:897-938): NO zero-size guard —
    two empty sketches give 0/0 = nan, whose rows never pass the
    ``< maxDist`` filter (nan comparisons are false), exactly as the
    reference's fprintf path behaves."""
    denom = size0 + size1 - common
    jaccard = common / denom if denom else math.nan
    if jaccard == 1.0:
        mash = 0.0
    elif jaccard == 0.0:
        mash = 1.0
    else:
        mash = (-1.0 / kmer_size) * math.log((2 * jaccard) / (1.0 + jaccard))
    return jaccard, mash


def run_alldist_legacy(sk: SketchSet, output_file: str,
                       max_dist: float) -> None:
    """The reference's LEGACY sorted-intersection all-vs-all text path
    (``tri_dist``, dist.cpp:345-427): same header/row format as the
    index path but rows printed with ``fprintf(" %s\\t%s\\t%d|%d|%d\\t
    %lf\\t%lf\\n")`` — a LEADING SPACE before genome0 (dist.cpp:387).
    Counting runs the batched sorted-intersection op (the AVX2 kernel's
    device analogue, ops/intersect.py).  Unreachable from the reference
    CLI (subCommand.cpp:197 is commented out); exposed here behind
    ``KSSD_LEGACY_DIST=1`` for full behavioral coverage."""
    from ..ops.intersect import common_counts_sorted

    hashes = [np.sort(s.hashes) for s in sk.sketches]
    names = [s.name for s in sk.sketches]
    kmer_size = 2 * sk.info.half_k
    common = common_counts_sorted(hashes, None)
    with open(output_file, "w") as f:
        f.write(LEGACY_HEADER_TRI)
        for i in range(len(names)):
            si = hashes[i].size
            for j in range(i + 1, len(names)):
                c = int(common[i, j])
                jac, d = _legacy_mash(c, si, hashes[j].size, kmer_size)
                if d < max_dist:
                    f.write(f" {names[j]}\t{names[i]}\t{c}|{si}|"
                            f"{hashes[j].size}\t{jac:.6f}\t{d:.6f}\n")


def run_dist_legacy(ref: SketchSet, query: SketchSet, output_file: str,
                    max_dist: float) -> None:
    """The reference's LEGACY ref-vs-query path (``dist``,
    dist.cpp:778-893): header names referenceGenome/queryGenome
    (dist.cpp:870) but rows still print query first; the branch on
    ``refSize >= querySize`` (dist.cpp:805-860) swaps which side's size
    lands in the size0 column — both quirks reproduced.  Threshold is
    strict ``<`` (unlike index_dist's ``<=``)."""
    from ..ops.intersect import common_counts_sorted

    rh = [np.sort(s.hashes) for s in ref.sketches]
    qh = [np.sort(s.hashes) for s in query.sketches]
    rnames = [s.name for s in ref.sketches]
    qnames = [s.name for s in query.sketches]
    kmer_size = 2 * ref.info.half_k
    with open(output_file, "w") as f:
        f.write(LEGACY_HEADER_RQ)
        if len(rh) >= len(qh):
            common = common_counts_sorted(rh, qh)  # [ref, query]
            for i in range(len(rh)):
                s0 = rh[i].size
                for j in range(len(qh)):
                    c = int(common[i, j])
                    jac, d = _legacy_mash(c, s0, qh[j].size, kmer_size)
                    if d < max_dist:
                        f.write(f" {qnames[j]}\t{rnames[i]}\t{c}|{s0}|"
                                f"{qh[j].size}\t{jac:.6f}\t{d:.6f}\n")
        else:
            common = common_counts_sorted(qh, rh)  # [query, ref]
            for i in range(len(qh)):
                s0 = qh[i].size  # size0 = QUERY size in this branch
                for j in range(len(rh)):
                    c = int(common[i, j])
                    jac, d = _legacy_mash(c, s0, rh[j].size, kmer_size)
                    if d < max_dist:
                        f.write(f" {qnames[i]}\t{rnames[j]}\t{c}|{s0}|"
                                f"{rh[j].size}\t{jac:.6f}\t{d:.6f}\n")


def run_dist(ref: SketchSet, query: SketchSet, output_file: str,
             max_dist: float, containment: bool, max_neighbor: int = 0,
             ref_index_path: str | None = None) -> None:
    """command_dist engine (reference subCommand.cpp:203-305).

    Blocked over both the query and reference axes like
    :func:`run_alldist` (full-width reference strips per query block,
    since every query row emits against all references).

    ref_index_path: the reference-side ``.sketch`` whose persisted
    ``.index``/``.dict`` should be consumed for counting (reference
    dist.cpp:442-523) instead of recomputing ref membership."""
    qh = [s.hashes for s in query.sketches]
    rh = [s.hashes for s in ref.sketches]
    kmer_size = 2 * ref.info.half_k
    nq, nr = len(qh), len(rh)
    block = _auto_block(nr)
    csr = _load_csr(ref_index_path, ref.use64,
                    payload_nnz=int(sum(h.size for h in rh)))

    if csr is None and (nq > block or nr > block):
        # blocked runs: one in-memory ref index beats per-tile
        # re-deduplication (see run_alldist)
        csr = _CsrIndex.from_hashes(rh)

    def blk_counts(common_blk, q0, bq):
        if csr is not None:
            q_pairs = csr.query_pairs(qh[q0 : q0 + bq])
            lp = csr.walk_layout(q_pairs)
            if _use_walk(lp, bq, nr):
                csr.walk(common_blk, lp)
                return
            common_blk[:] = 0
            for j0 in range(0, nr, block):
                j1 = min(nr, j0 + block)
                common_blk[:, j0:j1] = csr.counts(
                    q_pairs, csr.side_pairs(j0, j1), bq, j1 - j0)
        else:
            _tile_counts(common_blk, qh, rh, q0, bq, 0, nr, block)

    if nq <= block and nr <= block:
        if csr is None and _small_n_walk(rh, nr):
            # same below-one-block cost dispatch as run_alldist: a
            # wide-vocab membership matmul loses to the posting walk
            # at low-drlevel sketch densities
            csr = _CsrIndex.from_hashes(rh)
        if csr is not None:
            common = np.zeros((nq, nr), np.int32)
            blk_counts(common, 0, nq)
        else:
            common = _counts(qh, rh)
        rows = dist_rows(ref, query, common, kmer_size, max_dist,
                         containment, max_neighbor)
        _write_rows(rows, [s.name for s in query.sketches], output_file)
        return

    def count_strip(strip, q0):
        bq = min(block, nq - q0)
        common_blk = strip[:bq]
        common_blk[:] = 0
        blk_counts(common_blk, q0, bq)
        return common_blk

    def row_gen():
        # double-buffered strips: next query block counts on device
        # while this block's rows emit on host (see run_alldist)
        from concurrent.futures import ThreadPoolExecutor

        strips = [np.empty((min(block, nq), nr), np.int32)
                  for _ in range(2)]
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(count_strip, strips[0], 0)
            for k, q0 in enumerate(range(0, nq, block)):
                common_blk = fut.result()
                if q0 + block < nq:
                    fut = ex.submit(count_strip, strips[(k + 1) % 2],
                                    q0 + block)
                sub = SketchSet(info=query.info,
                                sketches=query.sketches[q0 : q0 + block])
                yield from dist_rows(ref, sub, common_blk, kmer_size,
                                     max_dist, containment, max_neighbor,
                                     progress_offset=q0, progress_total=nq)

    _write_rows(row_gen(), [s.name for s in query.sketches], output_file)
