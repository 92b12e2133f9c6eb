"""On-disk formats: ``.sketch``, ``.sketch.index``/``.dict``, Kssd directories.

Byte-compatible with the reference wire protocol:

* ``.sketch``  — ``sketchInfo_t`` (5 x int32: id, half_k, half_subk,
  drlevel, genomeNumber), then ``int32 nameSize[N]``, ``int32 hashSize[N]``,
  then per genome raw name bytes + raw uint32/uint64 hashes
  (reference sketch.cpp:1024-1068 writer, 1070-1154 reader).
  The reference stores hashes in hash-set iteration order; only per-genome
  *set equality* is well-defined.  This implementation always stores hashes
  **sorted ascending** (a canonical, set-equal representation that makes
  downstream intersection a merge of sorted arrays).

* ``.index``/``.dict`` inverted index (reference sketch.cpp:894-1021):
  - 32-bit: dense. ``.index`` = size_t hashSize, uint64 totalIndex,
    uint32 counts[hashSize]; ``.dict`` = posting lists (uint32 genome ids)
    concatenated in hash order.
  - 64-bit: sparse. ``.index`` = size_t n, uint64 hash[n], uint32 count[n];
    ``.dict`` = concatenated posting lists.  (The reference emits hashes in
    hash-map iteration order; we emit sorted by hash — readers on both
    sides accept any order.)

* Kssd-compatible directory (``cofiles.stat`` + ``combco.index.0`` +
  ``combco.0``), reference sketch.cpp:1179-1365.

Hash width rule everywhere: ``use64 = half_k - drlevel > 8``
(reference sketch.cpp:336, dist.cpp:29).
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

PATHLEN = 256  # reference sketch.cpp:25


@dataclasses.dataclass
class SketchInfo:
    """Mirrors sketchInfo_t (reference sketch.h:28-35)."""

    id: int
    half_k: int
    half_subk: int
    drlevel: int
    genome_number: int

    @property
    def use64(self) -> bool:
        return self.half_k - self.drlevel > 8

    @property
    def hash_space(self) -> int:
        return 1 << (4 * (self.half_k - self.drlevel))

    @property
    def kmer_size(self) -> int:
        return 2 * self.half_k

    def pack(self) -> bytes:
        return struct.pack(
            "<5i", self.id, self.half_k, self.half_subk, self.drlevel, self.genome_number
        )

    @classmethod
    def unpack(cls, b: bytes) -> "SketchInfo":
        sid, hk, hs, dl, gn = struct.unpack("<5i", b)
        return cls(id=sid, half_k=hk, half_subk=hs, drlevel=dl, genome_number=gn)


@dataclasses.dataclass
class Sketch:
    """One genome's sampled-hash set (canonical form: sorted, deduplicated)."""

    name: str
    hashes: np.ndarray  # uint32 or uint64, sorted ascending

    @property
    def size(self) -> int:
        return int(self.hashes.size)


@dataclasses.dataclass
class SketchSet:
    info: SketchInfo
    sketches: list[Sketch]

    @property
    def use64(self) -> bool:
        return self.info.use64

    def names(self) -> list[str]:
        return [s.name for s in self.sketches]


def _hash_dtype(use64: bool) -> np.dtype:
    return np.dtype("<u8") if use64 else np.dtype("<u4")


def is_sketch_file(path: str) -> bool:
    """Suffix check mirroring isSketchFile (reference sketch.cpp:163-169)."""
    return path.rsplit(".", 1)[-1] == "sketch" if "." in os.path.basename(path) else False


def ensure_sketch_suffix(path: str) -> str:
    return path if is_sketch_file(path) else path + ".sketch"


# --------------------------------------------------------------------------
# .sketch
# --------------------------------------------------------------------------

def save_sketches(sk: SketchSet, path: str) -> None:
    info = sk.info
    info.genome_number = len(sk.sketches)
    info.id = (info.half_k << 8) + (info.half_subk << 4) + info.drlevel
    dt = _hash_dtype(info.use64)
    with open(path, "wb") as f:
        f.write(info.pack())
        name_sizes = np.array([len(s.name.encode()) for s in sk.sketches], dtype="<i4")
        hash_sizes = np.array([s.size for s in sk.sketches], dtype="<i4")
        f.write(name_sizes.tobytes())
        f.write(hash_sizes.tobytes())
        for s in sk.sketches:
            f.write(s.name.encode())
            f.write(np.ascontiguousarray(s.hashes, dtype=dt).tobytes())


def read_sketches(path: str) -> SketchSet:
    with open(path, "rb") as f:
        info = SketchInfo.unpack(f.read(20))
        n = info.genome_number
        name_sizes = np.frombuffer(f.read(4 * n), dtype="<i4")
        hash_sizes = np.frombuffer(f.read(4 * n), dtype="<i4")
        if name_sizes.size != n or hash_sizes.size != n:
            raise IOError(f"truncated sketch header in {path}")
        dt = _hash_dtype(info.use64)
        sketches = []
        for i in range(n):
            name = f.read(int(name_sizes[i])).decode()
            raw = f.read(int(hash_sizes[i]) * dt.itemsize)
            h = np.frombuffer(raw, dtype=dt)
            if h.size != int(hash_sizes[i]):
                raise IOError(f"truncated hash data in {path} (genome {i})")
            sketches.append(Sketch(name=name, hashes=h.copy()))
    return SketchSet(info=info, sketches=sketches)


def read_sketch_header(path: str) -> tuple[SketchInfo, np.ndarray, np.ndarray]:
    """Header-only scan (info + name sizes + hash sizes), for merge/info."""
    with open(path, "rb") as f:
        info = SketchInfo.unpack(f.read(20))
        n = info.genome_number
        name_sizes = np.frombuffer(f.read(4 * n), dtype="<i4")
        hash_sizes = np.frombuffer(f.read(4 * n), dtype="<i4")
    return info, name_sizes, hash_sizes


def iter_sketches(path: str):
    """Stream (name, hashes) pairs without loading the whole file.

    The streaming analogue of the reference's producer loops
    (subCommand.cpp:380-432, 654-707).
    """
    with open(path, "rb") as f:
        info = SketchInfo.unpack(f.read(20))
        n = info.genome_number
        name_sizes = np.frombuffer(f.read(4 * n), dtype="<i4")
        hash_sizes = np.frombuffer(f.read(4 * n), dtype="<i4")
        dt = _hash_dtype(info.use64)
        for i in range(n):
            name = f.read(int(name_sizes[i])).decode()
            h = np.frombuffer(f.read(int(hash_sizes[i]) * dt.itemsize), dtype=dt)
            yield name, h.copy()


# --------------------------------------------------------------------------
# inverted index (.index / .dict)
# --------------------------------------------------------------------------

def build_index(sk: SketchSet) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Build posting lists: returns (counts_or_hashes, postings, hashes64).

    32-bit: returns (counts uint32[hash_space], postings uint32[total], None).
    64-bit: returns (counts uint32[n], postings uint32[total], hashes uint64[n]).
    Postings for each hash are genome ids ascending (matches the reference's
    genome-major insertion order, sketch.cpp:979-984).
    """
    use64 = sk.use64
    gids = np.concatenate(
        [np.full(s.size, i, dtype=np.uint32) for i, s in enumerate(sk.sketches)]
        or [np.empty(0, dtype=np.uint32)]
    )
    allh = np.concatenate(
        [s.hashes for s in sk.sketches]
        or [np.empty(0, dtype=_hash_dtype(use64))]
    )
    order = np.argsort(allh, kind="stable")  # stable: keeps gid ascending per hash
    sh = allh[order]
    sg = gids[order]
    if use64:
        uniq, counts = np.unique(sh, return_counts=True)
        return counts.astype(np.uint32), sg, uniq.astype(np.uint64)
    else:
        counts = np.zeros(sk.info.hash_space, dtype=np.uint32)
        if sh.size:
            u, c = np.unique(sh, return_counts=True)
            counts[u] = c
        return counts, sg, None


def write_index(sk: SketchSet, dict_path: str, index_path: str) -> None:
    counts, postings, hashes64 = build_index(sk)
    with open(dict_path, "wb") as f:
        f.write(np.ascontiguousarray(postings, dtype="<u4").tobytes())
    with open(index_path, "wb") as f:
        if sk.use64:
            f.write(struct.pack("<Q", len(hashes64)))
            f.write(np.ascontiguousarray(hashes64, dtype="<u8").tobytes())
            f.write(np.ascontiguousarray(counts, dtype="<u4").tobytes())
        else:
            f.write(struct.pack("<Q", counts.size))
            f.write(struct.pack("<Q", int(postings.size)))
            f.write(np.ascontiguousarray(counts, dtype="<u4").tobytes())


def _read_exact(f, dtype: str, n: int, path: str) -> np.ndarray:
    """Length-checked binary array read: raises IOError on ANY short
    read (a truncation not a multiple of the item size would otherwise
    surface as np.frombuffer's ValueError; reference reads hard-exit on
    short fread counts, e.g. sketch.cpp:1085-1088)."""
    dt = np.dtype(dtype)
    raw = f.read(dt.itemsize * n)
    if len(raw) != dt.itemsize * n:
        raise IOError(f"truncated index file {path}")
    return np.frombuffer(raw, dtype=dt)


def read_index(dict_path: str, index_path: str, use64: bool):
    """Returns (counts, postings, hashes64-or-None)."""
    with open(index_path, "rb") as f:
        if use64:
            (n,) = struct.unpack("<Q", f.read(8))
            hashes = _read_exact(f, "<u8", n, index_path)
            counts = _read_exact(f, "<u4", n, index_path)
        else:
            (hash_size,) = struct.unpack("<Q", f.read(8))
            (total,) = struct.unpack("<Q", f.read(8))
            counts = _read_exact(f, "<u4", hash_size, index_path)
            if int(counts.sum(dtype=np.uint64)) != total:
                raise IOError(f"mismatched total hash number in {index_path}")
            hashes = None
    postings = np.fromfile(dict_path, dtype="<u4")
    return counts, postings, hashes


def read_index_csr(sketch_path: str, use64: bool):
    """Load ``<sketch>.index``/``.dict`` as a normalized CSR over the
    OCCUPIED vocabulary: (vocab sorted ascending, offsets int64[nv+1],
    postings uint32).  Returns None if either file is missing.

    This is the read-side of the reference's distance entry
    (/root/reference/src/dist.cpp:83-130, 442-523): distance consumes a
    previously built inverted index instead of recomputing membership
    from the raw sketches.  Normalizations beyond the reference:

    * 32-bit dense indexes drop empty hash slots (vocab = hash ids with
      a non-empty posting list) — posting offsets are rebuilt over the
      occupied slots only;
    * 64-bit sparse indexes may arrive in the reference's hash-map
      iteration order; vocab is sorted and posting segments reordered.
    """
    index_path, dict_path = sketch_path + ".index", sketch_path + ".dict"
    if not (os.path.exists(index_path) and os.path.exists(dict_path)):
        return None
    counts, postings, hashes = read_index(dict_path, index_path, use64)
    if use64:
        vocab = hashes
        seg_counts = counts.astype(np.int64)
        # NB unsigned diff wraps around (5 -> 3 gives 2^64-2, not -2):
        # compare adjacent values directly to detect unsorted/dup slots
        if vocab.size > 1 and np.any(vocab[1:] <= vocab[:-1]):
            order = np.argsort(vocab, kind="stable")
            ends = np.cumsum(seg_counts)
            starts = ends - seg_counts
            # gather posting segments into sorted-vocab order with one
            # fancy index: src[i] = start-of-segment + offset-within-it
            # (a per-segment Python loop is O(n_vocab) interpreted work —
            # minutes at multi-million-slot mammal scale)
            new_counts = seg_counts[order]
            new_ends = np.cumsum(new_counts)
            within = np.arange(postings.size, dtype=np.int64) - np.repeat(
                new_ends - new_counts, new_counts
            )
            src = np.repeat(starts[order], new_counts) + within
            postings = postings[src]
            vocab = vocab[order]
            seg_counts = new_counts
        vocab = vocab.astype(np.uint64)
    else:
        occupied = np.nonzero(counts)[0]
        seg_counts = counts[occupied].astype(np.int64)
        vocab = occupied.astype(np.uint32)
    offsets = np.zeros(len(vocab) + 1, np.int64)
    np.cumsum(seg_counts, out=offsets[1:])
    if offsets[-1] != postings.size:
        raise IOError(
            f"index/dict size mismatch for {sketch_path}: "
            f"{offsets[-1]} postings expected, {postings.size} found"
        )
    # the native posting walk's upper-triangle trim (pair_count.cpp
    # col_lo lower_bound) requires genome ids ASCENDING within each
    # run.  Our builds and the reference's transSketches both emit
    # ascending runs, but an externally produced .dict might not —
    # and a violated invariant silently undercounts.  One vectorized
    # check; normalize (stable per-run sort) only if violated.
    if postings.size > 1:
        dec = postings[1:] < postings[:-1]
        b = offsets[1:-1]  # run boundaries may decrease (empty runs
        b = b[(b > 0) & (b < postings.size)]  # index nothing in dec)
        dec[b - 1] = False
        if dec.any():
            run_id = np.repeat(
                np.arange(len(vocab), dtype=np.int64), seg_counts
            )
            postings = postings[np.lexsort((postings, run_id))]
    return vocab, offsets, postings


# --------------------------------------------------------------------------
# Kssd-compatible directory format (convert)
# --------------------------------------------------------------------------

# co_dstat_t with C struct padding (reference sketch.h:38-47):
# u32 shuf_id; u8 koc; 3 pad; i32 kmerlen; i32 dim_rd_len; i32 comp_num;
# i32 infile_num; u64 all_ctx_ct (offset 24 is already 8-aligned) -> 32 B
_CO_DSTAT = struct.Struct("<IB3x4iQ")


def read_kssd_dir(input_dir: str) -> SketchSet:
    """Kssd sketch dir -> SketchSet (mirrors convertSketch, sketch.cpp:1179-1285)."""
    stat_file = os.path.join(input_dir, "cofiles.stat")
    index_file = os.path.join(input_dir, "combco.index.0")
    sketch_file = os.path.join(input_dir, "combco.0")
    with open(stat_file, "rb") as f:
        shuf_id, koc, kmerlen, dim_rd_len, comp_num, infile_num, all_ctx_ct = (
            _CO_DSTAT.unpack(f.read(_CO_DSTAT.size))
        )
        ctx_ct = np.frombuffer(f.read(4 * infile_num), dtype="<u4")
        names = []
        for _ in range(infile_num):
            raw = f.read(PATHLEN)
            names.append(raw.split(b"\x00", 1)[0].decode())
    offsets = np.fromfile(index_file, dtype="<u8", count=infile_num + 1)
    hashes = np.fromfile(sketch_file, dtype="<u4")
    if hashes.size != all_ctx_ct:
        raise IOError("total hash number does not match the stat info")
    info = SketchInfo(
        id=shuf_id,
        half_k=kmerlen // 2,
        half_subk=6,  # reference hardcodes 6 on this path (sketch.cpp:1197)
        drlevel=dim_rd_len // 2,
        genome_number=infile_num,
    )
    sketches = []
    for i in range(infile_num):
        h = hashes[int(offsets[i]) : int(offsets[i + 1])]
        sketches.append(Sketch(name=names[i], hashes=np.sort(h)))
    return SketchSet(info=info, sketches=sketches)


def write_kssd_dir(sk: SketchSet, output_dir: str) -> None:
    """SketchSet -> Kssd dir (mirrors sketch.cpp:1288-1365)."""
    os.makedirs(output_dir, exist_ok=True)
    stat_file = os.path.join(output_dir, "cofiles.stat")
    index_file = os.path.join(output_dir, "combco.index.0")
    sketch_file = os.path.join(output_dir, "combco.0")
    n = len(sk.sketches)
    sizes = np.array([s.size for s in sk.sketches], dtype=np.uint64)
    offsets = np.zeros(n + 1, dtype="<u8")
    np.cumsum(sizes, out=offsets[1:])
    with open(sketch_file, "wb") as f:
        for s in sk.sketches:
            f.write(np.ascontiguousarray(s.hashes, dtype="<u4").tobytes())
    with open(index_file, "wb") as f:
        f.write(offsets.tobytes())
    with open(stat_file, "wb") as f:
        f.write(
            _CO_DSTAT.pack(
                sk.info.id & 0xFFFFFFFF,
                0,
                sk.info.half_k * 2,
                sk.info.drlevel * 2,
                1,
                n,
                int(sizes.sum()),
            )
        )
        f.write(np.array(sizes, dtype="<u4").tobytes())
        for s in sk.sketches:
            raw = s.name.encode()[: PATHLEN - 1]
            f.write(raw + b"\x00" * (PATHLEN - len(raw)))
