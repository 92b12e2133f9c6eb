"""The sketch pipeline: genomes -> device hash kernel -> SketchSet.

Device re-design of the reference sketch scheduler (reference
sketch.cpp:318-593 fasta, 596-890 fastq).  Instead of
per-file threads + per-thread hash sets, all genomes are concatenated into
one logical **tape** of 2-bit codes (genomes and records separated by
invalid sentinels so k-mers never span either), the tape is cut into
uniform halo'd blocks, and fixed-shape batches of blocks stream through a
single compiled device program:

    hash windows (ops/kmer.py)  ->  on-device compaction

The compaction is rank-scatter-based (cumsum of the keep mask, then each
survivor scatters its position to slot rank-1): only the ~16**-drlevel
surviving hashes and their tape positions cross the device->host link.  Capacity overflow (more
survivors than the static buffer) is detected exactly via the returned
count and handled by re-running that batch at full capacity — results are
always exact.

Dedup per genome (the reference's robin_hood per-genome hash sets,
sketch.cpp:529) becomes: map kept tape positions -> genome via one
searchsorted over genome start offsets, then np.unique per genome; the
fastq k-mer abundance filter (sketch.cpp:826-838) is np.unique with
counts.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from ..formats import Sketch, SketchInfo, SketchSet
from ..params import KssdParams
from ..seqio import read_records
from .. import shuffle as shuffle_mod
from ..ops.hostxfer import read_prefixes, read_scalars
from ..ops.kmer import (
    encode_concat,
    hash_windows_stream,
    pack_words_np,
    pad_exceptions,
)


def aligned_halo(params: KssdParams) -> int:
    """Halo rounded up to a multiple of 16 so packed rows stay u32-word-
    aligned (any halo >= kmer_size-1 is correct; extra positions are
    covered by the previous block's payload or invalid padding)."""
    return -(-(params.kmer_size - 1) // 16) * 16


# --------------------------------------------------------------------------
# device program: hash + compact
# --------------------------------------------------------------------------

def make_stream_step(params: KssdParams, n_blocks: int, block: int, cap: int,
                     buf_cap: int, compaction: str = "auto") -> Callable:
    """Compiled streaming batch step with device-resident accumulation.

    The pipeline never syncs per batch: each step appends its compacted
    survivors into donated carry buffers on device; the host reads one
    large slab per flush window.

    (words, exc, table, buf_lo, buf_hi, buf_pos, buf_batch, count,
     overflow, batch_idx, valid_upto)
      -> (buf_lo, buf_hi, buf_pos, buf_batch, count, overflow)

    buf_*: int32/uint32[buf_cap] carry (donated); count: device scalar
    write offset; overflow: sticky flag (batch survivors > cap, or
    buffer full) — checked once per flush, triggering an exact re-run.

    Inputs arrive as the WordTapeFeeder's u32 word batches (words
    u32[n_blocks, nw], 16 bases per word, each row carrying an
    ``aligned_halo``-base overlap into its predecessor) plus a padded
    list of invalid flat positions (exc i32[cap_exc], pads out of
    range) and the traced ``valid_upto`` payload watermark masking the
    tape tail of a final partial batch — 2 bits per base cross the
    host->device link; window extraction and the validity scatter run
    on device.
    """
    return jax.jit(_stream_step_body(params, cap, buf_cap, compaction),
                   donate_argnums=(3, 4, 5, 6, 7, 8))


def _stream_step_body(params: KssdParams, cap: int, buf_cap: int,
                      compaction: str) -> Callable:
    """The un-jitted stream-step computation (shared by the single-chip
    jit and the shard_map data-parallel wrapper).

    ``valid_upto`` (traced i32): payload coordinates >= it are invalid —
    the tape tail of a final partial batch (beyond the ingested data)
    is masked by this one compare instead of a per-position exception
    list.  A position at offset o of row b has payload coordinate
    b*block + o - halo (halo offsets reach into the previous row's
    payload, or before the batch for row 0).
    """
    hasher = hash_windows_stream(params)
    halo = aligned_halo(params)

    def step(words, exc, table, buf_lo, buf_hi, buf_pos, buf_batch,
             count, overflow, batch_idx, valid_upto):
        nb, nw = words.shape
        L = 16 * (nw - 2)
        block = L - halo
        valid = (
            jnp.ones((nb * L,), jnp.bool_)
            .at[exc].set(False, mode="drop", unique_indices=True)
            .reshape(nb, L)
        )
        coord = (jax.lax.broadcasted_iota(jnp.int32, (nb, L), 0) * block
                 + jax.lax.broadcasted_iota(jnp.int32, (nb, L), 1) - halo)
        valid = valid & (coord < valid_upto)
        # keep test: one gather per window into the permutation table
        h_lo, h_hi, keep = hasher(words, valid, table)
        h_lo = h_lo[:, halo:].ravel()
        h_hi = h_hi[:, halo:].ravel()
        keep = keep[:, halo:].ravel()
        n = keep.size

        # survivors are a ~16^-drlevel fraction; at high reduction a
        # two-level compaction (select 32-window groups containing any
        # survivor, then compact only those) replaces the full-length
        # sort-searchsorted with two small ones
        sparse = (compaction == "auto" and params.drlevel >= 3
                  and n % 32 == 0)
        o_flag = jnp.bool_(False)
        if sparse:
            G = n // 32
            g_cap = min(G, max(4096, 4 * (n >> (4 * params.drlevel)) // 32))
            gflag = (keep.reshape(G, 32).sum(axis=1, dtype=jnp.int32) > 0)
            gcsum = jnp.cumsum(gflag.astype(jnp.int32))
            n_sel = gcsum[-1]
            # rank-scatter selection: flagged group g lands at slot
            # rank(g)-1; unflagged groups get sentinels G + g, which no
            # rank (< G) can equal even on overflow, so unique_indices
            # stays honest (all indices >= g_cap are dropped).  Slots
            # beyond n_sel stay 0 -> they alias group 0, masked below by
            # grp_ok.
            gidx = jnp.where(
                gflag, gcsum - 1,
                G + jax.lax.broadcasted_iota(jnp.int32, (G,), 0))
            sel = (jnp.zeros(g_cap, jnp.int32)
                   .at[gidx].set(jax.lax.broadcasted_iota(jnp.int32,
                                                          (G,), 0),
                                 mode="drop", unique_indices=True))
            sub_pos = (
                sel[:, None] * 32
                + jnp.arange(32, dtype=jnp.int32)[None, :]
            ).ravel()
            grp_ok = (
                jax.lax.broadcasted_iota(jnp.int32, (g_cap, 32), 0) < n_sel
            ).ravel()
            keep_c = jnp.take(keep, sub_pos) & grp_ok
            o_flag = n_sel > g_cap
        else:
            keep_c = keep

        # exact compaction by rank scatter: survivor i lands at slot
        # rank(i)-1 (ascending window order).  Non-survivors get
        # sentinels m + i, which no rank (< m) can equal even on
        # overflow, so unique_indices stays honest (all indices >= cap
        # are dropped).  Beyond-total slots stay 0 — never read
        # (new_count advances by wrote = min(total, cap)).
        csum = jnp.cumsum(keep_c.astype(jnp.int32))
        total = csum[-1]
        m = keep_c.size
        ranks = jnp.where(
            keep_c, csum - 1,
            m + jax.lax.broadcasted_iota(jnp.int32, (m,), 0))
        pos_c = (jnp.zeros(cap, jnp.int32)
                 .at[ranks].set(jax.lax.broadcasted_iota(jnp.int32, (m,), 0),
                                mode="drop", unique_indices=True))
        if sparse:
            pos_c = jnp.take(sub_pos, pos_c)
        out_lo = jnp.take(h_lo, pos_c, axis=0)
        out_hi = jnp.take(h_hi, pos_c, axis=0)
        bidx = jnp.full((cap,), batch_idx, jnp.int32)

        start = jnp.minimum(count, buf_cap - cap)
        buf_lo = jax.lax.dynamic_update_slice(buf_lo, out_lo, (start,))
        buf_hi = jax.lax.dynamic_update_slice(buf_hi, out_hi, (start,))
        buf_pos = jax.lax.dynamic_update_slice(buf_pos, pos_c, (start,))
        buf_batch = jax.lax.dynamic_update_slice(buf_batch, bidx, (start,))
        wrote = jnp.minimum(total, cap)
        new_count = start + wrote
        overflow = (overflow | o_flag | (total > cap)
                    | (count > buf_cap - cap))
        return buf_lo, buf_hi, buf_pos, buf_batch, new_count, overflow

    return step


def make_sharded_stream_step(params: KssdParams, mesh, n_blocks: int,
                             block: int, cap: int, buf_cap: int,
                             compaction: str = "auto") -> Callable:
    """Data-parallel stream step over all mesh devices (shard_map).

    Batches carry a leading shard axis: words [S, n_blocks, nw],
    exc [S, cap_exc], carry buffers [S, buf_cap], count/overflow [S];
    each device runs the identical accumulate step on its shard — the
    per-consumer privatized hash sets of the reference (sketch.cpp:
    411-435) re-expressed as per-device carry buffers, merged on host
    at flush.
    """
    from jax.sharding import PartitionSpec as P

    body = _stream_step_body(params, cap, buf_cap, compaction)
    axes = tuple(mesh.axis_names)

    def per_shard(words, exc, table, b_lo, b_hi, b_pos, b_batch, count,
                  overflow, batch_idx, valid_upto):
        out = body(words[0], exc[0], table, b_lo[0], b_hi[0], b_pos[0],
                   b_batch[0], count[0], overflow[0], batch_idx,
                   valid_upto[0])
        return tuple(o[None] for o in out)

    sharded = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(axes), P(axes), P(), P(axes), P(axes), P(axes),
                  P(axes), P(axes), P(axes), P(), P(axes)),
        out_specs=(P(axes),) * 6,
    )
    return jax.jit(sharded, donate_argnums=(3, 4, 5, 6, 7, 8))




# --------------------------------------------------------------------------
# tape feeder
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _TapeBatch:
    words: np.ndarray  # uint32[n_blocks, (block + halo)/16 + 2]
    exc: np.ndarray  # int32[k] invalid positions, halo'd-row flat coords
    base: int  # tape offset of this batch's first payload position
    valid_upto: int  # payload coords >= this are invalid (tape tail)


class WordTapeFeeder:
    """Concatenates packed genomes into fixed-shape halo'd word batches.

    The tape is word-aligned: every genome starts on a 16-base (one
    u32-word) boundary, padded with 1..16 invalid positions (>= 1 so
    k-mer windows never span genomes; invalid positions generate no
    windows, so extra pads are semantically free).  Batch assembly is
    then pure u32 slicing — no per-base repacking on the feeder thread
    (round-1's measured host wall; the packing itself runs in the
    native reader, the RabbitFX consumer role, reference
    sketch.cpp:396-410).

    Source items may be:
      * ``(words u32, n_bases, exc i32)`` — a native-packed genome
      * ``np.int8`` code array — packed here via :func:`pack_words_np`
      * an iterator of either — one genome streamed in bounded chunks
        (multi-GB inputs; every packed chunk except the genome's last
        must hold a multiple of 16 bases)

    Tracks each genome's [start, end) tape span for position->genome
    mapping; invalid positions are carried as tape coordinates and
    emitted per batch in halo'd-row flat coordinates (a position in the
    last ``halo`` of a block also appears in the next row's halo).

    Cross-thread invariant: ``starts``/``ends`` are APPEND-ONLY, written
    solely by the producer thread that calls :meth:`next_batch`, and a
    genome's entries are appended before the batch covering its tape
    span is returned.  The GenomeFinalizer's flusher thread reads them
    without a lock — safe because list appends are atomic under the GIL
    and the flusher only inspects spans at or below an already-flushed
    batch watermark, which the producer completed before dispatching
    that batch.  Any refactor that mutates entries in place, reorders
    flushes ahead of ingestion, or drops the GIL (free-threaded Python)
    must add a snapshot-under-lock here.
    """

    def __init__(self, sources, n_blocks: int, block: int, halo: int):
        assert block % 16 == 0 and halo % 16 == 0
        self._src = iter(sources)
        self.n_blocks = n_blocks
        self.block = block
        self.halo = halo
        self.starts: list[int] = []  # genome start offsets (tape coords)
        self.ends: list[int] = []
        import collections

        self._chunks: collections.deque = collections.deque()
        self._have = 0  # words queued in _chunks
        self._exc: collections.deque = collections.deque()
        # the initial halo (tape coords [-halo, 0)) is invalid
        self._exc.append(np.arange(-halo, 0, dtype=np.int64))
        self._tape = 0  # bases ingested (word-aligned at genome ends)
        self._avail = 0  # bases available as pushed words (>= _tape while
        # a chunked genome is open: its whole-word prefix is usable
        # before the genome closes)
        self._open = None  # (iterator, start, total, int8 stage) of the
        # chunked genome currently being ingested — pulled INCREMENTALLY
        # so batches flow (and the device runs) while a multi-GB genome
        # is still being parsed, and memory stays bounded by one batch
        # window instead of one genome
        self._exhausted = False

    # -- ingest -------------------------------------------------------------
    def _push(self, words: np.ndarray, exc: np.ndarray, offset: int) -> None:
        if len(words):
            self._chunks.append(words)
            self._have += len(words)
        if len(exc):
            self._exc.append(exc.astype(np.int64) + offset)

    def _pad_genome(self, start: int, n: int) -> None:
        """Close a genome at tape position start+n: pad to the next word
        boundary with >= 1 invalid separators."""
        self.ends.append(start + n)
        pad = 16 - (n % 16) if n % 16 else 16
        if n % 16 == 0:
            self._chunks.append(np.zeros(1, np.uint32))
            self._have += 1
        self._exc.append(np.arange(start + n, start + n + pad,
                                   dtype=np.int64))
        self._tape = start + n + pad
        self._avail = self._tape

    def _append_packed(self, words: np.ndarray, n: int, exc: np.ndarray
                       ) -> None:
        start = self._tape
        self.starts.append(start)
        self._push(words, exc, start)
        self._pad_genome(start, n)

    def _pull_open_chunk(self) -> None:
        """Ingest ONE chunk of the open chunked genome (close on end)."""
        it, start, total, stage = self._open
        try:
            piece = next(it)
        except StopIteration:
            if len(stage):
                w, n, e = pack_words_np(stage)
                self._push(w, e, start + total)
                total += n
            self._pad_genome(start, total)
            self._open = None
            return
        if isinstance(piece, np.ndarray):
            if len(stage):
                piece = np.concatenate([stage, piece])
            cut = len(piece) - (len(piece) % 16)
            stage = piece[cut:]
            if cut == 0:
                self._open = (it, start, total, stage)
                return
            w, n, e = pack_words_np(piece[:cut])
        else:
            w, n, e = piece
            if len(stage):
                raise ValueError("packed chunk after unaligned int8 chunk")
        if total % 16:
            raise ValueError("non-final packed chunk not word-aligned")
        self._push(w, e, start + total)
        total += n
        self._open = (it, start, total, stage)
        self._avail = start + total - (total % 16)

    def _pull_to(self, need_bases: int) -> None:
        while not self._exhausted and self._avail < need_bases:
            if self._open is not None:
                self._pull_open_chunk()
                continue
            try:
                item = next(self._src)
            except StopIteration:
                self._exhausted = True
                return
            if isinstance(item, tuple):
                self._append_packed(*item)
            elif isinstance(item, np.ndarray):
                self._append_packed(*pack_words_np(item))
            else:
                self._open = (iter(item), self._tape, 0,
                              np.empty(0, np.int8))
                self.starts.append(self._tape)

    # -- batch emission -----------------------------------------------------
    def _take_words(self, want: int) -> list[np.ndarray]:
        take = min(want, self._have)
        parts: list[np.ndarray] = []
        got = 0
        while got < take:
            c = self._chunks[0]
            if got + len(c) <= take:
                parts.append(c)
                got += len(c)
                self._chunks.popleft()
            else:
                parts.append(c[: take - got])
                self._chunks[0] = c[take - got :]
                got = take
        self._have -= take
        return parts

    def _take_exc(self, limit: int) -> np.ndarray:
        """Pop queued invalid tape positions < limit (globally ascending)."""
        out: list[np.ndarray] = []
        while self._exc:
            e = self._exc[0]
            if e[-1] < limit:
                out.append(e)
                self._exc.popleft()
            else:
                k = int(np.searchsorted(e, limit))
                if k:
                    out.append(e[:k])
                    self._exc[0] = e[k:]
                break
        return (np.concatenate(out) if out
                else np.empty(0, np.int64))

    def _exc_to_flat(self, exc_tape: np.ndarray, base: int) -> np.ndarray:
        """Tape coords in [base-halo, base+payload) -> halo'd flat coords."""
        block, halo = self.block, self.halo
        L = block + halo
        rel = exc_tape - base
        row = np.maximum(rel // block, 0)  # rel<0 -> row 0 halo
        flat1 = row * L + (rel - row * block + halo)
        dup = (rel >= 0) & (rel % block >= block - halo) \
            & (row + 1 < self.n_blocks)
        row2 = row[dup] + 1
        flat2 = row2 * L + (rel[dup] - row2 * block + halo)
        return np.concatenate([flat1, flat2]).astype(np.int32)

    def __iter__(self) -> Iterator[_TapeBatch]:
        P = self.n_blocks * self.block
        WP, WB, WH = P // 16, self.block // 16, self.halo // 16
        nw_row = WB + WH + 2  # + 2 zero pad words (hash_windows_stream)
        base = 0
        tail = np.zeros(WH, np.uint32)  # words covering [base-halo, base)
        halo_exc = np.empty(0, np.int64)  # invalid positions in that span
        while True:
            self._pull_to(base + P)
            if self._avail <= base:
                return
            parts = self._take_words(WP)
            flat = np.concatenate([tail, *parts])
            if len(flat) < WH + WP:
                flat = np.concatenate(
                    [flat, np.zeros(WH + WP - len(flat), np.uint32)]
                )
            rows = np.zeros((self.n_blocks, nw_row), np.uint32)
            for b in range(self.n_blocks):
                rows[b, : WB + WH] = flat[b * WB : b * WB + WB + WH]
            tail = flat[WP:].copy()
            exc_tape = np.concatenate([halo_exc, self._take_exc(base + P)])
            halo_exc = exc_tape[exc_tape >= base + P - self.halo]
            yield _TapeBatch(
                words=rows,
                exc=self._exc_to_flat(exc_tape, base),
                base=base,
                valid_upto=min(self._avail - base, P),
            )
            base += P
            if self._exhausted and self._avail <= base:
                return


# --------------------------------------------------------------------------
# sketcher
# --------------------------------------------------------------------------

def _prefetch_chunks(gen, depth: int = 4):
    """Run a chunk generator on its own thread, `depth` chunks ahead.

    The returned iterator yields the same items; exceptions from the
    source re-raise at the consumer.  Abandoning the iterator (error
    mid-pipeline, generator close/GC) cancels the worker and closes the
    source generator — no leaked thread, fd, or buffered chunks."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    cancelled = threading.Event()

    def run():
        try:
            for item in gen:
                q.put(item)
                if cancelled.is_set():
                    return
        except BaseException as e:
            q.put(e)
            return
        finally:
            close = getattr(gen, "close", None)
            if close is not None:
                close()
        q.put(None)

    threading.Thread(target=run, daemon=True, name="kssd-prefetch").start()

    def out():
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            cancelled.set()
            try:  # unblock a producer stuck on a full queue
                q.get_nowait()
            except queue.Empty:
                pass

    return out()


class _AsyncFlusher:
    """Runs flush jobs on one dedicated thread, strictly in submission
    order.

    Running readbacks on this thread lets the main loop keep dispatching
    stream steps into fresh carry buffers, so the device does not wait
    on a flush.  The queue bound caps how many retired buffer windows
    stay live on device.
    """

    def __init__(self, fn):
        import queue
        import threading

        self._fn = fn
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self.error: BaseException | None = None
        self._t = threading.Thread(target=self._run, daemon=True,
                                    name="kssd-flush")
        self._t.start()

    def _run(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            if self.error is None:
                try:
                    self._fn(*job)
                except BaseException as e:  # surfaced by the main thread
                    self.error = e

    def submit(self, *job) -> None:
        if self.error is not None:
            raise self.error
        self._q.put(job)

    def shutdown(self) -> None:
        """Join the worker; never raises (check .error afterwards)."""
        self._q.put(None)
        self._t.join()


def default_n_blocks(cpu_blocks: int) -> int:
    """Blocks (of 128 Kbase) per device batch.  On the GPU: 64, i.e.
    8.4 Mbase batches — the config-1 sketch (256 x 2 Mb, L3K10) took
    0.25-0.27 s at 64 against 0.70-0.87 s at 16 on an H100 at 700 W,
    fewer dispatches and transfers (PERF.md).  CPU backends keep
    ``cpu_blocks`` so tests stay light."""
    return 64 if jax.default_backend() == "gpu" else cpu_blocks


class DeviceSketcher:
    """Streams genomes through the device sketch step and collects sketches."""

    def __init__(self, params: KssdParams, shuffled_dim: np.ndarray,
                 n_blocks: int | None = None, block: int = 1 << 17,
                 least_qual: int = 0, least_num_kmer: int = 1,
                 buf_cap: int = 1 << 23, threads: int = 0):
        if n_blocks is None:
            n_blocks = default_n_blocks(16)
        self.params = params
        self.least_qual = least_qual
        self.least_num_kmer = least_num_kmer
        self.threads = threads
        self.n_blocks = n_blocks
        self.block = block
        self.table = jnp.asarray(shuffled_dim.astype(np.int32))
        n = n_blocks * block
        # per-batch capacity: 4x the expected survivor count, floor 16k
        exp = n >> (4 * params.drlevel)
        self.cap = min(n, max(1 << 14, 4 * exp))
        self.buf_cap = max(buf_cap, 4 * self.cap)
        self._step = make_stream_step(params, n_blocks, block, self.cap,
                                      self.buf_cap)

    def _fresh_buffers(self):
        z32 = jnp.zeros(self.buf_cap, jnp.uint32)
        return (z32, jnp.zeros_like(z32), jnp.zeros(self.buf_cap, jnp.int32),
                jnp.zeros(self.buf_cap, jnp.int32), jnp.int32(0),
                jnp.bool_(False))

    def _zero_batch(self) -> tuple:
        """Stream-step arguments for one all-zero batch."""
        halo = aligned_halo(self.params)
        nw = self.block // 16 + halo // 16 + 2
        words = jnp.zeros((self.n_blocks, nw), jnp.uint32)
        exc = jnp.asarray(pad_exceptions(
            np.empty(0, np.int32), self.n_blocks * (self.block + halo)))
        return (words, exc, self.table, *self._fresh_buffers(),
                jnp.int32(0), jnp.int32(0))

    def prewarm(self) -> None:
        """Trace + compile (or cache-load) the stream step and flush
        reads on a zero batch, off the critical path — a serving
        process warms these once instead of inside the first sketch
        call."""
        bufs = self._step(*self._zero_batch())
        read_scalars(bufs[4], bufs[5])
        read_prefixes(list(bufs[:4]), 1)

    def step_memory_analysis(self):
        """``compiled.memory_analysis()`` of the stream step."""
        return self._step.lower(*self._zero_batch()).compile(
        ).memory_analysis()

    def _full_cap_sketcher(self, payload: int) -> "DeviceSketcher":
        """Clone with cap = the whole batch payload (cannot overflow),
        used by the exact fallback; built lazily, cached."""
        full = getattr(self, "_full_cache", None)
        if full is None:
            full = DeviceSketcher.__new__(DeviceSketcher)
            full.__dict__.update(self.__dict__)
            full.cap = payload
            full.buf_cap = max(self.buf_cap, 2 * payload)
            full._step = make_stream_step(self.params, self.n_blocks,
                                          self.block, full.cap,
                                          full.buf_cap, compaction="dense")
            self._full_cache = full
        return full

    # -- core ---------------------------------------------------------------
    def sketch_codes(self, genome_codes: Iterator[np.ndarray]
                     ) -> tuple[list[np.ndarray], int]:
        """Run the pipeline over per-genome code arrays.

        Returns (per-genome sorted-unique hash arrays, n_genomes).
        Zero per-batch device syncs: results accumulate on device and are
        read back as large slabs per flush window.
        """
        p = self.params
        halo = aligned_halo(p)
        payload = self.n_blocks * self.block
        flat_size = self.n_blocks * (self.block + halo)
        feeder = WordTapeFeeder(genome_codes, self.n_blocks, self.block,
                                halo)
        pos_chunks: list[np.ndarray] = []
        hash_chunks: list[np.ndarray] = []
        finalizer = GenomeFinalizer(feeder, p, self.least_num_kmer)

        # flush window: batches per carry-buffer drain, at most what
        # the carry buffers hold.  Each pending batch keeps its packed
        # words on device (~2 MB, kept only for the rare overflow
        # re-run; the host copy is dropped once transferred) —
        # KSSD_FLUSH_WINDOW bounds that and the survivor-accumulation
        # footprint.
        window = max(1, min((self.buf_cap // self.cap) - 1,
                            int(os.environ.get("KSSD_FLUSH_WINDOW", 512))))
        pending: list[_TapeBatch] = []
        bufs = self._fresh_buffers()

        # itemized wall budget (cheap perf_counter accumulators; read
        # via .last_budget): where the sketch phase actually goes, per
        # pipeline role — the three threads overlap, so components sum
        # to MORE than the wall unless one role is the bottleneck
        from time import perf_counter as _pc

        B = {"feed": 0.0, "h2d_put": 0.0, "h2d_wait": 0.0, "qwait": 0.0,
             "dispatch": 0.0, "flush_scalars": 0.0, "flush_collect": 0.0,
             "finalize": 0.0, "drain": 0.0, "wall": 0.0,
             "h2d_bytes": 0, "batches": 0}
        t_start = _pc()

        def flush(cur_bufs, pending_batches):
            *bufarrs, count, overflow = cur_bufs
            t0 = _pc()
            total, oflow = read_scalars(count, overflow)
            B["flush_scalars"] += _pc() - t0
            oflow = bool(oflow)
            if oflow:
                # exact fallback: re-run this window, one batch at a time,
                # at full capacity (the full-cap step compiles once per
                # sketcher, not per overflowing window)
                full = self._full_cap_sketcher(payload)
                for b in pending_batches:
                    fb = full._fresh_buffers()
                    fb = full._step(b.words,
                                    pad_exceptions(b.exc, flat_size),
                                    self.table, *fb, jnp.int32(0),
                                    jnp.int32(b.valid_upto))
                    _collect(fb, [b])
            else:
                t0 = _pc()
                _collect((*bufarrs, count, overflow), pending_batches,
                         known_total=total)
                B["flush_collect"] += _pc() - t0
            t0 = _pc()
            finalizer.add(hash_chunks, pos_chunks,
                          pending_batches[-1].base
                          + pending_batches[-1].valid_upto)
            B["finalize"] += _pc() - t0

        def _collect(cur_bufs, pending_batches, known_total=None):
            buf_lo, buf_hi, buf_pos, buf_batch, count, overflow = cur_bufs
            if known_total is None:
                known_total, oflow = read_scalars(count, overflow)
                if oflow:
                    raise RuntimeError(
                        "sketch capacity overflow in fallback path"
                    )
            n = known_total
            if n == 0:
                return
            # one transfer for all carry buffers
            slabs = [buf_lo] + ([buf_hi] if p.use64 else []) \
                + [buf_pos, buf_batch]
            got = read_prefixes(slabs, n)
            lo = got[0]
            pos = got[-2].astype(np.int64)
            bidx = got[-1]
            base = np.array([b.base for b in pending_batches], np.int64)
            gpos = base[bidx] + pos
            if p.use64:
                h = got[1].astype(np.uint64) << np.uint64(32)
                h |= lo.astype(np.uint64)
            else:
                h = lo.astype(np.uint32)
            hash_chunks.append(h)
            pos_chunks.append(gpos)

        # producer thread: parse+pack+H2D overlap with device execution
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=8)

        def producer():
            # device_put is async; each in-flight transfer pins a host
            # staging copy, so if the parse pool outruns H2D the backlog
            # grows without bound.  Gate on total in-flight BYTES
            # (KSSD_INFLIGHT_MB), waiting only on the OLDEST transfer
            # when over budget — newer transfers stay enqueued behind
            # it, so the pipeline stays deep while host memory is
            # bounded.
            from collections import deque

            budget = int(os.environ.get("KSSD_INFLIGHT_MB", "512")) << 20
            # KSSD_XFER_COALESCE batches share one device_put of their
            # stacked exception lists; the consumer slices per-batch
            # views on device
            coalesce = int(os.environ.get("KSSD_XFER_COALESCE", "1"))
            inflight: deque = deque()
            cur = 0

            def ship(group):
                # words go as one async put per batch; only the small
                # per-batch exception lists are stacked into one put
                nonlocal cur
                t0 = _pc()
                excs = [pad_exceptions(b.exc, flat_size) for b in group]
                cap_e = max(e.size for e in excs)
                exc_pad = np.full((len(group), cap_e), flat_size,
                                  np.int32)
                for i, e in enumerate(excs):
                    exc_pad[i, : e.size] = e
                des = jax.device_put(exc_pad)
                dws = [jax.device_put(b.words) for b in group]
                nbytes = sum(b.words.nbytes for b in group)
                B["h2d_put"] += _pc() - t0
                B["h2d_bytes"] += nbytes
                B["batches"] += len(group)
                q.put((dws, des, group))
                cur += nbytes
                inflight.append((nbytes, dws[-1]))
                t0 = _pc()
                while cur > budget and inflight:
                    nb_, arr = inflight.popleft()
                    jax.block_until_ready(arr)
                    cur -= nb_
                B["h2d_wait"] += _pc() - t0

            try:
                it = iter(feeder)
                group: list[_TapeBatch] = []
                while True:
                    t0 = _pc()
                    batch = next(it, None)
                    B["feed"] += _pc() - t0
                    if batch is None:
                        break
                    group.append(batch)
                    if len(group) == coalesce:
                        ship(group)
                        group = []
                if group:
                    ship(group)
            except BaseException as e:  # surface in consumer
                q.put(e)
                return
            q.put(None)

        t = threading.Thread(target=producer, daemon=True,
                             name="kssd-feed")
        t.start()
        flusher = _AsyncFlusher(flush)
        try:
            while True:
                t0 = _pc()
                item = q.get()
                B["qwait"] += _pc() - t0
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                dws, des, group = item
                for i, batch in enumerate(group):
                    # per-batch words transfer + a device-side slice of
                    # the coalesced exception stack (no further host
                    # traffic)
                    d2 = dws[i]
                    dexc = des[i]
                    # pending batches keep their words ONLY for the
                    # rare overflow re-run; retain the DEVICE transfer
                    # (~2 MB/batch) and drop the host copy — over a
                    # whole flush window the host copies would be the
                    # whole packed corpus
                    batch.words = d2
                    if len(pending) == window:
                        flusher.submit(bufs, pending)
                        bufs = self._fresh_buffers()
                        pending = []
                    t0 = _pc()
                    bufs = self._step(d2, dexc, self.table, *bufs,
                                      jnp.int32(len(pending)),
                                      jnp.int32(batch.valid_upto))
                    B["dispatch"] += _pc() - t0
                    pending.append(batch)
            t.join()
            t_loop_end = _pc()
            if pending:
                flusher.submit(bufs, pending)
        finally:
            flusher.shutdown()
        if flusher.error is not None:
            raise flusher.error
        B["drain"] = _pc() - t_loop_end

        self.last_peak_pending = finalizer.peak_pending
        t0 = _pc()
        out = finalizer.finish()
        B["finalize"] += _pc() - t0
        B["wall"] = _pc() - t_start
        self.last_budget = {k: (round(v, 4) if isinstance(v, float) else v)
                            for k, v in B.items()}
        return out

    # -- file-level API -------------------------------------------------------
    def sketch_files(self, files: list[str]) -> SketchSet:
        """Sketch each file as one genome (the reference's per-file unit,
        sketch.cpp:455-566).

        Files are processed largest-first (stable), matching the
        reference's size-descending schedule (cmpFile, sketch.cpp:39-41,
        348-378) — its single-thread sketch order, which also determines
        the i/j orientation of distance rows.
        """
        sizes = [os.stat(p).st_size for p in files]
        order = sorted(range(len(files)), key=lambda i: -sizes[i])
        files = [files[i] for i in order]

        from concurrent.futures import ThreadPoolExecutor

        from ..native import fasta_packed, fasta_packed_chunks, load_native

        # files beyond this stream through the chunked native reader
        # instead of materializing their whole packed tape (config-4
        # multi-GB genomes; reference big-file path sketch.cpp:380-410)
        stream_threshold = int(
            os.environ.get("KSSD_STREAM_THRESHOLD", 1 << 30)
        )

        def parse(path: str):
            if (load_native() is not None
                    and os.stat(path).st_size > stream_threshold):
                # prefetch thread: the file parses ahead of (and in
                # parallel with) the feeder consuming it, so a multi-GB
                # genome's read overlaps the device processing of the
                # previous one (the RabbitFX producer role,
                # reference sketch.cpp:396-410); memory stays bounded
                # by `depth` chunks
                return _prefetch_chunks(
                    fasta_packed_chunks(path, self.least_qual))
            pk = fasta_packed(path, self.least_qual)
            if pk is None:  # no native toolchain: python parser
                recs = [(r.seq, r.qual) for r in read_records(path)]
                pk = pack_words_np(encode_concat(recs, self.least_qual))
            return pk

        def gen() -> Iterator[np.ndarray]:
            # bounded parallel parse (native parser releases the GIL) —
            # the RabbitFX producer-pool role (sketch.cpp:380-410)
            workers = self.threads or min(8, os.cpu_count() or 1)
            depth = 2 * workers
            with ThreadPoolExecutor(max_workers=workers) as ex:
                futs: list = []
                it = iter(files)
                for path in it:
                    futs.append(ex.submit(parse, path))
                    if len(futs) >= depth:
                        break
                ring = len(futs)
                i = 0
                for path in it:
                    yield futs[i % ring].result()
                    futs[i % ring] = ex.submit(parse, path)
                    i += 1
                for j in range(ring):
                    yield futs[(i + j) % ring].result()

        import sys

        from ..utils.timers import progress_bar_size

        step_pb = progress_bar_size(len(files))

        def gen_progress():
            for i, codes in enumerate(gen()):
                if i % step_pb == 0:
                    print(f"finshed sketching: {i} genomes",
                          file=sys.stderr)
                yield codes

        hashes, n = self.sketch_codes(gen_progress())
        assert n == len(files)
        p = self.params
        info = SketchInfo(
            id=p.sketch_id, half_k=p.half_k, half_subk=p.half_subk,
            drlevel=p.drlevel, genome_number=len(files),
        )
        sketches = [Sketch(name=f, hashes=h) for f, h in zip(files, hashes)]
        return SketchSet(info=info, sketches=sketches)


class ShardedSketcher:
    """Mesh-data-parallel sketcher: batches shard across all devices.

    Same exactness contract as DeviceSketcher; each device accumulates
    its shard's survivors in private carry buffers (the reference's
    per-consumer hash sets, sketch.cpp:411-435), merged on host at
    flush.  Overflow anywhere falls back to the single-chip exact path
    for the affected window.
    """

    def __init__(self, params: KssdParams, shuffled_dim: np.ndarray,
                 mesh=None, n_blocks: int | None = None,
                 block: int = 1 << 17,
                 least_qual: int = 0, least_num_kmer: int = 1,
                 buf_cap: int = 1 << 22, threads: int = 0):
        from ..parallel.sharded import make_mesh

        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = int(np.prod(self.mesh.devices.shape))
        if n_blocks is None:
            # per-SHARD batch size: the single-device value on GPUs;
            # CPU-mesh tests keep small batches
            n_blocks = default_n_blocks(4)
        self.params = params
        self.least_qual = least_qual
        self.least_num_kmer = least_num_kmer
        self.threads = threads
        self.n_blocks = n_blocks  # per shard
        self.block = block
        self.table = jnp.asarray(shuffled_dim.astype(np.int32))
        n = n_blocks * block  # per-shard payload
        exp = n >> (4 * params.drlevel)
        self.cap = min(n, max(1 << 14, 4 * exp))
        self.buf_cap = max(buf_cap, 4 * self.cap)
        self._step = make_sharded_stream_step(
            params, self.mesh, n_blocks, block, self.cap, self.buf_cap
        )

    def _fresh_buffers(self):
        s = self.n_shards
        z = jnp.zeros((s, self.buf_cap), jnp.uint32)
        return (z, jnp.zeros_like(z),
                jnp.zeros((s, self.buf_cap), jnp.int32),
                jnp.zeros((s, self.buf_cap), jnp.int32),
                jnp.zeros((s,), jnp.int32),
                jnp.zeros((s,), jnp.bool_))

    def sketch_codes(self, genome_codes: Iterator[np.ndarray]
                     ) -> tuple[list[np.ndarray], int]:
        from ..ops.hostxfer import read_array

        p = self.params
        halo = aligned_halo(p)
        S = self.n_shards
        shard_payload = self.n_blocks * self.block
        L = self.block + halo  # halo'd row length (bases)
        feeder = WordTapeFeeder(genome_codes, S * self.n_blocks,
                                self.block, halo)
        # same flush-window policy as the single-device path (see
        # DeviceSketcher.sketch_codes)
        window = max(1, min((self.buf_cap // self.cap) - 1,
                            int(os.environ.get("KSSD_FLUSH_WINDOW", 512))))
        pending: list[_TapeBatch] = []
        bufs = self._fresh_buffers()
        hash_chunks: list[np.ndarray] = []
        pos_chunks: list[np.ndarray] = []
        finalizer = GenomeFinalizer(feeder, p, self.least_num_kmer)

        def collect(cur_bufs, pending_batches):
            buf_lo, buf_hi, buf_pos, buf_batch, count, overflow = cur_bufs
            counts = read_array(count)
            oflow = read_array(overflow)
            if oflow.any():
                # exact fallback: dense single-chip re-run of this window
                for b in pending_batches:
                    h, pos = _rerun_batch_single(self.table, b, p)
                    hash_chunks.append(h)
                    pos_chunks.append(pos)
                finalizer.add(hash_chunks, pos_chunks,
                              pending_batches[-1].base
                              + pending_batches[-1].valid_upto)
                return
            mx = int(counts.max()) if counts.size else 0
            if mx > 0:
                bucket = 1024
                while bucket < mx:
                    bucket <<= 1
                bucket = min(bucket, self.buf_cap)
                lo2 = read_array(buf_lo[:, :bucket])
                hi2 = read_array(buf_hi[:, :bucket]) if p.use64 else None
                po2 = read_array(buf_pos[:, :bucket])
                bi2 = read_array(buf_batch[:, :bucket])
                base = np.array([b.base for b in pending_batches],
                                np.int64)
                for s in range(S):
                    c = int(counts[s])
                    if c == 0:
                        continue
                    lo = lo2[s, :c]
                    if p.use64:
                        h = (hi2[s, :c].astype(np.uint64) << np.uint64(32)
                             | lo.astype(np.uint64))
                    else:
                        h = lo.astype(np.uint32)
                    gpos = (base[bi2[s, :c]]
                            + np.int64(s) * shard_payload
                            + po2[s, :c].astype(np.int64))
                    hash_chunks.append(h)
                    pos_chunks.append(gpos)
            finalizer.add(hash_chunks, pos_chunks,
                          pending_batches[-1].base
                          + pending_batches[-1].valid_upto)

        shard_flat = self.n_blocks * L
        flusher = _AsyncFlusher(collect)
        try:
            self._stream_loop(feeder, flusher, bufs, pending, window, S,
                              shard_flat, shard_payload)
        finally:
            flusher.shutdown()
        if flusher.error is not None:
            raise flusher.error

        self.last_peak_pending = finalizer.peak_pending
        return finalizer.finish()

    def _stream_loop(self, feeder, flusher, bufs, pending, window, S,
                     shard_flat, shard_payload):
        for batch in feeder:
            if len(pending) == window:
                flusher.submit(bufs, pending)
                bufs = self._fresh_buffers()
                pending = []
            words = batch.words.reshape(S, self.n_blocks, -1)
            # split the batch exception list by shard (flat coords are
            # row-major over all S * n_blocks halo'd rows)
            shard_of = batch.exc // shard_flat
            order = np.argsort(shard_of, kind="stable")
            exc_s = batch.exc[order] - shard_of[order] * shard_flat
            bounds = np.searchsorted(shard_of[order], np.arange(S + 1))
            cap_exc = 1024
            while cap_exc < max(np.diff(bounds), default=0):
                cap_exc <<= 1
            exc_arr = np.full((S, cap_exc), shard_flat, np.int32)
            for s in range(S):
                e = exc_s[bounds[s] : bounds[s + 1]]
                exc_arr[s, : len(e)] = e
            # per-shard valid_upto in shard-local payload coords
            vupto = np.clip(
                batch.valid_upto - np.arange(S) * shard_payload,
                0, shard_payload,
            ).astype(np.int32)
            bufs = self._step(words, exc_arr, self.table, *bufs,
                              jnp.int32(len(pending)), vupto)
            pending.append(batch)
        if pending:
            flusher.submit(bufs, pending)


# the file-level API is identical across sketchers (it only needs
# .params, .least_qual and .sketch_codes)
ShardedSketcher.sketch_files = DeviceSketcher.sketch_files
MeshSketcher = ShardedSketcher



@functools.lru_cache(maxsize=8)
def _rerun_kernel(p: KssdParams):
    """Jitted dense hash kernel for the overflow re-run (one wrapper per
    params so retraces/compiles do not repeat per window)."""
    return jax.jit(hash_windows_stream(p))


def _rerun_batch_single(table, batch: _TapeBatch,
                        p: KssdParams) -> tuple[np.ndarray, np.ndarray]:
    """Exact re-hash of one batch via the (overflow-safe) dense path."""
    from ..ops.kmer import combine_hash_words

    halo_a = aligned_halo(p)
    nb, nw = batch.words.shape
    L = 16 * (nw - 2)
    block = L - halo_a
    valid = np.ones(nb * L, bool)
    valid[batch.exc] = False
    valid = valid.reshape(nb, L)
    coord = (np.arange(nb)[:, None] * block + np.arange(L)[None, :]
             - halo_a)
    valid &= coord < batch.valid_upto
    h_lo, h_hi, keep = _rerun_kernel(p)(
        jnp.asarray(batch.words), jnp.asarray(valid), table)
    keep = np.asarray(keep)[:, halo_a:]
    h = combine_hash_words(
        np.asarray(h_lo)[:, halo_a:], np.asarray(h_hi)[:, halo_a:],
        keep, p.use64,
    )
    flat_pos = np.nonzero(keep.ravel())[0].astype(np.int64) + batch.base
    return h, flat_pos


class GenomeFinalizer:
    """Per-genome sketch finalization as the tape passes genome ends.

    Survivor (hash, tape-position) chunks arrive per flush window; any
    genome whose [start, end) span lies entirely below the flushed
    watermark is final — its survivors are deduplicated (np.unique, plus
    the fastq abundance filter) and freed immediately.  Host memory is
    thus bounded by one flush window's survivors plus any genome still
    in flight, independent of corpus size — the streaming analogue of
    the reference freeing each per-genome hash set after insertion into
    the sketch vector (sketch.cpp:529,434-447), where round 1 held every
    survivor until end of corpus (tens of GB at the 100k-genome config).
    """

    def __init__(self, feeder: WordTapeFeeder, p: KssdParams,
                 least_num_kmer: int):
        self.feeder = feeder
        self.dt = np.uint64 if p.use64 else np.uint32
        self.least = least_num_kmer
        self._h: list[np.ndarray] = []  # pending survivor hashes
        self._p: list[np.ndarray] = []  # ... and their tape positions
        self._next = 0  # next genome index to finalize
        self.out: list[np.ndarray] = []
        self.peak_pending = 0  # max survivors ever held (for tests)

    def _finalize_upto(self, g_hi: int) -> None:
        if g_hi <= self._next:
            return
        if self._h:
            allh = np.concatenate(self._h)
            allp = np.concatenate(self._p)
        else:
            allh = np.empty(0, self.dt)
            allp = np.empty(0, np.int64)
        self._h.clear()
        self._p.clear()
        self.peak_pending = max(self.peak_pending, allh.size)
        starts = np.asarray(self.feeder.starts, dtype=np.int64)
        gidx = np.searchsorted(starts, allp, side="right") - 1
        order = np.argsort(gidx, kind="stable")
        gsorted = gidx[order]
        hsorted = allh[order]
        psorted = allp[order]
        bounds = np.searchsorted(gsorted, np.arange(self._next, g_hi + 1))
        for i in range(g_hi - self._next):
            h = hsorted[bounds[i]: bounds[i + 1]]
            if self.least > 1:
                vals, counts = np.unique(h, return_counts=True)
                vals = vals[counts >= self.least]
            else:
                vals = np.unique(h)
            self.out.append(vals.astype(self.dt))
        if bounds[-1] < hsorted.size:  # survivors of unfinished genomes
            self._h.append(hsorted[bounds[-1]:])
            self._p.append(psorted[bounds[-1]:])
        self._next = g_hi

    def add(self, hash_chunks: list[np.ndarray],
            pos_chunks: list[np.ndarray], upto: int) -> None:
        """Ingest one flush window's survivor chunks (consumes the
        lists) and finalize every genome that ended at tape position
        <= ``upto``."""
        self._h.extend(hash_chunks)
        self._p.extend(pos_chunks)
        hash_chunks.clear()
        pos_chunks.clear()
        ends = self.feeder.ends
        g_hi = self._next
        while g_hi < len(ends) and ends[g_hi] <= upto:
            g_hi += 1
        self._finalize_upto(g_hi)

    def finish(self) -> tuple[list[np.ndarray], int]:
        self._finalize_upto(len(self.feeder.ends))
        n = len(self.feeder.starts)
        while len(self.out) < n:  # trailing genomes with zero survivors
            self.out.append(np.empty(0, self.dt))
        return self.out, n


def sketch_file_list(list_path: str, shuf: "shuffle_mod.ShuffleFile",
                     least_qual: int = 0, least_num_kmer: int = 1,
                     threads: int = 0, **kw) -> SketchSet:
    """List-of-files entry point (the command_sketch engine,
    reference subCommand.cpp:50-68).

    The input list must classify as fasta or fastq (sniffers mirror
    sketch.cpp:68-161); quality/abundance thresholds apply only on the
    fastq path, as in the reference (sketchFastaFile takes neither).
    """
    from ..seqio import classify_list, read_list

    kind = classify_list(list_path)
    if kind == "fasta":
        least_qual, least_num_kmer = 0, 1
    files = read_list(list_path)
    params = KssdParams(half_k=shuf.k, half_subk=shuf.subk, drlevel=shuf.drlevel)
    sketcher = kw.pop("sketcher", None)
    if sketcher is not None:
        # caller-provided (e.g. constructed early and prewarmed while
        # other work ran); quality thresholds must already match
        return sketcher.sketch_files(files)
    if kw.get("mesh") is not None or len(jax.devices()) > 1:
        sk = MeshSketcher(params, shuf.shuffled_dim, least_qual=least_qual,
                          least_num_kmer=least_num_kmer, threads=threads,
                          **kw)
    else:
        kw.pop("mesh", None)
        sk = DeviceSketcher(params, shuf.shuffled_dim,
                            least_qual=least_qual,
                            least_num_kmer=least_num_kmer,
                            threads=threads, **kw)
    return sk.sketch_files(files)
