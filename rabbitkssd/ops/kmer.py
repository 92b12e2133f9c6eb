"""Device k-mer hashing: the sketch kernel (XLA formulation).

Re-design of the reference per-base rolling hot loop
(reference sketch.cpp:491-532 fasta, 781-825 fastq) as a
*batched windowed array program*:

* Sequences arrive as fixed-size blocks of 2-bit base codes with a
  ``kmer_size-1``-base halo prefix (so windows never span block edges and
  blocks of one genome can be processed independently — the device
  analogue of RabbitFX's chunked consumers, sketch.cpp:396-410).
* All k-mer integer math is done in **paired uint32 lanes** (hi/lo words)
  rather than uint64, so every vector op is a native 32-bit one.
* The per-base sequential rolling state of the reference collapses into
  O(1)-per-window bitstream extraction (:func:`hash_windows_stream`, the
  production kernel) or a ``kmer_size``-step shift-OR
  (:func:`hash_windows`, the reference formulation kept for the sharded
  dryrun + cross-validation); the "reset on invalid base" semantics
  (sketch.cpp:507-510) collapse into a windowed all-valid test via
  cumulative sums — bit-exact because a window is emitted iff the last
  kmer_size bases were all valid/contiguous (sketch.cpp:512).
* The substring-space permutation lookup (``shuffled_dim[dim_id]``,
  sketch.cpp:519) becomes one device gather into the int32 permutation
  table resident in device memory.

Output: per window, the composed reduced hash as (hi, lo) uint32 words
plus a keep mask.  Deduplication happens downstream (segmented
sort-unique or host np.unique).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import _config  # noqa: F401  (persistent compile cache)
import numpy as np

from ..params import KssdParams

U32 = jnp.uint32


def _extract_field(lo, hi, start: int, width: int):
    """Static-bit-range field extraction from a (hi, lo) uint32 pair.

    All shift amounts are Python ints resolved at trace time, so only the
    needed ops are emitted (no dynamic shifts, no 64-bit lanes).
    """
    assert 0 < width <= 32
    mask = jnp.uint32((1 << width) - 1) if width < 32 else jnp.uint32(0xFFFFFFFF)
    if start >= 32:
        v = hi >> (start - 32) if start > 32 else hi
    elif start + width <= 32:
        v = lo >> start if start > 0 else lo
    else:
        v = (lo >> start) | (hi << (32 - start))
    return v & mask


def _deposit_field(acc_lo, acc_hi, value, shift: int, width: int):
    """OR a (<=32-bit) value into a (hi, lo) pair at static bit offset."""
    if shift >= 32:
        return acc_lo, acc_hi | (value << (shift - 32) if shift > 32 else value)
    acc_lo = acc_lo | (value << shift if shift > 0 else value)
    if shift + width > 32:
        acc_hi = acc_hi | (value >> (32 - shift))
    return acc_lo, acc_hi


def _shift_right(x, t: int):
    """x[i] -> x[i-t] along the last axis, zero-filled (static t)."""
    if t == 0:
        return x
    pad = [(0, 0)] * (x.ndim - 1) + [(t, 0)]
    return jnp.pad(x, pad)[..., : x.shape[-1]]


def _window_codes(codes_u32, K: int):
    """Rolling forward / reverse-complement codes for every window.

    codes_u32: uint32[..., L] base codes in 0..3 (invalid positions may
    hold any value in 0..3; they are masked out by the validity window).

    Returns (fwd_lo, fwd_hi, rvs_lo, rvs_hi) for the window *ending* at
    each position: fwd = b[i-K+1]..b[i] with the newest base in the low
    bits (reference ``tuple`` update sketch.cpp:502), rvs = complement
    with newest base in the high bits (``rvs_tuple``, sketch.cpp:503).
    """
    zeros = jnp.zeros_like(codes_u32)
    fwd_lo, fwd_hi = zeros, zeros
    rvs_lo, rvs_hi = zeros, zeros
    for t in range(K):
        s = _shift_right(codes_u32, t)  # base at window offset t (newest=0)
        c = s ^ jnp.uint32(3)
        off = 2 * t
        if off < 32:
            fwd_lo = fwd_lo | (s << off)
        else:
            fwd_hi = fwd_hi | (s << (off - 32))
        off2 = 2 * (K - 1 - t)
        if off2 < 32:
            rvs_lo = rvs_lo | (c << off2)
        else:
            rvs_hi = rvs_hi | (c << (off2 - 32))
    return fwd_lo, fwd_hi, rvs_lo, rvs_hi


def _windows_all_valid(valid_i32, K: int):
    """True where the K positions ending here are all valid (cumsum trick)."""
    csum = jnp.cumsum(valid_i32, axis=-1)
    behind = _shift_right(csum, K)
    n = valid_i32.shape[-1]
    wsum = csum - behind
    pos_ok = jax.lax.broadcasted_iota(jnp.int32, valid_i32.shape, valid_i32.ndim - 1) >= (
        K - 1
    )
    del n
    return (wsum == K) & pos_ok


def pack_codes_sparse_np(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int8 codes (-1 invalid) -> (packed2 u8, exception positions i32).

    Invalid bases (N runs, low-quality, record/genome separators) are
    typically <1% of the tape, so shipping their flat positions beats a
    dense 1-bit mask.
    Positions index the flattened ``codes``.
    """
    assert codes.shape[-1] % 4 == 0
    valid = codes >= 0
    vals = np.where(valid, codes, 0).astype(np.uint8)
    v4 = vals.reshape(*codes.shape[:-1], -1, 4)
    packed2 = (v4[..., 0] | (v4[..., 1] << 2) | (v4[..., 2] << 4)
               | (v4[..., 3] << 6)).astype(np.uint8)
    exc = np.nonzero(~valid.ravel())[0].astype(np.int32)
    return packed2, exc


def pack_words_np(codes: np.ndarray) -> tuple[np.ndarray, int, np.ndarray]:
    """int8 codes (-1 invalid) -> (words u32[ceil(n/16)], n, exc i32).

    numpy fallback for the native ``kssd_pack_codes``: base i lands at
    bits 2*(i%16) of word i//16; invalid positions pack as 0 bits and
    are returned as flat positions.
    """
    n = len(codes)
    valid = codes >= 0
    exc = np.nonzero(~valid)[0].astype(np.int32)
    pad = (-n) % 16
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, np.int8)])
        valid = np.concatenate([valid, np.ones(pad, bool)])
    vals = np.where(valid, codes, 0).astype(np.uint8)
    v4 = vals.reshape(-1, 4)
    packed2 = (v4[:, 0] | (v4[:, 1] << 2) | (v4[:, 2] << 4)
               | (v4[:, 3] << 6)).astype(np.uint8)
    words = np.ascontiguousarray(packed2).view("<u4")
    return words, n, exc


def pad_exceptions(exc: np.ndarray, flat_size: int, floor: int = 1024
                   ) -> np.ndarray:
    """Pad exception positions to a power-of-two bucket; pads carry
    ``flat_size`` (out of range -> dropped by the device scatter)."""
    cap = floor
    while cap < len(exc):
        cap <<= 1
    out = np.full(cap, flat_size, np.int32)
    out[: len(exc)] = exc
    return out


def hash_windows(params: KssdParams):
    """Block-hash function for fixed params (plain, composable under jit).

    Returned fn:  (codes int8[..., L], valid bool[..., L], table int32[D])
    -> (hash_lo u32[..., L], hash_hi u32[..., L], keep bool[..., L])

    where a window ends at each position (positions < kmer_size-1 and
    invalid windows have keep=False).  Hash composition mirrors
    sketch.cpp:524: ``((uni&undomask0) | ((uni&undomask1)<<u1shift))
    >> (drlevel*4) | pfilter`` — re-derived here as static bit-field
    extract/deposit on uint32 pairs.
    """
    p = params
    K = p.kmer_size
    hoc2 = 2 * p.half_outctx_len
    subk4 = 4 * p.half_subk
    pf_bits = 4 * (p.half_subk - p.drlevel)
    dimsize_mask = p.dim_size - 1
    dim_end = p.dim_end

    def hash_blocks(codes, valid, table):
        codes_u32 = jnp.where(valid, codes, 0).astype(U32)
        fwd_lo, fwd_hi, rvs_lo, rvs_hi = _window_codes(codes_u32, K)
        ok = _windows_all_valid(valid.astype(jnp.int32), K)

        use_fwd = (fwd_hi < rvs_hi) | ((fwd_hi == rvs_hi) & (fwd_lo <= rvs_lo))
        uni_lo = jnp.where(use_fwd, fwd_lo, rvs_lo)
        uni_hi = jnp.where(use_fwd, fwd_hi, rvs_hi)

        dim_id = _extract_field(uni_lo, uni_hi, hoc2, subk4) & jnp.uint32(dimsize_mask)
        # one gather into the permutation table (sketch.cpp:519)
        pf = jnp.take(table, dim_id.astype(jnp.int32), axis=0)
        keep = ok & (pf >= 0) & (pf < dim_end)
        pf_u = pf.astype(U32)

        h_lo = pf_u
        h_hi = jnp.zeros_like(pf_u)
        if hoc2 > 0:
            low_outer = _extract_field(uni_lo, uni_hi, 0, hoc2)
            high_outer = _extract_field(uni_lo, uni_hi, hoc2 + subk4, hoc2)
            h_lo, h_hi = _deposit_field(h_lo, h_hi, low_outer, pf_bits, hoc2)
            h_lo, h_hi = _deposit_field(h_lo, h_hi, high_outer, pf_bits + hoc2, hoc2)
        return h_lo, h_hi, keep

    return hash_blocks


def make_hash_kernel(params: KssdParams):
    """Jitted wrapper of :func:`hash_windows` (test / standalone use)."""
    return jax.jit(hash_windows(params))


# --------------------------------------------------------------------------
# bitstream formulation: O(1) work per window instead of a K-step unroll
# --------------------------------------------------------------------------

def _rev2_32(x):
    """Reverse the order of the 16 2-bit groups in each uint32 lane."""
    m2 = jnp.uint32(0x33333333)
    m4 = jnp.uint32(0x0F0F0F0F)
    m8 = jnp.uint32(0x00FF00FF)
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    return (x << 16) | (x >> 16)


def _shift_right_fill(x, t: int):
    """x[i] -> x[i-t] along the last axis (t may be negative = left)."""
    if t == 0:
        return x
    n = x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 1)
    if t > 0:
        return jnp.pad(x, pad + [(t, 0)])[..., :n]
    return jnp.pad(x, pad + [(0, -t)])[..., -t:]


def hash_windows_stream(params: KssdParams):
    """Bitstream hash kernel: same contract as :func:`hash_windows` but
    taking the 2-bit **packed word stream** directly.

    The packed stream already holds every window's bits contiguously, so
    the forward code of the window ending at i is a variable-shift
    extraction from words W[s>>4], W[s>>4+1], W[s>>4+2] (s = i-K+1) —
    O(1) vector ops per window instead of the kmer_size-step shift-OR
    unroll, and the reverse complement is a 4-step 2-bit-group reversal.
    This is the performance-critical reformulation: the unrolled version
    costs ~K HBM passes; this one is a handful.

    fn: (words u32[..., nw], valid bool[..., L]) with L = 16*(nw-2)
        -> (hash_lo, hash_hi, keep) per window position in [0, L).
    Base i of the tape lives at bits 2*(i%16) of word i//16 (the layout
    produced by pack_codes_sparse_np + a u32 little-endian view, with 2
    zero pad words appended per row).
    """
    p = params
    K = p.kmer_size
    TB = 2 * K  # total window bits
    hoc2 = 2 * p.half_outctx_len
    subk4 = 4 * p.half_subk
    pf_bits = 4 * (p.half_subk - p.drlevel)
    dimsize_mask = p.dim_size - 1
    dim_end = p.dim_end

    def fwd_mask(lo, hi):
        if TB >= 64:
            return lo, hi
        if TB > 32:
            return lo, hi & jnp.uint32((1 << (TB - 32)) - 1)
        if TB == 32:
            return lo, jnp.zeros_like(hi)
        return lo & jnp.uint32((1 << TB) - 1), jnp.zeros_like(hi)

    def hash_stream(words, valid):
        nw = words.shape[-1]
        L = 16 * (nw - 2)
        lead = words.shape[:-1]

        # A_i = W[(i-K+1)>>4], B = next word, C = next — via one repeat
        wr = jnp.repeat(words, 16, axis=-1)  # wr[j] = W[j//16]
        a = _shift_right_fill(wr, K - 1)[..., :L]
        b = _shift_right_fill(wr, K - 1 - 16)[..., :L]
        c = _shift_right_fill(wr, K - 1 - 32)[..., :L]

        iota = jax.lax.broadcasted_iota(jnp.int32, (*lead, L), len(lead))
        sh = (2 * ((iota - (K - 1)) & 15)).astype(jnp.uint32)
        nz = sh != 0
        ish = jnp.uint32(32) - sh
        # E = the window's stream bits: OLDEST base in the low bits
        e_lo = jnp.where(nz, (a >> sh) | (b << ish), a)
        e_hi = jnp.where(nz, (b >> sh) | (c << ish), b)
        e_lo, e_hi = fwd_mask(e_lo, e_hi)

        # rvs (complemented, newest at high bits) = complement(E)
        r_lo = e_lo ^ jnp.uint32(0xFFFFFFFF)
        r_hi = e_hi ^ jnp.uint32(0xFFFFFFFF)
        r_lo, r_hi = fwd_mask(r_lo, r_hi)

        # fwd (newest at low bits) = 2-bit-group reversal of E
        t_lo, t_hi = _rev2_32(e_hi), _rev2_32(e_lo)
        shift = 64 - TB
        if shift == 0:
            f_lo, f_hi = t_lo, t_hi
        elif shift < 32:
            f_lo = (t_lo >> shift) | (t_hi << (32 - shift))
            f_hi = t_hi >> shift
        else:
            f_lo = t_hi >> (shift - 32) if shift > 32 else t_hi
            f_hi = jnp.zeros_like(t_hi)
        f_lo, f_hi = fwd_mask(f_lo, f_hi)

        ok = _windows_all_valid(valid.astype(jnp.int32), K)

        use_fwd = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo <= r_lo))
        uni_lo = jnp.where(use_fwd, f_lo, r_lo)
        uni_hi = jnp.where(use_fwd, f_hi, r_hi)

        dim_id = _extract_field(uni_lo, uni_hi, hoc2, subk4) & jnp.uint32(
            dimsize_mask
        )
        return uni_lo, uni_hi, dim_id, ok

    def compose(uni_lo, uni_hi, pf):
        """dr_tuple from canonical window + permuted rank (sketch.cpp:524)."""
        pf_u = pf.astype(U32)
        h_lo = pf_u
        h_hi = jnp.zeros_like(pf_u)
        if hoc2 > 0:
            low_outer = _extract_field(uni_lo, uni_hi, 0, hoc2)
            high_outer = _extract_field(uni_lo, uni_hi, hoc2 + subk4, hoc2)
            h_lo, h_hi = _deposit_field(h_lo, h_hi, low_outer, pf_bits, hoc2)
            h_lo, h_hi = _deposit_field(h_lo, h_hi, high_outer,
                                        pf_bits + hoc2, hoc2)
        return h_lo, h_hi

    def hash_full(words, valid, table):
        uni_lo, uni_hi, dim_id, ok = hash_stream(words, valid)
        pf = jnp.take(table, dim_id.astype(jnp.int32), axis=0)
        keep = ok & (pf >= 0) & (pf < dim_end)
        h_lo, h_hi = compose(uni_lo, uni_hi, pf)
        return h_lo, h_hi, keep

    return hash_full


def packed_to_words_np(packed2: np.ndarray) -> np.ndarray:
    """Host: packed 2-bit rows u8[..., B] (B % 4 == 0) -> u32 word rows
    with 2 zero pad words appended (the layout hash_windows_stream
    expects)."""
    assert packed2.shape[-1] % 4 == 0
    w = np.ascontiguousarray(packed2).view("<u4").reshape(
        *packed2.shape[:-1], -1
    )
    pad = np.zeros((*w.shape[:-1], 2), np.uint32)
    return np.concatenate([w, pad], axis=-1)


# --------------------------------------------------------------------------
# Host-side genome -> block packing
# --------------------------------------------------------------------------

_BASE_LUT_NP = np.full(256, -1, dtype=np.int8)
for _i, _ch in enumerate(b"ACGT"):
    _BASE_LUT_NP[_ch] = _i
    _BASE_LUT_NP[_ch + 32] = _i  # lowercase


def encode_concat(records: list[tuple[bytes, bytes | None]], least_qual: int = 0
                  ) -> np.ndarray:
    """Concatenate a genome's records into one int8 code array.

    Records are separated by a single -1 sentinel so k-mers never span
    record boundaries (kseq record loop, reference sketch.cpp:478-489).
    Low-quality bases (fastq, quality byte < least_qual) are marked
    invalid, mirroring sketch.cpp:795.
    """
    parts: list[np.ndarray] = []
    sep = np.array([-1], dtype=np.int8)
    for seq, qual in records:
        codes = _BASE_LUT_NP[np.frombuffer(seq, dtype=np.uint8)]
        if least_qual > 0 and qual is not None:
            # partial quality (EOF-truncated record) applies as far as read
            q = np.frombuffer(qual, dtype=np.uint8)
            m = min(len(q), len(codes))
            codes = codes.copy()
            codes[:m][q[:m] < least_qual] = -1
        if parts:
            parts.append(sep)
        parts.append(codes)
    if not parts:
        return np.empty(0, dtype=np.int8)
    return np.concatenate(parts)


def pack_blocks(codes: np.ndarray, block: int, K: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Split one genome's code array into [n, block+K-1] halo'd blocks.

    Block b's payload is codes[b*block:(b+1)*block] with the previous
    K-1 codes as halo prefix (first block and tail padded invalid).
    Window outputs at positions >= K-1 of each row cover exactly the
    payload positions, each window seeing its true preceding context —
    the device equivalent of RabbitFX chunking one big file across
    consumers (reference sketch.cpp:396-410).
    Returns (codes_blocks int8[n, block+K-1], valid bool[n, block+K-1]).
    """
    n = max(1, -(-len(codes) // block))
    halo = K - 1
    out = np.full((n, block + halo), -1, dtype=np.int8)
    for b in range(n):
        lo = b * block
        hi = min(len(codes), lo + block)
        out[b, halo : halo + (hi - lo)] = codes[lo:hi]
        hlo = max(0, lo - halo)
        out[b, halo - (lo - hlo) : halo] = codes[hlo:lo]
    valid = out >= 0
    return out, valid


def combine_hash_words(h_lo: np.ndarray, h_hi: np.ndarray, keep: np.ndarray,
                       use64: bool) -> np.ndarray:
    """Device (hi, lo, keep) block outputs -> flat kept hash values."""
    lo = np.asarray(h_lo)[np.asarray(keep)]
    if use64:
        hi = np.asarray(h_hi)[np.asarray(keep)]
        return lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return lo.astype(np.uint32)
