"""Batched sorted-set intersection: the AVX2 kernel's device analogue.

The reference keeps a second, index-free distance path: sort both
sketches and merge-intersect, vectorized with an 8x8 AVX2 comparison
block (reference dist.cpp:941-1050, used by tri_dist/dist,
dist.cpp:345-427, 778-893).  The device equivalent intersects the
padded sorted sketch matrix pairwise via vectorized binary search
(searchsorted of every row against every other row) — no posting-list
index required.

The membership-matmul path (ops/distance.py) is the default engine;
this op exists for parity and for regimes where building the shared
vocabulary is undesirable (e.g. few pairs of very large sketches).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from . import _config  # noqa: F401
from .hostxfer import read_array

_SENTINEL64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def pad_sketch_matrix(hashes: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Sorted per-genome hash arrays -> (uint64 padded matrix, sizes).

    Rows are padded with the max sentinel (keeps rows sorted; pad slots
    are excluded by the size masks, so a real max-valued hash is safe).
    """
    n = len(hashes)
    smax = max((h.size for h in hashes), default=0)
    smax = max(smax, 1)
    smax = -(-smax // 128) * 128  # lane-align
    out = np.full((n, smax), _SENTINEL64, dtype=np.uint64)
    sizes = np.zeros(n, np.int32)
    for i, h in enumerate(hashes):
        out[i, : h.size] = h.astype(np.uint64)
        sizes[i] = h.size
    return out, sizes


@jax.jit
def _pair_common(rows_a, sizes_a, rows_b, sizes_b):
    """common[i, j] = |rows_a[i] ∩ rows_b[j]| via vectorized searchsorted.

    rows_*: uint64 sorted padded [Na, S] / [Nb, S].  Each element of a is
    binary-searched in every row of b; equality at the insertion point
    counts it.  Pad slots are excluded on BOTH sides by index masks (the
    max-sentinel itself can be a real hash when hash_bits == 64).
    Only comparisons are needed, so uint64 costs no 64-bit arithmetic.
    """
    s = rows_a.shape[1]
    lane = jax.lax.broadcasted_iota(jnp.int32, (s, 1), 0)[:, 0]

    def one_vs_row(b_row, size_b):
        def count_in(a_row, size_a):
            idx = jnp.searchsorted(b_row, a_row, side="left")
            idx_c = jnp.minimum(idx, b_row.size - 1)
            hit = ((jnp.take(b_row, idx_c) == a_row)
                   & (idx < size_b) & (lane < size_a))
            return hit.sum(dtype=jnp.int32)

        return jax.vmap(count_in)(rows_a, sizes_a)

    return jax.vmap(one_vs_row)(rows_b, sizes_b).T


def common_counts_sorted(hashes0: list[np.ndarray],
                         hashes1: list[np.ndarray] | None) -> np.ndarray:
    """Pairwise intersection counts by direct sorted-set intersection."""
    symmetric = hashes1 is None
    if symmetric:
        hashes1 = hashes0
    a, sizes_a = pad_sketch_matrix(hashes0)
    b, sizes_b = pad_sketch_matrix(hashes1)
    smax = max(a.shape[1], b.shape[1])
    if a.shape[1] < smax:
        pad = np.full((a.shape[0], smax - a.shape[1]), _SENTINEL64, np.uint64)
        a = np.concatenate([a, pad], axis=1)
    if b.shape[1] < smax:
        pad = np.full((b.shape[0], smax - b.shape[1]), _SENTINEL64, np.uint64)
        b = np.concatenate([b, pad], axis=1)
    out = _pair_common(jnp.asarray(a), jnp.asarray(sizes_a),
                       jnp.asarray(b), jnp.asarray(sizes_b))
    return read_array(out)
