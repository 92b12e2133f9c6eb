"""Sharded pipelines over a device mesh (shard_map + collectives).

The reference is single-node OpenMP (SURVEY §2: per-thread privatization
+ reduction, reference sketch.cpp:411-435, dist.cpp:143-204).  The
multi-device scale-out re-expresses those patterns on a 2-D
``("dp", "vp")`` mesh:

* **dp (data parallel)** — genome blocks / genome rows shard across dp.
  The sketch tape's blocks are embarrassingly parallel (halo'd blocks,
  ops/kmer.py), so the per-thread hash sets of the reference become
  per-device compacted hash streams, merged on host (a set-union
  reduce).
* **vp (vocabulary parallel)** — the hash-vocabulary axis of the
  distance membership matmul shards across vp; each device computes a
  partial intersection count over its vocab slice and the true count is
  a ``psum`` over vp — exactly the per-thread partial-counter
  reduction of the reference (dist.cpp:143,167) as a collective.

Everything is expressed with ``shard_map`` over ``jax.sharding.Mesh``
so XLA inserts the collectives (NCCL on GPUs); no hand-scheduled
communication.  The GPUs of one host are joined all to all (NVLink),
so the mesh shape follows the algorithm, not a topology.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import _config  # noqa: F401
from ..ops.kmer import hash_windows
from ..params import KssdParams


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Best 2-D ("dp", "vp") mesh over the first n devices.

    Multi-process (jax.distributed) runs delegate to
    ``multihost.global_mesh`` so vp stays within each host's local
    devices — the distance ``psum`` over vp then stays inside a host,
    and only host-mergeable dp partials cross the network.  A
    locality-blind factorization here could put one vp row across two
    hosts.
    """
    if devices is None and n_devices is None and jax.process_count() > 1:
        from .multihost import global_mesh

        return global_mesh()
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    dp = 1
    for cand in range(int(math.isqrt(n)), 0, -1):
        if n % cand == 0:
            dp = cand
            break
    vp = n // dp
    arr = np.asarray(devices).reshape(dp, vp)
    return Mesh(arr, ("dp", "vp"))


# --------------------------------------------------------------------------
# sharded sketch step
# --------------------------------------------------------------------------

def make_sharded_sketch_step(params: KssdParams, mesh: Mesh, n_blocks: int,
                             block: int, cap: int):
    """Data-parallel sketch step over all mesh devices.

    codes int8[n_shards * n_blocks, block + K - 1] (sharded on axis 0)
    -> per-shard compacted (h_lo, h_hi, pos, total), each leading axis
    n_shards.  ``pos`` is relative to the shard's payload start.
    """
    hasher = hash_windows(params)
    halo = params.kmer_size - 1
    axes = ("dp", "vp")

    def shard_fn(codes, table):
        valid = codes >= 0
        h_lo, h_hi, keep = hasher(codes, valid, table)
        h_lo = h_lo[:, halo:].ravel()
        h_hi = h_hi[:, halo:].ravel()
        keep = keep[:, halo:].ravel()
        csum = jnp.cumsum(keep.astype(jnp.int32))
        total = csum[-1]
        targets = jnp.arange(1, cap + 1, dtype=jnp.int32)
        pos = jnp.searchsorted(csum, targets, side="left", method="sort")
        pos_c = jnp.minimum(pos, csum.size - 1).astype(jnp.int32)
        out = (jnp.take(h_lo, pos_c)[None], jnp.take(h_hi, pos_c)[None],
               pos_c[None], total[None])
        return out

    sharded = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axes, None), P()),
        out_specs=(P(axes), P(axes), P(axes), P(axes)),
    )
    return jax.jit(sharded)


# --------------------------------------------------------------------------
# sharded distance step
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def make_sharded_common_step(mesh: Mesh, rows_per_dp: int, n1_per_dp: int,
                             cols_per_vp: int, cap0: int, cap1: int):
    """Intersection counts with genome rows on dp and vocab columns on vp.

    BOTH sides shard over the mesh — side 0's rows and side 1's rows
    each split across dp (nothing is replicated, so per-device memory
    stays flat as the corpus grows).  Side 1 rotates around the dp ring
    with ``ppermute`` (a ring matmul: each of the dp steps multiplies
    the local side-0 membership against one visiting side-1 shard,
    then passes that shard to the next device), and each product is
    psum-reduced over vp — the reference's per-thread partial counters
    (dist.cpp:143) as collectives.

    Inputs (host-prepared, padded):
      g0 int32[dp, vp, cap0]  side-0 row ids (local to the dp shard)
      c0 int32[dp, vp, cap0]  column ids (local to the vp slice; pads
                              carry cols_per_vp -> dropped)
      g1, c1 int32[dp, vp, cap1]  side 1, same layout (row ids local
                              to its dp shard of n1_per_dp genomes)
    Output int32[dp, rows_per_dp, dp * n1_per_dp]: true counts.
    """
    dp = mesh.devices.shape[0]
    ring = [(i, (i + 1) % dp) for i in range(dp)]

    def shard_fn(acc, g0, c0, g1, c1):
        m0 = jnp.zeros((rows_per_dp, cols_per_vp), jnp.bfloat16)
        m0 = m0.at[g0[0, 0], c0[0, 0]].set(1, mode="drop",
                                           unique_indices=True)
        me = jax.lax.axis_index("dp")

        def ring_step(i, carry):
            acc, g1c, c1c = carry
            m1 = jnp.zeros((n1_per_dp, cols_per_vp), jnp.bfloat16)
            m1 = m1.at[g1c, c1c].set(1, mode="drop", unique_indices=True)
            part = jax.lax.dot_general(
                m0, m1, dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            part = jax.lax.psum(part.astype(jnp.int32), "vp")
            # each ppermute sends shards forward (d -> d+1), so after i
            # rotations I hold the shard that STARTED at dp index me - i
            col0 = (jnp.mod(me - i, dp) * n1_per_dp).astype(jnp.int32)
            row0 = jnp.int32(0)
            acc = jax.lax.dynamic_update_slice(
                acc, (jax.lax.dynamic_slice(
                    acc, (row0, col0), (rows_per_dp, n1_per_dp))
                    + part),
                (row0, col0))
            g1c = jax.lax.ppermute(g1c, "dp", ring)
            c1c = jax.lax.ppermute(c1c, "dp", ring)
            return acc, g1c, c1c

        acc, _, _ = jax.lax.fori_loop(
            0, dp, ring_step, (acc[0], g1[0, 0], c1[0, 0]))
        return acc[None]

    sharded = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("dp", None, None),
                  P("dp", "vp", None), P("dp", "vp", None),
                  P("dp", "vp", None), P("dp", "vp", None)),
        out_specs=P("dp", None, None),
    )

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(acc, g0, c0, g1, c1):
        # acc int32[dp, rows_per_dp, dp * n1_per_dp] (donated carry)
        return sharded(acc, g0, c0, g1, c1)

    return step


def sharded_common_counts(hashes0: list[np.ndarray],
                          hashes1: list[np.ndarray] | None,
                          mesh: Mesh, vocab0=None) -> np.ndarray:
    """Mesh-parallel version of ops.distance.common_counts.

    Rows of BOTH sides shard over dp (side 1 rotates around the dp ring
    with ppermute — nothing replicated, per-device memory flat in the
    corpus); the vocabulary shards over vp.  Exact (same math as the
    single-chip path).
    """
    from ..ops.distance import _memberships

    symmetric = hashes1 is None
    if symmetric:
        allh = (np.concatenate(hashes0) if hashes0 else np.empty(0, np.uint64))
        vocab, counts = np.unique(allh, return_counts=True)
        vocab = vocab[counts >= 2]
        hashes1 = hashes0
    else:
        if vocab0 is None:
            vocab0 = (np.unique(np.concatenate(hashes0)) if hashes0
                      else np.empty(0))
        v1 = np.unique(np.concatenate(hashes1)) if hashes1 else np.empty(0)
        vocab = np.intersect1d(vocab0, v1)

    n0, n1 = len(hashes0), len(hashes1)
    if len(vocab) == 0:
        out = np.zeros((n0, n1), np.int32)
        if symmetric:
            np.fill_diagonal(out, [h.size for h in hashes0])
        return out

    g0j, c0j = _memberships(hashes0, vocab)
    g1j, c1j = (g0j, c0j) if symmetric else _memberships(hashes1, vocab)
    from ..ops.distance import (_host_join_max, _join_layout,
                                _pair_counts_host, mem_budget)

    host_max = _host_join_max()
    backend_cpu = jax.default_backend() == "cpu"
    if host_max > 0 and (backend_cpu
                         or min(len(c0j), len(c1j)) * 64 <= host_max):
        # small join (or CPU backend, where the dense matmul pays
        # O(n0*n1*vocab) scalar FLOPs for the join's O(join) work):
        # device dispatch is pure overhead, mesh or not
        layout = _join_layout(c0j, c1j)
        if backend_cpu or layout[-1] <= host_max:
            out = _pair_counts_host(g0j, c0j, g1j, c1j, n0, n1,
                                    layout=layout)
            if symmetric:
                np.fill_diagonal(out, [h.size for h in hashes0])
            return out

    dp, vp = mesh.devices.shape
    rows_per_dp = -(-n0 // dp)
    n1_per_dp = -(-n1 // dp)
    # memory-based auto-sizing of the vocab slice per device: the two
    # membership matrices hold (rows_per_dp + n1_per_dp) * cols_per_vp
    # bf16 per device — cap that at mem_budget() and iterate vocab
    # CHUNKS of vp * cols_per_vp columns, accumulating in a donated
    # device carry (one readback total).  Without this, a 2^28-slot
    # vocabulary would demand an infeasible per-device membership no
    # matter how many devices shard it.
    budget = mem_budget()
    max_cols = max(1024, budget // (2 * (rows_per_dp + n1_per_dp)))
    cols_per_vp = min(-(-len(vocab) // vp),
                      1 << (max_cols.bit_length() - 1))
    chunk_cols = vp * cols_per_vp

    g0, c0 = g0j, c0j
    g1, c1 = g1j, c1j

    def split_pairs(g, c, col_lo: int, group: int):
        """Partition one vocab chunk's pairs into the [dp, vp, cap]
        padded layout (cap = largest bucket, power-of-two bucketed);
        ``group`` genome rows per dp shard, ids made shard-local."""
        buckets = []
        cap = 0
        for r in range(dp):
            sel = (g >= r * group) & (g < (r + 1) * group)
            gg, cc = g[sel] - r * group, c[sel] - col_lo
            row_buckets = []
            for v in range(vp):
                lo, hi = v * cols_per_vp, (v + 1) * cols_per_vp
                sel_v = (cc >= lo) & (cc < hi)
                row_buckets.append((gg[sel_v], cc[sel_v] - lo))
                cap = max(cap, int(sel_v.sum()))
            buckets.append(row_buckets)
        cap = max(1024, 1 << (cap - 1).bit_length()) if cap else 1024
        G = np.zeros((dp, vp, cap), np.int32)
        C = np.full((dp, vp, cap), cols_per_vp, np.int32)
        for r, row_buckets in enumerate(buckets):
            for v, (gv, cv) in enumerate(row_buckets):
                G[r, v, : len(gv)] = gv
                C[r, v, : len(cv)] = cv
        return G, C, cap

    from ..ops.hostxfer import read_array

    acc = jnp.zeros((dp, rows_per_dp, dp * n1_per_dp), jnp.int32)
    n_chunks = -(-len(vocab) // chunk_cols)
    for ci in range(n_chunks):
        lo, hi = ci * chunk_cols, min(len(vocab), (ci + 1) * chunk_cols)
        s0 = slice(*np.searchsorted(c0, [lo, hi]))
        s1 = slice(*np.searchsorted(c1, [lo, hi]))
        G0, C0, cap0 = split_pairs(g0[s0], c0[s0], lo, rows_per_dp)
        G1, C1, cap1 = split_pairs(g1[s1], c1[s1], lo, n1_per_dp)
        step = make_sharded_common_step(mesh, rows_per_dp, n1_per_dp,
                                        cols_per_vp, cap0, cap1)
        acc = step(acc, G0, C0, G1, C1)

    out = read_array(acc).reshape(dp * rows_per_dp, dp * n1_per_dp)
    out = out[:n0, :n1]
    if symmetric:
        # the >=2-genome vocab filter drops singleton self-counts;
        # read_array may hand back a read-only device view -> copy
        out = np.array(out)
        np.fill_diagonal(out, [h.size for h in hashes0])
    return out
