"""Native radix-sort / partition kernels vs numpy oracles.

These back the inverted-index build (`_CsrIndex.from_hashes` /
`strip_runs`, engine/dist_engine.py) — this build's sparse equivalent
of the reference's transSketches scatter
(/root/reference/src/sketch.cpp:971-1016)."""

import numpy as np
import pytest

from rabbitkssd.native import (load_native, partition_pairs,
                                   radix_sort_kv64, radix_sort_u64)


@pytest.fixture(scope="module", autouse=True)
def native_available():
    if load_native() is None:
        pytest.skip("native toolchain unavailable")


def test_radix_sort_u64_packed_stability():
    rng = np.random.default_rng(7)
    n = 200_001  # odd, multi-block
    h = rng.integers(0, 1 << 20, size=n, dtype=np.uint64)  # many ties
    g = np.arange(n, dtype=np.uint64) % 977
    keys = (h << np.uint64(32)) | g
    got = radix_sort_u64(keys.copy(), 32, 32 + 20)
    order = np.argsort(h, kind="stable")
    np.testing.assert_array_equal(got >> np.uint64(32), h[order])
    np.testing.assert_array_equal(got & np.uint64(0xFFFFFFFF), g[order])


def test_radix_sort_u64_partial_bits_leaves_payload():
    # bits below lo_bit must ride along untouched, unordered
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 1 << 63, size=4096, dtype=np.uint64)
    got = radix_sort_u64(keys.copy(), 32, 64)
    np.testing.assert_array_equal(np.sort(got >> np.uint64(32)),
                                  np.sort(keys >> np.uint64(32)))
    # full multiset preserved
    np.testing.assert_array_equal(np.sort(got), np.sort(keys))


def test_radix_sort_kv64_wide_keys():
    rng = np.random.default_rng(9)
    n = 100_000
    h = rng.integers(0, 1 << 52, size=n, dtype=np.uint64)
    v = rng.integers(0, 1 << 31, size=n, dtype=np.uint64)
    sk, sv = radix_sort_kv64(h.copy(), v.copy(), 0, 52)
    order = np.argsort(h, kind="stable")
    np.testing.assert_array_equal(sk, h[order])
    np.testing.assert_array_equal(sv, v[order])


@pytest.mark.parametrize("n,block,ng", [(100_000, 1342, 100_000),
                                        (1_000, 128, 300),
                                        (0, 128, 256)])
def test_partition_pairs_matches_argsort(n, block, ng):
    rng = np.random.default_rng(n + block)
    gids = rng.integers(0, ng, size=n, dtype=np.int32)
    cols = rng.integers(0, 1 << 30, size=n, dtype=np.int32)
    n_strips = -(-ng // block)
    go, co, bo = partition_pairs(gids, cols, block, n_strips)
    strip = gids // block
    order = np.argsort(strip, kind="stable")
    np.testing.assert_array_equal(go, gids[order])
    np.testing.assert_array_equal(co, cols[order])
    np.testing.assert_array_equal(
        bo, np.searchsorted(strip[order], np.arange(n_strips + 1)))


def test_sort_postings_variants_agree():
    """from_hashes' native packed / kv paths == the argsort fallback."""
    from rabbitkssd.engine.dist_engine import _sort_postings

    rng = np.random.default_rng(11)
    sizes = rng.integers(1, 40, size=200)
    gids = np.repeat(np.arange(200, dtype=np.int32), sizes)
    n = int(sizes.sum())
    for hmax in (1 << 28, 1 << 52):  # packed path vs kv path
        allh = rng.integers(0, hmax, size=n, dtype=np.uint64)
        sh, sg = _sort_postings(allh.copy(), gids.copy())
        order = np.argsort(allh, kind="stable")
        np.testing.assert_array_equal(sh, allh[order])
        np.testing.assert_array_equal(sg, gids[order])
