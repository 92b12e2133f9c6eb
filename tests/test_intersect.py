"""Sorted-set intersection op vs the membership-matmul path."""

import numpy as np

from rabbitkssd.ops.distance import common_counts
from rabbitkssd.ops.intersect import common_counts_sorted


def test_sorted_intersect_matches_matmul(rng):
    hashes = [
        np.unique(rng.integers(0, 50000, size=rng.integers(0, 700))
                  .astype(np.uint64))
        for _ in range(17)
    ]
    a = common_counts_sorted(hashes, None)
    b = common_counts(hashes, None)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        np.diag(b), [h.size for h in hashes]
    )


def test_sorted_intersect_refquery_64bit(rng):
    ref = [np.unique((rng.integers(0, 2**60, size=300, dtype=np.uint64)))
           for _ in range(5)]
    qry = [np.unique(rng.choice(ref[i % 5], size=100))
           for i in range(3)]
    got = common_counts_sorted(qry, ref)
    for i in range(3):
        for j in range(5):
            want = np.intersect1d(qry[i], ref[j]).size
            assert got[i, j] == want, (i, j)


def test_pair_counts_host_matches_device(rng, monkeypatch):
    """The small-join host path and the MXU matmul path agree exactly."""
    from rabbitkssd.ops.distance import common_counts

    hashes0 = [np.unique(rng.integers(0, 4000, size=rng.integers(5, 300))
                         .astype(np.uint32)) for _ in range(17)]
    hashes1 = [np.unique(rng.integers(0, 4000, size=rng.integers(5, 300))
                         .astype(np.uint32)) for _ in range(9)]
    monkeypatch.setenv("KSSD_HOST_JOIN_MAX", str(1 << 30))
    host_ab = common_counts(hashes0, hashes1)
    host_aa = common_counts(hashes0, None)
    monkeypatch.setenv("KSSD_HOST_JOIN_MAX", "0")
    dev_ab = common_counts(hashes0, hashes1)
    dev_aa = common_counts(hashes0, None)
    np.testing.assert_array_equal(host_ab, dev_ab)
    np.testing.assert_array_equal(host_aa, dev_aa)
    # oracle: direct set intersection
    want = np.array([[len(np.intersect1d(a, b)) for b in hashes1]
                     for a in hashes0], np.int32)
    np.testing.assert_array_equal(host_ab, want)
