"""glibc rand()/srand() emulation tests.

Expected values recorded from glibc 2.36 x86-64 (srand + rand), which the
reference shuffle generator uses (reference shuffle.cpp:87-104).
"""

import numpy as np

from rabbitkssd.glibc_rand import GlibcRand, fisher_yates, shuffle_n

GLIBC_EXPECTED = {
    1: [1804289383, 846930886, 1681692777, 1714636915, 1957747793],
    23: [1562469902, 1039845534, 2025653534, 739593874, 994290584],
    2659: [1969248010, 753843552, 1552456072, 322315680, 1207211395],
    348842630: [213393882, 678633718, 71512822, 693253680, 345619655],
}


def test_rand_streams_match_glibc():
    for seed, expected in GLIBC_EXPECTED.items():
        r = GlibcRand(seed)
        got = [r.next() for _ in range(5)]
        assert got == expected, f"seed {seed}"


def test_seed_zero_equals_seed_one():
    a = GlibcRand(0).take(10)
    b = GlibcRand(1).take(10)
    np.testing.assert_array_equal(a, b)


def test_take_matches_next():
    r1 = GlibcRand(42)
    r2 = GlibcRand(42)
    bulk = r1.take(10000)
    singles = np.array([r2.next() for _ in range(10000)])
    np.testing.assert_array_equal(bulk, singles)


def test_block_boundary_consistency():
    # crossing the internal block size must not perturb the stream
    r = GlibcRand(7)
    a = r.take(GlibcRand._BLOCK - 3)
    b = r.take(10)
    full = GlibcRand(7).take(GlibcRand._BLOCK + 7)
    np.testing.assert_array_equal(np.concatenate([a, b]), full)


def test_fisher_yates_is_permutation():
    arr = shuffle_n(1 << 16)
    assert sorted(arr.tolist()) == list(range(1 << 16))
    arr2 = fisher_yates(arr.copy(), 2659)
    assert sorted(arr2.tolist()) == list(range(1 << 16))
