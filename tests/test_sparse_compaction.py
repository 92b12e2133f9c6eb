"""Sparse (two-level) on-device compaction: drlevel >= 3 configs."""

import numpy as np
import pytest

from rabbitkssd.engine.sketcher import DeviceSketcher
from rabbitkssd.oracle import sketch_records_oracle
from rabbitkssd.params import KssdParams
from rabbitkssd.shuffle import generate_shuffle


@pytest.fixture(scope="module")
def l3k10():
    # the headline L3K10 config (16M-dim shuffle, native FY)
    shuf = generate_shuffle(10, 6, 3)
    return KssdParams(half_k=10, half_subk=6, drlevel=3), shuf


def _seq(rng, n):
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    out = s.tobytes()
    return out


def test_sparse_compaction_matches_oracle(rng, l3k10):
    params, shuf = l3k10
    sk = DeviceSketcher(params, shuf.shuffled_dim, n_blocks=4, block=1 << 15)
    seqs = [_seq(rng, n) for n in (500, 200000, 70000)]
    from rabbitkssd.ops.kmer import encode_concat

    codes = [encode_concat([(s, None)]) for s in seqs]
    got, n = sk.sketch_codes(iter(codes))
    assert n == 3
    for i, s in enumerate(seqs):
        want = sketch_records_oracle([(s, None)], params, shuf.shuffled_dim)
        np.testing.assert_array_equal(got[i], want, err_msg=f"genome {i}")


def test_sparse_group_overflow_fallback(rng, l3k10):
    """Force n_sel > g_cap: the sticky overflow must trigger the exact
    dense re-run."""
    from rabbitkssd.engine.sketcher import make_stream_step

    params, shuf = l3k10
    sk = DeviceSketcher(params, shuf.shuffled_dim, n_blocks=2, block=1 << 14)
    # monkeypatch a tiny-group-capacity step by shrinking cap so that
    # g_cap floors at 4096 but survivors spread over more groups than a
    # tiny synthetic g_cap; easiest honest trigger: huge survivor count
    # via drlevel-3 on a long random sequence is still sparse, so
    # instead rebuild the step with cap tiny -> per-batch overflow path
    sk.cap = 32
    sk._step = make_stream_step(params, 2, 1 << 14, sk.cap, sk.buf_cap)
    codes = (rng.integers(0, 4, size=300000)).astype(np.int8)
    got, n = sk.sketch_codes(iter([codes]))
    sk2 = DeviceSketcher(params, shuf.shuffled_dim, n_blocks=2,
                         block=1 << 14)
    want, _ = sk2.sketch_codes(iter([codes]))
    np.testing.assert_array_equal(got[0], want[0])
