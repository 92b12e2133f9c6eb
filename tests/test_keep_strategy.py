"""The stream step's keep test (one gather per window into the
permutation table) against the numpy oracle (the keep test of reference
sketch.cpp:519-523), under both compactions of the step."""

import numpy as np
import pytest

from rabbitkssd.engine.sketcher import DeviceSketcher, make_stream_step
from rabbitkssd.ops.kmer import encode_concat
from rabbitkssd.oracle import sketch_records_oracle
from rabbitkssd.params import KssdParams
from rabbitkssd.shuffle import generate_shuffle


@pytest.mark.parametrize("half_k,half_subk,drlevel", [
    (8, 6, 3),   # drlevel 3: two-level (group) compaction
    (8, 5, 2),   # drlevel 2: 65,536 kept dims, one-level compaction
    (12, 6, 3),  # use64: the 64-bit hash path
])
def test_keep_strategies_match_oracle(rng, half_k, half_subk, drlevel):
    """Sketches equal the oracle's with the default ("auto") and the
    one-level ("dense") compaction."""
    params = KssdParams(half_k=half_k, half_subk=half_subk, drlevel=drlevel)
    assert params.use64 == (half_k == 12)
    table = generate_shuffle(half_k, half_subk, drlevel).shuffled_dim
    seqs = [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), n))
            for n in (5000, 700, 12000)]
    seqs[1] = seqs[1][:50] + b"N" * 20 + seqs[1][70:]
    want = [sketch_records_oracle([(s, None)], params, table) for s in seqs]
    for compaction in ("auto", "dense"):
        sk = DeviceSketcher(params, table, n_blocks=2, block=4096)
        sk._step = make_stream_step(params, 2, 4096, sk.cap, sk.buf_cap,
                                    compaction=compaction)
        got, n = sk.sketch_codes(iter([encode_concat([(s, None)])
                                       for s in seqs]))
        assert n == len(seqs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
