"""Oracle sketcher tests: pyloop vs numpy vs the reference binary's sketches."""

import os

import numpy as np
import pytest

from rabbitkssd.formats import read_sketches
from rabbitkssd.oracle import (
    oracle_hashes_numpy,
    oracle_hashes_pyloop,
    sketch_records_oracle,
)
from rabbitkssd.params import KssdParams
from rabbitkssd.seqio import read_list, read_records
from rabbitkssd.shuffle import read_shuffle_file

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _rand_seq(rng, n, with_junk=True):
    bases = np.array(list("ACGTacgt" + ("N-xU" if with_junk else "")))
    probs = None
    if with_junk:
        probs = np.array([0.22] * 4 + [0.02] * 4 + [0.01] * 4)
        probs /= probs.sum()
    return "".join(rng.choice(bases, size=n, p=probs))


@pytest.mark.parametrize("k,s,l", [(8, 4, 1), (10, 4, 1), (10, 6, 3), (16, 7, 4)])
def test_pyloop_vs_numpy(rng, k, s, l):
    p = KssdParams(k, s, l)
    dim_size = 1 << (4 * s)
    # random permutation table (the math doesn't care that it's not FY-derived)
    shuffled = rng.permutation(dim_size).astype(np.int32)
    for trial in range(3):
        seq = _rand_seq(rng, 3000)
        a = oracle_hashes_pyloop(seq, p, shuffled)
        b = oracle_hashes_numpy(seq, p, shuffled)
        assert a == b.tolist(), f"k={k},s={s},l={l} trial {trial}"


def test_pyloop_vs_numpy_quality(rng):
    p = KssdParams(8, 4, 1)
    shuffled = rng.permutation(1 << 16).astype(np.int32)
    seq = _rand_seq(rng, 2000, with_junk=False).encode()
    qual = bytes(rng.integers(35, 74, size=2000).astype(np.uint8).tolist())
    a = oracle_hashes_pyloop(seq, p, shuffled, quality=qual, least_qual=50)
    b = oracle_hashes_numpy(seq, p, shuffled, quality=qual, least_qual=50)
    assert a == b.tolist()


def test_short_sequences(rng):
    p = KssdParams(8, 4, 1)
    shuffled = rng.permutation(1 << 16).astype(np.int32)
    for n in (0, 1, 15, 16, 17):
        seq = _rand_seq(rng, n, with_junk=False)
        a = oracle_hashes_pyloop(seq, p, shuffled)
        b = oracle_hashes_numpy(seq, p, shuffled)
        assert a == b.tolist()
        if n <= p.kmer_size - 1:
            assert a == []


def _load_params_and_table(shuf_name):
    shuf = read_shuffle_file(os.path.join(GOLDEN, shuf_name))
    return KssdParams(shuf.k, shuf.subk, shuf.drlevel), shuf.shuffled_dim


@pytest.mark.parametrize(
    "shuf_name,sketch_name",
    [("k8s4l1.shuf", "fa_k8s4l1.sketch"), ("k10s4l1.shuf", "fa_k10s4l1.sketch")],
)
def test_oracle_matches_reference_sketches(shuf_name, sketch_name):
    """Set-equality of oracle sketches vs the reference binary's .sketch."""
    params, table = _load_params_and_table(shuf_name)
    golden = read_sketches(os.path.join(GOLDEN, sketch_name))
    by_name = {s.name: s for s in golden.sketches}
    files = read_list(os.path.join(GOLDEN, "fa.list"))
    for rel in files:
        path = os.path.join(GOLDEN, rel)
        records = [(r.seq, None) for r in read_records(path)]
        ours = sketch_records_oracle(records, params, table)
        want = np.sort(by_name[rel].hashes.astype(np.uint64))
        np.testing.assert_array_equal(
            ours.astype(np.uint64), want, err_msg=f"{rel} ({shuf_name})"
        )


def test_oracle_matches_reference_fastq():
    """FASTQ with -Q 40 -n 2 quality/abundance filters."""
    params, table = _load_params_and_table("k8s4l1.shuf")
    golden = read_sketches(os.path.join(GOLDEN, "fq_k8s4l1.sketch"))
    by_name = {s.name: s for s in golden.sketches}
    for rel in read_list(os.path.join(GOLDEN, "fq.list")):
        path = os.path.join(GOLDEN, rel)
        records = [(r.seq, r.qual) for r in read_records(path)]
        ours = sketch_records_oracle(
            records, params, table, least_qual=40, least_num_kmer=2
        )
        want = np.sort(by_name[rel].hashes.astype(np.uint64))
        np.testing.assert_array_equal(ours.astype(np.uint64), want, err_msg=rel)
