"""Device hash kernel vs the exact oracle sketchers."""

import os

import numpy as np
import pytest

from rabbitkssd.oracle import oracle_hashes_pyloop, sketch_records_oracle
from rabbitkssd.ops.kmer import (
    combine_hash_words,
    encode_concat,
    make_hash_kernel,
    pack_blocks,
)
from rabbitkssd.params import KssdParams
from rabbitkssd.shuffle import generate_shuffle, read_shuffle_file

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def random_seq(rng, n, n_fraction=0.02, lower_fraction=0.2):
    bases = np.array(list("ACGTN"), dtype="U1")
    p = [(1 - n_fraction) / 4] * 4 + [n_fraction]
    s = rng.choice(bases, size=n, p=p)
    low = rng.random(n) < lower_fraction
    arr = np.where(low, np.char.lower(s), s)
    return "".join(arr).encode()


def device_hashes(records, params, table, least_qual=0, block=4096):
    kern = make_hash_kernel(params)
    codes = encode_concat(records, least_qual)
    blocks, valid = pack_blocks(codes, block, params.kmer_size)
    h_lo, h_hi, keep = kern(blocks, valid, table)
    return combine_hash_words(h_lo, h_hi, keep, use64=True)


@pytest.mark.parametrize(
    "half_k,half_subk,drlevel",
    # half_k=16 exercises the hi-word paths (64-bit k-mer codes, >32-bit
    # hashes); half_k=12/subk=5 exercises lo/hi field straddling.
    [(8, 4, 1), (10, 4, 1), (12, 5, 2), (16, 4, 1), (5, 4, 1), (4, 4, 1)],
)
def test_kernel_matches_oracle(rng, half_k, half_subk, drlevel):
    params = KssdParams(half_k=half_k, half_subk=half_subk, drlevel=drlevel)
    shuf = generate_shuffle(half_k, half_subk, drlevel)
    table = shuf.shuffled_dim.astype(np.int32)

    seqs = [random_seq(rng, n) for n in (1, 10, 400, 5000, 13000)]
    records = [(s, None) for s in seqs]

    got = device_hashes(records, params, table)
    want = np.concatenate(
        [
            np.asarray(
                oracle_hashes_pyloop(s, params, table), dtype=np.uint64
            )
            for s in seqs
        ]
        or [np.empty(0, np.uint64)]
    )
    # device emits in block order == position order within each record
    np.testing.assert_array_equal(np.sort(got), np.sort(want))
    # multiset equality (duplicates preserved)
    assert got.size == want.size


def test_kernel_matches_oracle_fastq(rng):
    params = KssdParams(half_k=8, half_subk=4, drlevel=1)
    shuf = generate_shuffle(8, 4, 1)
    table = shuf.shuffled_dim.astype(np.int32)
    seq = random_seq(rng, 4000)
    qual = rng.integers(30, 75, size=len(seq)).astype(np.uint8).tobytes()
    got = device_hashes([(seq, qual)], params, table, least_qual=53)
    want = oracle_hashes_pyloop(seq, params, table, quality=qual, least_qual=53)
    np.testing.assert_array_equal(np.sort(got), np.sort(np.array(want, np.uint64)))


def test_kernel_block_boundaries(rng):
    """Hashes must be identical regardless of block size (halo correctness)."""
    params = KssdParams(half_k=10, half_subk=4, drlevel=1)
    shuf = generate_shuffle(10, 4, 1)
    table = shuf.shuffled_dim.astype(np.int32)
    seq = random_seq(rng, 30000, n_fraction=0.01)
    ref = device_hashes([(seq, None)], params, table, block=1 << 16)
    for block in (64, 1000, 4096):
        got = device_hashes([(seq, None)], params, table, block=block)
        np.testing.assert_array_equal(np.sort(got), np.sort(ref))


def test_kernel_golden_shuffle(rng):
    """End-to-end with a committed reference .shuf file."""
    shuf = read_shuffle_file(os.path.join(GOLDEN, "k8s4l1.shuf"))
    params = KssdParams(half_k=shuf.k, half_subk=shuf.subk, drlevel=shuf.drlevel)
    table = shuf.shuffled_dim.astype(np.int32)
    seqs = [random_seq(rng, 8000) for _ in range(3)]
    records = [(s, None) for s in seqs]
    got = np.unique(device_hashes(records, params, table)).astype(np.uint32)
    want = sketch_records_oracle(records, params, table)
    np.testing.assert_array_equal(got, want)
