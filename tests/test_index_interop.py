"""Inverted-index (.index/.dict) interop vs golden reference artifacts."""

import os

import numpy as np

from rabbitkssd.formats import read_index, read_sketches, write_index

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _as_map(hashes, counts, postings):
    off = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    return {
        int(h): sorted(postings[off[i]: off[i + 1]].tolist())
        for i, h in enumerate(hashes)
    }


def test_index64_semantics_match_reference(tmp_path):
    """Our sparse 64-bit index holds identical posting lists to the one
    the reference binary wrote (hash order differs: robin_hood iteration
    vs sorted — both readers accept any order)."""
    sk = read_sketches(os.path.join(GOLDEN, "fa_k10s4l1.sketch"))
    assert sk.use64
    d, i = str(tmp_path / "o.dict"), str(tmp_path / "o.index")
    write_index(sk, d, i)
    oc, op, oh = read_index(d, i, True)
    gc, gp, gh = read_index(
        os.path.join(GOLDEN, "fa_k10s4l1.sketch.dict"),
        os.path.join(GOLDEN, "fa_k10s4l1.sketch.index"), True,
    )
    assert _as_map(oh, oc, op) == _as_map(gh, gc, gp)


def test_index32_bytes_match_reference(tmp_path):
    """Dense 32-bit index: ours must be byte-identical (counts are in
    hash order; postings genome-major per hash, both deterministic)."""
    sk = read_sketches(os.path.join(GOLDEN, "fa_k5s4l1.sketch"))
    assert not sk.use64
    d, i = str(tmp_path / "o.dict"), str(tmp_path / "o.index")
    write_index(sk, d, i)
    for ours, golden in ((d, "fa_k5s4l1.sketch.dict"),
                         (i, "fa_k5s4l1.sketch.index")):
        with open(ours, "rb") as a, open(os.path.join(GOLDEN, golden), "rb") as b:
            assert a.read() == b.read(), golden


def test_index64_unsorted_vocab_normalized(tmp_path):
    """A 64-bit index in hash-map iteration order (the reference's
    robin_hood ordering, sketch.cpp:904-968) must load as a sorted CSR
    with posting segments realigned.  Regression: unsigned np.diff
    wraps around (5 -> 3 gives 2^64-2), so descending vocabs passed the
    old 'sorted' check and searchsorted consumers got garbage."""
    import struct

    import numpy as np

    from rabbitkssd.formats import read_index_csr

    base = str(tmp_path / "x.sketch")
    vocab = np.array([900, 5, 77, 3], np.uint64)  # decidedly unsorted
    counts = np.array([2, 1, 3, 1], np.uint32)
    postings = np.array([10, 11, 20, 30, 31, 32, 40], np.uint32)
    with open(base + ".index", "wb") as f:
        f.write(struct.pack("<Q", len(vocab)))
        f.write(vocab.astype("<u8").tobytes())
        f.write(counts.astype("<u4").tobytes())
    postings.astype("<u4").tofile(base + ".dict")

    got = read_index_csr(base, use64=True)
    assert got is not None
    v, off, post = got
    np.testing.assert_array_equal(v, [3, 5, 77, 900])
    np.testing.assert_array_equal(np.diff(off), [1, 1, 3, 2])
    # segments follow their hash: 3 -> [40], 5 -> [20], 77 -> [30,31,32],
    # 900 -> [10,11]
    np.testing.assert_array_equal(post, [40, 20, 30, 31, 32, 10, 11])
