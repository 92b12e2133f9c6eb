"""Shuffle-file generation: byte-exact vs the reference binary's output."""

import hashlib
import json
import os

import numpy as np
import pytest

from rabbitkssd.shuffle import (
    generate_shuffle,
    read_shuffle_file,
    write_shuffle_file,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            h.update(chunk)
    return h.hexdigest()


@pytest.mark.parametrize(
    "name,k,s,l",
    [("k5s4l1.shuf", 5, 4, 1), ("k8s4l1.shuf", 8, 4, 1), ("k10s4l1.shuf", 10, 4, 1)],
)
def test_shuffle_bytes_match_reference(tmp_path, name, k, s, l):
    golden_path = os.path.join(GOLDEN, name)
    shuf = generate_shuffle(k, s, l)
    out = tmp_path / name
    write_shuffle_file(shuf, str(out))
    with open(golden_path, "rb") as f:
        want = f.read()
    with open(out, "rb") as f:
        got = f.read()
    assert got == want


def test_roundtrip(tmp_path):
    shuf = generate_shuffle(8, 4, 1)
    p = tmp_path / "x.shuf"
    write_shuffle_file(shuf, str(p))
    back = read_shuffle_file(str(p))
    assert back.id == shuf.id == (8 << 8) + (4 << 4) + 1
    assert back.k == 8 and back.subk == 4 and back.drlevel == 1
    np.testing.assert_array_equal(back.shuffled_dim, shuf.shuffled_dim)


def test_golden_shuffles_readable():
    shuf = read_shuffle_file(os.path.join(GOLDEN, "k8s4l1.shuf"))
    assert shuf.k == 8 and shuf.subk == 4 and shuf.drlevel == 1
    assert shuf.dim_size == 1 << 16
    assert sorted(shuf.shuffled_dim.tolist()) == list(range(1 << 16))


@pytest.mark.slow
def test_standard_L3K8_shuffle_sha256():
    """The standard bacteria config (k=8, s=6, l=3): 16.7M-entry table.

    sha256 recorded from the reference binary's output (shuf_sha256.json).
    """
    with open(os.path.join(GOLDEN, "shuf_sha256.json")) as f:
        hashes = json.load(f)
    import tempfile

    shuf = generate_shuffle(8, 6, 3)
    with tempfile.NamedTemporaryFile(suffix=".shuf") as tf:
        write_shuffle_file(shuf, tf.name)
        assert _sha256(tf.name) == hashes["L3K8.shuf"]
