"""dist_engine._use_walk: the walk-vs-matmul choice at the strip shapes
whose walls were measured on an H100 (scripts/perf_probe.py --rates,
PERF.md), and its overrides."""

import jax
import numpy as np
import pytest

from rabbitkssd.engine import dist_engine as E


def _layout(join: int, vocab: int):
    return None, (np.empty(vocab), None, None, None, None, join)


# (n genomes, join, strip vocabulary, the faster path on the card)
MEASURED = {
    "config1": (256, 1_191_325, 58_336, "walk"),
    "config4": (4, 3_000_000, 750_000, "walk"),
    "dense": (64, 73_856_042, 145_964, "walk"),
    "outbreak256": (256, 32_115_200, 3_050, "matmul"),
    "outbreak1024": (1024, 513_812_480, 10_730, "matmul"),
    "config5_tile": (2048, 85_812_658, 1_412_521, "walk"),
}


@pytest.mark.parametrize("shape", sorted(MEASURED))
def test_use_walk_picks_the_measured_winner(monkeypatch, shape):
    n, join, vocab, faster = MEASURED[shape]
    monkeypatch.delenv("KSSD_DIST_PATH", raising=False)
    monkeypatch.delenv("KSSD_WALK_RATE", raising=False)
    monkeypatch.delenv("KSSD_MATMUL_RATE", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    walk = E._use_walk(_layout(join, vocab), n, n)
    assert ("walk" if walk else "matmul") == faster


@pytest.mark.parametrize("mode,backend,want", [
    ("walk", "gpu", True),
    ("matmul", "gpu", False),
    ("matmul", "cpu", False),
    ("auto", "cpu", True),
])
def test_use_walk_overrides(monkeypatch, mode, backend, want):
    n, join, vocab, _ = MEASURED["outbreak1024"]
    monkeypatch.setenv("KSSD_DIST_PATH", mode)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert E._use_walk(_layout(join, vocab), n, n) is want
