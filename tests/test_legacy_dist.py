"""Golden tests for the LEGACY sorted-intersection text path.

The reference keeps ``tri_dist``/``dist`` (dist.cpp:345-427, 778-893)
compiled but unreachable from its CLI (subCommand.cpp:197 commented
out).  Ours is exposed behind ``KSSD_LEGACY_DIST=1``; these tests force
the reference down its legacy path with a tiny harness main linked
against the reference objects and assert byte equality (single thread
-> deterministic row order on both sides).
"""

import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden")
sys.path.insert(0, os.path.dirname(HERE))
import bench  # noqa: E402  (repo-root module: the reference build)

# linked next to bench.py's reference build
HARNESS = os.path.join(os.path.dirname(os.path.abspath(bench.REF_BIN)),
                       "legacy_dist")

HARNESS_SRC = r"""
#include "sketch.h"
#include "dist.h"
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
// drive the reference's LEGACY tri_dist/dist paths (unreachable from
// its CLI: subCommand.cpp:197) for golden comparison
int main(int argc, char** argv) {
    std::string mode = argv[1];
    std::vector<sketch_t> a;
    sketchInfo_t info;
    readSketches(a, info, argv[2]);
    int kmer = 2 * info.half_k;
    if (mode == "tri") {
        tri_dist(a, argv[3], kmer, atof(argv[4]), 1);
    } else {
        std::vector<sketch_t> q;
        sketchInfo_t qi;
        readSketches(q, qi, argv[3]);
        dist(a, q, argv[4], kmer, atof(argv[5]), 1);
    }
    return 0;
}
"""


def _ensure_harness() -> str | None:
    if os.path.exists(HARNESS):
        return HARNESS
    bdir = os.path.dirname(HARNESS)
    src_dir = os.path.join(bdir, "src")
    stub = os.path.join(bdir, "stub")
    if not os.path.isdir(src_dir) or not os.path.isdir(stub):
        # bench.py's reference build (with its RabbitFX stub) lays these
        # down; build it on demand
        if bench.ensure_ref_binary() is None:
            return None
    harness_cpp = os.path.join(bdir, "legacy_main.cpp")
    with open(harness_cpp, "w") as f:
        f.write(HARNESS_SRC)
    srcs = [os.path.join(src_dir, f) for f in sorted(os.listdir(src_dir))
            if f.endswith(".cpp") and f != "main.cpp"]
    r = subprocess.run(
        ["g++", "-O2", "-fopenmp", "-std=c++14", "-march=native",
         harness_cpp] + srcs
        + ["-I" + stub, "-I" + src_dir, "-lz", "-lpthread", "-o", HARNESS],
        capture_output=True, text=True)
    if r.returncode != 0:
        print(r.stderr[-2000:], file=sys.stderr)
        return None
    return HARNESS


@pytest.fixture(scope="module")
def harness():
    h = _ensure_harness()
    if h is None:
        pytest.skip("no native toolchain for the reference harness")
    return h


def _cli(env_extra, argv):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(HERE)
    env.update(env_extra)
    r = subprocess.run([sys.executable, "-m", "rabbitkssd.cli"] + argv,
                       env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]


def test_legacy_tri_dist_bytes(harness, tmp_path):
    sk = os.path.join(GOLDEN, "fa_k8s4l1.sketch")
    ref_out = str(tmp_path / "ref.tri")
    subprocess.run([harness, "tri", sk, ref_out, "1.0"], check=True,
                   capture_output=True)
    ours_out = str(tmp_path / "ours.tri")
    _cli({"KSSD_LEGACY_DIST": "1"},
         ["alldist", "-i", sk, "-o", ours_out, "-D", "1.0"])
    with open(ref_out, "rb") as f:
        want = f.read()
    with open(ours_out, "rb") as f:
        got = f.read()
    assert want.startswith(b" genome0\t")
    assert got == want


def test_legacy_dist_bytes_both_branches(harness, tmp_path):
    """ref>=query branch AND query>ref branch (they emit size0 from
    different sides — dist.cpp:805-860)."""
    import numpy as np

    from rabbitkssd.formats import (SketchSet, read_sketches,
                                        save_sketches)

    full = read_sketches(os.path.join(GOLDEN, "fa_k8s4l1.sketch"))
    assert len(full.sketches) >= 3
    big = str(tmp_path / "big.sketch")
    small = str(tmp_path / "small.sketch")
    save_sketches(full, big)
    import dataclasses

    sub = dataclasses.replace(
        full, sketches=full.sketches[:1],
        info=dataclasses.replace(full.info, genome_number=1))
    save_sketches(sub, small)

    for ref_sk, qry_sk, tag in ((big, small, "rq"), (small, big, "qr")):
        ref_out = str(tmp_path / f"ref.{tag}")
        subprocess.run([harness, "rq", ref_sk, qry_sk, ref_out, "1.0"],
                       check=True, capture_output=True)
        ours_out = str(tmp_path / f"ours.{tag}")
        _cli({"KSSD_LEGACY_DIST": "1"},
             ["dist", "-r", ref_sk, "-q", qry_sk, "-o", ours_out,
              "-D", "1.0"])
        with open(ref_out, "rb") as f:
            want = f.read()
        with open(ours_out, "rb") as f:
            got = f.read()
        assert want.startswith(b" referenceGenome\t")
        assert got == want, tag
