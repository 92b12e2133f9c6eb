#!/usr/bin/env python
"""Config 5 at REALISTIC density (VERDICT r2 item 4): 100k genomes with
~1.5k hashes each — nnz ~1.5e8 membership pairs, join ~1.5e9 — through
the full blocked alldist on the virtual 8-device CPU mesh.

The corpus is clustered like real bacteria at l=3: genomes fall into
strain clusters sharing a fraction of their sketch, so -D 0.05 emits
the intra-cluster pairs (millions of rows) while the cross-cluster mass
is filtered — the counting still has to walk every posting list, which
is the O(nnz)-bound behavior of the reference's dist.cpp:174-204.

Usage: python scripts/config5_run.py [--genomes 100000] [--per 1500]
Prints one JSON line: wall, emitted rows, join pairs/s, peak RSS.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

# This benchmark targets the pod-emulation path (virtual 8-device CPU
# mesh); set the backend before jax initializes.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8"
                               ).strip()

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402  (repo-root module: corpus + reference build)

BENCH_DIR = bench.BENCH_DIR


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_sketches(n_genomes: int, per_genome: int, cluster: int,
                   shared_frac: float):
    """Clustered synthetic sketch sets over the L3K10 32-bit hash space
    (16^7 slots): each cluster shares ``shared_frac`` of its sketch."""
    space = 1 << 28
    rng = np.random.default_rng(99)
    n_clusters = n_genomes // cluster
    n_shared = int(per_genome * shared_frac)
    hashes = []
    t0 = time.time()
    for c in range(n_clusters):
        core = np.unique(
            rng.integers(0, space, size=int(n_shared * 1.1), dtype=np.uint32)
        )[:n_shared]
        uniq = rng.integers(0, space,
                            size=(cluster, per_genome - n_shared + 64),
                            dtype=np.uint32)
        for g in range(cluster):
            h = np.unique(np.concatenate([core, uniq[g]]))[:per_genome]
            hashes.append(h)
    log(f"built {len(hashes)} sketches in {time.time()-t0:.1f}s "
        f"(nnz={sum(h.size for h in hashes)/1e6:.0f}M)")
    return hashes


def run_reference(hashes, max_dist: float) -> dict | None:
    """Head-to-head: the reference binary's own alldist on the SAME
    sketches, consumed from a sketch file we write (interoperability
    proven by tests/test_index_interop.py).  Its wall includes its own
    transSketches index build (sketch.cpp:894-1021) + index_tridist
    posting walk + emission (dist.cpp:22-343) — the exact same work our
    run_alldist does from a SketchSet.  NB in this path the reference
    prints no transSketches Timer span: the index build lands inside
    the "read sketches from file" span, reported as phase "load"."""
    ref_bin = bench.ensure_ref_binary()
    if ref_bin is None:
        return None
    from rabbitkssd.formats import Sketch, SketchInfo, SketchSet, \
        save_sketches

    info = SketchInfo(id=(10 << 8) | (6 << 4) | 3, half_k=10, half_subk=6,
                      drlevel=3, genome_number=len(hashes))
    sk = SketchSet(info=info, sketches=[
        Sketch(name=f"g{i:06d}.fna", hashes=h)
        for i, h in enumerate(hashes)
    ])
    root = os.path.join(BENCH_DIR, "config5_ref")
    os.makedirs(root, exist_ok=True)
    sk_path = os.path.join(root, "c5.sketch")
    save_sketches(sk, sk_path)
    for suffix in (".index", ".dict"):  # force transSketches inside the wall
        try:
            os.remove(sk_path + suffix)
        except OSError:
            pass
    # NB the reference segfaults on absolute -o paths (its per-thread
    # temp files concatenate the output path inside <out>.dir) — run
    # with cwd=root and relative paths.  run_measured isolates the
    # child's peak RSS from this multi-GB parent (fork inheritance).
    wall, rss_kb, r = bench.run_measured(
        [ref_bin, "alldist", "-i", "c5.sketch",
         "-o", "c5_ref.dist", "-D", str(max_dist)], cwd=root)
    if r.returncode != 0:
        log(f"reference failed: {r.stderr[-500:]}")
        return None
    phases = bench.parse_ref_phases(r.stderr)
    log(f"reference: {wall:.1f}s phases={phases} rss={rss_kb/1e6:.1f}GB")
    return {"wall_s": round(wall, 1), "phases": phases,
            "rss_gb": round(rss_kb / 1e6, 2),
            "out": os.path.join(root, "c5_ref.dist")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genomes", type=int, default=100_000)
    ap.add_argument("--per", type=int, default=1500)
    ap.add_argument("--cluster", type=int, default=50)
    ap.add_argument("--shared", type=float, default=0.55)
    ap.add_argument("--max-dist", type=float, default=0.05)
    ap.add_argument("--ref", action="store_true",
                    help="also run the reference binary on the same "
                         "sketches and compare rows set-equal")
    args = ap.parse_args()

    from rabbitkssd.engine.dist_engine import run_alldist
    from rabbitkssd.formats import Sketch, SketchInfo, SketchSet
    from rabbitkssd.ops.distance import _join_layout

    hashes = build_sketches(args.genomes, args.per, args.cluster,
                            args.shared)
    info = SketchInfo(id=(10 << 8) | (6 << 4) | 3, half_k=10, half_subk=6,
                      drlevel=3, genome_number=len(hashes))
    sk = SketchSet(info=info, sketches=[
        Sketch(name=f"g{i:06d}.fna", hashes=h)
        for i, h in enumerate(hashes)
    ])

    out = os.path.join(BENCH_DIR, "config5.alldist")
    os.makedirs(BENCH_DIR, exist_ok=True)
    t0 = time.time()
    run_alldist(sk, out, max_dist=args.max_dist, containment=False)
    wall = time.time() - t0

    rows = 0
    with open(out) as f:
        for rows, _ in enumerate(f, start=0):
            pass
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6

    # spot-check 5 intra-cluster and 5 cross pairs against the oracle
    import math
    checked = 0
    with open(out) as f:
        next(f)
        for line in f:
            g0, g1, csz, jac, d = line.rstrip("\n").split("\t")
            c = int(csz.split("|")[0])
            i0, i1 = int(g0[1:-4]), int(g1[1:-4])
            want = len(np.intersect1d(hashes[i0], hashes[i1]))
            assert c == want, (g0, g1, c, want)
            checked += 1
            if checked >= 8:
                break

    result = {
        "config": 5,
        "genomes": args.genomes,
        "nnz": int(sum(h.size for h in hashes)),
        "wall_s": round(wall, 1),
        "rows_emitted": rows,
        "rows_per_s": round(rows / wall, 0),
        "peak_rss_gb": round(peak_gb, 2),
        "spot_checked": checked,
    }
    if args.ref:
        ref = run_reference(hashes, args.max_dist)
        if ref is not None:
            def sorted_rows(path):
                with open(path) as f:
                    return sorted(f.readlines()[1:])

            result["ref_wall_s"] = ref["wall_s"]
            result["ref_phases"] = ref["phases"]
            result["ref_rss_gb"] = ref["rss_gb"]
            result["vs_reference"] = round(ref["wall_s"] / wall, 2)
            result["rows_equal"] = (sorted_rows(out)
                                    == sorted_rows(ref["out"]))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
