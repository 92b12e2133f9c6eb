#!/usr/bin/env python
"""Configs 2 + 3 of BASELINE.json, head-to-head vs the reference binary.

  config 2 — dist ref-vs-query: the canonical 256-genome corpus split
  192 reference / 64 query, ``dist -D 0.05`` (reference
  subCommand.cpp:221-296, dist.cpp:429-776).  Both sides sketch from
  scratch inside the timed wall; output rows must be set-equal.

  config 3 — set-operation chain: sketch two 128-genome halves, then
  union(A) -> sub(union from B) -> merge(A, B) -> alldist on the
  merged sketch (reference subCommand.cpp:307-892).  Artifacts are
  compared set-equal per step (the reference's hash-set iteration
  order differs from our canonical sorted form by design, PARITY.md),
  final alldist rows set-equal.

The reference binary runs with all host cores (its default,
main.cpp:50); ours on the attached backend.  Prints one JSON line per
config.

Usage: python scripts/config23_run.py
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402  (repo-root module: corpus + reference build)

BENCH_DIR, REF_BIN = bench.BENCH_DIR, bench.REF_BIN


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def rows_of(path: str) -> list[str]:
    with open(path) as f:
        return sorted(f.readlines()[1:])


def sketch_sets(path: str):
    from rabbitkssd.formats import read_sketches

    import numpy as np

    sk = read_sketches(path)
    return {s.name: np.sort(s.hashes).tolist() for s in sk.sketches}


def run_ref(args: list[str], cwd: str) -> float:
    t0 = time.time()
    subprocess.run([REF_BIN] + args, check=True, capture_output=True,
                   cwd=cwd)
    return time.time() - t0


def run_ours(args: list[str]) -> float:
    from rabbitkssd.cli import main as cli_main

    t0 = time.time()
    rc = cli_main(args)
    assert rc == 0, args
    return time.time() - t0


def clean(*paths: str) -> None:
    """Drop sketch side artifacts so neither side short-circuits."""
    for p in paths:
        for suffix in (".sketch", ".sketch.index", ".sketch.dict"):
            try:
                os.remove(p + suffix)
            except OSError:
                pass


def config2(root: str, files: list[str], shuf: str) -> dict:
    ref_list = os.path.join(root, "c2_ref.list")
    q_list = os.path.join(root, "c2_query.list")
    with open(ref_list, "w") as f:
        f.write("\n".join(files[:192]) + "\n")
    with open(q_list, "w") as f:
        f.write("\n".join(files[192:]) + "\n")

    # reference (all cores, sketches both lists inside the wall)
    clean(ref_list, q_list)
    t_ref = run_ref(["dist", "-r", "c2_ref.list", "-q", "c2_query.list",
                     "-o", "c2_ref.dist", "-D", "0.05", "-L", shuf],
                    cwd=root)
    # ours (sketches both lists inside the wall; drop the reference
    # run's sketch side artifacts so nothing short-circuits).  Runs
    # from the repo cwd, so the shuffle path must be absolute.
    clean(ref_list, q_list)
    t_ours = run_ours(["dist", "-r", ref_list, "-q", q_list,
                       "-o", os.path.join(root, "c2_ours.dist"),
                       "-D", "0.05", "-L", os.path.join(root, shuf)])
    same = (rows_of(os.path.join(root, "c2_ref.dist"))
            == rows_of(os.path.join(root, "c2_ours.dist")))
    return {"config": 2, "ref_wall_s": round(t_ref, 2),
            "ours_wall_s": round(t_ours, 2),
            "vs_baseline": round(t_ref / t_ours, 2), "rows_equal": same}


def config3(root: str, files: list[str], shuf: str) -> dict:
    a_list = os.path.join(root, "c3_a.list")
    b_list = os.path.join(root, "c3_b.list")
    with open(a_list, "w") as f:
        f.write("\n".join(files[:128]) + "\n")
    with open(b_list, "w") as f:
        f.write("\n".join(files[128:]) + "\n")

    def chain(prefix: str, run, sep: str) -> float:
        """sketch A/B -> union(A) -> sub -> merge -> alldist."""
        # drop every artifact of a previous run of this prefix: the
        # reference TRUSTS an existing <m>.sketch.index/.dict
        # (dist.cpp:83-130) while its union/merge hash ORDER is
        # hash-set iteration order — nondeterministic across runs —
        # so a stale index silently miscounts (observed: jaccard 1.04)
        import glob

        for p in glob.glob(os.path.join(root, f"{prefix}_*")):
            os.remove(p)
        wall = 0.0
        wall += run(["sketch", "-i", a_list if sep else "c3_a.list",
                     "-o", f"{prefix}_a", "-L", shuf])
        wall += run(["sketch", "-i", b_list if sep else "c3_b.list",
                     "-o", f"{prefix}_b", "-L", shuf])
        # union/sub/merge write -o verbatim (no .sketch appended, unlike
        # sketch): pass explicit .sketch names so both sides agree
        wall += run(["union", "-i", f"{prefix}_a.sketch",
                     "-o", f"{prefix}_au.sketch"])
        wall += run(["sub", "--rs", f"{prefix}_au.sketch",
                     "--qs", f"{prefix}_b.sketch",
                     "-o", f"{prefix}_bs.sketch"])
        mlist = os.path.join(root, f"{prefix}_merge.list")
        with open(mlist, "w") as f:
            f.write(f"{prefix}_a.sketch\n{prefix}_b.sketch\n")
        wall += run(["merge", "-i", mlist if sep else
                     os.path.basename(mlist), "-o", f"{prefix}_m.sketch"])
        wall += run(["alldist", "-i", f"{prefix}_m.sketch",
                     "-o", f"{prefix}_m.dist", "-D", "0.05", "-L", shuf])
        return wall

    cwd = os.getcwd()
    os.chdir(root)  # the reference segfaults on absolute -o paths
    try:
        t_ref = chain("c3ref", lambda a: run_ref(a, root), sep=False)
        t_ours = chain("c3ours", lambda a: run_ours(a), sep=True)
    finally:
        os.chdir(cwd)

    eq = {}
    for step in ("au", "bs", "m"):
        ra = sketch_sets(os.path.join(root, f"c3ref_{step}.sketch"))
        ob = sketch_sets(os.path.join(root, f"c3ours_{step}.sketch"))
        if step == "au":
            # the union genome's NAME embeds its input path ("<input>
            # merged sketches", reference subCommand.cpp union), which
            # differs between the two prefixes by construction —
            # compare the hash sets only
            eq[step] = sorted(ra.values()) == sorted(ob.values())
        else:
            eq[step] = ra == ob
    eq["dist_rows"] = (rows_of(os.path.join(root, "c3ref_m.dist"))
                       == rows_of(os.path.join(root, "c3ours_m.dist")))
    return {"config": 3, "ref_wall_s": round(t_ref, 2),
            "ours_wall_s": round(t_ours, 2),
            "vs_baseline": round(t_ref / t_ours, 2), "equal": eq}


def main() -> int:
    list_path = bench.ensure_corpus()
    shuf_path = bench.ensure_shuffle()
    if not os.path.exists(REF_BIN):
        bench.ensure_ref_binary()
    with open(list_path) as f:
        files = [ln.strip() for ln in f if ln.strip()]
    assert len(files) >= 256, "config 2/3 expect the 256-genome corpus"
    root = os.path.dirname(list_path)
    # the shuffle must be reachable from the corpus cwd for the
    # reference binary; copy it next to the lists
    shuf_local = os.path.join(root, os.path.basename(shuf_path))
    if not os.path.exists(shuf_local):
        shutil.copy(shuf_path, shuf_local)
    shuf = os.path.basename(shuf_local)

    print(json.dumps(config2(root, files, shuf)), flush=True)
    print(json.dumps(config3(root, files, shuf)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
