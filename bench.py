#!/usr/bin/env python
"""Headline benchmark: sketch + all-vs-all distance, ours vs reference.

Config 1 of BASELINE.json: bacterial all-vs-all with L3K10 (half_k=10,
half_subk=6, drlevel=3) at -D 0.05.  The corpus is deterministic
synthetic "bacteria": mutated copies of a few ancestor sequences so
sketch overlaps (and hence emitted distance rows) are realistic.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "s", "vs_baseline": N}
vs_baseline = reference_wall / our_wall (>1 means we are faster).

The reference baseline runs the actual RabbitKSSD binary (built on
demand from /root/reference with a stub RabbitFX header — the corpus
uses the small-file path only) with all host cores, and is cached per
(corpus, machine).  Our run includes everything end-to-end: host FASTA
reading, device sketching, device distance, text emission; correctness
is asserted against the reference output rows when the binary exists.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# corpora, shuffles and the reference build live under this checkout's
# git-ignored build/, so two checkouts never share (and reuse) them
BENCH_DIR = os.environ.get("KSSD_BENCH_DIR",
                           os.path.join(REPO, "build", "bench"))
N_GENOMES = int(os.environ.get("KSSD_BENCH_GENOMES", "256"))
GENOME_LEN = int(os.environ.get("KSSD_BENCH_GENOME_LEN", "2000000"))
MAX_DIST = 0.05
REF_BIN = os.environ.get("REF_BIN", os.path.join(REPO, "build", "refbuild",
                                                 "rabbit_kssd"))
# sketch config, e.g. L3K10 (bacteria default) or L2K8 (drlevel 2:
# 65,536 kept dims); s=6 as in init_shuffle.sh
CONFIG = os.environ.get("KSSD_BENCH_CONFIG", "L3K10")


def _config_kls() -> tuple[int, int, int]:
    import re

    m = re.fullmatch(r"L(\d+)K(\d+)", CONFIG)
    if not m:
        raise SystemExit(f"bad KSSD_BENCH_CONFIG {CONFIG!r} (want LxKy)")
    return int(m.group(2)), 6, int(m.group(1))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# corpus
# --------------------------------------------------------------------------

def write_corpus(root: str, n_genomes: int, genome_len: int,
                 seed: int = 2024) -> str:
    """Write the synthetic bacterial corpus under ``root``: n_genomes
    FASTA files, mutated copies (SNP rate 0.25%..20%, a few N runs) of
    8 random ancestors, mean length genome_len.  Returns the list path."""
    os.makedirs(root, exist_ok=True)
    list_path = os.path.join(root, "bacteria.list")
    rng = np.random.default_rng(seed)
    n_anc = 8
    bases = np.frombuffer(b"ACGT", np.uint8)
    ancestors = [rng.integers(0, 4, size=int(1.3 * genome_len) + 128,
                              dtype=np.int8)
                 for _ in range(n_anc)]
    files = []
    t0 = time.time()
    for g in range(n_genomes):
        # unique per-genome length: the reference orders genomes by file
        # size with an UNSTABLE sort (sketch.cpp:39-41), so equal sizes
        # would make row orientation nondeterministic
        glen = int(genome_len * (0.7 + 0.6 * g / max(n_genomes - 1, 1)))
        glen -= glen % 100
        anc = ancestors[g % n_anc][:glen]
        rate = 10 ** rng.uniform(-2.6, -0.7)  # SNP rate 0.25%..20%
        n_mut = int(len(anc) * rate)
        seq = anc.copy()
        pos = rng.integers(0, len(anc), size=n_mut)
        seq[pos] = (seq[pos] + rng.integers(1, 4, size=n_mut)) % 4
        # sprinkle N runs (window-reset edge case)
        ascii_seq = bases[seq]
        for _ in range(4):
            st = int(rng.integers(0, len(anc) - 50))
            ascii_seq[st : st + int(rng.integers(1, 30))] = ord("N")
        path = os.path.join(root, f"g{g:05d}.fna")
        with open(path, "wb") as f:
            f.write(b">g%d synthetic\n" % g)
            rows = ascii_seq.reshape(-1, 100)
            nl = np.full((rows.shape[0], 1), ord("\n"), np.uint8)
            f.write(np.hstack([rows, nl]).tobytes())
        files.append(path)
    with open(list_path, "w") as f:
        f.write("\n".join(files) + "\n")
    log(f"corpus: {n_genomes} genomes x {genome_len} bp in "
        f"{time.time()-t0:.1f}s -> {root}")
    return list_path


def ensure_corpus() -> str:
    """The benchmark corpus, written once per (size) under BENCH_DIR."""
    root = os.path.join(BENCH_DIR, f"v2_n{N_GENOMES}_l{GENOME_LEN}")
    if os.path.exists(os.path.join(root, "DONE")):
        return os.path.join(root, "bacteria.list")
    list_path = write_corpus(root, N_GENOMES, GENOME_LEN)
    with open(os.path.join(root, "DONE"), "w") as f:
        f.write("ok")
    return list_path


def ensure_shuffle() -> str:
    path = os.path.join(BENCH_DIR, f"{CONFIG}.shuf")
    if not os.path.exists(path):
        from rabbitkssd.shuffle import generate_shuffle, write_shuffle_file

        k, s, l = _config_kls()
        os.makedirs(BENCH_DIR, exist_ok=True)
        t0 = time.time()
        write_shuffle_file(generate_shuffle(k, s, l), path)
        log(f"{CONFIG}.shuf generated in {time.time()-t0:.1f}s")
    return path


# --------------------------------------------------------------------------
# reference baseline
# --------------------------------------------------------------------------

def ensure_ref_binary() -> str | None:
    if os.path.exists(REF_BIN):
        return REF_BIN
    try:
        bdir = os.path.dirname(os.path.abspath(REF_BIN))
        os.makedirs(os.path.join(bdir, "stub"), exist_ok=True)
        shutil.copytree("/root/reference/src", os.path.join(bdir, "src"),
                        dirs_exist_ok=True)
        stub = """#pragma once
#include <string>
#include <vector>
#include <thread>
#include <functional>
#include <cstdlib>
struct Reference { std::string name, comment, seq, quality; int length = 0; };
struct FA {}; struct FQ_SE {};
template <typename T> class FXReader {
public:
    explicit FXReader(const std::string &) { std::abort(); }
    std::vector<Reference> get_formated_reads() { return {}; }
    void join_producer() {}
};
"""
        for h in ("Formater.h", "RabbitFX.h"):
            with open(os.path.join(bdir, "stub", h), "w") as f:
                f.write(stub)
        subprocess.run(
            # -DTimer turns on the reference's own per-phase stderr
            # spans (CMakeLists.txt:6-8 default-on), parsed by
            # parse_ref_phases for the benchmark artifact
            ["g++", "-O2", "-fopenmp", "-std=c++14", "-march=native",
             "-DTimer"]
            + sorted(
                os.path.join(bdir, "src", f)
                for f in os.listdir(os.path.join(bdir, "src"))
                if f.endswith(".cpp")
            )
            + ["-I" + os.path.join(bdir, "stub"), "-I" + os.path.join(bdir, "src"),
               "-lz", "-lpthread", "-o", REF_BIN],
            check=True, capture_output=True,
        )
        return REF_BIN
    except Exception as e:
        log(f"reference binary unavailable: {e}")
        return None


def parse_ref_phases(stderr_text: str) -> dict:
    """Per-phase walls from the reference's own Timer spans (printed to
    stderr by default, CMakeLists.txt:6-8; messages at e.g.
    subCommand.cpp:192, sketch.cpp:588, dist.cpp:134,273,340)."""
    import re

    frags = [
        ("sketch", "computing sketches and save sketches"),
        # NB "read sketches from" (dist.cpp:134) is a plain file load
        # when .index/.dict exist, but when they are absent the alldist
        # path rebuilds the dense index INSIDE this span with no
        # separate Timer line — keep it distinct from "sketch" so an
        # index-build pathology can't masquerade as sketch time
        ("load", "read sketches from"),
        ("index", "transSketches"),
        ("dist", "read index and offset"),
        ("dist", "read the index and dict"),
        ("dist", "distance computing and save"),
        ("dist", "merge the subFiles"),
    ]
    phases: dict[str, float] = {}
    for line in stderr_text.splitlines():
        m = re.search(r"time of (.*?) is:? ([0-9.eE+-]+)", line)
        if not m:
            continue
        try:
            val = float(m.group(2))
        except ValueError:
            continue
        for key, frag in frags:
            if frag in m.group(1):
                phases[key] = round(phases.get(key, 0.0) + val, 3)
                break
    # the transSketches span (sketch.cpp:588) is NESTED inside the
    # "computing sketches and save" span (subCommand.cpp:192) — report
    # the sketch phase net of the index build
    if "sketch" in phases and "index" in phases:
        phases["sketch"] = round(max(0.0, phases["sketch"]
                                     - phases["index"]), 3)
    return phases


def run_measured(cmd: list[str], cwd: str | None = None):
    """Run cmd, returning (wall_s, maxrss_kb, CompletedProcess).

    The child's peak RSS cannot come from getrusage(RUSAGE_CHILDREN) in
    the benchmark process itself: fork inherits the parent's RSS for an
    instant before exec, so a multi-GB benchmark parent masks any
    smaller child (this silently reported OUR footprint as the
    reference's in round 4).  A ~15 MB python wrapper forks the child
    instead, making the inheritance floor negligible."""
    wrapper = ("import resource,subprocess,sys;"
               "r=subprocess.run(sys.argv[1:]);"
               "print('MAXRSS_KB',"
               "resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss,"
               "file=sys.stderr);"
               "sys.exit(r.returncode)")
    t0 = time.time()
    r = subprocess.run([sys.executable, "-Sc", wrapper] + cmd,
                       capture_output=True, text=True, cwd=cwd)
    wall = time.time() - t0
    rss_kb = 0
    keep = []
    for ln in r.stderr.splitlines():
        if ln.startswith("MAXRSS_KB"):
            rss_kb = int(ln.split()[1])
        else:
            keep.append(ln)
    r.stderr = "\n".join(keep)
    return wall, rss_kb, r


def run_reference(list_path: str, shuf: str
                  ) -> tuple[float, str, dict] | None:
    """Cached (wall_s, output_path, phases) of reference sketch+alldist."""
    root = os.path.dirname(list_path)
    cache = os.path.join(root, f"baseline_{CONFIG}.json")
    out = os.path.join(root, f"ref_{CONFIG}.alldist")
    if os.path.exists(cache) and os.path.exists(out):
        with open(cache) as f:
            c = json.load(f)
        if "phases" in c:
            return c["wall_s"], out, c["phases"]
    ref = ensure_ref_binary()
    if ref is None:
        return None
    # the reference SHORT-CIRCUITS onto an existing <input>.sketch
    # (subCommand.cpp:161-193) — a leftover from a previous run would
    # silently replace its whole sketch phase with a 1 s file load and
    # deflate the baseline.  Both sides must sketch from FASTA.
    for suffix in (".sketch", ".sketch.index", ".sketch.dict"):
        try:
            os.remove(list_path + suffix)
        except OSError:
            pass
    # big-file RabbitFX path would abort in the stub build; the corpus
    # files are all below totalSize/threads only when many files — use
    # a thread count that keeps every file on the small-file path.
    # NB: the reference segfaults on absolute -o paths (its per-thread
    # temp files concatenate the full output path inside <out>.dir,
    # dist.cpp:154) — run with cwd=corpus and relative paths.
    t0 = time.time()
    r = subprocess.run(
        [ref, "alldist", "-i", "bacteria.list", "-L", shuf,
         "-o", os.path.basename(out), "-D", str(MAX_DIST)],
        check=True, capture_output=True, text=True, cwd=root,
    )
    wall = time.time() - t0
    phases = parse_ref_phases(r.stderr)
    # clean reference side artifacts so our run is from scratch
    with open(cache, "w") as f:
        json.dump({"wall_s": wall, "threads": os.cpu_count(),
                   "phases": phases}, f)
    log(f"reference baseline: {wall:.2f}s ({os.cpu_count()} cores) "
        f"phases={phases}")
    return wall, out, phases


def run_reference_t1(list_path: str, shuf: str) -> str | None:
    """Cached output of a DETERMINISTIC -t 1 reference run (not timed).

    With one thread the reference's size-sort tie-breaks and row order
    are reproducible, so strict (sorted-)row equality is well-defined;
    the multi-thread run above stays the wall-clock baseline.
    """
    root = os.path.dirname(list_path)
    out = os.path.join(root, f"ref_t1_{CONFIG}.alldist")
    if os.path.exists(out):
        return out
    ref = ensure_ref_binary()
    if ref is None:
        return None
    subprocess.run(
        [ref, "alldist", "-i", "bacteria.list", "-L", shuf,
         "-o", os.path.basename(out), "-D", str(MAX_DIST), "-t", "1"],
        check=True, capture_output=True, cwd=root,
    )
    return out


# --------------------------------------------------------------------------
# ours
# --------------------------------------------------------------------------

def prewarm_ours(shuf_path: str):
    """Build + prewarm the sketcher (trace/compile-load the stream step
    and flush reads) while the reference baseline runs — a serving
    process does this once at startup, outside any request."""
    import jax

    from rabbitkssd.engine.sketcher import DeviceSketcher
    from rabbitkssd.params import KssdParams
    from rabbitkssd.shuffle import read_shuffle_file

    if len(jax.devices()) > 1:
        return None
    shuf = read_shuffle_file(shuf_path)
    params = KssdParams(half_k=shuf.k, half_subk=shuf.subk,
                        drlevel=shuf.drlevel)
    sk = DeviceSketcher(params, shuf.shuffled_dim)
    sk.prewarm()
    return sk


def run_ours(list_path: str, shuf_path: str,
             sketcher=None) -> tuple[float, str, dict]:
    from rabbitkssd.engine.dist_engine import run_alldist
    from rabbitkssd.engine.sketcher import sketch_file_list
    from rabbitkssd.shuffle import read_shuffle_file

    root = os.path.dirname(list_path)
    out = os.path.join(root, f"ours_{CONFIG}.alldist")
    shuf = read_shuffle_file(shuf_path)

    t0 = time.time()
    sk = sketch_file_list(list_path, shuf, sketcher=sketcher)
    t1 = time.time()
    log(f"ours: sketch {t1-t0:.2f}s "
        f"({N_GENOMES * GENOME_LEN / max(t1-t0, 1e-9) / 1e6:.1f} Mbase/s)")
    run_alldist(sk, out, max_dist=MAX_DIST, containment=False)
    t2 = time.time()
    log(f"ours: alldist {t2-t1:.2f}s  total {t2-t0:.2f}s")
    phases = {"sketch": round(t1 - t0, 3), "alldist": round(t2 - t1, 3)}
    if sketcher is not None and getattr(sketcher, "last_budget", None):
        # itemized sketch-wall budget (see sketcher.sketch_codes): the
        # pipeline roles overlap, so the wall floor is the max role
        phases["sketch_budget"] = dict(sketcher.last_budget)
    return t2 - t0, out, phases


def rows(path):
    with open(path) as f:
        return sorted(f.readlines()[1:])


def canonical_rows(path):
    """Rows normalized for pair orientation (i/j order is tie-broken
    arbitrarily by the reference's unstable size sort)."""
    out = set()
    with open(path) as f:
        next(f)
        for line in f:
            g0, g1, csz, j, d = line.rstrip("\n").split("\t")
            c, s0, s1 = csz.split("|")
            a, b = sorted([(g0, s1), (g1, s0)])
            out.add((a, b, c, j, d))
    return out


def device_info() -> dict:
    """The device JAX runs on, plus the card's name and power limit from
    nvidia-smi; exits when JAX finds no GPU (a CPU number is not a
    benchmark result)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX platform {dev.platform!r})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}


def main() -> int:
    device = device_info()
    list_path = ensure_corpus()
    shuf_path = ensure_shuffle()

    baseline = run_reference(list_path, shuf_path)
    sketcher = prewarm_ours(shuf_path)
    ours_wall, ours_out, ours_phases = run_ours(list_path, shuf_path,
                                                sketcher=sketcher)

    vs = None
    result = {
        "metric": f"sketch+alldist wall, {N_GENOMES} genomes x "
                  f"{GENOME_LEN/1e6:g}Mb ({CONFIG}, D=0.05)",
        "value": round(ours_wall, 3),
        "unit": "s",
        "vs_baseline": None,
        "device": device,
    }
    if baseline is not None:
        ref_wall, _, ref_phases = baseline
        # strict check against the deterministic -t 1 reference output
        # (multi-thread runs tie-break the size sort arbitrarily)
        t1_out = run_reference_t1(list_path, shuf_path)
        same = t1_out is not None and rows(ours_out) == rows(t1_out)
        log(f"strict row equality vs -t 1 reference: {same}")
        if not same and t1_out is not None:
            canon = canonical_rows(ours_out) == canonical_rows(t1_out)
            log(f"canonical (orientation-insensitive) equality: {canon}")
            if not canon:
                log("WARNING: output rows differ from the reference!")
        vs = ref_wall / ours_wall
        result["vs_baseline"] = round(vs, 3)
        # per-phase honesty: the total ratio can be dominated by the
        # reference's index build (transSketches is page-fault-bound on
        # some hosts); the phase walls let a reader attribute the win.
        # ref phases come from the reference's own Timer spans.
        result["phases"] = {
            "ref": {**ref_phases, "total": round(ref_wall, 3)},
            "ours": {**ours_phases, "total": round(ours_wall, 3)},
        }
        if ref_phases.get("sketch") and ours_phases.get("sketch"):
            result["vs_baseline_sketch_phase"] = round(
                ref_phases["sketch"] / ours_phases["sketch"], 3)
        # pathology-proof ratio: clamp the reference's dense
        # transSketches phase (page-fault-bound on some hosts) to a
        # healthy floor so the headline can't ride a sick host
        if ref_phases.get("index"):
            floor = float(os.environ.get("KSSD_HEALTHY_INDEX_S", "13.0"))
            healthy_ref = ref_wall - ref_phases["index"] + min(
                ref_phases["index"], floor)
            result["vs_baseline_healthy_est"] = round(
                healthy_ref / ours_wall, 3)
        result["rows_equal"] = bool(same)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
