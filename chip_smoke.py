#!/usr/bin/env python
"""Smoke run of the main path on the GPU: shuffle -> sketch -> alldist/dist.

    python chip_smoke.py                # one GPU: phases a-e below
    python chip_smoke.py --four-cards   # four GPUs: the sharded path only

Phases, in order (a failed check raises and the script exits non-zero;
no phase is caught and passed over):

a. Device and native runtime: JAX's platform is ``gpu``, the native host
   library was built and loaded (not the Python fallback), and the
   card's name and power limit.
b. Goldens: the reference binary's committed outputs under tests/golden/
   reproduced through the CLI (sketch, alldist, dist, dist -N 2, union,
   sub, merge), with the equality the golden tests use.
c. Config 1 of BASELINE.json at full size: 256 synthetic bacterial
   genomes x 2 Mb (bench.write_corpus, seed 2024), L3K10, through
   ``shuffle``, ``sketch``, ``alldist -D 0.05`` and ``dist -N 3`` (192
   references, 64 queries); sampled sketches equal the numpy oracle's.
   Then the 64-bit hash path: L3K12 on 16 genomes x 2 Mb.
d. The device distance path forced (KSSD_DIST_PATH=matmul,
   KSSD_HOST_JOIN_MAX=0): its rows are text-identical to the host
   posting walk's (KSSD_DIST_PATH=walk) and to the default run's.
e. Reports: each phase's wall with its compile time apart, the stream
   step's compiled memory analysis, peak device memory, the keep
   strategy and the counting path the default alldist chose.

``--four-cards`` asserts four GPUs and runs config 1 through the CLI on
the mesh (the sharded sketcher, then the ppermute ring distance with
KSSD_HOST_JOIN_MAX=0), checked against the oracle sample and against
the host walk's rows in the same process.

The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")
SEED = 2024
N_GENOMES, GENOME_LEN, N_REF = 256, 2_000_000, 192  # config 1
N_GENOMES_64 = 16  # L3K12, the 64-bit hash path
ORACLE_SAMPLE = 8
MAX_DIST = "0.05"


def say(*a) -> None:
    print(*a, flush=True)


class Phases:
    """Wall time per phase, with the JAX compile time (tracing, lowering
    and backend compilation, from jax.monitoring events) inside it."""

    def __init__(self):
        import jax

        self.compile_s = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._event)

    def _event(self, event: str, duration: float, **_) -> None:
        if event.startswith("/jax/core/compile/"):
            self.compile_s += duration

    @contextlib.contextmanager
    def __call__(self, name: str):
        c0, t0 = self.compile_s, time.perf_counter()
        yield
        say(f"phase {name}: wall {time.perf_counter() - t0:.3f} s, "
            f"compile {self.compile_s - c0:.3f} s")


@contextlib.contextmanager
def env(**kv):
    """Set environment variables for the duration of the block."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _Tee(io.TextIOBase):
    def __init__(self, stream):
        self.stream, self.text = stream, io.StringIO()

    def write(self, s: str) -> int:
        self.stream.write(s)
        return self.text.write(s)

    def flush(self) -> None:
        self.stream.flush()


def cli(*argv: str) -> str:
    """Run one CLI command in-process; returns what it wrote to stderr."""
    from rabbitkssd.cli import main

    tee = _Tee(sys.stderr)
    with contextlib.redirect_stderr(tee):
        rc = main(list(argv))
    if rc != 0:
        raise RuntimeError(f"{' '.join(argv)} exited {rc}")
    return tee.text.getvalue()


def counting_path(stderr: str) -> str:
    lines = [ln for ln in stderr.splitlines() if ln.startswith("counting: ")]
    if len(lines) != 1:
        raise RuntimeError(f"expected one 'counting:' line, got {lines}")
    return lines[0].split(": ", 1)[1]


def _sets(path: str) -> dict:
    from rabbitkssd.formats import read_sketches

    return {s.name: np.sort(s.hashes) for s in read_sketches(path).sketches}


def _same_sets(got: dict, want: dict, what: str) -> None:
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: genome names differ")
    for k in got:
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{what}: sketch of {k} differs")


def _rows(path: str) -> tuple[str, list[str]]:
    with open(path) as f:
        lines = f.readlines()
    return lines[0], sorted(lines[1:])


def _same_bytes(a: str, b: str, what: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError(f"{what}: {a} and {b} differ")


def phase_goldens(work: str) -> None:
    """Reproduce the reference binary's committed outputs through the CLI
    (the equality of tests/test_setops_cli.py and tests/test_dist.py);
    every output goes under ``work``."""
    from rabbitkssd.formats import read_sketches

    def golden_rows(got: str, want: str) -> None:
        if _rows(got) != _rows(want):
            raise AssertionError(f"rows of {got} differ from {want}")

    with contextlib.chdir(GOLDEN):
        sk = os.path.join(work, "fa.sketch")
        cli("sketch", "-L", "k8s4l1.shuf", "-i", "fa.list", "-o", sk)
        _same_sets(_sets(sk), _sets("fa_k8s4l1.sketch"), "sketch")
        out = os.path.join(work, "fa.alldist")
        cli("alldist", "-i", sk, "-o", out, "-D", "1.0")
        golden_rows(out, "fa_k8s4l1.alldist")

        k10 = os.path.join(work, "k10.sketch")
        shutil.copy("fa_k10s4l1.sketch", k10)
        out = os.path.join(work, "k10.alldist")
        cli("alldist", "-i", k10, "-o", out, "-D", "0.5")
        golden_rows(out, "fa_k10s4l1.alldist")

        ref, qry = os.path.join(work, "r.sketch"), os.path.join(work,
                                                               "q.sketch")
        shutil.copy("fa_k8s4l1.sketch", ref)
        shutil.copy("faq_k8s4l1.sketch", qry)
        for extra, want in (([], "fa_k8s4l1.dist"),
                            (["-N", "2"], "fa_k8s4l1.distN2")):
            out = os.path.join(work, want)
            cli("dist", "-r", ref, "-q", qry, "-o", out, "-D", "1.0", *extra)
            golden_rows(out, want)

        out = os.path.join(work, "u.sketch")
        cli("union", "-i", "fa_k8s4l1.sketch", "-o", out)
        _same_bytes(out, "fa_k8s4l1.union.sketch", "union")

        out = os.path.join(work, "s.sketch")
        cli("sub", "--rs", "fa_k8s4l1.union.sketch", "--qs",
            "faq_k8s4l1.sketch", "-o", out)
        if (read_sketches(out).info.id
                != read_sketches("fa_k8s4l1.sub.sketch").info.id):
            raise AssertionError("sub: sketch info differs")
        _same_sets(_sets(out), _sets("fa_k8s4l1.sub.sketch"), "sub")

        lst = os.path.join(work, "merge.list")
        with open(lst, "w") as f:
            f.write("fa_k8s4l1.sketch\nfaq_k8s4l1.sketch\n")
        out = os.path.join(work, "m.sketch")
        cli("merge", "-i", lst, "-o", out)
        _same_bytes(out, "fa_k8s4l1.merged.sketch", "merge")


def check_oracle(sketch_path: str, shuf_path: str, n_sample: int) -> None:
    """Sampled per-genome sketches equal oracle.sketch_records_oracle's."""
    from rabbitkssd.oracle import sketch_records_oracle
    from rabbitkssd.params import KssdParams
    from rabbitkssd.seqio import read_records
    from rabbitkssd.shuffle import read_shuffle_file

    shuf = read_shuffle_file(shuf_path)
    params = KssdParams(half_k=shuf.k, half_subk=shuf.subk,
                        drlevel=shuf.drlevel)
    got = _sets(sketch_path)
    names = sorted(got)
    pick = np.random.default_rng(SEED).choice(len(names), n_sample,
                                              replace=False)
    for i in pick:
        name = names[i]
        recs = [(r.seq, r.qual) for r in read_records(name)]
        want = sketch_records_oracle(recs, params, shuf.shuffled_dim)
        if not np.array_equal(got[name], want):
            raise AssertionError(f"sketch of {name} differs from the oracle")
    say(f"oracle: {n_sample} sampled sketches of {sketch_path} equal")


def forced_paths_agree(sketch_path: str, work: str, tag: str,
                       max_dist: str, default_out: str | None = None
                       ) -> None:
    """alldist with the device matmul forced == the host walk's rows."""
    mm = os.path.join(work, f"{tag}.matmul.alldist")
    walk = os.path.join(work, f"{tag}.walk.alldist")
    with env(KSSD_DIST_PATH="matmul", KSSD_HOST_JOIN_MAX="0"):
        path = counting_path(cli("alldist", "-i", sketch_path, "-o", mm,
                                 "-D", max_dist))
    if path != "matmul":
        raise AssertionError(f"forced matmul counted by {path}")
    with env(KSSD_DIST_PATH="walk"):
        cli("alldist", "-i", sketch_path, "-o", walk, "-D", max_dist)
    _same_bytes(mm, walk, f"{tag} device matmul vs host walk")
    if default_out is not None:
        _same_bytes(default_out, walk, f"{tag} default vs host walk")
    say(f"{tag}: device-matmul rows == host-walk rows "
        f"({sum(1 for _ in open(walk)) - 1} rows)")


def split_lists(list_path: str, work: str) -> tuple[str, str]:
    """192 reference and 64 query genomes drawn from the corpus."""
    from rabbitkssd.seqio import read_list

    files = read_list(list_path)
    perm = np.random.default_rng(SEED).permutation(len(files))
    out = []
    for name, idx in (("ref", perm[:N_REF]), ("query", perm[N_REF:])):
        path = os.path.join(work, f"{name}.list")
        with open(path, "w") as f:
            f.write("".join(files[i] + "\n" for i in sorted(idx)))
        out.append(path)
    return out[0], out[1]


def phase_config1(work: str, ph: Phases) -> None:
    import bench

    with ph("config1 corpus (256 x 2 Mb)"):
        lst = bench.write_corpus(os.path.join(work, "c1"), N_GENOMES,
                                 GENOME_LEN, SEED)
    shuf = os.path.join(work, "L3K10.shuf")
    sk = os.path.join(work, "c1.sketch")
    with ph("shuffle L3K10"):
        cli("shuffle", "-k", "10", "-s", "6", "-l", "3", "-o", shuf)
    with ph("sketch"):
        cli("sketch", "-L", shuf, "-i", lst, "-o", sk)
    with ph("oracle sample"):
        check_oracle(sk, shuf, ORACLE_SAMPLE)
    out = os.path.join(work, "c1.alldist")
    with ph("alldist -D 0.05 (default dispatch)"):
        path = counting_path(cli("alldist", "-i", sk, "-o", out,
                                 "-D", MAX_DIST))
    say(f"default alldist counting path: {path}")
    ref, qry = split_lists(lst, work)
    dist_out = os.path.join(work, "c1.dist")
    with ph("dist -N 3 (192 ref, 64 query)"):
        cli("dist", "-r", ref, "-q", qry, "-L", shuf, "-N", "3",
            "-o", dist_out)
    forced = os.path.join(work, "c1.forced.dist")
    with ph("dist -N 3, device matmul forced"):
        with env(KSSD_DIST_PATH="matmul", KSSD_HOST_JOIN_MAX="0"):
            cli("dist", "-r", ref + ".sketch", "-q", qry + ".sketch",
                "-N", "3", "-o", forced)
    _same_bytes(dist_out, forced, "dist -N 3 default vs device matmul")
    every, refs = _sets(sk), _sets(ref + ".sketch")
    _same_sets(refs, {k: every[k] for k in refs}, "ref list sketches")
    with ph("alldist: device matmul vs host walk"):
        forced_paths_agree(sk, work, "c1", MAX_DIST, default_out=out)

    with ph("L3K12 corpus (16 x 2 Mb)"):
        lst64 = bench.write_corpus(os.path.join(work, "c64"), N_GENOMES_64,
                                   GENOME_LEN, SEED + 1)
    shuf64 = os.path.join(work, "L3K12.shuf")
    sk64 = os.path.join(work, "c64.sketch")
    with ph("L3K12 shuffle + sketch"):
        cli("shuffle", "-k", "12", "-s", "6", "-l", "3", "-o", shuf64)
        cli("sketch", "-L", shuf64, "-i", lst64, "-o", sk64)
    with ph("L3K12 oracle sample"):
        check_oracle(sk64, shuf64, 4)
    with ph("L3K12 alldist -D 1.0: device matmul vs host walk"):
        forced_paths_agree(sk64, work, "c64", "1.0")


def report_device(shuf_path: str) -> None:
    import jax

    from rabbitkssd.engine.sketcher import DeviceSketcher
    from rabbitkssd.params import KssdParams
    from rabbitkssd.shuffle import read_shuffle_file

    shuf = read_shuffle_file(shuf_path)
    params = KssdParams(half_k=shuf.k, half_subk=shuf.subk,
                        drlevel=shuf.drlevel)
    say("keep strategy: gather (one permutation-table lookup per window, "
        "the stream step's only keep test)")
    sk = DeviceSketcher(params, shuf.shuffled_dim)
    ma = sk.step_memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    say(f"stream step (n_blocks {sk.n_blocks}, block {sk.block}) memory "
        "analysis:", {f: getattr(ma, f, None) for f in fields})
    stats = jax.devices()[0].memory_stats() or {}
    say("peak_bytes_in_use:", stats.get("peak_bytes_in_use"),
        "bytes_limit:", stats.get("bytes_limit"))


def four_cards(work: str, ph: Phases) -> None:
    import jax

    import bench

    if len(jax.devices()) != 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, JAX sees "
                           f"{len(jax.devices())}")
    with ph("config1 corpus (256 x 2 Mb)"):
        lst = bench.write_corpus(os.path.join(work, "c1"), N_GENOMES,
                                 GENOME_LEN, SEED)
    shuf = os.path.join(work, "L3K10.shuf")
    sk = os.path.join(work, "c1.sketch")
    with ph("shuffle L3K10"):
        cli("shuffle", "-k", "10", "-s", "6", "-l", "3", "-o", shuf)
    with ph("sketch (sharded over 4 GPUs)"):
        cli("sketch", "-L", shuf, "-i", lst, "-o", sk)
    with ph("oracle sample"):
        check_oracle(sk, shuf, ORACLE_SAMPLE)
    ring = os.path.join(work, "ring.alldist")
    walk = os.path.join(work, "walk.alldist")
    with ph("alldist, ppermute ring (KSSD_HOST_JOIN_MAX=0)"):
        with env(KSSD_HOST_JOIN_MAX="0"):
            cli("alldist", "-i", sk, "-o", ring, "-D", MAX_DIST)
    with ph("alldist, host walk"):
        with env(KSSD_HOST_JOIN_MAX=str(1 << 62)):
            cli("alldist", "-i", sk, "-o", walk, "-D", MAX_DIST)
    _same_bytes(ring, walk, "ring vs host walk")
    say(f"ring rows == host-walk rows ({sum(1 for _ in open(walk)) - 1} "
        "rows)")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path, on four GPUs")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    from rabbitkssd.native import load_native

    if load_native() is None:
        raise RuntimeError("native host library unavailable")
    smi = nvidia_smi()
    say(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
        f"jax {jax.__version__}")
    say(smi)

    ph = Phases()
    with tempfile.TemporaryDirectory(prefix="kssd_smoke_") as work:
        if args.four_cards:
            four_cards(work, ph)
        else:
            with ph("goldens"):
                gw = os.path.join(work, "golden")
                os.makedirs(gw)
                phase_goldens(gw)
            phase_config1(work, ph)
            report_device(os.path.join(work, "L3K10.shuf"))
    say(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
