"""Multi-host execution: 2 jax.distributed processes on the CPU backend.

SURVEY §4 requires multi-host tests runnable on CPU via jax.distributed.
Two coordinated processes (4 virtual CPU devices each, gloo collectives)
build the global ("dp", "vp") mesh, run sharded_common_counts and a
ShardedSketcher window, and their results must equal a single-process
run of the same computation (computed here in the parent).
"""

import hashlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(__file__)
CHILD = os.path.join(HERE, "multihost_child.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child_env(pid: int, port: int) -> dict:
    env = dict(os.environ)
    # the package may be importable only from the repo root (no editable
    # install in a fresh environment) — the child runs with cwd=tests/
    repo_root = os.path.dirname(HERE)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo_root, env.get("PYTHONPATH")) if p
    )
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    env["JAX_NUM_PROCESSES"] = "2"
    env["JAX_PROCESS_ID"] = str(pid)
    env["KSSD_CPU_DEVICES"] = "4"
    return env


def _expected_sketch_digest() -> str:
    """The single-process result the 2-process run must reproduce
    (same synthetic corpus as multihost_child.py)."""
    from rabbitkssd.engine.sketcher import DeviceSketcher
    from rabbitkssd.params import KssdParams
    from rabbitkssd.shuffle import generate_shuffle

    shuf = generate_shuffle(8, 6, 3)
    params = KssdParams(half_k=8, half_subk=6, drlevel=3)
    g_rng = np.random.default_rng(21)
    genomes = [g_rng.integers(0, 4, size=n).astype(np.int8)
               for n in (20000, 3000, 45000, 12000)]
    genomes[1][100:160] = -1
    sk = DeviceSketcher(params, shuf.shuffled_dim, n_blocks=2, block=2048)
    hashes, n = sk.sketch_codes(iter(genomes))
    assert n == len(genomes)
    digest = hashlib.sha256()
    for h in hashes:
        digest.update(np.ascontiguousarray(h).tobytes())
    return digest.hexdigest()


def _write_corpus(root: str) -> tuple[str, str]:
    """Small deterministic FASTA corpus + shuffle file; returns
    (list_path, shuf_path)."""
    from rabbitkssd.shuffle import generate_shuffle, write_shuffle_file

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", np.uint8)
    files = []
    for g in range(6):
        n = 4000 + 157 * g  # distinct sizes: deterministic size sort
        seq = bases[rng.integers(0, 4, size=n)]
        seq[100:110] = ord("N")
        path = os.path.join(root, f"g{g}.fna")
        with open(path, "wb") as f:
            f.write(b">g%d\n" % g + seq.tobytes() + b"\n")
        files.append(path)
    list_path = os.path.join(root, "corpus.list")
    with open(list_path, "w") as f:
        f.write("\n".join(files) + "\n")
    shuf_path = os.path.join(root, "small.shuf")
    write_shuffle_file(generate_shuffle(6, 4, 1), shuf_path)
    return list_path, shuf_path


def test_two_process_cli_end_to_end(tmp_path):
    """sketch + alldist through the REAL CLI in 2 jax.distributed
    processes: artifacts must be byte-identical to single-process
    (VERDICT r2 item 5 — the config-5 story proven end-to-end)."""
    list_path, shuf_path = _write_corpus(str(tmp_path / "corpus"))
    child = os.path.join(HERE, "multihost_cli_child.py")

    # single-process reference run of the same CLI surface
    env1 = _child_env(0, 0)
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        env1.pop(k, None)
    single = str(tmp_path / "single")
    r = subprocess.run(
        [sys.executable, child, list_path, shuf_path, single],
        env=env1, capture_output=True, text=True, timeout=600, cwd=HERE,
    )
    assert r.returncode == 0, f"single-process CLI failed:\n{r.stderr[-3000:]}"

    port = _free_port()
    outs = [str(tmp_path / f"proc{pid}") for pid in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, child, list_path, shuf_path, outs[pid]],
            env=_child_env(pid, port),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=HERE,
        )
        for pid in range(2)
    ]
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"child failed:\n{err[-3000:]}"
        assert "CLI-OK" in out

    def read(d, name):
        with open(os.path.join(d, name), "rb") as f:
            return f.read()

    for name in ("corpus.sketch", "corpus.alldist", "rq.dist",
                 "rq_top2.dist", "u.sketch", "s.sketch", "m.sketch",
                 "m.info"):
        want = read(single, name)
        assert want, name
        for pid in range(2):
            assert read(outs[pid], name) == want, \
                f"process {pid} {name} differs from single-process"


def test_two_process_distributed():
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, CHILD],
            env=_child_env(pid, port),
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            cwd=HERE,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"child failed:\n{err[-4000:]}"
        outs.append(out)

    want = _expected_sketch_digest()
    for pid, out in enumerate(outs):
        assert "COUNTS-OK" in out, f"process {pid}: {out}"
        line = [ln for ln in out.splitlines()
                if ln.startswith("SKETCH-DIGEST")]
        assert line, f"process {pid}: {out}"
        got = line[0].split()[1]
        assert got == want, f"process {pid} sketch digest mismatch"
