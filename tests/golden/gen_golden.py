"""Generate golden fixtures from the reference binary.

Run from tests/golden/ with a build of the reference binary (RabbitKSSD)
on PATH or given via REF_BIN.  The fixtures committed here let the test
suite verify byte/set-level compatibility without the reference binary.

Synthetic genomes are deterministic (numpy PCG64 seed per file) and include
the edge cases the kernels must honor: lowercase bases, N runs (window
resets), short records (< k-mer size), multi-record files, and FASTQ
qualities.

Configs:
  k8s4l1:  half_k=8, half_subk=4, drlevel=1  -> 28-bit hashes (32-bit path)
  k10s4l1: half_k=10, half_subk=4, drlevel=1 -> 36-bit hashes (64-bit path)
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np

REF_BIN = os.environ.get("REF_BIN", os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "build",
    "refbuild", "rabbit_kssd"))
HERE = os.path.dirname(os.path.abspath(__file__))


def wrap(seq: str, width: int = 70) -> str:
    return "\n".join(seq[i : i + width] for i in range(0, len(seq), width))


def make_genome(path: str, seed: int, n_records: int, approx_len: int):
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    with open(path, "w") as f:
        for r in range(n_records):
            ln = int(approx_len * (0.5 + rng.random()))
            s = rng.choice(bases, size=ln)
            # sprinkle N runs
            for _ in range(max(1, ln // 2000)):
                st = int(rng.integers(0, max(1, ln - 10)))
                s[st : st + int(rng.integers(1, 8))] = "N"
            seq = "".join(s)
            # lowercase a stretch
            if ln > 100:
                st = int(rng.integers(0, ln - 50))
                seq = seq[:st] + seq[st : st + 40].lower() + seq[st + 40 :]
            f.write(f">seq{r} synthetic record {r}\n{wrap(seq)}\n")
            # a too-short record exercising the < kmer_size edge
            if r == 0:
                f.write(f">tiny{r} too short\n{''.join(rng.choice(bases, 9))}\n")


def make_fastq(path: str, seed: int, n_reads: int, read_len: int):
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    with open(path, "w") as f:
        for r in range(n_reads):
            s = "".join(rng.choice(bases, size=read_len))
            # qualities spanning the printable range so -Q thresholds bite
            q = "".join(chr(c) for c in rng.integers(35, 74, size=read_len))
            f.write(f"@read{r}\n{s}\n+\n{q}\n")


def run(args, cwd=HERE):
    print("+", " ".join(args), file=sys.stderr)
    subprocess.run(args, cwd=cwd, check=True, stdout=subprocess.DEVNULL)


def sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            h.update(chunk)
    return h.hexdigest()


def main():
    os.makedirs(os.path.join(HERE, "genomes"), exist_ok=True)
    os.chdir(HERE)

    for i in range(5):
        make_genome(f"genomes/g{i}.fna", seed=100 + i, n_records=1 + i % 3,
                    approx_len=30000 + 7000 * i)
    # related genomes: g5/g6 share content with g0 (distance signal)
    with open("genomes/g0.fna") as f:
        g0 = f.read()
    with open("genomes/g5.fna", "w") as f:
        f.write(g0.replace("A", "A"))  # identical copy
    rng = np.random.default_rng(999)
    lines = g0.splitlines()
    mutated = []
    for ln in lines:
        if ln.startswith(">"):
            mutated.append(ln)
        else:
            chars = list(ln)
            for j in range(len(chars)):
                if rng.random() < 0.02:
                    chars[j] = "ACGT"[int(rng.integers(4))]
            mutated.append("".join(chars))
    with open("genomes/g6.fna", "w") as f:
        f.write("\n".join(mutated) + "\n")

    make_fastq("genomes/r0.fq", seed=300, n_reads=400, read_len=150)
    make_fastq("genomes/r1.fq", seed=301, n_reads=400, read_len=150)

    with open("fa.list", "w") as f:
        f.write("\n".join(f"genomes/g{i}.fna" for i in range(7)) + "\n")
    with open("fa_query.list", "w") as f:
        f.write("genomes/g5.fna\ngenomes/g6.fna\n")
    with open("fq.list", "w") as f:
        f.write("genomes/r0.fq\ngenomes/r1.fq\n")

    # ---- shuffle files -------------------------------------------------
    run([REF_BIN, "shuffle", "-k", "5", "-s", "4", "-l", "1", "-o", "k5s4l1.shuf"])
    run([REF_BIN, "shuffle", "-k", "8", "-s", "4", "-l", "1", "-o", "k8s4l1.shuf"])
    run([REF_BIN, "shuffle", "-k", "10", "-s", "4", "-l", "1", "-o", "k10s4l1.shuf"])
    # big standard config: record hash only (file too large to commit)
    run([REF_BIN, "shuffle", "-k", "10", "-s", "6", "-l", "3", "-o", "/tmp/L3K10.shuf"])
    run([REF_BIN, "shuffle", "-k", "8", "-s", "6", "-l", "3", "-o", "/tmp/L3K8.shuf"])
    hashes = {
        "L3K10.shuf": sha256("/tmp/L3K10.shuf"),
        "L3K8.shuf": sha256("/tmp/L3K8.shuf"),
        "k8s4l1.shuf": sha256("k8s4l1.shuf"),
        "k10s4l1.shuf": sha256("k10s4l1.shuf"),
    }
    with open("shuf_sha256.json", "w") as f:
        json.dump(hashes, f, indent=1)

    # ---- sketches (fasta 32-bit, fasta 64-bit, fastq) ------------------
    run([REF_BIN, "sketch", "-L", "k8s4l1.shuf", "-i", "fa.list",
         "-o", "fa_k8s4l1.sketch", "-t", "1"])
    run([REF_BIN, "sketch", "-L", "k10s4l1.shuf", "-i", "fa.list",
         "-o", "fa_k10s4l1.sketch", "-t", "1"])
    run([REF_BIN, "sketch", "-L", "k8s4l1.shuf", "-i", "fq.list",
         "-o", "fq_k8s4l1.sketch", "-t", "1", "-n", "2", "-Q", "40"])
    run([REF_BIN, "sketch", "-L", "k8s4l1.shuf", "-i", "fa_query.list",
         "-o", "faq_k8s4l1.sketch", "-t", "1", "-q"])

    # info dumps (the de-facto golden comparison tool)
    run([REF_BIN, "info", "-i", "fa_k8s4l1.sketch", "-o", "fa_k8s4l1.info", "-F"])
    run([REF_BIN, "info", "-i", "fa_k10s4l1.sketch", "-o", "fa_k10s4l1.info", "-F"])
    run([REF_BIN, "info", "-i", "fq_k8s4l1.sketch", "-o", "fq_k8s4l1.info", "-F"])

    # ---- distances -----------------------------------------------------
    run([REF_BIN, "alldist", "-i", "fa_k8s4l1.sketch", "-o", "fa_k8s4l1.alldist",
         "-D", "1.0", "-t", "1"])
    run([REF_BIN, "alldist", "-i", "fa_k10s4l1.sketch", "-o", "fa_k10s4l1.alldist",
         "-D", "0.5", "-t", "1"])
    run([REF_BIN, "alldist", "-i", "fa_k8s4l1.sketch", "-o", "fa_k8s4l1.allcont",
         "-D", "1.0", "-M", "1", "-t", "1"])
    run([REF_BIN, "dist", "-r", "fa_k8s4l1.sketch", "-q", "faq_k8s4l1.sketch",
         "-o", "fa_k8s4l1.dist", "-D", "1.0", "-t", "1"])
    run([REF_BIN, "dist", "-r", "fa_k8s4l1.sketch", "-q", "faq_k8s4l1.sketch",
         "-o", "fa_k8s4l1.distN2", "-D", "1.0", "-N", "2", "-t", "1"])

    # ---- set ops ---------------------------------------------------------
    run([REF_BIN, "union", "-i", "fa_k8s4l1.sketch", "-o", "fa_k8s4l1.union.sketch",
         "-t", "2"])
    run([REF_BIN, "sub", "--rs", "fa_k8s4l1.union.sketch", "--qs", "faq_k8s4l1.sketch",
         "-o", "fa_k8s4l1.sub.sketch", "-t", "2"])
    with open("merge.list", "w") as f:
        f.write("fa_k8s4l1.sketch\nfaq_k8s4l1.sketch\n")
    run([REF_BIN, "merge", "-i", "merge.list", "-o", "fa_k8s4l1.merged.sketch",
         "-t", "1"])

    # ---- convert ---------------------------------------------------------
    run([REF_BIN, "convert", "-i", "fa_k8s4l1.sketch", "-o", "kssd_dir",
         "--reverse", "-t", "1"])
    run([REF_BIN, "convert", "-i", "kssd_dir", "-o", "fa_roundtrip.sketch",
         "-t", "1", "-q"])

    # small config whose dense .index is committable byte-for-byte
    run([REF_BIN, "sketch", "-L", "k5s4l1.shuf", "-i", "fa.list",
         "-o", "fa_k5s4l1.sketch", "-t", "1"])
    run([REF_BIN, "alldist", "-i", "fa_k5s4l1.sketch", "-o", "fa_k5s4l1.alldist",
         "-D", "1.0", "-t", "1"])

    # the k8 dense indexes are ~1 GB (16^7-slot counts array); they are
    # derived artifacts — drop them rather than committing
    for fat in ("fa_k8s4l1.sketch.index", "fq_k8s4l1.sketch.index"):
        if os.path.exists(fat):
            os.remove(fat)
    print("golden fixtures written to", HERE, file=sys.stderr)


if __name__ == "__main__":
    main()
