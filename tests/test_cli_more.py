"""Additional CLI-path coverage: shuffle bytes, list classification,
dist-from-lists artifacts."""

import os

import numpy as np
import pytest

from rabbitkssd.cli import main as cli_main

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def test_cli_shuffle_byte_identical(tmp_path):
    out = str(tmp_path / "o.shuf")
    assert cli_main(["shuffle", "-k", "8", "-s", "4", "-l", "1",
                     "-o", out]) == 0
    with open(out, "rb") as a, open(os.path.join(GOLDEN, "k8s4l1.shuf"),
                                    "rb") as b:
        assert a.read() == b.read()


def test_sketch_rejects_non_sequence_list(tmp_path, monkeypatch):
    monkeypatch.chdir(GOLDEN)
    bad = str(tmp_path / "bad.list")
    with open(bad, "w") as f:
        f.write("k8s4l1.shuf\n")  # exists but is not fasta/fastq
    with pytest.raises(ValueError, match="must be list of fasta and fastq"):
        cli_main(["sketch", "-L", "k8s4l1.shuf", "-i", bad,
                  "-o", str(tmp_path / "x.sketch")])


def test_cli_dist_from_lists(tmp_path, monkeypatch):
    """dist with genome LISTS: sketches both sides (writing
    <list>.sketch + ref index artifacts) and matches the golden output."""
    import shutil

    for g in os.listdir(os.path.join(GOLDEN, "genomes")):
        shutil.copy(os.path.join(GOLDEN, "genomes", g),
                    tmp_path / g)
    monkeypatch.chdir(tmp_path)
    with open("ref.list", "w") as f:
        f.write("\n".join(f"genomes/g{i}.fna" for i in range(7)) + "\n")
    os.makedirs("genomes", exist_ok=True)
    for g in os.listdir("."):
        if g.endswith((".fna", ".fq")):
            shutil.move(g, os.path.join("genomes", g))
    with open("query.list", "w") as f:
        f.write("genomes/g5.fna\ngenomes/g6.fna\n")
    shuf = os.path.join(GOLDEN, "k8s4l1.shuf")
    assert cli_main(["dist", "-r", "ref.list", "-q", "query.list",
                     "-L", shuf, "-o", "out.dist", "-D", "1.0"]) == 0
    assert os.path.exists("ref.list.sketch")
    assert os.path.exists("ref.list.sketch.index")
    assert os.path.exists("ref.list.sketch.dict")
    assert os.path.exists("query.list.sketch")

    with open("out.dist") as f:
        got = sorted(f.readlines()[1:])
    with open(os.path.join(GOLDEN, "fa_k8s4l1.dist")) as f:
        want_raw = f.readlines()[1:]
    # golden used file paths from tests/golden; normalize basenames
    def norm(rows):
        out = []
        for r in rows:
            q, ref, rest = r.split("\t", 2)
            out.append((os.path.basename(q), os.path.basename(ref), rest))
        return sorted(out)

    assert norm(got) == norm(want_raw)
