"""Set ops + CLI end-to-end vs golden reference artifacts."""

import os
import shutil

import numpy as np
import pytest

from rabbitkssd.cli import main as cli_main
from rabbitkssd.formats import read_kssd_dir, read_sketches

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _sets(path):
    sk = read_sketches(path)
    return {s.name: np.sort(s.hashes) for s in sk.sketches}, sk.info


def test_union_byte_equal(tmp_path, monkeypatch):
    """Union output is byte-identical: the reference enumerates its bitmap
    in ascending hash order, matching our canonical sorted form."""
    monkeypatch.chdir(GOLDEN)
    out = str(tmp_path / "u.sketch")
    assert cli_main(["union", "-i", "fa_k8s4l1.sketch", "-o", out]) == 0
    with open(out, "rb") as a, open("fa_k8s4l1.union.sketch", "rb") as b:
        assert a.read() == b.read()


def test_sub_golden(tmp_path, monkeypatch):
    monkeypatch.chdir(GOLDEN)
    out = str(tmp_path / "s.sketch")
    assert cli_main(["sub", "--rs", "fa_k8s4l1.union.sketch",
                     "--qs", "faq_k8s4l1.sketch", "-o", out]) == 0
    got, ginfo = _sets(out)
    want, winfo = _sets("fa_k8s4l1.sub.sketch")
    assert ginfo.id == winfo.id
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_merge_byte_equal(tmp_path, monkeypatch):
    monkeypatch.chdir(GOLDEN)
    out = str(tmp_path / "m.sketch")
    lst = str(tmp_path / "merge.list")
    with open(lst, "w") as f:
        f.write("fa_k8s4l1.sketch\nfaq_k8s4l1.sketch\n")
    assert cli_main(["merge", "-i", lst, "-o", out]) == 0
    with open(out, "rb") as a, open("fa_k8s4l1.merged.sketch", "rb") as b:
        assert a.read() == b.read()


def test_convert_from_kssd(tmp_path, monkeypatch):
    monkeypatch.chdir(GOLDEN)
    out = str(tmp_path / "conv.sketch")
    assert cli_main(["convert", "-i", "kssd_dir", "-o", out, "-q"]) == 0
    got, ginfo = _sets(out)
    want, winfo = _sets("fa_roundtrip.sketch")
    assert ginfo.id == winfo.id
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_convert_reverse_roundtrip(tmp_path, monkeypatch):
    monkeypatch.chdir(GOLDEN)
    outdir = str(tmp_path / "kssd_out")
    assert cli_main(["convert", "-i", "fa_k8s4l1.sketch", "-o", outdir,
                     "--reverse"]) == 0
    # our dir must read back set-equal, and the reference reader's
    # format invariants hold (formats.read_kssd_dir mirrors it)
    rt = read_kssd_dir(outdir)
    want, winfo = _sets("fa_k8s4l1.sketch")
    assert rt.info.id == winfo.id
    for s in rt.sketches:
        np.testing.assert_array_equal(np.sort(s.hashes), want[s.name])


def test_info_golden(tmp_path, monkeypatch):
    """Header + name/size lines match the reference exactly; the -F hash
    dump is compared as per-genome sets (order is undefined)."""
    monkeypatch.chdir(GOLDEN)
    out = str(tmp_path / "o.info")
    assert cli_main(["info", "-i", "fa_k8s4l1.sketch", "-o", out, "-F"]) == 0

    def parse(path):
        with open(path) as f:
            txt = f.read()
        lines = txt.split("\n")
        header = lines[0]
        entries = {}
        i = 1
        while i < len(lines) and lines[i]:
            name, size = lines[i].rsplit("\t", 1)
            vals = []
            i += 1
            while i < len(lines) and "\t" in lines[i] and not lines[i][0].isalpha():
                vals.extend(int(v) for v in lines[i].split("\t") if v)
                i += 1
                if len(vals) >= int(size):
                    break
            # skip blank line after each genome's dump
            while i < len(lines) and lines[i] == "":
                i += 1
                break
            entries[name] = (int(size), sorted(vals))
        return header, entries

    gh, got = parse(out)
    wh, want = parse("fa_k8s4l1.info")
    assert gh == wh
    assert got.keys() == want.keys()
    for k in got:
        assert got[k][0] == want[k][0], k
        assert got[k][1] == want[k][1], k


def test_cli_sketch_alldist_end_to_end(tmp_path, monkeypatch):
    """Full CLI drive: sketch a list then alldist, vs golden outputs."""
    monkeypatch.chdir(GOLDEN)
    out_sk = str(tmp_path / "cli.sketch")
    assert cli_main(["sketch", "-L", "k8s4l1.shuf", "-i", "fa.list",
                     "-o", out_sk]) == 0
    got, _ = _sets(out_sk)
    want, _ = _sets("fa_k8s4l1.sketch")
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert os.path.exists(out_sk + ".index")
    assert os.path.exists(out_sk + ".dict")

    out_d = str(tmp_path / "cli.alldist")
    assert cli_main(["alldist", "-i", out_sk, "-o", out_d, "-D", "1.0"]) == 0
    with open(out_d) as f:
        got_rows = f.readlines()
    with open("fa_k8s4l1.alldist") as f:
        want_rows = f.readlines()
    assert got_rows[0] == want_rows[0]
    assert sorted(got_rows[1:]) == sorted(want_rows[1:])


def test_cli_dist_end_to_end(tmp_path, monkeypatch):
    monkeypatch.chdir(GOLDEN)
    shutil.copy("fa_k8s4l1.sketch", tmp_path / "r.sketch")
    shutil.copy("faq_k8s4l1.sketch", tmp_path / "q.sketch")
    out = str(tmp_path / "cli.dist")
    assert cli_main(["dist", "-r", str(tmp_path / "r.sketch"),
                     "-q", str(tmp_path / "q.sketch"),
                     "-o", out, "-D", "1.0", "-N", "2"]) == 0
    with open(out) as f:
        got_rows = f.readlines()
    with open("fa_k8s4l1.distN2") as f:
        want_rows = f.readlines()
    assert sorted(got_rows) == sorted(want_rows)


def test_union64_byte_equal(tmp_path, monkeypatch):
    """64-bit hash path union is also byte-identical to the reference."""
    monkeypatch.chdir(GOLDEN)
    out = str(tmp_path / "u64.sketch")
    assert cli_main(["union", "-i", "fa_k10s4l1.sketch", "-o", out]) == 0
    with open(out, "rb") as a, open("fa_k10s4l1.union.sketch", "rb") as b:
        assert a.read() == b.read()
