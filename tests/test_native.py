"""Native C++ host components vs their Python fallbacks."""

import gzip
import os

import numpy as np
import pytest

from rabbitkssd.native import fasta_codes, load_native
from rabbitkssd.ops.kmer import encode_concat
from rabbitkssd.seqio import read_records

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module", autouse=True)
def native_available():
    if load_native() is None:
        pytest.skip("native toolchain unavailable")


def _python_codes(path, least_qual=0):
    recs = [(r.seq, r.qual) for r in read_records(path)]
    return encode_concat(recs, least_qual)


@pytest.mark.parametrize("name", ["g0.fna", "g3.fna", "r0.fq", "r1.fq"])
def test_native_matches_python(name):
    path = os.path.join(GOLDEN, "genomes", name)
    got = fasta_codes(path)
    want = _python_codes(path)
    np.testing.assert_array_equal(got, want)


def test_native_fastq_quality():
    path = os.path.join(GOLDEN, "genomes", "r0.fq")
    got = fasta_codes(path, least_qual=40)
    want = _python_codes(path, least_qual=40)
    np.testing.assert_array_equal(got, want)


def test_native_gzip(tmp_path):
    src = os.path.join(GOLDEN, "genomes", "g1.fna")
    gz = str(tmp_path / "g1.fna.gz")
    with open(src, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    np.testing.assert_array_equal(fasta_codes(gz), _python_codes(src))


def test_native_edge_cases(tmp_path):
    p = str(tmp_path / "edge.fa")
    with open(p, "w") as f:
        f.write(">a\nACGT\nNNttGG\n\n>b empty\n>c\nA\n>d\r\nACgtN\r\n")
    np.testing.assert_array_equal(fasta_codes(p), _python_codes(p))


def test_stream_reader_matches_oneshot():
    from rabbitkssd.native import fasta_codes_chunks

    for name in ("g0.fna", "r0.fq"):
        path = os.path.join(GOLDEN, "genomes", name)
        chunks = list(fasta_codes_chunks(path, chunk=777))
        got = np.concatenate(chunks) if chunks else np.empty(0, np.int8)
        np.testing.assert_array_equal(got, fasta_codes(path), err_msg=name)


def test_stream_reader_fastq_quality():
    from rabbitkssd.native import fasta_codes_chunks

    path = os.path.join(GOLDEN, "genomes", "r1.fq")
    got = np.concatenate(list(fasta_codes_chunks(path, least_qual=40,
                                                 chunk=123)))
    np.testing.assert_array_equal(got, fasta_codes(path, least_qual=40))


def test_streaming_sketch_end_to_end(monkeypatch):
    """Tiny stream threshold forces the chunked path; sketches must be
    identical to the materializing path."""
    import subprocess
    import sys

    from conftest import REPO_ROOT

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["KSSD_STREAM_THRESHOLD"] = "1000"
    env["PYTHONPATH"] = REPO_ROOT
    code = f"""
import sys, os
os.chdir({GOLDEN!r})
import numpy as np
from rabbitkssd.engine.sketcher import sketch_file_list
from rabbitkssd.shuffle import read_shuffle_file
from rabbitkssd.formats import read_sketches
ours = sketch_file_list('fa.list', read_shuffle_file('k8s4l1.shuf'))
ref = {{s.name: np.sort(s.hashes) for s in read_sketches('fa_k8s4l1.sketch').sketches}}
for s in ours.sketches:
    np.testing.assert_array_equal(s.hashes, ref[s.name])
print('STREAMING SKETCH OK')
"""
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "STREAMING SKETCH OK" in r.stdout


def test_empty_fastq_record_does_not_eat_next(tmp_path):
    """Regression: an empty FASTQ record must not consume the following
    record's header as quality (kseq reads zero quality lines when
    seq_len == 0)."""
    p = str(tmp_path / "empty.fq")
    with open(p, "w") as f:
        f.write("@r1\nACGT\n+\nIIII\n@r2\n\n+\n\n@r3\nGGTTAA\n+\nIIIIII\n")
    want = np.array([0, 1, 2, 3, -1, -1, 2, 2, 3, 3, 0, 0], np.int8)
    np.testing.assert_array_equal(fasta_codes(p), want)
    np.testing.assert_array_equal(_python_codes(p), want)
    from rabbitkssd.native import fasta_codes_chunks

    np.testing.assert_array_equal(
        np.concatenate(list(fasta_codes_chunks(p, chunk=5))), want)
    # no blank quality line before the next header either
    p2 = str(tmp_path / "empty2.fq")
    with open(p2, "w") as f:
        f.write("@r1\nAC\n+\nII\n@r2\n+\n@r3\nGG\n+\nII\n")
    want2 = np.array([0, 1, -1, -1, 2, 2], np.int8)
    np.testing.assert_array_equal(fasta_codes(p2), want2)
    np.testing.assert_array_equal(_python_codes(p2), want2)


def test_eof_partial_quality_kept(tmp_path):
    """kseq keeps a record whose quality is cut off at EOF."""
    p = str(tmp_path / "trunc.fq")
    with open(p, "w") as f:
        f.write("@r1\nACGT\n+\nI")  # only 1 of 4 quality bytes
    want = np.array([0, 1, 2, 3], np.int8)
    np.testing.assert_array_equal(fasta_codes(p), want)
    np.testing.assert_array_equal(_python_codes(p), want)
    from rabbitkssd.native import fasta_codes_chunks

    np.testing.assert_array_equal(
        np.concatenate(list(fasta_codes_chunks(p, chunk=3))), want)
    # with a quality threshold: the one read byte applies ('I'=73 < 80)
    got = fasta_codes(p, least_qual=80)
    np.testing.assert_array_equal(got, np.array([-1, 1, 2, 3], np.int8))
    np.testing.assert_array_equal(_python_codes(p, least_qual=80), got)


def test_crlf_line_endings(tmp_path):
    """CRLF input parses identically to LF (the bulk line-segment fast
    path splits runs at '\\r'; round-2 parser rewrite)."""
    from rabbitkssd.native import fasta_packed_chunks

    fa_lf = (b">a desc\nACGTNNACGT\nGGCC\n>b\nacgt\n")
    fq_lf = (b"@r1\nACGTACGT\n+\nIIIIII!!\n@r2\nGGGG\n+\nIIII\n")
    for lf, name in ((fa_lf, "x.fna"), (fq_lf, "x.fq")):
        p_lf = str(tmp_path / name)
        p_crlf = str(tmp_path / ("crlf_" + name))
        with open(p_lf, "wb") as f:
            f.write(lf)
        with open(p_crlf, "wb") as f:
            f.write(lf.replace(b"\n", b"\r\n"))
        for lq in (0, 40):
            a = fasta_codes(p_lf, lq)
            b = fasta_codes(p_crlf, lq)
            np.testing.assert_array_equal(a, b, err_msg=f"{name} lq={lq}")
        # streaming reader too
        sa = np.concatenate([np.frombuffer(bytes(c), np.int8) if not
                             isinstance(c, np.ndarray) else c
                             for c in _stream_all(p_lf)])
        sb = np.concatenate(list(_stream_all(p_crlf)))
        np.testing.assert_array_equal(np.asarray(sa), np.asarray(sb))


def _stream_all(path, least_qual=0, chunk=7):
    """Tiny-chunk pulls through the handle API (stresses boundaries)."""
    import ctypes as ct

    from rabbitkssd.native import _bind_stream, load_native

    lib = load_native()
    _bind_stream(lib)
    h = lib.kssd_fasta_open(path.encode(), least_qual)
    assert h
    try:
        while True:
            buf = np.empty(chunk, np.int8)
            n = lib.kssd_fasta_read_codes(
                h, buf.ctypes.data_as(ct.POINTER(ct.c_int8)),
                ct.c_int64(chunk))
            assert n >= 0
            if n == 0:
                return
            yield buf[:n].copy()
    finally:
        lib.kssd_fasta_close(h)
