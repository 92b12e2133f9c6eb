"""FASTA/FASTQ(.gz) reading and input-list classification.

Python fallback parser (kseq-equivalent semantics, reference kseq.h) plus
the input-list sniffers mirroring reference sketch.cpp:52-161.  A native
C++ streaming reader (the RabbitFX equivalent) plugs in behind the same
interface for the hot path; see rabbitkssd/native/__init__.py.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
from typing import Iterator


@dataclasses.dataclass
class SeqRecord:
    name: str
    seq: bytes
    qual: bytes | None = None


def _open_maybe_gz(path: str):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_records(path: str) -> Iterator[SeqRecord]:
    """Iterate records of a FASTA or FASTQ file (optionally gzipped).

    Multi-line FASTA and 4-line/multi-line FASTQ supported (kseq semantics:
    a record is delimited by '>' or '@'; FASTQ '+' starts the quality which
    runs until it reaches sequence length).
    """
    with _open_maybe_gz(path) as f:
        name = None
        seq_parts: list[bytes] = []
        qual_parts: list[bytes] | None = None
        reading_qual = False
        seq_len = 0
        qual_len = 0
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if reading_qual:
                qual_parts.append(line)
                qual_len += len(line)
                if qual_len >= seq_len:
                    yield SeqRecord(
                        name=name,
                        seq=b"".join(seq_parts),
                        qual=b"".join(qual_parts),
                    )
                    name = None
                    seq_parts = []
                    qual_parts = None
                    reading_qual = False
                    seq_len = qual_len = 0
                continue
            if not line:
                continue
            c = line[:1]
            if c in (b">", b"@"):
                if name is not None:
                    yield SeqRecord(name=name, seq=b"".join(seq_parts), qual=None)
                fields = line[1:].split()
                name = fields[0].decode() if fields else ""
                seq_parts = []
                seq_len = 0
            elif c == b"+" and name is not None:
                if seq_len == 0:
                    # kseq reads zero quality lines for an empty record
                    yield SeqRecord(name=name, seq=b"", qual=b"")
                    name = None
                    seq_parts = []
                else:
                    reading_qual = True
                    qual_parts = []
                    qual_len = 0
            else:
                seq_parts.append(line)
                seq_len += len(line)
        if name is not None:
            # EOF: keep the record; partial quality applies as far as
            # read (kseq semantics)
            yield SeqRecord(
                name=name,
                seq=b"".join(seq_parts),
                qual=b"".join(qual_parts) if reading_qual else None,
            )


# --------------------------------------------------------------------------
# input-list classification (mirrors reference sketch.cpp:52-161)
# --------------------------------------------------------------------------

def _first_char(path: str) -> bytes:
    with open(path, "rb") as f:
        line = f.readline()
    return line[:1]


def read_list(list_path: str) -> list[str]:
    with open(list_path) as f:
        return [line.rstrip("\n") for line in f if line.rstrip("\n")]


def is_fasta_list(list_path: str) -> bool:
    files = read_list(list_path)
    return bool(files) and all(_first_char(p) == b">" for p in files)


def is_fastq_list(list_path: str) -> bool:
    files = read_list(list_path)
    return bool(files) and all(_first_char(p) == b"@" for p in files)


def _has_suffixes(path: str, inner: tuple[str, ...]) -> bool:
    base, _, ext = path.rpartition(".")
    if ext != "gz" or not base:
        return False
    _, _, inner_ext = base.rpartition(".")
    return inner_ext in inner


def is_fasta_gz_list(list_path: str) -> bool:
    files = read_list(list_path)
    return bool(files) and all(
        _has_suffixes(p, ("fna", "fasta", "fa")) for p in files
    )


def is_fastq_gz_list(list_path: str) -> bool:
    files = read_list(list_path)
    return bool(files) and all(_has_suffixes(p, ("fq", "fastq")) for p in files)


def classify_list(list_path: str) -> str:
    """Returns 'fasta' | 'fastq' | raises ValueError."""
    if is_fasta_list(list_path) or is_fasta_gz_list(list_path):
        return "fasta"
    if is_fastq_list(list_path) or is_fastq_gz_list(list_path):
        return "fastq"
    raise ValueError(
        "the input file list for sketching must be list of fasta and fastq "
        "file in normal format or gz format"
    )


def file_sizes(files: list[str]) -> list[int]:
    return [os.stat(p).st_size for p in files]
