"""Streaming FASTA/FASTQ reader/writer (plain or gzip).

Plays the role of btllib SeqReader/SeqWriter in the reference
(reference: scripts/goldpolish:24,524-539; goldpolish-reaper:51-73).
Records are (id, comment, seq, qual); the writer emits single-line FASTA
records, matching the record shape produced by the reference's editing
chain (ntedit output is one header + one sequence line,
reference: subprojects/ntedit/ntedit.cpp:788,909-935).

Frozen copy of goldpolish_tpu_torch/io/fasta.py for the benchmark's plain
reference.
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from typing import Iterator


@dataclass
class SeqRecord:
    id: str
    comment: str
    seq: str
    qual: str = ""

    @property
    def name(self) -> str:
        """id + comment (the reference's contigName, ntedit.cpp:1832-1837)."""
        return f"{self.id} {self.comment}" if self.comment else self.id


def _open_text(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f), encoding="ascii")
    return io.TextIOWrapper(f, encoding="ascii")


def read_seqs(path: str) -> Iterator[SeqRecord]:
    """Stream records from a FASTA/FASTQ file (multi-line FASTA supported)."""
    with _open_text(path) as f:
        first = f.read(1)
        if not first:
            return
        f.seek(0)
        if first == "@":
            yield from _read_fastq(f)
        elif first == ">":
            yield from _read_fasta(f)
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def _split_header(line: str):
    h = line[1:].rstrip("\n")
    for i, c in enumerate(h):
        if c in (" ", "\t"):
            return h[:i], h[i + 1 :]
    return h, ""


def _read_fasta(f) -> Iterator[SeqRecord]:
    rid = comment = None
    chunks: list[str] = []
    for line in f:
        if line.startswith(">"):
            if rid is not None:
                yield SeqRecord(rid, comment, "".join(chunks))
            rid, comment = _split_header(line)
            chunks = []
        else:
            chunks.append(line.strip())
    if rid is not None:
        yield SeqRecord(rid, comment, "".join(chunks))


def _read_fastq(f) -> Iterator[SeqRecord]:
    while True:
        header = f.readline()
        if not header:
            return
        seq = f.readline().rstrip("\n")
        f.readline()  # '+'
        qual = f.readline().rstrip("\n")
        rid, comment = _split_header(header)
        yield SeqRecord(rid, comment, seq, qual)


class FastaWriter:
    """Single-line FASTA writer; append mode supports the ordered reaper."""

    def __init__(self, path: str, append: bool = False):
        self.path = path
        self._f = open(path, "a" if append else "w", encoding="ascii")

    def write(self, rec: SeqRecord | tuple) -> None:
        if isinstance(rec, SeqRecord):
            header, seq = rec.name, rec.seq
        else:
            header, seq = rec
        self._f.write(f">{header}\n{seq}\n")

    def flush(self) -> None:
        self._f.flush()

    def tell(self) -> int:
        """Current byte offset (post-flush) — reaper resume bookkeeping."""
        self._f.flush()
        return self._f.tell()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_fasta(path: str, records) -> None:
    with FastaWriter(path) as w:
        for rec in records:
            w.write(rec)


def count_bases(path: str) -> int:
    return sum(len(r.seq) for r in read_seqs(path))


def file_nonempty(path: str) -> bool:
    return os.path.exists(path) and os.path.getsize(path) > 0
