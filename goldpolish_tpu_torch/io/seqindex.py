"""SeqIndex — random access into FASTA/FASTQ by record id.

TSV format and framing semantics mirror the reference indexer
(reference: src/seqindex.{hpp,cpp}): one row per record
`id \t seq_start_byte \t seq_len \t phred_avg`, built by a single linear
scan assuming 2-line FASTA / 4-line FASTQ records; `get_seq` preads
the raw bytes.  The mean phred of a FASTQ record averages quality bytes
[0, len-1) (the reference passes line.size()-1 as the length,
reference: src/seqindex.cpp:45).

The build path prefers the native scanner (goldpolish_tpu_torch.native,
gp_seqindex_build) and falls back to pure Python.

Port counterpart: goldpolish_tpu/io/seqindex.py, copied with only the imports renamed
(this package must import without jax).
"""

from __future__ import annotations

import os
import socket
from typing import Iterator


class SeqIndex:
    def __init__(self, seqs_filepath: str):
        self.seqs_filepath = seqs_filepath
        # id -> (seq_start, seq_len, phred_avg); dict preserves insert order
        self._records: dict[str, tuple[int, int, float]] = {}
        self._fh = None

    # -- construction ---------------------------------------------------------
    @classmethod
    def build(cls, seqs_filepath: str, use_native: bool = True) -> "SeqIndex":
        idx = cls(seqs_filepath)
        if use_native:
            try:
                from .. import native

                tmp = seqs_filepath + ".gptpu_index_tmp"
                native.seqindex_build(seqs_filepath, tmp)
                idx._load_tsv(tmp)
                os.remove(tmp)
                return idx
            except Exception:  # noqa: BLE001 — fall back to python scan
                idx._records.clear()
        idx._build_python()
        return idx

    def _build_python(self) -> None:
        with open(self.seqs_filepath, "rb") as f:
            first = f.read(1)
            fastq = first == b"@"
            f.seek(0)
            byte = 0
            i = 0
            rid = ""
            id_endbyte = 0
            seq_start = seq_len = 0
            for raw in f:
                line = raw.rstrip(b"\n")
                endbyte = byte + len(line)
                if fastq:
                    m = i % 4
                    if m == 0:
                        id_endbyte = endbyte
                        rid = line.split(b" ")[0].split(b"\t")[0][1:].decode()
                    elif m == 1:
                        seq_start = id_endbyte + 1
                        seq_len = endbyte - id_endbyte - 1
                    elif m == 3:
                        qlen = max(0, len(line) - 1)
                        phred = (
                            sum(line[q] - 33 for q in range(qlen)) / qlen
                            if qlen
                            else 0.0
                        )
                        self._records[rid] = (seq_start, seq_len, phred)
                else:
                    if i % 2 == 0:
                        id_endbyte = endbyte
                        rid = line.split(b" ")[0][1:].decode()
                    else:
                        self._records[rid] = (
                            id_endbyte + 1,
                            endbyte - id_endbyte - 1,
                            0.0,
                        )
                byte = endbyte + (1 if raw.endswith(b"\n") else 0)
                i += 1

    # -- TSV persistence (reference: seqindex.cpp:68-125) ---------------------
    def save(self, filepath: str) -> None:
        # a temporary of this host and process, then a rename: the hosts of
        # a multi-host run index the same input at once, and none may read
        # a half-written index
        tmp = f"{filepath}.{socket.gethostname()}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                for rid, (start, length, phred) in self._records.items():
                    f.write(f"{rid}\t{start}\t{length}\t{phred:g}\n")
            os.replace(tmp, filepath)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    @classmethod
    def load(cls, index_filepath: str, seqs_filepath: str) -> "SeqIndex":
        idx = cls(seqs_filepath)
        idx._load_tsv(index_filepath)
        return idx

    def _load_tsv(self, path: str) -> None:
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 4:
                    continue
                self._records[parts[0]] = (
                    int(parts[1]),
                    int(parts[2]),
                    float(parts[3]),
                )

    # -- queries (reference: seqindex.hpp:59-102) -----------------------------
    def get_seq(self, rid: str) -> bytes:
        start, length, _ = self._records[rid]
        if self._fh is None:
            self._fh = open(self.seqs_filepath, "rb")
        # pread: offset-explicit and atomic, so concurrent batch workers
        # (threads sharing this handle, or fork-pool children sharing the
        # file description and therefore its offset) cannot interleave a
        # seek with another worker's read.
        try:
            return os.pread(self._fh.fileno(), length, start)
        except OSError:
            # a stale handle (e.g. inherited across an exec/fork boundary
            # that closed it) is recoverable: reopen once and retry
            self._fh = open(self.seqs_filepath, "rb")
            return os.pread(self._fh.fileno(), length, start)

    def get_seq_len(self, rid: str) -> int:
        return self._records[rid][1]

    def get_phred_avg(self, rid: str) -> float:
        return self._records[rid][2]

    def seq_exists(self, rid: str) -> bool:
        return rid in self._records

    def ids(self) -> Iterator[str]:
        return iter(self._records)

    def __len__(self) -> int:
        return len(self._records)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _main(argv=None) -> int:
    """CLI: build + save a SeqIndex (the reference's goldpolish-index,
    reference: src/goldpolish_index.cpp:3-18).

    Usage: python -m goldpolish_tpu_torch.io.seqindex <seqs.fa|fq> <out.index>
    """
    import sys

    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 2:
        print(__doc__)
        print("usage: python -m goldpolish_tpu_torch.io.seqindex <seqs> <out.index>")
        return 2
    idx = SeqIndex.build(args[0])
    idx.save(args[1])
    print(f"indexed {len(idx)} records -> {args[1]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
