"""2-bit packed k-mer codec — the vertex type of the gap-filler graph
search (host and device).

Plays the role of the reference's packed Kmer
(reference: subprojects/sealer/Common/Kmer.h:58-144 — shiftAppend /
shiftPrepend / setLastBase over a 2-bit-packed byte array): BFS state,
color/depth maps, visited sets and traversal DAGs key on Python ints
holding the packing instead of k-char strings.  Layout matches the device
BFS kernel (ops/dbg_bfs): first base in the HIGH bits, A=0 C=1 G=2 T=3,
so a k<=32 k-mer fits one uint64 and successor/predecessor vertices are
O(1) shifts instead of string slicing.

`pack_kmer` case-folds (hashing does not distinguish case) — callers that
need exact string identity (the search's pure-ACGT gate,
fill/konnector._prepare_search) must check `is_packable` first: a vertex
containing N/IUPAC/lowercase stays a string so that packing can never
alias two distinct reference vertices.

Frozen copy of goldpolish_tpu_torch/ops/kmers.py for the benchmark's plain
reference (NumPy and Python only; it imports nothing of the port).
"""

from __future__ import annotations

import numpy as np

BASES = b"ACGT"
BASE_CODE = np.full(256, 255, np.uint8)
for _i, _b in enumerate(BASES):
    BASE_CODE[_b] = _i
    BASE_CODE[_b + 32] = _i

_ACGT = frozenset("ACGT")


def is_packable(kmer: str) -> bool:
    """True when packing is a bijection for this k-mer (pure uppercase
    ACGT) — the gate for using packed vertices in the host search."""
    return not set(kmer) - _ACGT


def pack_kmer(kmer: str) -> int:
    """2-bit pack (ACGT -> 0..3, case-folded), first base in the HIGH
    bits.  Non-ACGT bytes produce an unspecified (but deterministic)
    value — gate with is_packable where identity matters."""
    v = 0
    for c in kmer.encode():
        v = (v << 2) | int(BASE_CODE[c] & 3)
    return v


def unpack_kmer(v: int, k: int) -> str:
    out = []
    for i in range(k):
        out.append(chr(BASES[(v >> (2 * (k - 1 - i))) & 3]))
    return "".join(out)


def unpack_many(vals, k: int) -> np.ndarray:
    """[n] packed uint64 -> [n, k] ASCII uint8 (vectorized)."""
    vals = np.asarray(vals, np.uint64)
    shifts = (2 * (k - 1 - np.arange(k))).astype(np.uint64)
    codes = ((vals[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.uint8)
    return np.frombuffer(BASES, np.uint8)[codes]
