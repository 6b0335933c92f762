"""Needleman-Wunsch global alignment with affine gaps + IUPAC consensus.

Exact semantics of the reference's multi-path consensus aligner
(reference: subprojects/sealer/Align/alignGlobal.{h,cc}):

 * scores MATCH=5, MISMATCH=-4, GAP_OPEN=-12, GAP_EXTEND=-4 (Gotoh),
 * mismatch consensus char = IUPAC ambiguityOr of the two bases
   (reference: Common/Sequence.h:102-107, Sequence.cpp:141-198) — if the OR
   covers one input it still scores MATCH,
 * gap columns contribute the lowercase base to the consensus,
 * backtrack preference: diagonal, then gap-in-A (query), then gap-in-B,
   with whole gap runs emitted at once,
 * progressive multi-alignment: fold each next sequence into the running
   consensus; the returned match count is min-accumulated from 0
   (reference alignGlobal.h:57-69 — yes, that makes it 0 for 3+ sequences;
   kept for parity).

The DP is NumPy-vectorized row-wise (anti-diagonal free since only the
previous row is needed); paths here are short (gap size <= ~900 bp).

Frozen copy of goldpolish_tpu_torch/fill/nw.py for the benchmark's plain
reference (NumPy and Python only; it imports nothing of the port).
"""

from __future__ import annotations

import numpy as np

MATCH = 5
MISMATCH = -4
GAP_OPEN = -12
GAP_EXTEND = -4
NEG_INF = -(2**31) // 2

_AMB_TO_MASK = {}
for _c, _m in zip("ABCDGHKMNRSTVWY",
                  [0x1, 0xE, 0x2, 0xD, 0x4, 0xB, 0xC, 0x3, 0xF, 0x5, 0x6,
                   0x8, 0x7, 0x9, 0xA]):
    _AMB_TO_MASK[_c] = _m
_MASK_TO_AMB = "NACMGRSVTWYHKDBN"


def ambiguity_or(ca: str, cb: str) -> str:
    c = _MASK_TO_AMB[
        _AMB_TO_MASK.get(ca.upper(), 0xF) | _AMB_TO_MASK.get(cb.upper(), 0xF)
    ]
    return c.lower() if (ca.islower() or cb.islower()) else c


def _score(a: str, b: str) -> tuple[int, str]:
    if a == b:
        return MATCH, a
    c = ambiguity_or(a, b)
    return (MATCH if c in (a, b) else MISMATCH), c


def align_global(seq_a: str, seq_b: str):
    """Returns (matches, NWAlignment-like dict with query/target/consensus)."""
    la, lb = len(seq_a), len(seq_b)
    # score matrices (int32), row-wise DP
    f = np.zeros((la + 1, lb + 1), np.int64)
    g = np.zeros((la + 1, lb + 1), np.int64)
    h = np.zeros((la + 1, lb + 1), np.int64)
    i_idx = np.arange(1, la + 1)
    j_idx = np.arange(1, lb + 1)
    f[:, 0] = g[:, 0] = np.concatenate(([0], GAP_OPEN + GAP_EXTEND * (i_idx - 1)))
    h[:, 0] = NEG_INF
    f[0, :] = h[0, :] = np.concatenate(([0], GAP_OPEN + GAP_EXTEND * (j_idx - 1)))
    g[0, 1:] = NEG_INF
    h[0, 0] = f[0, 0]
    g[0, 0] = f[0, 0]

    # substitution score row per i, vectorized over j
    a_arr = np.frombuffer(seq_a.encode(), np.uint8)
    b_arr = np.frombuffer(seq_b.encode(), np.uint8)
    amb = np.zeros(256, np.uint8)
    for c, m in _AMB_TO_MASK.items():
        amb[ord(c)] = m
        amb[ord(c.lower())] = m
    amb[amb == 0] = 0xF
    ma = amb[a_arr][:, None]
    mb = amb[b_arr][None, :]
    eq = a_arr[:, None] == b_arr[None, :]
    or_mask = ma | mb
    covered = (or_mask == ma) | (or_mask == mb)
    s_mat = np.where(eq | covered, MATCH, MISMATCH).astype(np.int64)

    for i in range(1, la + 1):
        g[i, 1:] = np.maximum(f[i - 1, 1:] + GAP_OPEN, g[i - 1, 1:] + GAP_EXTEND)
        # h depends on its own row -> sequential recurrence; do it with a scan
        fi_prev = f[i - 1, :-1] + s_mat[i - 1]
        # f[i,j] = max(diag, g[i,j], h[i,j]); h[i,j] = max(f[i,j-1]+GO, h[i,j-1]+GE)
        hrow = h[i]
        frow = f[i]
        grow = g[i]
        hprev = hrow[0]
        fprev = frow[0]
        for j in range(1, lb + 1):
            hj = max(fprev + GAP_OPEN, hprev + GAP_EXTEND)
            fj = max(fi_prev[j - 1], grow[j], hj)
            hrow[j] = hj
            frow[j] = fj
            hprev, fprev = hj, fj

    # backtrack (reference alignGlobal.cc:55-136)
    align_a = []
    align_b = []
    cons = []
    matches = 0
    i, j = la, lb
    while i > 0 and j > 0:
        fij = f[i, j]
        a, b = seq_a[i - 1], seq_b[j - 1]
        s, c = _score(a, b)
        if fij == f[i - 1, j - 1] + s:
            align_a.append(a)
            align_b.append(b)
            cons.append(c)
            if s == MATCH:
                matches += 1
            i -= 1
            j -= 1
        elif fij == f[i - 1, j] + GAP_OPEN or fij == g[i - 1, j] + GAP_EXTEND:
            while g[i, j] == g[i - 1, j] + GAP_EXTEND:
                a = seq_a[i - 1]
                align_a.append(a)
                align_b.append("*")
                cons.append(a.lower())
                i -= 1
                assert i > 0
            assert g[i, j] == f[i - 1, j] + GAP_OPEN
            a = seq_a[i - 1]
            align_a.append(a)
            align_b.append("*")
            cons.append(a.lower())
            i -= 1
        elif fij == f[i, j - 1] + GAP_OPEN or fij == h[i, j - 1] + GAP_EXTEND:
            while h[i, j] == h[i, j - 1] + GAP_EXTEND:
                b = seq_b[j - 1]
                align_a.append("*")
                align_b.append(b)
                cons.append(b.lower())
                j -= 1
                assert j > 0
            assert h[i, j] == f[i, j - 1] + GAP_OPEN
            b = seq_b[j - 1]
            align_a.append("*")
            align_b.append(b)
            cons.append(b.lower())
            j -= 1
        else:  # pragma: no cover - DP invariant
            raise AssertionError("NW backtrack inconsistency")
    while i > 0:
        a = seq_a[i - 1]
        align_a.append(a)
        align_b.append("*")
        cons.append(a.lower())
        i -= 1
    while j > 0:
        b = seq_b[j - 1]
        align_a.append("*")
        align_b.append(b)
        cons.append(b.lower())
        j -= 1
    return matches, {
        "query_align": "".join(reversed(align_a)),
        "target_align": "".join(reversed(align_b)),
        "match_align": "".join(reversed(cons)),
    }


def align_multi(seqs: list[str]):
    """Progressive consensus (reference alignGlobal.h:57-69).

    Returns (matches, consensus_size, consensus).  Note the reference's
    min-from-zero match accumulation for >2 sequences is preserved.
    """
    if len(seqs) == 2:
        matches, aln = align_global(seqs[0], seqs[1])
        return matches, len(aln["match_align"]), aln["match_align"]
    alignment = seqs[0]
    matches = 0
    aln = None
    for j in range(len(seqs) - 1):
        m, aln = align_global(alignment, seqs[j + 1])
        matches = min(matches, m)
        alignment = aln["match_align"]
    return matches, len(alignment), alignment
