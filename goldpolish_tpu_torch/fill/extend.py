"""Greedy de Bruijn graph sequence extension (Konnector companion API).

The reference ships extendSeq / extendSeqThroughBubble / trimRead in
konnector.h (reference: subprojects/sealer/Konnector/konnector.h:452-906,
Graph/ExtendPath.h) — not used by the sealer binary itself but part of the
Konnector library surface consumed by other GoldRush tools.  Re-provided
here with the same semantics:

 * trueBranches — a neighbor counts as a real branch only if it extends
   fpTrim(=5) further steps in the graph; shorter dead-ends are Bloom-filter
   false-positive spurs and are trimmed (reference ExtendPath.h:275-305),
 * extend_seq — greedy walk from the sequence end: single true branch ->
   extend; none -> DEAD_END; >=2 -> attempt simple-bubble resolution
   (two branches, both paths length k+2, reconverging head -> NW consensus
   of the two branch sequences), else BRANCHING_POINT; visited-set cycle
   guard; max-length cap (reference konnector.h:452-700),
 * trim_read — keep the longest run of consecutive graph k-mers
   (reference konnector.h trimRead).

Port counterpart: goldpolish_tpu/fill/extend.py, copied unchanged.
"""

from __future__ import annotations

from enum import Enum

from .konnector import DBG
from .nw import align_global

FP_TRIM = 5


class ExtendResult(Enum):
    DEAD_END = "DEAD_END"
    BRANCHING_POINT = "BRANCHING_POINT"
    CYCLE = "CYCLE"
    LENGTH_LIMIT = "LENGTH_LIMIT"
    EXTENDED = "EXTENDED"


def _has_depth(dbg: DBG, kmer: str, forward: bool, depth: int) -> bool:
    """True if `kmer` extends at least `depth` further steps."""
    if depth == 0:
        return True
    frontier = [kmer]
    for _ in range(depth):
        nxt = []
        for km in frontier:
            nxt.extend(
                dbg.successors(km) if forward else dbg.predecessors(km)
            )
            if nxt:
                break  # any survivor is enough for this level
        if not nxt:
            return False
        frontier = nxt[:4]
    return True


def true_branches(dbg: DBG, kmer: str, forward: bool, fp_trim: int = FP_TRIM):
    """Neighbors with a >= fp_trim-deep extension (ExtendPath.h:275-305)."""
    neigh = dbg.successors(kmer) if forward else dbg.predecessors(kmer)
    return [v for v in neigh if _has_depth(dbg, v, forward, fp_trim)]


def _resolve_bubble(dbg: DBG, buds: list[str], forward: bool, k: int):
    """Simple two-branch bubble: both paths of length k+1 from the buds must
    reconverge (reference extendSeqThroughBubble, konnector.h:452-560).
    Returns the consensus branch sequence (without the head kmer) or None.
    """
    if len(buds) != 2:
        return None
    paths = []
    for bud in buds:
        path = [bud]
        for _ in range(k):
            nxt = true_branches(dbg, path[-1], forward, FP_TRIM)
            if len(nxt) != 1:
                return None
            path.append(nxt[0])
        paths.append(path)
    if paths[0][-1] != paths[1][-1]:
        return None
    def pseq(p):
        if forward:
            return p[0] + "".join(km[-1] for km in p[1:])
        return "".join(km[0] for km in p[:-1]) + p[-1]
    _, aln = align_global(pseq(paths[0]), pseq(paths[1]))
    return aln["match_align"].upper()


def extend_seq(dbg: DBG, seq: str, forward: bool = True, max_len: int = 0,
               fp_trim: int = FP_TRIM, pop_bubbles: bool = True):
    """Greedily extend `seq` in the given direction.

    Returns (extended_seq, stop_reason, extended_any).  max_len == 0 = no cap.
    """
    k = dbg.k
    if len(seq) < k:
        return seq, ExtendResult.DEAD_END, False
    visited: set[str] = set()
    result = ExtendResult.DEAD_END
    extended = False
    while True:
        head = seq[-k:] if forward else seq[:k]
        if head in visited:
            result = ExtendResult.CYCLE
            break
        visited.add(head)
        if max_len and len(seq) >= max_len:
            result = ExtendResult.LENGTH_LIMIT
            break
        branches = true_branches(dbg, head, forward, fp_trim)
        if not branches:
            result = ExtendResult.DEAD_END
            break
        if len(branches) > 1:
            cons = _resolve_bubble(dbg, branches, forward, k) if pop_bubbles else None
            if cons is None:
                result = ExtendResult.BRANCHING_POINT
                break
            add = cons[k - 1 :] if forward else cons[: len(cons) - k + 1]
            seq = seq + add if forward else add + seq
            extended = True
            continue
        nxt = branches[0]
        seq = seq + nxt[-1] if forward else nxt[0] + seq
        extended = True
    return seq, result, extended


def trim_read(dbg: DBG, seq: str) -> str:
    """Trim to the longest stretch of consecutive graph k-mers
    (reference konnector.h trimRead)."""
    k = dbg.k
    if len(seq) < k:
        return ""
    present, valid = dbg.window_probes(seq)
    ok = present & valid
    best_len = 0
    best_start = 0
    run = 0
    for i, v in enumerate(ok):
        run = run + 1 if v else 0
        if run > best_len:
            best_len = run
            best_start = i - run + 1
    if best_len == 0:
        return ""
    return seq[best_start : best_start + best_len + k - 1]
