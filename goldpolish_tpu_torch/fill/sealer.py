"""Sealer — de Bruijn graph gap filling over soft-masked regions.

Reimplements the reference's sealer-gr flow (reference:
subprojects/sealer/sealer.cpp) as used by the pipeline
(reference: scripts/goldpolish-make:68-72 — flags
`-L<first k> -P10 -B1000 --lower -k... --input-bloom=...`):

 * gap detection: runs of "Nnatcgurykmswbdhvx" with --lower, else "Nn"
   (reference sealer.cpp:701); trailing gap runs are skipped with a warning,
 * flank pseudo-read pairs: left flank uppercased, right flank uppercased +
   reverse-complemented, bounded by neighboring gaps and the flank length
   (reference :560-577, 695-733),
 * per-k (descending) Konnector bridge attempt per gap; gaps closed at a
   larger k are retired from the work set (reference kRun :580-685 —
   including the quirk that *all* gaps sharing one left-flank key retire
   together once any of them closes),
 * outcome counters per k (noStartOrGoalKmer/noPath/uniquePath/... ,
   reference :229-245),
 * final splice: per scaffold, closed gaps replace [left.start,
   right.end) right-to-left (reference insertIntoScaffold :525-558).

Byte-format quirk preserved: the reference always writes
">id<space>comment" even when the comment is empty.

Port counterpart: goldpolish_tpu/fill/sealer.py, copied with two changes
in seal_records: `device` picks where the device arms run, the hybrid
arm's DeviceBFS and the jax arm's DeviceDBG ("cuda", or "cpu" for the
plain torch versions in tests), and `tally` counts the searches and those
the native round took (the `seal` span's attributes).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.log import get_logger
from .konnector import (
    DBG, ConnectPairsParams, DeviceDBG, NO_LIMIT, connect_pairs_batch, revcomp,
)

log = get_logger("sealer")

GAP_CHARS_LOWER = "Nnatcgurykmswbdhvx"
GAP_CHARS_PLAIN = "Nn"

COUNTER_NAMES = [
    "noStartOrGoalKmer", "noPath", "uniquePath", "multiplePaths",
    "tooManyPaths", "tooManyBranches", "tooManyMismatches",
    "tooManyReadMismatches", "containsCycle", "maxCostExceeded",
    "exceededMemLimit",
    # Konnector-heritage fields: the reference declares and zeroes these
    # per k (sealer.cpp:241-243, :603-605) but its sealer flow never
    # increments or prints them — its merge() path maps memory exhaustion
    # to exceededMemLimit (:503) and has no read-pair stage.  They are
    # carried here (always 0) for struct-level counter parity.
    "traversalMemExceeded", "readPairsProcessed", "readPairsMerged",
    "skipped",
]


@dataclass(frozen=True)
class Gap:
    left_start: int
    left_end: int  # == gap start
    right_start: int  # == gap end (exclusive of gap chars)
    right_end: int

    @property
    def gap_start(self) -> int:
        return self.left_end

    @property
    def gap_size(self) -> int:
        return self.right_start - self.left_end

    @property
    def total_size(self) -> int:
        return self.right_end - self.left_start


@dataclass
class SealerConfig:
    """reference sealer.cpp:132-225 defaults + pipeline flags."""

    k_values: list[int] = field(default_factory=lambda: [32, 28, 24, 20])
    flank_length: int = 32  # -L = first k (goldpolish-make:70)
    max_gap_length: int = 800  # -G
    max_paths: int = 10  # -P (pipeline) — default 2 in sealer itself
    max_branches: int = 1000  # -B (pipeline)
    max_cost: int = 100000  # -C default
    search_mem: int = 500 * 1024 * 1024  # --mem per search (sealer.cpp:203)
    lower: bool = True  # --lower
    max_mismatches: int = NO_LIMIT
    verbose: bool = False


def find_flanks(record_id: str, seq: str, cfg: SealerConfig):
    """Locate gaps + flanks (reference sealer.cpp:695-733).

    Returns list of (left_flank_seq, right_flank_rc_seq, Gap).
    """
    import re

    chars = GAP_CHARS_LOWER if cfg.lower else GAP_CHARS_PLAIN
    out = []
    n = len(seq)
    # one regex pass over gap-char runs replaces the per-character generator
    # scans (O(n * gaps) -> O(n)); the runs are exactly the (start, end)
    # pairs the scalar loop found, and right_end is simply the next run's
    # start (or n) — semantics identical to the reference's findFlanks
    runs = [
        (m.start(), m.end())
        for m in re.finditer(f"[{re.escape(chars)}]+", seq)
    ]
    if runs and runs[-1][1] == n:
        log.warning("sequence ends with a gap: %s", record_id)
        runs.pop()
    offset = 0
    for gi, (start, end) in enumerate(runs):
        right_end = runs[gi + 1][0] if gi + 1 < len(runs) else n
        gap = Gap(
            max(offset, start - cfg.flank_length),
            start,
            end,
            min(right_end, end + cfg.flank_length),
        )
        left = seq[gap.left_start : gap.left_end].upper()
        right = revcomp(seq[gap.right_start : gap.right_end].upper())
        out.append((left, right, gap))
        offset = end
    return out


def _classify(res) -> str:
    if res.path_result == "NO_PATH":
        return "noPath" if (res.found_start and res.found_goal) else "noStartOrGoalKmer"
    if res.path_result == "FOUND_PATH":
        return "multiplePaths" if len(res.merged_seqs) > 1 else "uniquePath"
    return {
        "TOO_MANY_PATHS": "tooManyPaths",
        "TOO_MANY_BRANCHES": "tooManyBranches",
        "PATH_CONTAINS_CYCLE": "containsCycle",
        "MAX_COST_EXCEEDED": "maxCostExceeded",
        "EXCEEDED_MEM_LIMIT": "exceededMemLimit",
    }.get(res.path_result, "skipped")


def seal_records(records, bfs_by_k: dict[int, object], cfg: SealerConfig,
                 trace_out: list | None = None, backend: str = "numpy",
                 device: str = "cuda", tally: dict | None = None):
    """Gap-fill a batch of (header, seq) records.

    bfs_by_k: {k: host BloomFilter}.  Returns (records_out, stats) where
    stats = {k: {counter: n}, "gaps_found": n, "gaps_closed": n}.

    backend="hybrid" computes every gap's extension masks with the
    whole-search BFS kernel (ops/dbg_bfs.DeviceBFS on `device`) and replays
    the host search against them.  backend="jax" runs every gap's search
    in lockstep on a DeviceDBG (on `device`): one extension probe per round
    covers all the searches' frontiers and the unbranched chains from them
    (up to ops/dbg_extend.CHAIN_STEPS levels).  Outcomes of both are
    identical to the host DBG (membership is a pure function of the Bloom
    filter).

    tally, if given, gets "searches" (the pairs of every k round's work
    list) and "native" (those the native round took, konnector
    _native_round: the host DBG at k <= 32).
    """
    # collect flanks across all records, keyed like the reference's
    # map<FastaRecord(left), map<FastaRecord(right), Gap>> — outer key is
    # (record_id + "/1", left_seq), sorted iteration
    flanks: dict[tuple[str, str], dict[tuple[str, str], Gap]] = {}
    headers = {}
    gaps_found = 0
    for header, seq in records:
        rid = header.split()[0] if header.split() else header
        headers[rid] = header
        for left, right, gap in find_flanks(rid, seq, cfg):
            gaps_found += 1
            flanks.setdefault((rid + "/1", left), {})[(rid + "/2", right)] = gap

    all_merged: dict[str, dict[int, tuple[Gap, str]]] = {}
    stats = {"gaps_found": gaps_found, "gaps_closed": 0}
    counts = {"searches": 0, "native": 0}
    for k in cfg.k_values:
        bf = bfs_by_k[k]
        device_bfs = None
        if backend == "hybrid" and k <= 32:
            # whole-search device BFS (ops/dbg_bfs): ONE dispatch per gap
            # batch computes every level's probes; the host replays the
            # exact search bookkeeping from the returned masks.  This is
            # the per-level-round-trip-free redesign of DeviceDBG.
            from ..ops.dbg_bfs import DeviceBFS

            dbg = DBG(bf, k)
            device_bfs = DeviceBFS(bf, k, device=device)
        elif backend == "jax":
            dbg = DeviceDBG(bf, k, device=device)
        else:
            dbg = DBG(bf, k)
        params = ConnectPairsParams(
            max_merged_seq_len=cfg.max_gap_length + 2 * cfg.flank_length,
            max_paths=cfg.max_paths,
            max_branches=cfg.max_branches,
            max_cost=cfg.max_cost,
            max_path_mismatches=cfg.max_mismatches,
            mem_limit=cfg.search_mem,
        )
        counters = {c: 0 for c in COUNTER_NAMES}
        closed_keys = []
        # collect the k-round's work list in the reference's sorted order,
        # run all searches in lockstep (cross-gap device batching with
        # DeviceDBG; degenerates to the serial loop on the host DBG), then
        # consume the per-gap results in the same order
        work = [
            (key1, key2)
            for key1 in sorted(flanks)
            for key2 in sorted(flanks[key1])
        ]
        counts["searches"] += len(work)
        if device_bfs is not None:
            from .konnector import connect_pairs_batch_masks

            results = connect_pairs_batch_masks(
                dbg, [(k1[1], k2[1]) for k1, k2 in work], params, device_bfs
            )
        else:
            results = connect_pairs_batch(
                dbg, [(k1[1], k2[1]) for k1, k2 in work], params, tally=counts
            )
        res_by_keys = {keys: r for keys, r in zip(work, results)}
        for key1 in sorted(flanks):
            read1_id, read1_seq = key1
            success = False
            for key2 in sorted(flanks[key1]):
                read2_id, read2_seq = key2
                gap = flanks[key1][key2]
                res = res_by_keys[(key1, key2)]
                counters[_classify(res)] += 1
                if trace_out is not None:
                    trace_out.append({
                        "k": k,
                        "read_id": f"{read1_id[:-2]}_{gap.gap_start}_{gap.gap_size}",
                        "search_result": res.path_result,
                        "search_cost": res.cost,
                        "num_paths": len(res.merged_seqs),
                        "path_lengths": ",".join(
                            str(len(m)) for m in res.merged_seqs) or "NA",
                        "start_kmer_pos": res.start_kmer_pos,
                        "end_kmer_pos": res.goal_kmer_pos,
                        "nodes_visited": res.num_nodes_visited,
                        "max_breadth": res.max_active_branches,
                    })
                merged = ""
                if res.path_result == "FOUND_PATH":
                    if res.path_mismatches > params.max_path_mismatches:
                        counters["tooManyMismatches"] += 1
                    else:
                        merged = (
                            res.consensus
                            if len(res.merged_seqs) > 1
                            else res.merged_seqs[0]
                        )
                if merged:
                    success = True
                    rid = read1_id[:-2]
                    all_merged.setdefault(rid, {})[gap.gap_start] = (gap, merged)
                    stats["gaps_closed"] += 1
            if success:
                closed_keys.append(key1)
        for key in closed_keys:
            flanks.pop(key, None)
        stats[k] = counters
        if cfg.verbose:
            log.info("k=%d: %s; %d flanks left", k, counters, len(flanks))
    if tally is not None:
        tally.update(counts)

    # splice (reference insertIntoScaffold :525-558)
    out = []
    for header, seq in records:
        rid = header.split()[0] if header.split() else header
        comment = header[len(rid) + 1 :] if " " in header else ""
        if rid in all_merged:
            positions = sorted(all_merged[rid])
            spans = [
                (g.left_start, g.left_start + g.total_size)
                for g in (all_merged[rid][p][0] for p in positions)
            ]
            if all(spans[i][1] <= spans[i + 1][0] for i in range(len(spans) - 1)):
                # disjoint replacement spans: the right-to-left splice is
                # equivalent to one segment join — O(n) instead of
                # O(n * gaps) string copying
                parts = []
                prev = 0
                for p, (a, b) in zip(positions, spans):
                    parts.append(seq[prev:a])
                    parts.append(all_merged[rid][p][1])
                    prev = b
                parts.append(seq[prev:])
                s = "".join(parts)
            else:
                # overlapping flank spans (gaps < 2*flank apart): keep the
                # reference's exact right-to-left splice semantics
                s = seq
                for pos in reversed(positions):
                    gap, merged = all_merged[rid][pos]
                    s = (
                        s[: gap.left_start] + merged
                        + s[gap.left_start + gap.total_size :]
                    )
            out.append((f"{rid} {comment}", s))
        else:
            out.append((f"{rid} {comment}", seq))
    return out, stats
