"""Konnector-style gap bridging over the Bloom-filter de Bruijn graph.

Reimplements the reference's connectPairs machinery
(reference: subprojects/sealer/Konnector/konnector.h:234-438,
DBGBloomAlgorithms.h:51-108, Graph/BidirectionalBFS.h:80-156,
Graph/ConstrainedBidiBFSVisitor.h):

 * anchor k-mer selection on each flank with the 3-consecutive-hits rule and
   longest-run fallback, scanning from the gap side (getStartKmerPos with
   FORWARD direction = right-to-left roll_back),
 * alternating two-frontier BFS between the left anchor and the
   reverse-complemented right anchor, expanding via 4-way Bloom membership
   probes, with the reference's constraint set: depth split
   ceil/floor((maxPathLen-1)/2), max active branches (queue size), max cost
   (edge examinations), max common edges (maxPaths), cycle-free by color
   maps,
 * path enumeration from the recorded traversal DAGs per common edge with
   the min/max path-length window, then unique-path merge or NW-MSA
   consensus (fill/nw.py) for multiple paths,
 * flank overlay + mismatch count (maskNew semantics).

Vertices are 2-bit PACKED k-mers (Python ints, ops/kmers — the reference's
packed Kmer, Common/Kmer.h:58-144) whenever the anchors are pure ACGT and
the graph is the host probing DBG: BFS state, color/depth maps and
traversal DAGs key on ints, children are O(1) shifts.
Anchors containing N/IUPAC/lowercase keep k-char string vertices (packing
would alias distinct vertices) — the search logic is vertex-type-agnostic,
so both representations share one implementation and produce identical
results (pinned by tests/test_packed_kmers.py).

Frozen copy of goldpolish_tpu_torch/fill/konnector.py, the host search
only: the native probes, DeviceDBG and the device-mask replay are left
out, so every probe runs the NumPy / Python-int path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import kmers as km
from . import nthash as nt

NO_MATCH = -1
NO_LIMIT = 0xFFFFFFFF

_COMP = str.maketrans("ACGTacgt", "TGCAtgca")

_ACGT_TAB = np.zeros(256, bool)
_ACGT_TAB[np.frombuffer(b"ACGT", np.uint8)] = True


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


class DBG:
    """Bloom-filter de Bruijn graph with batched probes."""

    def __init__(self, bf, k: int):
        self.bf = bf
        self.k = k
        self.h = bf.hash_num

    def _probe_many(self, kmers: list[str]) -> np.ndarray:
        if not kmers:
            return np.zeros(0, bool)
        arr = np.frombuffer("".join(kmers).encode(), np.uint8).reshape(
            len(kmers), self.k
        )
        from .siteeval import _batch_forward_np, _batch_reverse_np

        base = (
            _batch_forward_np(arr, self.k) + _batch_reverse_np(arr, self.k)
        )[..., 0]
        hashes = nt.multi_hashes(base, self.k, self.h)
        return self.bf.contains(hashes)

    def contains_kmer(self, kmer: str) -> bool:
        _, _, hv = nt.ntc64_base(np.frombuffer(kmer.encode(), np.uint8), self.k)
        return self.bf.contains_one(nt.multi_hashes(np.uint64(hv), self.k, self.h))

    def window_probes(self, seq: str) -> tuple[np.ndarray, np.ndarray]:
        """(present[], acgt_valid[]) for every k-window of seq.

        Consumers read present[] only at valid (all-ACGT) windows
        (get_start_kmer_pos, correct_single_base_error), where the native
        rolling hasher and the numpy batch hasher agree bit-for-bit
        (tests/test_nthash.py) — so the native path is decision-equivalent
        and ~50x cheaper on the short flanks the anchor search hashes
        (the numpy scalar-u64 fixed overhead dominated the noisy-case
        sealer profile, docs/ROUND5.md)."""
        codes = np.frombuffer(seq.encode(), np.uint8)
        n = len(codes)
        k = self.k
        if n < k:
            return np.zeros(0, bool), np.zeros(0, bool)
        base = nt.canonical_hashes(codes, k)
        present = self.bf.contains(nt.multi_hashes(base, k, self.h))
        is_acgt = _ACGT_TAB[codes]
        c = np.concatenate(([0], np.cumsum(~is_acgt)))
        valid = (c[k:] - c[:-k]) == 0
        return present, valid

    def _seed_state(self, kmer: str) -> tuple[int, int]:
        return nt.ntc64_base_i(kmer.encode(), 0, self.k)

    def successors(self, kmer: str) -> list[str]:
        # the 4 candidates share the (k-1)-prefix: seed one state, then
        # O(1) changelast rehashes instead of 4 from-scratch batch hashes
        prefix = kmer[1:]
        fh0, rh0 = self._seed_state(prefix + "A")
        k, h, bf = self.k, self.h, self.bf
        out = []
        for b in "ACGT":
            fh, rh = (
                (fh0, rh0) if b == "A"
                else nt.ntc64_changelast_i(fh0, rh0, k, ord("A"), ord(b))
            )
            if bf.contains_tuple(nt.multi_hashes_i(fh, rh, k, h)):
                out.append(prefix + b)
        return out

    def predecessors(self, kmer: str) -> list[str]:
        suffix = kmer[:-1]
        fh0, rh0 = self._seed_state("A" + suffix)
        k, h, bf = self.k, self.h, self.bf
        out = []
        for b in "ACGT":
            fh, rh = (
                (fh0, rh0) if b == "A"
                else nt.ntc64_changefirst_i(fh0, rh0, k, ord("A"), ord(b))
            )
            if bf.contains_tuple(nt.multi_hashes_i(fh, rh, k, h)):
                out.append(b + suffix)
        return out


class PackedDBG:
    """Int-vertex adjacency view over a probing DBG.

    Vertices are 2-bit packed k-mers (ops/kmers; reference
    Common/Kmer.h:58-144 packed Kmer role): successors/predecessors take
    and return Python ints, children are O(1) shift arithmetic, and the
    4-way probe goes through the string DBG (the port's native packed
    probe is left out).  Adjacency answers are identical to the string
    DBG's for pure-ACGT vertices (the only ones _prepare_search lets in
    here)."""

    def __init__(self, dbg: DBG):
        self.dbg = dbg
        self.k = dbg.k
        self.h = dbg.h
        self.kmask = (1 << (2 * self.k)) - 1
        self.top = 2 * (self.k - 1)

    def successors(self, v: int) -> list[int]:
        m = 0
        for c in self.dbg.successors(km.unpack_kmer(v, self.k)):
            m |= 1 << int(km.BASE_CODE[ord(c[-1])])
        base = (v << 2) & self.kmask
        return [base | b for b in range(4) if m >> b & 1]

    def predecessors(self, v: int) -> list[int]:
        m = 0
        for c in self.dbg.predecessors(km.unpack_kmer(v, self.k)):
            m |= 1 << int(km.BASE_CODE[ord(c[0])])
        base = v >> 2
        return [base | (b << self.top) for b in range(4) if m >> b & 1]


def _packed_view(dbg: DBG) -> PackedDBG:
    """One shared PackedDBG per DBG."""
    view = getattr(dbg, "_packed", None)
    if view is None:
        view = PackedDBG(dbg)
        dbg._packed = view
    return view


def get_start_kmer_pos(dbg: DBG, seq: str, num_matches_threshold: int = 3,
                       anchor_to_end: bool = False) -> int:
    """Anchor k-mer choice, FORWARD direction (right-to-left scan with
    skip-aware run counting) — reference DBGBloomAlgorithms.h:51-108.
    anchor_to_end (preserveReads): every k-mer from the end of the read up
    to the anchor must match — the scan stops at the first break."""
    k = dbg.k
    if len(seq) < k:
        return NO_MATCH
    present, valid = dbg.window_probes(seq)
    # emulate btllib NtHash roll_back from the last window: positions with
    # non-ACGT are skipped (position jumps break runs)
    positions = [p for p in range(len(present) - 1, -1, -1) if valid[p]]
    match_count = 0
    max_len = 0
    max_pos = 0
    prev_pos = len(present)  # start_pos - step with step=-1
    for p in positions:
        if (prev_pos - p > 1) or not present[p]:
            if match_count > max_len:
                max_pos = p + 1
                max_len = match_count
            if anchor_to_end:
                break
            match_count = 0
        else:
            match_count += 1
            if match_count >= num_matches_threshold:
                return p
        prev_pos = p
    else:
        if match_count > max_len:
            max_pos = prev_pos
            max_len = match_count
    return max_pos if max_len > 0 else NO_MATCH


def correct_single_base_error(dbg: DBG, read: str):
    """Fix the highest-scoring single-base substitution (reference
    DBGBloomAlgorithms.h:127-180, fixErrors path): for every position and
    alternative base, count graph k-mers of the +-(k-1) overlap window that
    would exist after the change; keep candidates scoring > 3 and apply the
    best (first max wins).  Returns (fixed, corrected_read, pos)."""
    k = dbg.k
    if len(read) < k:
        return False, read, -1
    min_score = 3
    best = None  # (score, pos, base) — strictly-greater comparisons
    for i in range(len(read)):
        lo = max(i - k + 1, 0)
        hi = min(i + k - 1, len(read) - 1)
        window = read[lo : hi + 1]
        change = i - lo
        for b in "AGCT":
            if read[i] == b:
                continue
            cand = window[:change] + b + window[change + 1 :]
            pres, valid = dbg.window_probes(cand)
            score = int((pres & valid).sum())
            if score > min_score and (best is None or score > best[0]):
                best = (score, i, b)
    if best is None:
        return False, read, -1
    _score, pos, b = best
    return True, read[:pos] + b + read[pos + 1 :], pos


@dataclass
class SearchResult:
    path_result: str = "NO_PATH"
    paths: list[list[str]] = field(default_factory=list)
    cost: int = 0
    num_nodes_visited: int = 0
    max_active_branches: int = 0
    found_start: bool = False
    found_goal: bool = False
    start_kmer_pos: int = NO_MATCH
    goal_kmer_pos: int = NO_MATCH
    merged_seqs: list[str] = field(default_factory=list)
    consensus: str = ""
    read_mismatches: int = 0
    path_mismatches: int = 0
    # fixErrors: the corrected read actually used for anchors/merging
    # (reference pRead1/pRead2, konnector.h:268-291); None = original
    read1: str | None = None
    read2: str | None = None


class _BidiSearch:
    """Alternating two-frontier constrained BFS (reference
    BidirectionalBFS.h + ConstrainedBidiBFSVisitor.h)."""

    FORWARD, REVERSE = 0, 1

    MEM_COUNTER_ROLLOVER = 1000  # reference ConstrainedBidiBFSVisitor.h:344

    def __init__(self, dbg, start, goal, max_paths: int,
                 min_path_len: int, max_path_len: int, max_branches: int,
                 max_cost: int, mem_limit: int = NO_LIMIT):
        # dbg is any adjacency provider (DBG / PackedDBG / MaskDBG /
        # DeviceDBG); start/goal are its vertex type (packed int or str) —
        # the search treats vertices opaquely, so both representations run
        # the exact same bookkeeping.
        self.dbg = dbg
        self.k = dbg.k
        self.start = start
        self.goal = goal
        self.max_paths = max_paths
        self.min_path_len = min_path_len
        self.max_path_len = max_path_len
        self.max_branches = max_branches
        self.max_cost = max_cost
        self.mem_limit = mem_limit
        max_depth = max_path_len - 1
        self.max_depth = [max_depth // 2 + max_depth % 2, max_depth // 2]
        self.depth = [dict(), dict()]
        self.color = [dict(), dict()]  # vertex -> 1 gray / 2 black
        self.trav = [dict(), dict()]  # traversal DAG: child -> set(parents-ward)
        self.common_edges: list[tuple[str, str]] = []
        self._common_set = set()
        self.cost = 0
        self.nodes_visited = 0
        self.peak_branches = 0
        self.too_many_paths = False
        self.too_many_branches = False
        self.max_cost_exceeded = False
        self.exceeded_mem_limit = False
        self._trav_edges = 0
        self._mem_counter = 0

    def approx_mem_usage(self) -> int:
        """Approximate visitor memory (bytes): the Python analogue of the
        reference's approxMemUsage (traversal HashGraphs + depth maps,
        ConstrainedBidiBFSVisitor.h:275-282, HashGraph.h:52-62).  Entry
        costs model CPython dict slots + the k-char vertex strings (the
        same formula for packed-int vertices: the abort point must not
        depend on the vertex representation)."""
        k = self.k
        per_vertex = 160 + k  # dict slot + key str + depth int
        per_edge = 60 + k     # adjacency-list slot + held vertex str
        n_vertices = len(self.depth[0]) + len(self.depth[1])
        return n_vertices * per_vertex + self._trav_edges * per_edge

    def _check_mem(self) -> bool:
        """True to continue; False aborts the search (EXCEEDED_MEM_LIMIT).
        Checked every MEM_COUNTER_ROLLOVER edge traversals, like the
        reference (checkMemLimit, ConstrainedBidiBFSVisitor.h:342-354)."""
        if self.mem_limit == NO_LIMIT:
            return True
        self._mem_counter += 1
        if self._mem_counter >= self.MEM_COUNTER_ROLLOVER:
            self._mem_counter = 0
            if self.approx_mem_usage() > self.mem_limit:
                self.exceeded_mem_limit = True
                return False
        return True

    def _record_traversal(self, dirn, u, v):
        # FORWARD records v -> u (edges pointing back toward start);
        # REVERSE records u -> v (toward goal)  [visitor:recordEdgeTraversal]
        if dirn == self.FORWARD:
            self.trav[self.FORWARD].setdefault(v, []).append(u)
        else:
            self.trav[self.REVERSE].setdefault(u, []).append(v)
        self._trav_edges += 1

    def _init_run(self):
        F, R = self.FORWARD, self.REVERSE
        import collections

        self.color[F][self.start] = 1
        self.color[R][self.goal] = 1
        # discover_vertex for the two seeds
        for _dirn in (F, R):
            self.nodes_visited += 1
            self.peak_branches = max(self.peak_branches, 2)
        self._q = [collections.deque([self.start]), collections.deque([self.goal])]
        self._dirn = F
        self._started = True

    def run_while_cached(self) -> bool:
        """Advance the search until it completes (True) or pops a vertex
        whose probes are not yet in the DBG cache (False — the vertex is
        pushed back; call again after prefetching).  The processing order
        is identical to run(): prefetch timing cannot change outcomes
        because graph membership is pure."""
        F, R = self.FORWARD, self.REVERSE
        if not getattr(self, "_started", False):
            self._init_run()
        q = self._q
        is_cached = getattr(self.dbg, "is_cached", None)
        while q[F] or q[R]:
            dirn = self._dirn
            Q = q[dirn]
            u = Q.popleft()
            if is_cached is not None and not self.dbg.is_cached(u, dirn == F):
                Q.appendleft(u)
                return False
            edges = (
                [(u, v) for v in self.dbg.successors(u)]
                if dirn == F
                else [(v, u) for v in self.dbg.predecessors(u)]
            )
            for (eu, ev) in edges:
                if not self._visit_edge(dirn, eu, ev, q):
                    return True
            self.color[dirn][u] = 2
            if dirn == R and q[F]:
                self._dirn = F
            elif dirn == F and q[R]:
                self._dirn = R
        return True

    def frontier(self) -> tuple[list[str], list[str]]:
        """(successor-wanting, predecessor-wanting) vertices currently
        queued — the prefetch set for the next lockstep round."""
        if not getattr(self, "_started", False):
            return [self.start], [self.goal]
        return list(self._q[self.FORWARD]), list(self._q[self.REVERSE])

    def run(self):
        F, R = self.FORWARD, self.REVERSE
        prefetch = getattr(self.dbg, "prefetch", None)
        while not self.run_while_cached():
            # batch the whole live frontier (both directions) into one
            # device call; membership is pure, so outcomes are identical
            succs, preds = self.frontier()
            prefetch(succs, preds)

    def _visit_edge(self, dirn, u, v, q) -> bool:
        """Returns False to abort the whole search."""
        if not self._check_mem():
            return False
        F, R = self.FORWARD, self.REVERSE
        child = v if dirn == F else u
        parent = u if dirn == F else v
        other = R if dirn == F else F
        if child in self.color[other]:
            # common edge (visitor.common_edge)
            if self.cost >= self.max_cost:
                self.max_cost_exceeded = True
                return False
            self.cost += 1
            if self.depth[dirn].get(parent, 0) >= self.max_depth[dirn]:
                return True  # SKIP_ELEMENT
            edge = (u, v)
            if edge not in self._common_set:
                self._common_set.add(edge)
                self.common_edges.append(edge)
                if self.max_paths != NO_LIMIT and len(self.common_edges) > self.max_paths:
                    self.too_many_paths = True
                    return False
                # record in both traversal graphs (visitor:recordCommonEdge)
                self._record_traversal(F, u, v)
                self._record_traversal(R, u, v)
            else:
                self._record_traversal(F, u, v)
                self._record_traversal(R, u, v)
            return True
        if child not in self.color[dirn]:
            # tree edge
            if self.cost >= self.max_cost:
                self.max_cost_exceeded = True
                return False
            self.cost += 1
            pd = self.depth[dirn].get(parent, 0)
            if pd == self.max_depth[dirn]:
                return True  # SKIP: do not expand deeper
            self.depth[dirn][child] = pd + 1
            self._record_traversal(dirn, u, v)
            # discover_vertex
            if self.max_branches != NO_LIMIT and len(q[dirn]) >= self.max_branches:
                self.too_many_branches = True
                return False
            self.nodes_visited += 1
            self.peak_branches = max(self.peak_branches, len(q[dirn]) + 1)
            self.color[dirn][child] = 1
            q[dirn].append(child)
            return True
        # non-tree edge
        if self.cost >= self.max_cost:
            self.max_cost_exceeded = True
            return False
        self.cost += 1
        self._record_traversal(dirn, u, v)
        return True

    # -- path enumeration (visitor:buildPaths) --------------------------------
    def _all_paths(self, graph, start, goal, max_paths, max_depth, max_cost):
        """All simple-ish paths start->goal in the recorded DAG (may contain
        cycles -> bounded by depth); returns (status, paths, cost).

        Backtracking DFS with an on-path SET for the cycle guard — O(1) per
        check instead of the naive `nxt in path` O(len) scan — while the
        stack discipline keeps the pop order (hence path order, costs, and
        every consumer downstream: consensus input order included) identical
        to the list-copy formulation it replaces."""
        paths = []
        cost = 0
        stack = [(start, 0)]
        path: list = []
        on_path: set = set()
        while stack:
            cost += 1
            if cost > max_cost:
                return "MAX_COST_EXCEEDED", [], cost
            node, depth = stack.pop()
            while len(path) > depth:  # backtrack to this branch point
                on_path.discard(path.pop())
            path.append(node)
            on_path.add(node)
            if node == goal:
                paths.append(list(path))
                if max_paths != NO_LIMIT and len(paths) > max_paths:
                    return "TOO_MANY_PATHS", [], cost
                continue
            if depth >= max_depth:
                continue
            for nxt in graph.get(node, []):
                if nxt in on_path:  # cycle guard
                    continue
                stack.append((nxt, depth + 1))
        if not paths:
            return "NO_PATH", [], cost
        return "FOUND_PATH", paths, cost

    def paths_to_goal(self):
        F, R = self.FORWARD, self.REVERSE
        if self.too_many_paths:
            return "TOO_MANY_PATHS", []
        if self.too_many_branches:
            return "TOO_MANY_BRANCHES", []
        if self.max_cost_exceeded:
            return "MAX_COST_EXCEEDED", []
        if self.exceeded_mem_limit:
            return "EXCEEDED_MEM_LIMIT", []
        found = []
        overall = "NO_PATH"
        for (u, v) in self.common_edges:
            if self.cost > self.max_cost:
                return "MAX_COST_EXCEEDED", []
            max_to_start = self.max_paths - len(found)
            st, left, c = self._all_paths(
                self.trav[F], u, self.start, max_to_start, self.max_depth[F],
                self.max_cost - self.cost,
            )
            self.cost += c
            if st == "FOUND_PATH":
                max_to_goal = (self.max_paths - len(found)) // len(left)
                st, right, c = self._all_paths(
                    self.trav[R], v, self.goal, max_to_goal, self.max_depth[R],
                    self.max_cost - self.cost,
                )
                self.cost += c
                if st == "FOUND_PATH":
                    added = False
                    for lp in left:
                        for rp in right:
                            total = len(lp) + len(rp)
                            if total < self.min_path_len or total > self.max_path_len:
                                continue
                            found.append(list(reversed(lp)) + rp)
                            added = True
                    st = "FOUND_PATH" if added else "NO_PATH"
            if st == "FOUND_PATH":
                overall = "FOUND_PATH"
            elif st != "NO_PATH":
                if st == "MAX_COST_EXCEEDED":
                    self.max_cost_exceeded = True
                elif st == "TOO_MANY_PATHS":
                    self.too_many_paths = True
                return st, []
        return overall, found


def path_to_seq(path: list, k: int) -> str:
    """Kmer path -> sequence (reference DBGBloomAlgorithms.h pathToSeq).
    Accepts either vertex representation (packed ints or strings)."""
    if isinstance(path[0], int):
        return km.unpack_kmer(path[0], k) + "".join(
            "ACGT"[v & 3] for v in path[1:]
        )
    return path[0] + "".join(kk[-1] for kk in path[1:])


def mask_new(read1: str, read2: str, merged: str) -> tuple[str, int]:
    """Flank overlay + mismatch count (reference DBGBloomAlgorithms.h:183-210,
    mask=0 path).  Returns (merged_with_flank_case, mismatches)."""
    r1 = read1
    r2 = revcomp(read2)
    m = list(merged)
    mismatches = 0
    for i, c in enumerate(r1):
        if i < len(m) and c == m[i]:
            m[i] = c.upper()
        else:
            mismatches += 1
    off = len(m) - len(r2)
    for i, c in enumerate(r2):
        if c == m[off + i]:
            m[off + i] = c.upper()
        else:
            mismatches += 1
    return "".join(m), mismatches


@dataclass
class ConnectPairsParams:
    """Reference konnector.h:139-175 defaults + sealer main overrides."""

    min_merged_seq_len: int = 0
    max_merged_seq_len: int = 1000
    max_paths: int = NO_LIMIT
    max_branches: int = NO_LIMIT
    max_cost: int = NO_LIMIT
    max_path_mismatches: int = NO_LIMIT
    max_read_mismatches: int = NO_LIMIT
    # searchMem: per-search visitor memory cap (reference sealer.cpp:203
    # default 500 MiB/thread, konnector params.memLimit at :955)
    mem_limit: int = NO_LIMIT
    # fixErrors: retry a failed anchor after correcting one base in the
    # read (reference konnector.h:273-291); kmer_matches_threshold is the
    # relaxed anchor threshold used on the corrected read (:146,277)
    fix_errors: bool = False
    kmer_matches_threshold: int = 1
    # preserveReads: keep the original read bytes in the merged sequence
    # (anchors must be end-anchored; overlapping reads fail, konnector.h:337-357)
    preserve_reads: bool = False


def _prepare_search(dbg: DBG, read1: str, read2: str,
                    params: ConnectPairsParams):
    """Anchor selection + search construction (the front half of
    connect_pairs).  Returns (res, search) — search is None when the result
    is already decided (short reads, missing anchor, identical anchors)."""
    k = dbg.k
    res = SearchResult()
    if len(read1) < k or len(read2) < k:
        return res, None
    start_pos = get_start_kmer_pos(dbg, read1, 3, params.preserve_reads)
    goal_pos = get_start_kmer_pos(dbg, read2, 3, params.preserve_reads)
    if start_pos == NO_MATCH and params.fix_errors:
        ok, fixed, _ = correct_single_base_error(dbg, read1)
        if ok:
            read1 = fixed
            res.read1 = read1
            start_pos = get_start_kmer_pos(
                dbg, read1, params.kmer_matches_threshold
            )
    if goal_pos == NO_MATCH and params.fix_errors:
        ok, fixed, _ = correct_single_base_error(dbg, read2)
        if ok:
            read2 = fixed
            res.read2 = read2
            goal_pos = get_start_kmer_pos(
                dbg, read2, params.kmer_matches_threshold
            )
    if start_pos == NO_MATCH or goal_pos == NO_MATCH:
        return res, None
    res.found_start = res.found_goal = True
    res.start_kmer_pos = start_pos
    res.goal_kmer_pos = goal_pos
    start_kmer = read1[start_pos : start_pos + k]
    goal_kmer = revcomp(read2[goal_pos : goal_pos + k])

    max_path_len = params.max_merged_seq_len - k + 1 - start_pos - goal_pos
    min_path_len = max(0, params.min_merged_seq_len - k + 1 - start_pos - goal_pos)
    min_path_len = max(
        min_path_len,
        len(read1) - k + 1 - start_pos,
        len(read2) - k + 1 - goal_pos,
    )
    # special case: identical start/goal kmer is an immediate single-node path
    if start_kmer == goal_kmer:
        res.path_result = "FOUND_PATH"
        return res, None
    # packed-int vertices whenever the representation is a bijection and
    # the graph is the plain probing DBG (DeviceDBG keeps its string
    # lockstep protocol); dirty anchors (N/IUPAC) keep string vertices
    graph: object = dbg
    start_v: object = start_kmer
    goal_v: object = goal_kmer
    if (type(dbg) is DBG and km.is_packable(start_kmer)
            and km.is_packable(goal_kmer)):
        graph = _packed_view(dbg)
        start_v = km.pack_kmer(start_kmer)
        goal_v = km.pack_kmer(goal_kmer)
    search = _BidiSearch(
        graph, start_v, goal_v, params.max_paths, min_path_len,
        max_path_len, params.max_branches, params.max_cost,
        mem_limit=params.mem_limit,
    )
    search.start_str = start_kmer
    search.goal_str = goal_kmer
    search.packed = graph is not dbg
    return res, search


def _finish_search(dbg: DBG, res: SearchResult, search, read1: str,
                   read2: str,
                   params: "ConnectPairsParams | None" = None) -> SearchResult:
    """Path enumeration + consensus (the back half of connect_pairs).
    `search` is a completed _BidiSearch, or None for the decided cases.
    mask_new always compares against the ORIGINAL reads; anchors/merging use
    the (possibly fixErrors-corrected) res.read1/read2."""
    from . import nw

    k = dbg.k
    r1 = res.read1 if res.read1 is not None else read1
    r2 = res.read2 if res.read2 is not None else read2
    if search is not None:
        res.cost = search.cost
        res.num_nodes_visited = search.nodes_visited
        res.max_active_branches = search.peak_branches
        res.path_result, paths = search.paths_to_goal()
    elif res.path_result == "FOUND_PATH":
        paths = [[r1[res.start_kmer_pos : res.start_kmer_pos + k]]]
    if res.path_result != "FOUND_PATH":
        return res

    connecting = [path_to_seq(p, k) for p in paths]
    if params is not None and params.preserve_reads:
        # keep the original read bytes verbatim: the connecting path must
        # extend past both reads, else the merge cannot preserve them
        # (reference konnector.h:337-357)
        seq_prefix = r1
        seq_suffix = revcomp(r2)
        trim_left = len(r1) - res.start_kmer_pos
        trim_right = len(r2) - res.goal_kmer_pos
        trimmed = []
        for c in connecting:
            if trim_left + trim_right > len(c):
                res.path_result = "NO_PATH"
                return res
            trimmed.append(c[trim_left : len(c) - trim_right])
        connecting = trimmed
    else:
        seq_prefix = r1[: res.start_kmer_pos]
        seq_suffix = revcomp(r2[: res.goal_kmer_pos])
    if len(connecting) == 1:
        merged = seq_prefix + connecting[0] + seq_suffix
        merged, res.read_mismatches = mask_new(read1, read2, merged)
        res.merged_seqs = [merged]
        res.consensus = merged
    else:
        matches, size, cons = nw.align_multi(connecting)
        res.path_mismatches = size - matches
        merged = seq_prefix + cons + seq_suffix
        merged, res.read_mismatches = mask_new(read1, read2, merged)
        res.consensus = merged
        res.merged_seqs = [seq_prefix + c + seq_suffix for c in connecting]
    return res


def connect_pairs(dbg: DBG, read1: str, read2: str, params: ConnectPairsParams) -> SearchResult:
    """reference konnector.h:234-438 (fixErrors/preserveReads both false in
    the sealer pipeline)."""
    res, search = _prepare_search(dbg, read1, read2, params)
    if search is not None:
        search.run()
    return _finish_search(dbg, res, search, read1, read2, params)


def connect_pairs_batch(dbg: DBG, pairs: list[tuple[str, str]],
                        params: ConnectPairsParams) -> list[SearchResult]:
    """connect_pairs over many gaps with LOCKSTEP searches: every active
    search advances until it needs uncached probes, then one DeviceDBG
    prefetch covers the union of all frontiers — the cross-gap batching
    SURVEY §7.5 prescribes.  Each search's processing order is untouched,
    so per-gap results are identical to serial connect_pairs (pinned by
    tests).  With a host DBG every search completes on its first
    run_while_cached call and this degenerates to the serial loop."""
    prepared = [_prepare_search(dbg, r1, r2, params) for r1, r2 in pairs]
    active = [(i, s) for i, (_res, s) in enumerate(prepared) if s is not None]
    prefetch = getattr(dbg, "prefetch", None)
    while active:
        if prefetch is not None:
            want_s: list[str] = []
            want_p: list[str] = []
            for _i, s in active:
                fs, fp = s.frontier()
                want_s += fs
                want_p += fp
            prefetch(want_s, want_p)
        active = [(i, s) for i, s in active if not s.run_while_cached()]
    return [
        _finish_search(dbg, res, s, pairs[i][0], pairs[i][1], params)
        for i, (res, s) in enumerate(prepared)
    ]
