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

On the plain DBG at k <= 32 (fix_errors off) a round's anchor choice,
searches and path enumeration run in one native call outside the
interpreter lock (_native_round, native/gp_native.cpp gp_konnect_pairs),
a C port of get_start_kmer_pos, _prepare_search, _BidiSearch and
paths_to_goal on packed vertices, step for step; the merge stays here.
The Python search is its plain version and takes every other case.

Vertices are 2-bit PACKED k-mers (Python ints, ops/kmers — the reference's
packed Kmer, Common/Kmer.h:58-144) whenever the anchors are pure ACGT and
the graph is the host probing DBG or the device-mask replay: BFS state,
color/depth maps and traversal DAGs key on ints, children are O(1) shifts,
and the native 4-way probe takes the packed word directly (gp_extend4p).
Anchors containing N/IUPAC/lowercase keep k-char string vertices (packing
would alias distinct vertices) — the search logic is vertex-type-agnostic,
so both representations share one implementation and produce identical
results (pinned by tests/test_packed_kmers.py).

Port counterpart: goldpolish_tpu/fill/konnector.py, copied with one
change: DeviceDBG (:233-315, K8) probes a lockstep round's frontier with
the chain-walking extension probe of ops/dbg_extend.py (kernel 7 on CUDA,
its plain torch version on the CPU) on `device`, without the JAX call's
shape bucket and host-built [rows, 4, k] extension rows, and caches every
vertex of each unbranched chain it walked; and the native round above,
which the JAX package lacks.  The lockstep hooks it drives
(_BidiSearch.run_while_cached / frontier / prefetch, connect_pairs_batch)
are the JAX package's; on the probing DBG they reduce to the serial loop.
The other device arm is connect_pairs_batch_masks with
ops/dbg_bfs.DeviceBFS.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops import nthash as nt
from ..ops import kmers as km

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
        self._ext4 = None
        try:
            from .. import native

            native.extend4(b"A" * k, self.h, bf, True)  # configure + warm
            # bind the raw symbol + a prepared filter pointer once: the
            # per-call ctypes cast would otherwise cost ~half of gp_extend4
            self._ext4_fn = native.lib().gp_extend4
            self._ext4_bf = native._u8ptr(bf.array)
            self._ext4 = True
        except Exception:  # noqa: BLE001 — pure-Python fallback below
            pass

    def _probe_many(self, kmers: list[str]) -> np.ndarray:
        if not kmers:
            return np.zeros(0, bool)
        arr = np.frombuffer("".join(kmers).encode(), np.uint8).reshape(
            len(kmers), self.k
        )
        from ..ops.siteeval import _batch_forward_np, _batch_reverse_np

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
        try:
            from .. import native

            present = native.bf_contains(
                self.bf, native.nthash_all(codes, k, self.h)
            )
        except Exception:  # noqa: BLE001 — no native lib: numpy path
            base = nt.canonical_hashes(codes, k)
            present = self.bf.contains(nt.multi_hashes(base, k, self.h))
        is_acgt = _ACGT_TAB[codes]
        c = np.concatenate(([0], np.cumsum(~is_acgt)))
        valid = (c[k:] - c[:-k]) == 0
        return present, valid

    def _seed_state(self, kmer: str) -> tuple[int, int]:
        try:
            from .. import native

            return native.seed_window(kmer.encode(), 0, self.k)
        except Exception:  # noqa: BLE001
            return nt.ntc64_base_i(kmer.encode(), 0, self.k)

    def successors(self, kmer: str) -> list[str]:
        if self._ext4 is not None:
            mask = self._ext4_fn(
                kmer.encode(), self.k, self.h, self._ext4_bf, self.bf.bytes, 1
            )
            prefix = kmer[1:]
            return [prefix + b for i, b in enumerate("ACGT") if mask >> i & 1]
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
        if self._ext4 is not None:
            mask = self._ext4_fn(
                kmer.encode(), self.k, self.h, self._ext4_bf, self.bf.bytes, 0
            )
            suffix = kmer[:-1]
            return [b + suffix for i, b in enumerate("ACGT") if mask >> i & 1]
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
    4-way Bloom probe is one native call on the packed word
    (gp_extend4p) — no string allocation anywhere in the BFS inner loop.
    Adjacency answers are identical to the string DBG's for pure-ACGT
    vertices (the only ones _prepare_search lets in here)."""

    def __init__(self, dbg: DBG):
        self.dbg = dbg
        self.k = dbg.k
        self.h = dbg.h
        self.kmask = (1 << (2 * self.k)) - 1
        self.top = 2 * (self.k - 1)
        self._fn = None
        if dbg._ext4 is not None and self.k <= 32:
            try:
                from .. import native

                self._fn = native.bind_extend4p()
                self._bf = dbg._ext4_bf
                self._bytes = dbg.bf.bytes
            except Exception:  # noqa: BLE001 — string fallback below
                self._fn = None

    def successors(self, v: int) -> list[int]:
        m = -1
        if self._fn is not None:
            m = self._fn(v, self.k, self.h, self._bf, self._bytes, 1)
        if m < 0:  # no binding, or native param-range sentinel (k<2, h>16)
            m = 0
            for c in self.dbg.successors(km.unpack_kmer(v, self.k)):
                m |= 1 << int(km.BASE_CODE[ord(c[-1])])
        base = (v << 2) & self.kmask
        return [base | b for b in range(4) if m >> b & 1]

    def predecessors(self, v: int) -> list[int]:
        m = -1
        if self._fn is not None:
            m = self._fn(v, self.k, self.h, self._bf, self._bytes, 0)
        if m < 0:  # no binding, or native param-range sentinel (k<2, h>16)
            m = 0
            for c in self.dbg.predecessors(km.unpack_kmer(v, self.k)):
                m |= 1 << int(km.BASE_CODE[ord(c[0])])
        base = v >> 2
        return [base | (b << self.top) for b in range(4) if m >> b & 1]


def _packed_view(dbg: DBG) -> PackedDBG:
    """One shared PackedDBG per DBG (binds the native symbol once)."""
    view = getattr(dbg, "_packed", None)
    if view is None:
        view = PackedDBG(dbg)
        dbg._packed = view
    return view


_BASE_OF_MASK = {1: "A", 2: "C", 4: "G", 8: "T"}


def _cache_chain(cache: dict, v: str, row: list, succ: bool) -> None:
    """Cache the masks of one chain (dbg_extend.dbg_extend_chain's row:
    masks, then the chain's length) from vertex v, stepping through each
    mask's one base; an entry already there stays."""
    n = row[-1]
    for j in range(n):
        cache.setdefault(v, row[j])
        if j + 1 < n:
            b = _BASE_OF_MASK[row[j]]
            v = v[1:] + b if succ else b + v[:-1]


class DeviceDBG(DBG):
    """DBG whose 4-way extension probes run batched on `device`.

    The BFS bookkeeping (queue discipline, cost/branch limits, traversal
    recording) stays on host and is byte-identical to the host DBG path —
    graph membership is a pure function of the Bloom filter, so moving the
    probes to the device cannot change any outcome.  _BidiSearch hands the
    whole live frontier (both directions) to `prefetch` whenever it pops a
    vertex whose probes are not cached, so one device call (ops/dbg_extend:
    the extensions' hash and Bloom test) covers a whole BFS level, and, on
    every unbranched path from it, up to dbg_extend.CHAIN_STEPS levels
    more; children off those chains batch into the next call.  Vertices
    stay k-char strings (_prepare_search packs only for the plain DBG).

    device "cuda" (the default) raises without CUDA, never a CPU fallback;
    "cpu" runs the probe's plain torch version, for tests.  Each call's
    upload, launch and copy back run on the current stream of the calling
    thread, so batches may seal on several threads, each with its own
    DeviceDBG per k.
    """

    def __init__(self, bf, k: int, device: str = "cuda"):
        super().__init__(bf, k)
        import torch

        from ..ops import bloom_device

        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"DeviceDBG runs on device {device!r}, and CUDA is not available")
        self.device = device
        self._words = bloom_device.to_device_words(bf, device)
        self._succ_cache: dict[str, int] = {}
        self._pred_cache: dict[str, int] = {}

    def is_cached(self, kmer: str, want_succ: bool) -> bool:
        cache = self._succ_cache if want_succ else self._pred_cache
        return kmer in cache

    def prefetch(self, succ_vertices, pred_vertices) -> None:
        """Probe the 4 extensions of every uncached vertex, and walk the
        unbranched chain from each for up to dbg_extend.CHAIN_STEPS levels,
        in one device call (one upload, one launch, one copy back); fill
        the caches with the 4-bit mask of every vertex on each chain,
        leaving entries already there as they are."""
        from ..ops import dbg_extend

        succs = [v for v in dict.fromkeys(succ_vertices) if v not in self._succ_cache]
        preds = [v for v in dict.fromkeys(pred_vertices) if v not in self._pred_cache]
        rows = len(succs) + len(preds)
        if rows == 0:
            return
        verts = np.frombuffer("".join(succs + preds).encode(), np.uint8).reshape(
            rows, self.k)
        out = dbg_extend.probe_chains(self._words, int(self.bf.bits), self.h, self.k,
                                      verts, len(succs)).tolist()
        for v, row in zip(succs, out):
            _cache_chain(self._succ_cache, v, row, True)
        for v, row in zip(preds, out[len(succs):]):
            _cache_chain(self._pred_cache, v, row, False)

    def successors(self, kmer: str) -> list[str]:
        m = self._succ_cache.get(kmer)
        if m is None:
            self.prefetch([kmer], [])
            m = self._succ_cache[kmer]
        prefix = kmer[1:]
        return [prefix + b for i, b in enumerate("ACGT") if m >> i & 1]

    def predecessors(self, kmer: str) -> list[str]:
        m = self._pred_cache.get(kmer)
        if m is None:
            self.prefetch([], [kmer])
            m = self._pred_cache[kmer]
        suffix = kmer[:-1]
        return [b + suffix for i, b in enumerate("ACGT") if m >> i & 1]


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
    `search` is a completed _BidiSearch, or None for the decided cases."""
    k = dbg.k
    if search is not None:
        res.cost = search.cost
        res.num_nodes_visited = search.nodes_visited
        res.max_active_branches = search.peak_branches
        res.path_result, paths = search.paths_to_goal()
    elif res.path_result == "FOUND_PATH":
        r1 = res.read1 if res.read1 is not None else read1
        paths = [[r1[res.start_kmer_pos : res.start_kmer_pos + k]]]
    if res.path_result != "FOUND_PATH":
        return res
    return _merge_paths(res, [path_to_seq(p, k) for p in paths], read1, read2,
                        params)


def _merge_paths(res: SearchResult, connecting: list[str], read1: str,
                 read2: str, params: "ConnectPairsParams | None") -> SearchResult:
    """Merge a found result's connecting sequences with the flanks: the one
    path, or the NW consensus of several.  mask_new always compares against
    the ORIGINAL reads; anchors/merging use the (possibly
    fixErrors-corrected) res.read1/read2."""
    from . import nw

    r1 = res.read1 if res.read1 is not None else read1
    r2 = res.read2 if res.read2 is not None else read2
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


# gp_konnect_pairs' result codes and row kinds (native/gp_native.cpp)
_NATIVE_CODES = ("NO_PATH", "FOUND_PATH", "TOO_MANY_PATHS", "TOO_MANY_BRANCHES",
                 "MAX_COST_EXCEEDED", "EXCEEDED_MEM_LIMIT")
_ANCHORED, _FALLBACK = 1, 2  # kind 0: no anchors, the default SearchResult


def _native_round(dbg: DBG, pairs: list[tuple[str, str]],
                  params: ConnectPairsParams) -> list[SearchResult | None] | None:
    """The pairs' results from the native search (native.konnect_pairs: the
    anchor choice, the search and the path enumeration in one call outside
    the interpreter lock; the merge here), None for a pair whose anchors do
    not pack, which the Python search then takes.  None where it does not
    engage: a graph other than the plain DBG, k > 32, no native library,
    fix_errors, or reads that are not ASCII."""
    if (type(dbg) is not DBG or dbg._ext4 is None or dbg.k > 32
            or params.fix_errors):
        return None
    from .. import native

    try:
        rows = native.konnect_pairs(pairs, dbg.k, dbg.h, dbg.bf, params)
    except UnicodeEncodeError:
        return None
    out: list[SearchResult | None] = []
    for (r1, r2), (kind, code, sp, gp, cost, nodes, peak, connecting) in zip(pairs, rows):
        if kind == _FALLBACK:
            out.append(None)
            continue
        res = SearchResult()
        if kind == _ANCHORED:
            res.found_start = res.found_goal = True
            res.start_kmer_pos, res.goal_kmer_pos = sp, gp
            res.cost, res.num_nodes_visited, res.max_active_branches = cost, nodes, peak
            res.path_result = _NATIVE_CODES[code]
            if res.path_result == "FOUND_PATH":
                res = _merge_paths(res, connecting, r1, r2, params)
        out.append(res)
    return out


def connect_pairs(dbg: DBG, read1: str, read2: str, params: ConnectPairsParams) -> SearchResult:
    """reference konnector.h:234-438 (fixErrors/preserveReads both false in
    the sealer pipeline): connect_pairs_batch of one pair."""
    return connect_pairs_batch(dbg, [(read1, read2)], params)[0]


class MaskDBG:
    """DBG view over precomputed 4-bit extension masks (ops/dbg_bfs device
    kernel output), keyed by PACKED k-mers — the host replay's vertex type.
    Membership answers are identical to the probing DBG's for every vertex
    the kernel visited; a lookup outside that set marks `missed` and the
    caller re-runs the search on the probing DBG — the exactness shield
    for kernel-capacity corner cases."""

    def __init__(self, k: int, succ: dict, pred: dict):
        self.k = k
        self.kmask = (1 << (2 * k)) - 1
        self.top = 2 * (k - 1)
        self.succ = succ
        self.pred = pred
        self.missed = False

    def successors(self, v: int) -> list[int]:
        m = self.succ.get(v)
        if m is None:
            self.missed = True
            return []
        base = (v << 2) & self.kmask
        return [base | b for b in range(4) if m >> b & 1]

    def predecessors(self, v: int) -> list[int]:
        m = self.pred.get(v)
        if m is None:
            self.missed = True
            return []
        base = v >> 2
        return [base | (b << self.top) for b in range(4) if m >> b & 1]


def connect_pairs_batch_masks(dbg: DBG, pairs: list[tuple[str, str]],
                              params: ConnectPairsParams,
                              device_bfs) -> list[SearchResult]:
    """connect_pairs over many gaps with the WHOLE search's probes computed
    in one device dispatch (ops/dbg_bfs.DeviceBFS — one CUDA kernel runs
    every BFS level, vs one round trip per level for DeviceDBG lockstep): the
    kernel returns every reachable vertex's extension mask and the host
    replays _BidiSearch against the mask dictionary with zero probes.
    Replay order, cost accounting and aborts are the exact host semantics;
    kernel capacity overflows (and any mask miss) re-run natively."""
    prepared = [_prepare_search(dbg, r1, r2, params) for r1, r2 in pairs]
    live = [(i, s) for i, (_res, s) in enumerate(prepared) if s is not None]
    # string-vertex searches (dirty anchors — packing would alias
    # vertices) run natively; the common pure-ACGT case replays device
    # masks on packed vertices
    for _i, s in live:
        if not s.packed:
            s.run()
    live = [(i, s) for i, s in live if s.packed]
    masks = device_bfs.run(
        [(s.start_str, s.goal_str, s.max_depth[0], s.max_depth[1])
         for _i, s in live]
    ) if live else []
    for (i, s), (succ, pred) in zip(live, masks):
        redo = succ is None
        if not redo:
            mdbg = MaskDBG(dbg.k, succ, pred)
            s.dbg = mdbg
            s.run()
            redo = mdbg.missed
        if redo:
            res = prepared[i][0]
            s2 = _BidiSearch(
                _packed_view(dbg), s.start, s.goal, s.max_paths,
                s.min_path_len, s.max_path_len, s.max_branches, s.max_cost,
                mem_limit=s.mem_limit,
            )
            s2.run()
            prepared[i] = (res, s2)
    return [
        _finish_search(dbg, res, s, pairs[i][0], pairs[i][1], params)
        for i, (res, s) in enumerate(prepared)
    ]


def connect_pairs_batch(dbg: DBG, pairs: list[tuple[str, str]],
                        params: ConnectPairsParams,
                        tally: dict | None = None) -> list[SearchResult]:
    """connect_pairs over many gaps.  On the plain DBG the native round
    (_native_round) takes every pair it can; the rest run the Python
    searches in LOCKSTEP: every active search advances until it needs
    uncached probes, then one DeviceDBG prefetch covers the union of all
    frontiers — the cross-gap batching SURVEY §7.5 prescribes.  Each
    search's processing order is untouched, so per-gap results are
    identical to serial connect_pairs (pinned by tests).  With a host DBG
    every search completes on its first run_while_cached call and this
    degenerates to the serial loop.  tally["native"] gains the pairs the
    native round took."""
    done = _native_round(dbg, pairs, params) or [None] * len(pairs)
    if tally is not None:
        tally["native"] = tally.get("native", 0) + sum(r is not None for r in done)
    prepared = {i: _prepare_search(dbg, *pairs[i], params)
                for i, r in enumerate(done) if r is None}
    active = [(i, s) for i, (_res, s) in prepared.items() if s is not None]
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
    for i, (res, s) in prepared.items():
        done[i] = _finish_search(dbg, res, s, pairs[i][0], pairs[i][1], params)
    return done
