"""The two-phase ntEdit editor, host only: the benchmark's plain reference
of the port's editor.

Frozen copy of goldpolish_tpu_torch/polish/ntedit_gpu.py's host path (the
"numpy" backend with the native library absent): phase A probes every
window of the contig and picks the hot sites, phase B walks from hot site
to hot site, replays each site's trials from a batched site eval
(siteeval.eval_sites) and runs the oracle's scalar scan through each edit's
dirty zone.  Its output is byte-identical to the scalar oracle
(ntedit_oracle.polish_contig), which the port's tests pin.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from . import nthash as nt
from . import siteeval
from . import ntedit_oracle as orc
from .ntedit_oracle import (
    MULTI_POSSIBLE_BASES,
    NUM_TRIES,
    Config,
    NeedMoreCombos,
    Node,
    _upper,
    accept_edit,
    find_first_accepted_kmer,
    new_best,
    run_trials,
    update_sub_best,
)

TIER0_COMBOS = 21  # insertion combos of length <= 3; escalate to 341 on demand

_ACCEPTED_LUT = np.zeros(256, bool)
for _c in b"ATGCRYSWKMBDHV":
    _ACCEPTED_LUT[_c] = True
    _ACCEPTED_LUT[_c + 32] = True


class _TableProvider:
    """Trial provider reading precomputed site supports (ops.siteeval)."""

    def __init__(self, sup: siteeval.SiteSupports, si: int, draft: bytes, p: int,
                 mode2: bool = False):
        self.sup = sup
        self.si = si
        self.draft = draft
        self.p = p  # tail position of the site window
        self.mode2 = mode2
        self.applied_sub = False  # a gated sub trial ran (apply+revert effect)

    def sub_trial(self, ci):
        gate = bool(self.sup.gate[self.si, ci])
        if gate or self.mode2:
            # the reference's revert writes back toupper(draft_char)
            # (ntedit.cpp:1610), permanently uppercasing the position
            self.applied_sub = True
        return gate, int(self.sup.sub_support[self.si, ci])

    def ins_trial(self, ci, i):
        if i >= self.sup.n_combos:
            raise NeedMoreCombos
        return int(self.sup.ins_support[self.si, ci, i])

    def del_trial(self, d):
        return int(self.sup.del_support[self.si, d - 1])

    def deleted_bases(self, d):
        # clean mode: the d bases from the tail position are pure draft
        return bytes(self.draft[self.p : self.p + d])


@lru_cache(maxsize=64)
def _interleave_pattern(n_combos: int, n_dels: int, num_deletions: int):
    """Index arrays for the ins(0), del(d0), ins(1), del(d0+1), ... trial
    order — computed once per shape instead of a 341-iteration Python loop
    per site."""
    seq_len = n_combos + n_dels
    ins_pos = np.empty(n_combos, np.int64)
    del_pos = np.empty(n_dels, np.int64)
    is_del = np.zeros(seq_len, bool)
    payload = np.empty(seq_len, np.int32)
    pos = 0
    di = 0
    for i in range(n_combos):
        ins_pos[i] = pos
        payload[pos] = i
        pos += 1
        if di < n_dels:
            del_pos[di] = pos
            is_del[pos] = True
            payload[pos] = num_deletions + di
            pos += 1
            di += 1
    return ins_pos, del_pos, is_del, payload


def _engine_run_trials(cfg: Config, draft_char: int, provider: "_TableProvider"):
    """Mode-1 fast path of ntedit_oracle.run_trials.

    Semantically identical (the engine-vs-oracle differential suite pins
    it), but the 341-combo indel scan is replaced by a vectorized
    last-max-wins reduction over the support tables instead of ~1400 python
    trial calls per site.  Other modes fall back to the shared loop.
    """
    if cfg.mode != 1:
        return run_trials(cfg, draft_char, provider, 0)
    best = new_best()
    num_deletions = 1
    sup = provider.sup
    si = provider.si
    bases = cfg.bases_array.get(chr(draft_char), "")
    n_combos = NUM_TRIES[cfg.max_insertions]
    if sup.n_combos < n_combos:
        raise NeedMoreCombos
    for ci, sub_base_s in enumerate(bases):
        sub_base = ord(sub_base_s)
        gate, check_present = provider.sub_trial(ci)
        if not gate:
            continue
        if accept_edit(cfg, check_present):
            update_sub_best(best, sub_base, check_present)
            continue
        if best["edit_type"] == 1:
            continue
        # vectorized tryIndels: trial order ins(0), del(d0), ins(1),
        # del(d0+1), ..., with >= (last wins) accumulation
        ins_vals = sup.ins_support[si, ci, :n_combos]
        n_dels = max(0, min(n_combos, cfg.max_deletions - num_deletions + 1))
        del_vals = sup.del_support[si, num_deletions - 1 : num_deletions - 1 + n_dels]
        ins_pos, del_pos, is_del, payload = _interleave_pattern(
            n_combos, n_dels, num_deletions
        )
        vals = np.empty(n_combos + n_dels, np.int32)
        vals[ins_pos] = ins_vals
        vals[del_pos] = del_vals
        num_deletions += n_dels
        # deletions additionally require a positive raw count (the accepted
        # tryDeletion result is then tested > 0, run_trials)
        ok = np.where(
            is_del,
            (vals >= cfg.thr_del) & (vals > 0),
            vals >= cfg.thr_edit,
        )
        if not ok.any():
            continue
        m = vals[ok].max()
        idxs = np.flatnonzero(ok & (vals == m))
        j = int(idxs[-1])  # >= comparisons: the last maximal trial wins
        if is_del[j]:
            d = int(payload[j])
            best.update(
                edit_type=3, indel=provider.deleted_bases(d), num_support=int(m)
            )
        else:
            combo = MULTI_POSSIBLE_BASES[chr(sub_base)][int(payload[j])]
            best.update(edit_type=2, indel=combo.encode(), num_support=int(m))
        break  # found -> mode 1 exits the sub loop
    return best


@dataclass
class ScanMasks:
    present: np.ndarray
    hot: np.ndarray
    w0: int



def _seed(seq, start: int, k: int) -> tuple[int, int]:
    return nt.ntc64_base_i(seq, start, k)


class HostEditor:
    """One k's editor over one filter (NtEditGPU(backend="numpy") without
    the native library)."""

    def __init__(self, cfg: Config, bf, device):
        if cfg.snv:
            raise ValueError("the reference editor runs modes 0-2 without SNV")
        self.cfg = cfg
        self.bf = bf
        # the site eval in plain torch on `device` (siteeval.eval_sites)
        self.dev_filter = siteeval.DeviceFilter(bf, device)
        self.tables = siteeval.make_tables(
            cfg.k, cfg.jump, cfg.max_insertions, cfg.max_deletions
        )

    def _eval_sites(self, codes: np.ndarray, sites: np.ndarray, n_combos: int):
        return siteeval.eval_sites(
            codes, sites, self.bf, self.tables, self.cfg.h, n_combos,
            dev_filter=self.dev_filter,
        )

    def _masks(self, codes: np.ndarray) -> ScanMasks:
        cfg = self.cfg
        k, n = cfg.k, len(codes)
        present = self.bf.contains(
            nt.multi_hashes(nt.canonical_hashes(codes, k), k, cfg.h))
        nw = n - k + 1
        bad = ~_ACCEPTED_LUT[codes]
        badc = np.concatenate(([0], np.cumsum(bad)))
        window_clean = (badc[k:] - badc[:-k]) == 0  # [nw]
        w0 = find_first_accepted_kmer(0, bytearray(codes.tobytes()), k)
        visited = window_clean.copy()
        visited[: min(w0, nw)] = False
        # eligible: w <= n-2k and no bad char in [w+k, w+2k-1]
        eligible = np.zeros(nw, bool)
        lim = n - 2 * k
        if lim >= 0:
            eligible[: lim + 1] = window_clean[k : k + lim + 1]
        miss = ~present
        cm = np.zeros(nw, np.int32)
        missi = miss.astype(np.int32)
        for kk in range(0, k, cfg.jump):
            off = kk + 1  # cm[w] counts misses at windows w+1, w+1+j, ...
            if off < nw:
                cm[: nw - off] += missi[off:]
        cmf = cm.astype(np.float32)
        if cfg.use_ratio:
            thr = (np.float32(k) / np.float32(cfg.jump)) * np.float32(cfg.missing_ratio)
        else:
            thr = np.float32(k) / np.float32(cfg.missing_threshold)
        hot = visited & miss & eligible & (cmf >= thr)
        return ScanMasks(present=present, hot=hot, w0=w0)


    def polish_contig(self, seq_in: bytes):
        """Polish one contig; returns (edited_bytes, subs_records, editor)."""
        cfg = self.cfg
        k = cfg.k
        n = len(seq_in)
        ed = orc._Editor(cfg, self.bf)
        if n < cfg.min_contig_len or n < k:
            return bytes(seq_in), [], ed
        codes = np.frombuffer(seq_in, np.uint8)
        masks = self._masks(codes)
        hot_list = np.nonzero(masks.hot)[0]

        seq = bytearray(seq_in)
        new_seq = [Node(0, 0, n - 1, 0, 0)]
        recs: list[dict] = []
        ed.dirty_end = -1

        if masks.w0 + k - 1 >= n:
            return bytes(seq_in), [], ed
        if len(hot_list) == 0:
            return bytes(seq_in), [], ed

        # Lazy visited-prediction batching.  Errors produce *clusters* of hot
        # windows, and which cluster members the walker visits depends on the
        # decisions it makes: an accepted edit's dirty-zone segment scan
        # consumes the rest of its cluster (only the FIRST site of each
        # cluster is visited), while a mask/no-edit decision steps to the
        # IMMEDIATE next hot window (every cluster site is visited — the
        # unfixable-cluster regime that dominates real noisy batches).
        # Batching either pattern alone is ~12x wasteful in the other regime,
        # so the batch builder is adaptive: requests arriving after an
        # accepted edit predict the visited subset as hot sites spaced
        # >= k apart (next-cluster-first), requests arriving after a
        # no-edit decision batch consecutively.  A prediction miss just
        # starts a fresh batch at the missed site — correctness never
        # depends on the prediction.
        # Tier choice by mode: mode 0 stops at the first accepted indel, so
        # short combos (tier 0) resolve almost every site and the rare rest
        # escalate; modes 1/2 always scan all 341 combos.
        if cfg.mode == 0:
            batch_n, tier_combos = 64, TIER0_COMBOS
        else:
            batch_n = 64
            tier_combos = self.tables.n_combos
        site_cache: dict[int, tuple[siteeval.SiteSupports, int]] = {}

        def sup_for(si: int, consecutive: bool) -> tuple[siteeval.SiteSupports, int]:
            # Supports are computed on pure-draft content, which stays valid
            # downstream of every edit kind (subs/masks only rewrite bytes
            # inside their dirty zone, whose hot sites the scalar segment
            # scan consumes; indels shift the rope, not the draft).
            if si not in site_cache:
                if consecutive:
                    sel = list(range(si, min(si + batch_n, len(hot_list))))
                else:
                    sel = [si]
                    last = int(hot_list[si])
                    j = si + 1
                    while j < len(hot_list) and len(sel) < batch_n:
                        w = int(hot_list[j])
                        if w >= last + k:
                            sel.append(j)
                            last = w
                        j += 1
                sup = self._eval_sites(codes, hot_list[sel], tier_combos)
                for row, idx in enumerate(sel):
                    site_cache[idx] = (sup, row)
            return site_cache[si]

        full_sup_cache: dict[int, siteeval.SiteSupports] = {}

        cur_w = masks.w0
        trailing = 0  # rope index of the trailing pure-draft position node
        hot_pos = 0
        consec_hint = False  # last decision was mask/no-edit -> cluster walk
        while True:
            # FAST mode: jump to the next hot site at/after cur_w
            while hot_pos < len(hot_list) and hot_list[hot_pos] < cur_w:
                hot_pos += 1
            if hot_pos >= len(hot_list):
                break
            si = hot_pos
            w_h = int(hot_list[si])
            hot_pos += 1
            if w_h + k - 1 >= n:
                break
            # reseed the exact scan state at this pure-draft window
            st = {"h": w_h, "t": w_h + k - 1, "hn": trailing, "tn": trailing}
            fh, rh = _seed(seq, w_h, k)
            char_in = seq[st["t"]]
            draft_char = _upper(char_in)
            mode2 = cfg.mode == 2
            sup, local_si = sup_for(si, consec_hint)
            provider = _TableProvider(sup, local_si, seq, st["t"], mode2)
            try:
                best = _engine_run_trials(cfg, draft_char, provider)
            except NeedMoreCombos:
                if w_h not in full_sup_cache:
                    full_sup_cache[w_h] = self._eval_sites(
                        codes, np.array([w_h], np.int64), self.tables.n_combos
                    )
                provider = _TableProvider(full_sup_cache[w_h], 0, seq, st["t"], mode2)
                best = _engine_run_trials(cfg, draft_char, provider)
            if provider.applied_sub and seq[st["t"]] != draft_char:
                # reference side effect: the sub-trial revert writes the
                # *uppercased* draft char back (ntedit.cpp:1610)
                seq[st["t"]] = draft_char
                char_in = draft_char
            if best["edit_type"] == 0:
                consec_hint = True
                if cfg.mask:
                    # soft-mask (-a1) lowercases one byte — a case-only write
                    # that leaves every hash unchanged (seedTab indexes c&7),
                    # so the precomputed present/hot/support tables stay
                    # valid and the walk stays in FAST mode.  Unfixable
                    # clusters would otherwise run the scalar segment scan
                    # site by site (the dominant cost on noisy regions).
                    fh, rh, char_in = ed._make_edit(
                        draft_char, best, recs, st, fh, rh, seq, new_seq,
                        char_in,
                    )
                cur_w = w_h + 1
                continue
            consec_hint = False
            fh, rh, char_in = ed._make_edit(
                draft_char, best, recs, st, fh, rh, seq, new_seq, char_in
            )
            # SEGMENT mode: exact scalar scan through the dirty zone
            def _exit_clean(s):
                node = new_seq[s["hn"]]
                return (
                    s["h"] > ed.dirty_end
                    and s["hn"] == s["tn"]
                    and node.node_type == 0
                    and node.e_pos == n - 1
                )

            status, st, fh, rh, char_in = ed.scan_from(
                st, fh, rh, char_in, seq, new_seq, recs,
                exit_check=_exit_clean, start_with_roll=True,
            )
            if status == "end":
                break
            cur_w = st["h"]
            trailing = st["hn"]

        return ed._render(seq, new_seq), recs, ed
