"""Exact sequential ntEdit editor (host oracle).

A from-scratch Python reimplementation of the reference ntEdit polishing
algorithm (reference: subprojects/ntedit/ntedit.cpp v1.3.5), preserving its
observable semantics exactly:

 * rope ("seqNode") edit structure with position-range and literal-char nodes
   (reference ntedit.cpp:468-475) including the index/compaction behavior of
   makeInsertion/makeDeletion (reference :480-664),
 * O(1) last-base rehash via ntHash changelast during candidate trials
   (reference lib/nthash.hpp:134-169),
 * jump-subsampled subset verification windows and x/y vs X/Y accept rules
   (reference ntedit.cpp:1487-1523, 1226-1231, 1333-1337),
 * substitution alt-base bookkeeping (reference :1628-1677),
 * interleaved insertion/deletion trials with the shared deletion counter
   (reference :1276-1397),
 * low-complexity repeat-insertion guard + insertion cap rollback
   (reference :415-451, 1034-1102),
 * IUPAC candidate tables and SNV/mask modes (reference :158-194, 1540-1556).

This module is deliberately scalar and slow — it is the bit-exactness anchor
the batched TPU engine (polish/ntedit_tpu.py) is tested against, and the
fallback editor for tiny inputs.

Frozen copy of goldpolish_tpu_torch/polish/ntedit_oracle.py for the benchmark's plain
reference (NumPy and Python only; it imports nothing of the port).
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import product

import numpy as np

from . import nthash as nt

# --- candidate tables (reference ntedit.cpp:150-343) -------------------------
NUM_TRIES = [0, 1, 5, 21, 85, 341]

POLISH_BASES = {
    "A": "TCG", "T": "ACG", "C": "ATG", "G": "ATC",
    "R": "TC", "Y": "AG", "S": "AT", "W": "CG", "K": "AC", "M": "TG",
    "B": "A", "D": "C", "H": "G", "V": "T", "N": "ATCG",
}
SNV_BASES = {c: "ATCG" for c in "ATCGRYSWKMBDHVN"}


def _build_multi_possible_bases() -> dict[str, list[str]]:
    """All insertion combos of length 1..5 starting with each base, ordered by
    length then lexicographically over ACGT (reference ntedit.cpp:198-343)."""
    out = {}
    for b in "ACGT":
        combos = []
        for length in range(1, 6):
            for tail in product("ACGT", repeat=length - 1):
                combos.append(b + "".join(tail))
        out[b] = combos
    return out


MULTI_POSSIBLE_BASES = _build_multi_possible_bases()

_ATGC = frozenset(b"ATGC")
_ACCEPTED = frozenset(b"ATGCRYSWKMBDHV")
_RC = {ord(a): ord(b) for a, b in zip("AaTtGgCc", "TTAACCGG")}


def is_atgc(c: int) -> bool:
    return c in _ATGC


def is_accepted(c: int) -> bool:
    """ATGC or IUPAC (reference ntedit.cpp:363-367). Input should be upper."""
    return c in _ACCEPTED


def rc(c: int) -> int:
    """Complement of a base; 'N' for anything else (reference :369-388)."""
    return _RC.get(c, ord("N"))


@dataclass
class Config:
    """Unified ntEdit parameters (reference ntedit.cpp:83-114)."""

    k: int = 32
    h: int = 4  # hash_num, from the BF header in the reference (:2013)
    max_insertions: int = 5
    max_deletions: int = 5
    missing_threshold: float = 5.0  # -x
    edit_threshold: float = 9.0  # -y
    missing_ratio: float = 0.5  # -X
    edit_ratio: float = 0.5  # -Y
    use_ratio: bool = False
    jump: int = 3
    mode: int = 0
    snv: int = 0
    mask: int = 0
    min_contig_len: int = 100
    insertion_cap: int = 0  # 0 -> k * 1.5 (reference :2024-2025)

    def __post_init__(self):
        if self.insertion_cap == 0:
            self.insertion_cap = int(self.k * 1.5)
        if self.snv:
            # SNV mode disables indels (reference ntedit.cpp:1988-1990)
            self.max_insertions = 0
            self.max_deletions = 0
        # precomputed accept thresholds in float32 rounding (C++ float
        # parity); check counts are small ints, exactly representable, so
        # `count >= float(np.float32(expr))` == the reference comparison
        if self.use_ratio:
            kj = np.float32(self.k) / np.float32(self.jump)
            self.thr_edit = float(kj * np.float32(self.edit_ratio))
            self.thr_del = float((np.float32(1) + kj) * np.float32(self.edit_ratio))
            self.thr_missing = float(kj * np.float32(self.missing_ratio))
        else:
            self.thr_edit = float(np.float32(self.k) / np.float32(self.edit_threshold))
            self.thr_del = self.thr_edit
            self.thr_missing = float(
                np.float32(self.k) / np.float32(self.missing_threshold)
            )

    @property
    def bases_array(self) -> dict[str, str]:
        return SNV_BASES if self.snv else POLISH_BASES


# --- rope nodes (reference seqNode, ntedit.cpp:468-475) ----------------------
class Node:
    __slots__ = ("node_type", "s_pos", "e_pos", "c", "num_support")

    def __init__(self, node_type=-1, s_pos=0, e_pos=0, c=0, num_support=0):
        self.node_type = node_type  # -1 unset; 0 position-range; 1 literal
        self.s_pos = s_pos
        self.e_pos = e_pos
        self.c = c
        self.num_support = num_support

    def copy(self):
        return Node(self.node_type, self.s_pos, self.e_pos, self.c, self.num_support)


def find_first_accepted_kmer(b_i: int, seq: bytearray, k: int) -> int:
    """Reference ntedit.cpp:392-413 (note the strict `i + k < size` bound)."""
    n = len(seq)
    i = b_i
    while i + k < n:
        if is_accepted(_upper(seq[i])):
            good = True
            for j in range(i + 1, i + k):
                if not is_accepted(_upper(seq[j])):
                    good = False
                    i = j + 1
                    break
            if good:
                return i
        else:
            i += 1
    return n - 1


def _upper(c: int) -> int:
    return c - 32 if 97 <= c <= 122 else c


def _lower(c: int) -> int:
    return c + 32 if 65 <= c <= 90 else c


def compute_lps(s: str) -> list[int]:
    """KMP failure function (reference ntedit.cpp:416-438)."""
    n = len(s)
    lps = [0] * n
    length = 0
    i = 1
    while i < n:
        if s[i] == s[length]:
            length += 1
            lps[i] = length
            i += 1
        elif length != 0:
            length = lps[length - 1]
        else:
            lps[i] = 0
            i += 1
    return lps


def is_repeat_insertion(s: str) -> bool:
    """Low-complexity repeat test (reference ntedit.cpp:441-451)."""
    n = len(s)
    if n == 0:
        return False
    lps = compute_lps(s)
    length = lps[n - 1]
    return length > 0 and n % (n - length) == 0


def accept_edit(cfg: Config, check_present: int) -> bool:
    """Sub/ins accept rule (reference ntedit.cpp:1621-1626, 1333-1337);
    threshold precomputed in float32 rounding (Config.__post_init__)."""
    return check_present >= cfg.thr_edit


def accept_del(cfg: Config, check_present: int) -> bool:
    """Deletion accept rule — note the extra 1+ term (reference :1226-1231)."""
    return check_present >= cfg.thr_del


def accept_missing(cfg: Config, check_missing: int) -> bool:
    """Missing-kmer rule gating candidate trials (reference :1517-1523)."""
    return check_missing >= cfg.thr_missing


def update_sub_best(best: dict, sub_base: int, check_present: int) -> None:
    """Best-substitution + alt-base bookkeeping (reference :1628-1677)."""
    if check_present >= best["num_support"]:
        if best["altsupp2"]:
            best["altbase3"] = best["altbase2"]
            best["altsupp3"] = best["altsupp2"]
        if best["altsupp1"]:
            best["altbase2"] = best["altbase1"]
            best["altsupp2"] = best["altsupp1"]
        if best["num_support"]:
            best["altsupp1"] = best["num_support"]
            best["altbase1"] = best["sub_base"]
        best["edit_type"] = 1
        best["sub_base"] = sub_base
        best["num_support"] = check_present
    else:
        if not best["altsupp1"]:
            best["altbase1"] = sub_base
            best["altsupp1"] = check_present
        elif not best["altsupp2"]:
            if check_present < best["altsupp1"]:
                best["altbase2"] = sub_base
                best["altsupp2"] = check_present
            else:
                best["altbase2"] = best["altbase1"]
                best["altsupp2"] = best["altsupp1"]
                best["altbase1"] = sub_base
                best["altsupp1"] = check_present
        elif not best["altsupp3"]:
            if check_present < best["altsupp2"]:
                best["altbase3"] = sub_base
                best["altsupp3"] = check_present
            elif check_present < best["altsupp1"]:
                best["altbase3"] = best["altbase2"]
                best["altsupp3"] = best["altsupp2"]
                best["altbase2"] = sub_base
                best["altsupp2"] = check_present
            else:
                best["altbase3"] = best["altbase2"]
                best["altsupp3"] = best["altsupp2"]
                best["altbase2"] = best["altbase1"]
                best["altsupp2"] = best["altsupp1"]
                best["altbase1"] = sub_base
                best["altsupp1"] = check_present


def new_best() -> dict:
    return {
        "edit_type": 0,
        "indel": b"",
        "alt_indel": b"",
        "sub_base": 0,
        "num_support": 0,
        "altbase1": 0, "altsupp1": 0,
        "altbase2": 0, "altsupp2": 0,
        "altbase3": 0, "altsupp3": 0,
    }


class NeedMoreCombos(Exception):
    """Raised by tiered trial providers when the trial loop requests an
    insertion combo beyond the evaluated tier."""


def run_trials(cfg: Config, draft_char: int, provider, check_there: int = 0) -> dict:
    """The reference's candidate-trial loop (ntedit.cpp:1525-1713), decision
    logic only — probes are delegated to `provider`:

      provider.sub_trial(ci)    -> (gate_in_bf: bool, raw check_present: int)
      provider.ins_trial(ci, i) -> raw check_present
      provider.del_trial(d)     -> raw check_present

    Shared verbatim between the scalar oracle editor and the TPU engine's
    table replay, so both produce byte-identical decisions.
    """
    best = new_best()
    num_deletions = 1
    if cfg.snv and accept_edit(cfg, check_there):
        best["sub_base"] = draft_char
        best["num_support"] = check_there

    bases = cfg.bases_array.get(chr(draft_char), "")
    for ci, sub_base_s in enumerate(bases):
        sub_base = ord(sub_base_s)
        gate, check_present = provider.sub_trial(ci)
        if gate or cfg.mode == 2:
            if accept_edit(cfg, check_present):
                update_sub_best(best, sub_base, check_present)
                if cfg.mode in (0, 1):
                    continue
            if cfg.mode == 2 or best["edit_type"] != 1:
                found, num_deletions = _run_indel_trials(
                    cfg, draft_char, ci, num_deletions, provider, best
                )
                if found and cfg.mode in (0, 1):
                    break
    return best


def _run_indel_trials(cfg: Config, draft_char: int, ci: int, num_deletions: int,
                      provider, best: dict):
    """tryIndels decision structure (reference ntedit.cpp:1237-1411)."""
    t_best_support = 0
    t_alt_support = 0
    t_best_indel = b""
    t_alt_indel = b""
    t_best_type = 0
    index_char = ord(cfg.bases_array[chr(draft_char)][ci])
    for i in range(NUM_TRIES[cfg.max_insertions]):
        check_present = provider.ins_trial(ci, i)
        ins_bases = MULTI_POSSIBLE_BASES[chr(index_char)][i].encode()
        if accept_edit(cfg, check_present):
            if cfg.mode == 0:
                best.update(edit_type=2, indel=ins_bases, num_support=check_present)
                return True, num_deletions
            if check_present >= t_best_support:
                if t_best_support:
                    t_alt_indel = t_best_indel
                    t_alt_support = t_best_support
                t_best_type = 2
                t_best_indel = ins_bases
                t_best_support = check_present
        if num_deletions <= cfg.max_deletions:
            del_check = provider.del_trial(num_deletions)
            del_support = del_check if accept_del(cfg, del_check) else 0
            if del_support > 0:
                deleted = provider.deleted_bases(num_deletions)
                if cfg.mode == 0:
                    best.update(edit_type=3, indel=deleted, num_support=del_support)
                    return True, num_deletions + 1
                if del_support >= t_best_support:
                    if t_best_support:
                        t_alt_indel = t_best_indel
                        t_alt_support = t_best_support
                    t_best_type = 3
                    t_best_indel = deleted
                    t_best_support = del_support
            num_deletions += 1
    if t_best_support > 0:
        if (cfg.mode == 2 and t_best_support > best["num_support"]) or cfg.mode == 1:
            best.update(
                edit_type=t_best_type,
                indel=t_best_indel,
                num_support=t_best_support,
                alt_indel=t_alt_indel,
                altsupp1=t_alt_support,
            )
        return True, num_deletions
    return False, num_deletions


class _Editor:
    """Per-contig editing state machine (reference kmerizeAndCorrect)."""

    def __init__(self, cfg: Config, bloom, bloomrep=None):
        self.cfg = cfg
        self.bloom = bloom
        self.bloomrep = bloomrep
        self.secbf = bloomrep is not None
        self._arr = bloom.array
        self._bits = bloom._bits_i
        self._km = (cfg.k * nt._MULTI_SEED_I) & nt.MASK64
        # counters for observability (reference prints none, but the new
        # framework's structured logs report them)
        self.n_subs = 0
        self.n_ins = 0
        self.n_dels = 0
        self.n_masked = 0
        self.n_nofix = 0

    # -- hash helpers ---------------------------------------------------------
    def _contains(self, hval) -> bool:
        if not self.bloom.contains_tuple(hval):
            return False
        if self.secbf and self.bloomrep.contains_tuple(hval):
            return False
        return True

    def _contains_primary(self, hval) -> bool:
        return self.bloom.contains_tuple(hval)

    def _probe_fr(self, fh: int, rh: int) -> bool:
        """Fused canonical-multihash + Bloom probe on the (fh, rh) state —
        the scalar scan's hot operation, kept allocation-free.  Primary +
        optional secondary filter (same semantics as
        _contains(_mh(fh, rh)))."""
        b = (fh + rh) & 0xFFFFFFFFFFFFFFFF
        arr = self._arr
        bits = self._bits
        t = b % bits
        if not (arr[t >> 3] >> (t & 7)) & 1:
            return False
        km = self._km
        for i in range(1, self.cfg.h):
            t = (b * (i ^ km)) & 0xFFFFFFFFFFFFFFFF
            t ^= t >> 27
            t %= bits
            if not (arr[t >> 3] >> (t & 7)) & 1:
                return False
        if self.secbf and self.bloomrep.contains_tuple(self._mh(fh, rh)):
            return False
        return True

    def _probe_fr_primary(self, fh: int, rh: int) -> bool:
        b = (fh + rh) & 0xFFFFFFFFFFFFFFFF
        arr = self._arr
        bits = self._bits
        t = b % bits
        if not (arr[t >> 3] >> (t & 7)) & 1:
            return False
        km = self._km
        for i in range(1, self.cfg.h):
            t = (b * (i ^ km)) & 0xFFFFFFFFFFFFFFFF
            t ^= t >> 27
            t %= bits
            if not (arr[t >> 3] >> (t & 7)) & 1:
                return False
        return True

    def _mh(self, fh, rh):
        return nt.multi_hashes_i(fh, rh, self.cfg.k, self.cfg.h)

    # -- rope ops (exact reference index semantics) ---------------------------
    @staticmethod
    def get_character(pos, node, seq):
        if node.node_type == 0:
            return seq[pos]
        if node.node_type == 1:
            return node.c
        return 0

    @staticmethod
    def increment(pos, node_index, new_seq):
        """Reference ntedit.cpp:681-699; returns (pos, node_index)."""
        node = new_seq[node_index]
        if node.node_type == 0:
            pos += 1
            if pos > node.e_pos:
                node_index += 1
                if node_index < len(new_seq) and new_seq[node_index].node_type == 0:
                    pos = new_seq[node_index].s_pos
        elif node.node_type == 1:
            node_index += 1
            if node_index < len(new_seq) and new_seq[node_index].node_type == 0:
                pos = new_seq[node_index].s_pos
        return pos, node_index

    def roll(self, st, seq, new_seq):
        """Reference ntedit.cpp:939-969; st is a dict-like state with h/t
        positions and node indexes.  Returns (ok, char_out, char_in)."""
        if st["h"] >= len(seq) or st["hn"] >= len(new_seq):
            return False, 0, 0
        char_out = self.get_character(st["h"], new_seq[st["hn"]], seq)
        st["h"], st["hn"] = self.increment(st["h"], st["hn"], new_seq)
        if st["t"] >= len(seq) or st["tn"] >= len(new_seq):
            return False, char_out, 0
        st["t"], st["tn"] = self.increment(st["t"], st["tn"], new_seq)
        if st["t"] >= len(seq) or st["tn"] >= len(new_seq):
            return False, char_out, 0
        char_in = self.get_character(st["t"], new_seq[st["tn"]], seq)
        return True, char_out, char_in

    @staticmethod
    def make_insertion(t_node_index, insert_pos, insertion_bases, num_support, new_seq):
        """Reference ntedit.cpp:480-569; returns updated t_node_index."""
        orig = new_seq[t_node_index].copy()
        to_insert = [
            Node(1, 0, 0, ord(c), num_support) for c in insertion_bases
        ]
        if orig.node_type == 0:
            if insert_pos <= orig.s_pos:
                reappend = []
                i = t_node_index
                while i < len(new_seq) and new_seq[i].node_type != -1:
                    reappend.append(new_seq[i].copy())
                    new_seq[i].node_type = -1
                    i += 1
                for i, nd in enumerate(to_insert):
                    if t_node_index + i < len(new_seq):
                        new_seq[t_node_index + i] = nd
                    else:
                        new_seq.append(nd)
                for i, nd in enumerate(reappend):
                    j = t_node_index + len(to_insert) + i
                    if j < len(new_seq):
                        new_seq[j] = nd
                    else:
                        new_seq.append(nd)
            else:
                after = Node(0, insert_pos, orig.e_pos, 0, 0)
                new_seq[t_node_index].e_pos = insert_pos - 1
                for i, nd in enumerate(to_insert):
                    j = t_node_index + i + 1
                    if j < len(new_seq):
                        new_seq[j] = nd
                    else:
                        new_seq.append(nd)
                j = t_node_index + len(to_insert) + 1
                if j < len(new_seq):
                    new_seq[j] = after
                else:
                    new_seq.append(after)
                t_node_index += 1
        elif orig.node_type == 1:
            reappend = []
            i = t_node_index
            while i < len(new_seq) and new_seq[i].node_type != -1:
                reappend.append(new_seq[i].copy())
                new_seq[i].node_type = -1
                i += 1
            for i, nd in enumerate(to_insert):
                if t_node_index + i < len(new_seq):
                    new_seq[t_node_index + i] = nd
                else:
                    new_seq.append(nd)
            for i, nd in enumerate(reappend):
                j = t_node_index + len(to_insert) + i
                if j < len(new_seq):
                    new_seq[j] = nd
                else:
                    new_seq.append(nd)
        return t_node_index

    @classmethod
    def make_deletion(cls, t_node_index, pos, num_del, num_support, new_seq):
        """Reference ntedit.cpp:574-664; returns (t_node_index, pos)."""
        orig = new_seq[t_node_index].copy()
        if orig.node_type == 0:
            leftover = 0
            if pos <= orig.s_pos:
                if pos + num_del <= orig.e_pos:
                    new_seq[t_node_index].s_pos = pos + num_del
                    new_seq[t_node_index].num_support = num_support
                    pos = new_seq[t_node_index].s_pos
                    return t_node_index, pos
                leftover = pos + num_del - orig.e_pos
                pos = orig.e_pos + 1
                i = t_node_index + 1
                while i < len(new_seq) and new_seq[i].node_type != -1:
                    new_seq[i - 1] = new_seq[i]
                    new_seq[i] = Node()
                    i += 1
            else:
                if pos + num_del <= orig.e_pos:
                    split = Node(0, pos + num_del, orig.e_pos, 0, num_support)
                    new_seq[t_node_index].e_pos = pos - 1
                    pos = split.s_pos
                    t_node_index += 1
                    if t_node_index < len(new_seq):
                        new_seq[t_node_index] = split
                    else:
                        new_seq.append(split)
                    return t_node_index, pos
                leftover = pos + num_del - orig.e_pos
                new_seq[t_node_index].e_pos = pos - 1
                pos = orig.e_pos + 1
                t_node_index += 1
            if leftover > 0:
                if t_node_index < len(new_seq) and new_seq[t_node_index].node_type != -1:
                    if new_seq[t_node_index].node_type == 0:
                        pos = new_seq[t_node_index].s_pos
                    t_node_index, pos = cls.make_deletion(
                        t_node_index, pos, leftover, num_support, new_seq
                    )
        elif orig.node_type == 1:
            i = t_node_index
            leftover = num_del
            while i < len(new_seq) and new_seq[i].node_type == 1 and leftover > 0:
                new_seq[i].node_type = -1
                leftover -= 1
                i += 1
            j = t_node_index
            while i < len(new_seq) and new_seq[i].node_type != -1:
                new_seq[j] = new_seq[i]
                new_seq[i] = Node()
                i += 1
                j += 1
            if leftover > 0:
                if t_node_index < len(new_seq) and new_seq[t_node_index].node_type != -1:
                    if new_seq[t_node_index].node_type == 0:
                        pos = new_seq[t_node_index].s_pos
                    t_node_index, pos = cls.make_deletion(
                        t_node_index, pos, leftover, num_support, new_seq
                    )
        return t_node_index, pos

    def find_accepted_kmer(self, st, seq, new_seq):
        """Reference ntedit.cpp:703-758; advances st to the found k-mer and
        returns its string (or "" when none)."""
        k = self.cfg.k
        temp_tn = st["tn"]
        i = st["t"]
        while (
            i < len(seq)
            and temp_tn < len(new_seq)
            and new_seq[temp_tn].node_type != -1
        ):
            curr = new_seq[temp_tn]
            c = self.get_character(i, curr, seq)
            if is_accepted(_upper(c)):
                kmer = [c]
                temp_hn = temp_tn
                j, temp_tn2 = self.increment(i, temp_tn, new_seq)
                broke_inner = False
                while (
                    j < len(seq)
                    and temp_tn2 < len(new_seq)
                    and new_seq[temp_tn2].node_type != -1
                ):
                    curr = new_seq[temp_tn2]
                    c = self.get_character(j, curr, seq)
                    if not is_accepted(_upper(c)):
                        i = j
                        broke_inner = True
                        break
                    kmer.append(c)
                    if len(kmer) == k:
                        break
                    j, temp_tn2 = self.increment(j, temp_tn2, new_seq)
                if len(kmer) == k:
                    st["h"] = i
                    st["t"] = j
                    st["hn"] = temp_hn
                    st["tn"] = temp_tn2
                    return bytes(kmer)
                if broke_inner:
                    # continue outer scan from i=j with same node index path
                    temp_tn = temp_tn2
                    continue
            i, temp_tn = self.increment(i, temp_tn, new_seq)
        st["h"] = len(seq)
        st["t"] = len(seq)
        return b""

    @staticmethod
    def get_prev_insertion(t_seq_i, t_node_index, new_seq):
        """Reference ntedit.cpp:762-777 (RC'd literal run walking backwards)."""
        prev = []
        tn = t_node_index
        if (
            tn < len(new_seq)
            and new_seq[tn].node_type == 0
            and t_seq_i == new_seq[tn].s_pos
        ) or new_seq[tn].node_type == 1:
            tn -= 1
        while 0 <= tn < len(new_seq) and new_seq[tn].node_type == 1:
            prev.append(chr(rc(new_seq[tn].c)))
            tn -= 1
        return "".join(prev)

    # -- candidate trials -----------------------------------------------------
    def try_deletion(self, draft_char, num_deletions, st, fh, rh, seq, new_seq):
        """Reference ntedit.cpp:1157-1234; returns (raw_check, deleted_bytes).

        The accept rule (accept_del) is applied by the caller (run_trials)."""
        cfg = self.cfg
        tmp = dict(st)
        deleted = []
        for _ in range(num_deletions):
            deleted.append(self.get_character(tmp["t"], new_seq[tmp["tn"]], seq))
            tmp["t"], tmp["tn"] = self.increment(tmp["t"], tmp["tn"], new_seq)
        nxt = self.get_character(tmp["t"], new_seq[tmp["tn"]], seq) if tmp["tn"] < len(new_seq) else 0
        tfh, trh = nt.ntc64_changelast_i(fh, rh, cfg.k, draft_char, nxt)
        check_present = 0
        if self._probe_fr(tfh, trh):
            check_present += 1
        kk = 1
        while kk <= cfg.k - 2 and tmp["h"] < len(seq):
            ok, c_out, c_in = self.roll(tmp, seq, new_seq)
            if ok:
                tfh, trh = nt.ntc64_roll_i(tfh, trh, cfg.k, c_out, c_in)
                if kk % cfg.jump == 0 and self._probe_fr(tfh, trh):
                    check_present += 1
            kk += 1
        return check_present, bytes(deleted)

    def try_insertion(self, draft_char, index_char, combo_i, st, fh, rh, seq, new_seq):
        """One insertion-combo check (reference ntedit.cpp:1276-1331);
        returns the raw check_present count."""
        cfg = self.cfg
        combo = (
            MULTI_POSSIBLE_BASES[chr(index_char)][combo_i].encode()
            + bytes([draft_char])
        )
        tmp = dict(st)
        tfh, trh = nt.ntc64_changelast_i(fh, rh, cfg.k, draft_char, index_char)
        check_present = 0
        kk = 0
        while kk < len(combo) - 1 and tmp["h"] < len(seq):
            c_out = self.get_character(tmp["h"], new_seq[tmp["hn"]], seq)
            tfh, trh = nt.ntc64_roll_i(tfh, trh, cfg.k, c_out, combo[kk + 1])
            tmp["h"], tmp["hn"] = self.increment(tmp["h"], tmp["hn"], new_seq)
            if kk % cfg.jump == 0 and self._probe_fr(tfh, trh):
                check_present += 1
            kk += 1
        while kk < cfg.k - 1 and tmp["h"] < len(seq):
            ok, c_out, c_in = self.roll(tmp, seq, new_seq)
            if ok:
                tfh, trh = nt.ntc64_roll_i(tfh, trh, cfg.k, c_out, c_in)
                if kk % cfg.jump == 0 and self._probe_fr(tfh, trh):
                    check_present += 1
            kk += 1
        return check_present

    def sub_trial_scalar(self, ci, st, fh, rh, seq, new_seq):
        """One substitution gate+check (reference ntedit.cpp:1558-1619);
        returns (gate, raw check_present)."""
        cfg = self.cfg
        k = cfg.k
        n = len(seq)
        draft_char = _upper(self.get_character(st["t"], new_seq[st["tn"]], seq))
        sub_base = ord(cfg.bases_array[chr(draft_char)][ci])
        tfh, trh = nt.ntc64_changelast_i(fh, rh, k, draft_char, sub_base)
        gate = self._probe_fr(tfh, trh)
        if not (gate or cfg.mode == 2):
            return gate, 0
        tmp = dict(st)
        t_node = new_seq[st["tn"]]
        if t_node.node_type == 0:
            seq[st["t"]] = sub_base
        elif t_node.node_type == 1:
            t_node.c = sub_base
        check_present = 0
        kk = 0
        cfh, crh = tfh, trh
        while kk < k and tmp["h"] < n and tmp["t"] < n:
            ok, c_out, c_in = self.roll(tmp, seq, new_seq)
            if not ok:
                break
            cfh, crh = nt.ntc64_roll_i(cfh, crh, k, c_out, c_in)
            if kk % cfg.jump == 0 and self._probe_fr(cfh, crh):
                check_present += 1
            kk += 1
        if t_node.node_type == 0:
            seq[st["t"]] = draft_char
        elif t_node.node_type == 1:
            t_node.c = draft_char
        return gate, check_present


    # -- main per-contig loop -------------------------------------------------
    def correct(self, seq_in: bytes):
        """Polish one contig; returns (edited_bytes, substitution_records)."""
        cfg = self.cfg
        k = cfg.k
        seq = bytearray(seq_in)
        n = len(seq)
        subs_record = []
        new_seq = [Node(0, 0, n - 1, 0, 0)]
        st = {"h": find_first_accepted_kmer(0, seq, k), "t": 0, "hn": 0, "tn": 0}
        st["t"] = st["h"] + k - 1
        fh = rh = 0
        char_in = 0
        if st["h"] + k - 1 < n:
            fh, rh = nt.ntc64_base_i(seq, st["h"], k)
            char_in = seq[st["t"]]
        self.dirty_end = -1
        self.scan_from(st, fh, rh, char_in, seq, new_seq, subs_record)
        return self._render(seq, new_seq), subs_record

    def scan_from(self, st, fh, rh, char_in, seq, new_seq, subs_record,
                  exit_check=None, start_with_roll=False):
        """The reference outer editing loop (ntedit.cpp:1461-1760), resumable.

        Runs [detection -> trials -> edit -> roll] iterations from the given
        state.  With exit_check set, the loop yields control back ("clean")
        when exit_check(st) is true at the top of an iteration — used by the
        TPU engine to bound dirty-zone segments.  Returns
        (status, st, fh, rh, char_in) with status "end" (contig exhausted)
        or "clean" (exit_check fired).
        """
        cfg = self.cfg
        k = cfg.k
        n = len(seq)
        first = not start_with_roll
        while True:
            if not first:
                # roll and skip over non-ATGC k-mers (reference :1739-1759)
                target = -1
                alive = True
                while True:
                    ok, c_out, c_in = self.roll(st, seq, new_seq)
                    if ok:
                        if not is_accepted(_upper(c_in)):
                            target = st["t"] + k
                        fh, rh = nt.ntc64_roll_i(fh, rh, k, c_out, c_in)
                        char_in = c_in
                    else:
                        alive = False
                        break
                    if not (target >= 0 and st["t"] != target):
                        break
                if not alive:
                    return "end", st, fh, rh, char_in
            first = False
            if st["h"] + k - 1 >= n:
                return "end", st, fh, rh, char_in
            if exit_check is not None and exit_check(st):
                return "clean", st, fh, rh, char_in
            missing = cfg.snv or not self._probe_fr_primary(fh, rh)
            if missing:
                tmp = dict(st)
                tfh, trh = fh, rh
                draft_char = _upper(char_in)
                check_missing = 0
                check_there = 0
                do_not_fix = False
                kk = 0
                while kk < k and tmp["h"] < n:
                    ok, c_out, c_in = self.roll(tmp, seq, new_seq)
                    if ok:
                        tfh, trh = nt.ntc64_roll_i(tfh, trh, k, c_out, c_in)
                        if not is_accepted(_upper(c_in)):
                            do_not_fix = True
                            break
                        probe = self._probe_fr_primary(tfh, trh)
                        if kk % cfg.jump == 0 and not probe:
                            check_missing += 1
                        elif is_atgc(draft_char) and kk % cfg.jump == 0 and probe:
                            check_there += 1
                    else:
                        do_not_fix = True
                        break
                    kk += 1

                if cfg.snv or (not do_not_fix and accept_missing(cfg, check_missing)):
                    provider = _ScalarProvider(
                        self, draft_char, st, fh, rh, seq, new_seq
                    )
                    best = run_trials(cfg, draft_char, provider, check_there)
                    fh, rh, char_in = self._make_edit(
                        draft_char, best, subs_record, st, fh, rh, seq, new_seq,
                        char_in,
                    )

    # -- edit application -----------------------------------------------------
    def _make_edit(self, draft_char, best, subs_record, st, fh, rh, seq, new_seq, char_in):
        """Reference makeEdit (ntedit.cpp:972-1154)."""
        cfg = self.cfg
        k = cfg.k
        et = best["edit_type"]
        t_node = new_seq[st["tn"]]
        if et == 1:
            self.n_subs += 1
            if t_node.node_type == 0:
                seq[st["t"]] = best["sub_base"]
                rec = {
                    "pos": st["t"],
                    "draft_char": draft_char,
                    "sub_base": best["sub_base"],
                    "num_support": best["num_support"],
                }
                if best["altsupp1"] and best["altbase1"] != best["sub_base"]:
                    rec["altbase1"], rec["altsupp1"] = best["altbase1"], best["altsupp1"]
                if best["altsupp2"] and best["altbase2"] != best["altbase1"]:
                    rec["altbase2"], rec["altsupp2"] = best["altbase2"], best["altsupp2"]
                if best["altsupp3"] and best["altbase3"] != best["altbase2"]:
                    rec["altbase3"], rec["altsupp3"] = best["altbase3"], best["altsupp3"]
                subs_record.append(rec)
            elif t_node.node_type == 1:
                t_node.c = best["sub_base"]
            fh, rh = nt.ntc64_changelast_i(fh, rh, k, draft_char, best["sub_base"])
            char_in = best["sub_base"]
        elif et == 2:
            skipped_repeat = False
            prev = self.get_prev_insertion(st["t"], st["tn"], new_seq)
            indel = best["indel"].decode()
            if len(prev) + len(indel) >= k:
                if is_repeat_insertion(prev) or len(prev) + len(indel) >= cfg.insertion_cap:
                    self._rollback_insertion(st, len(prev), new_seq)
                    kmer = self.find_accepted_kmer(st, seq, new_seq)
                    if kmer:
                        fh, rh = nt.ntc64_base_i(kmer, 0, k)
                        char_in = kmer[-1]
                    skipped_repeat = True
                else:
                    prev_l = list(prev)
                    for w in range(len(indel)):
                        prev_l.insert(0, chr(rc(ord(indel[w]))))
                        if is_repeat_insertion("".join(prev_l)):
                            self._rollback_insertion(st, len(prev_l) - w, new_seq)
                            kmer = self.find_accepted_kmer(st, seq, new_seq)
                            if kmer:
                                fh, rh = nt.ntc64_base_i(kmer, 0, k)
                                char_in = kmer[-1]
                            skipped_repeat = True
            if not skipped_repeat:
                self.n_ins += 1
                st["tn"] = self.make_insertion(
                    st["tn"], st["t"], indel, best["num_support"], new_seq
                )
                fh, rh = nt.ntc64_changelast_i(fh, rh, k, draft_char, best["indel"][0])
                char_in = best["indel"][0]
        elif et == 3:
            self.n_dels += 1
            st["tn"], st["t"] = self.make_deletion(
                st["tn"], st["t"], len(best["indel"]), best["num_support"], new_seq
            )
            nxt = self.get_character(st["t"], new_seq[st["tn"]], seq)
            fh, rh = nt.ntc64_changelast_i(fh, rh, k, draft_char, nxt)
            char_in = nxt
        elif et == 0:
            self.n_nofix += 1
            if cfg.mask:
                self.n_masked += 1
                if t_node.node_type == 0:
                    seq[st["t"]] = _lower(draft_char)
                elif t_node.node_type == 1:
                    t_node.c = _lower(draft_char)
                fh, rh = nt.ntc64_changelast_i(fh, rh, k, draft_char, _lower(draft_char))
                char_in = _lower(draft_char)
        if et != 0 or cfg.mask:
            # watermark of the highest draft position whose content the edit
            # may have touched (used by the TPU engine's segment-exit rule)
            self.dirty_end = max(getattr(self, "dirty_end", -1), st["t"] + 1)
        return fh, rh, char_in

    @staticmethod
    def _rollback_insertion(st, count, new_seq):
        """Remove the previous `count` literal nodes (reference :1043-1056,
        1074-1088): shift following live nodes down over them."""
        j = 1
        if new_seq[st["tn"]].node_type == 0 and st["t"] == new_seq[st["tn"]].s_pos:
            j = 0
        for i in range(count, 0, -1):
            if st["tn"] + j < len(new_seq) and new_seq[st["tn"] + j].node_type != -1:
                new_seq[st["tn"] - i] = new_seq[st["tn"] + j]
                new_seq[st["tn"] + j] = Node()
                j += 1
            else:
                new_seq[st["tn"] - i].node_type = -1

    @staticmethod
    def _render(seq, new_seq) -> bytes:
        """Reference writeEditsToFile's sequence output (ntedit.cpp:780-936)."""
        out = bytearray()
        for node in new_seq:
            if node.node_type == -1:
                break
            if node.node_type == 0:
                out += seq[node.s_pos : node.e_pos + 1]
            elif node.node_type == 1:
                out.append(node.c)
        return bytes(out)


class _ScalarProvider:
    """Trial provider backed by the editor's live scalar probes."""

    def __init__(self, ed: "_Editor", draft_char, st, fh, rh, seq, new_seq):
        self.ed = ed
        self.draft_char = draft_char
        self.st = st
        self.fh = fh
        self.rh = rh
        self.seq = seq
        self.new_seq = new_seq
        self._del_cache: dict[int, tuple[int, bytes]] = {}

    def sub_trial(self, ci):
        return self.ed.sub_trial_scalar(
            ci, self.st, self.fh, self.rh, self.seq, self.new_seq
        )

    def ins_trial(self, ci, i):
        cfg = self.ed.cfg
        index_char = ord(cfg.bases_array[chr(self.draft_char)][ci])
        return self.ed.try_insertion(
            self.draft_char, index_char, i, self.st, self.fh, self.rh,
            self.seq, self.new_seq,
        )

    def _del(self, d):
        if d not in self._del_cache:
            self._del_cache[d] = self.ed.try_deletion(
                self.draft_char, d, self.st, self.fh, self.rh, self.seq, self.new_seq
            )
        return self._del_cache[d]

    def del_trial(self, d):
        return self._del(d)[0]

    def deleted_bases(self, d):
        return self._del(d)[1]


def polish_contig(seq: bytes, bloom, cfg: Config, bloomrep=None):
    """Polish a single contig; returns (edited_seq, subs_records, stats)."""
    ed = _Editor(cfg, bloom, bloomrep)
    if len(seq) < cfg.min_contig_len:
        return bytes(seq), [], ed
    edited, recs = ed.correct(seq)
    return edited, recs, ed
