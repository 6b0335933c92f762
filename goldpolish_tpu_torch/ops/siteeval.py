"""Batched candidate-edit evaluation for the two-phase ntEdit engine.

For each "hot site" (a detection-eligible window whose draft k-mer misses the
Bloom filter and whose check_missing passes), the reference serially tries
substitutions, insertion combos and deletions, verifying each with a
jump-subsampled chain of k-mer probes (reference: subprojects/ntedit/
ntedit.cpp:1558-1713, 1276-1397, 1157-1234).  Here all candidates for a batch
of sites are evaluated at once:

  * each candidate's probe chain equals the k-window hashes of a small
    *patched* local sequence (window prefix + candidate bases + draft
    suffix) at statically known window offsets,
  * patched buffers are materialized as fixed-shape tensors
    [sites, cand, L] and hashed with the closed-form ntHash (prefix-XOR),
  * probes are batched Bloom lookups; supports are popcounts over the
    statically-known checked-window sets.

The patch layouts / checked-window sets are derived once per (k, jump,
max_ins, max_del) in `SiteTables`.  The NumPy and JAX evaluators share those
tables and produce identical supports (pinned by tests against the oracle
editor's per-site trials).

Patch geometry (p = w + k - 1 is the site's tail position):
  sub:   prefix(k-1) + sub_base + s[p+1 : p+k+1]            L = 2k
         checked windows j = kk+1, kk in {0,jump,..} ∩ [0,k-1]; gate = window 0
  ins:   prefix(k-1) + combo(m) + draft + s[p+1 : p+k]       L = 2k+MAXI
         checked windows j = kk+1, kk in {0,jump,..} ∩ [0,k-2]
  del d: prefix(k-1) + s[p+d : p+d+k]                        L = 2k-1
         checked windows j = 0 and j = kk, kk in {jump,..} ∩ [jump, k-2];
         probe at window j valid iff p + d + j + 1 <= n-1 (j>0), j=0 always
         (validity bounds from the reference's roll() end-of-contig checks).

Port counterpart: goldpolish_tpu/ops/siteeval.py, copied with only the imports renamed
(this package must import without jax).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from . import nthash as nt
from .nthash import RC_SEED_TAB, SEED_TAB, SROL_PERIOD

# candidate sub bases, padded to 4 lanes (index into this table by draft char)
from ..polish.ntedit_oracle import MULTI_POSSIBLE_BASES, NUM_TRIES, POLISH_BASES


@dataclass(frozen=True)
class SiteTables:
    """Static per-(k, jump, max_ins, max_del) layout tables."""

    k: int
    jump: int
    max_ins: int
    max_del: int
    # checked window offsets
    j_sub: np.ndarray  # [n_chk_sub]
    j_ins: np.ndarray  # [n_chk_ins]
    j_del: np.ndarray  # [n_chk_del] (includes 0)
    # insertion combo statics, for combos of MULTI_POSSIBLE_BASES order:
    # combo_codes[4, C, max_ins] uint8 (0-padded), combo_len[C]
    combo_codes: np.ndarray
    combo_len: np.ndarray
    n_combos: int
    # per-draft-char substitution candidates, [n_chars, 4] uint8 (0-padded)
    sub_cand: np.ndarray  # indexed by raw byte of (uppercased) draft char
    sub_cand_n: np.ndarray  # [256]
    L_sub: int
    L_ins: int
    L_del: int

    @property
    def suffix_len(self) -> int:
        """Draft bases gathered after p: s[p+1 : p+1+suffix_len].  The
        deletion patches read k + max_del - 1 of them, the insertion
        patches' gathers up to offset k + max_ins - 2 (a combo of one base
        at the patch's last position), so both fit whatever (max_ins,
        max_del) is.  The JAX package's k + max_del falls short when
        max_ins > max_del + 1 (its gather then fills the bytes past the
        end; they lie past every checked window)."""
        return self.k + max(self.max_del, self.max_ins - 1)


@lru_cache(maxsize=8)
def make_tables(k: int, jump: int = 3, max_ins: int = 5, max_del: int = 5,
                snv: bool = False) -> SiteTables:
    j_sub = np.array([kk + 1 for kk in range(0, k) if kk % jump == 0], np.int32)
    j_ins = np.array([kk + 1 for kk in range(0, k - 1) if kk % jump == 0], np.int32)
    j_del = np.array(
        [0] + [kk for kk in range(1, k - 1) if kk % jump == 0], np.int32
    )
    n_combos = NUM_TRIES[max_ins]
    combo_codes = np.zeros((4, n_combos, max_ins), np.uint8)
    combo_len = np.zeros(n_combos, np.int32)
    for bi, b in enumerate("ACGT"):
        for ci, combo in enumerate(MULTI_POSSIBLE_BASES[b][:n_combos]):
            combo_codes[bi, ci, : len(combo)] = np.frombuffer(
                combo.encode(), np.uint8
            )
            combo_len[ci] = len(combo)
    sub_cand = np.zeros((256, 4), np.uint8)
    sub_cand_n = np.zeros(256, np.int32)
    # SNV mode swaps the candidate sets (reference ntedit.cpp:158-194
    # snv_bases_array): every draft char trials all four bases
    from ..polish.ntedit_oracle import SNV_BASES

    base_sets = SNV_BASES if snv else POLISH_BASES
    for c, bases in base_sets.items():
        sub_cand[ord(c), : len(bases)] = np.frombuffer(bases.encode(), np.uint8)
        sub_cand_n[ord(c)] = len(bases)
    return SiteTables(
        k=k, jump=jump, max_ins=max_ins, max_del=max_del,
        j_sub=j_sub, j_ins=j_ins, j_del=j_del,
        combo_codes=combo_codes, combo_len=combo_len, n_combos=n_combos,
        sub_cand=sub_cand, sub_cand_n=sub_cand_n,
        L_sub=2 * k, L_ins=2 * k + max_ins, L_del=2 * k - 1,
    )


# --- patch construction (NumPy; shapes shared with the JAX path) -------------
def gather_site_context(seq_codes: np.ndarray, sites_w: np.ndarray, tables: SiteTables):
    """Per-site local context from a contig.

    Returns (prefix[S,k-1], draft[S], suffix[S,k+max_del], suffix_valid[S])
    where suffix is zero-padded past the contig end and suffix_valid is the
    count of valid suffix bases.  draft is the *uppercased* tail base
    (reference ntedit.cpp:1480).
    """
    n = len(seq_codes)
    k = tables.k
    S = len(sites_w)
    p = sites_w + k - 1
    pref_idx = sites_w[:, None] + np.arange(k - 1)[None, :]
    prefix = seq_codes[pref_idx]
    draft = seq_codes[p]
    draft = np.where((draft >= 97) & (draft <= 122), draft - 32, draft).astype(np.uint8)
    suf_idx = p[:, None] + 1 + np.arange(tables.suffix_len)[None, :]
    valid = suf_idx < n
    suffix = np.where(valid, seq_codes[np.minimum(suf_idx, n - 1)], 0).astype(np.uint8)
    return prefix, draft, suffix, valid.sum(axis=1).astype(np.int32)


def build_sub_patches(prefix, draft, suffix, tables: SiteTables):
    """[S, 4, L_sub] patched buffers for substitution candidates."""
    k = tables.k
    S = prefix.shape[0]
    cand = tables.sub_cand[draft]  # [S,4]
    out = np.zeros((S, 4, tables.L_sub), np.uint8)
    out[:, :, : k - 1] = prefix[:, None, :]
    out[:, :, k - 1] = cand
    out[:, :, k:] = suffix[:, None, : k]
    return out, cand


def build_ins_patches(prefix, draft, suffix, tables: SiteTables, n_combos: int):
    """[S, 4, C, L_ins] patched buffers for insertion candidates.

    Candidate (sub_lane b, combo c): prefix + combo(with first char forced to
    the sub lane's base) + draft + suffix.  The reference's combos for index
    char X are exactly the A-combos with the first char replaced, so we use
    combo_codes[lane] directly; lanes beyond the draft's candidate count are
    masked by the caller.  Combo lanes use the per-base tables, but the
    candidate *index char* for IUPAC drafts is the sub candidate base, which
    is always one of ACGT.
    """
    k, MI = tables.k, tables.max_ins
    S = prefix.shape[0]
    C = n_combos
    cand = tables.sub_cand[draft]  # [S,4] index chars
    # map each candidate base to its combo table row (A,C,G,T -> 0..3)
    base_row = np.zeros(256, np.int64)
    for bi, b in enumerate(b"ACGT"):
        base_row[b] = bi
    rows = base_row[cand]  # [S,4]
    combos = tables.combo_codes[rows][:, :, :C, :]  # [S,4,C,MI]
    clen = tables.combo_len[:C]  # [C]
    L = tables.L_ins
    out = np.zeros((S, 4, C, L), np.uint8)
    out[:, :, :, : k - 1] = prefix[:, None, None, :]
    # positions q >= k-1: combo chars, then draft, then suffix
    q = np.arange(k - 1, L)
    rel = q - (k - 1)  # 0..k+MI-1... relative offset
    # for each combo c: rel < clen[c] -> combo; rel == clen[c] -> draft;
    # rel > clen[c] -> suffix[rel - clen[c] - 1]
    rel2 = rel[None, :]  # [1, L-k+1]
    cl = clen[:, None]  # [C,1]
    is_combo = rel2 < cl  # [C, L-k+1]
    is_draft = rel2 == cl
    suf_off = np.maximum(rel2 - cl - 1, 0)  # [C, L-k+1]
    combo_vals = np.take_along_axis(
        combos, np.minimum(rel2, MI - 1)[None, None, :, :].repeat(S, 0).repeat(4, 1),
        axis=3,
    )  # [S,4,C,L-k+1]
    suf_vals = suffix[:, None, None, :][
        np.arange(S)[:, None, None, None],
        np.zeros((1, 4, 1, 1), np.int64),
        np.zeros((1, 1, C, 1), np.int64),
        suf_off[None, None, :, :],
    ]  # [S,4,C,L-k+1]
    dr = draft[:, None, None, None]
    out[:, :, :, k - 1 :] = np.where(
        is_combo[None, None], combo_vals, np.where(is_draft[None, None], dr, suf_vals)
    )
    return out


def build_del_patches(prefix, suffix, tables: SiteTables):
    """[S, max_del, L_del] patched buffers for deletion candidates d=1..max_del."""
    k, MD = tables.k, tables.max_del
    S = prefix.shape[0]
    out = np.zeros((S, MD, tables.L_del), np.uint8)
    out[:, :, : k - 1] = prefix[:, None, :]
    # suffix slice for d: suffix[d-1 : d-1+k]
    idx = (np.arange(MD)[:, None] + np.arange(k)[None, :])  # [MD,k] = d-1..d-1+k-1
    out[:, :, k - 1 :] = suffix[:, idx]
    return out


# --- hashing + probing (NumPy backend) ---------------------------------------
def window_hashes_np(patches: np.ndarray, k: int, h: int, j_idx: np.ndarray):
    """Canonical multi-hashes of the checked windows of patched buffers.

    patches: uint8[..., L]; returns uint64[..., len(j_idx), h].
    """
    f = _batch_forward_np(patches, k)
    r = _batch_reverse_np(patches, k)
    base = (f + r)[..., j_idx]
    return nt.multi_hashes(base, k, h)


def _batch_forward_np(codes: np.ndarray, k: int) -> np.ndarray:
    n = codes.shape[-1]
    idx = np.arange(n, dtype=np.int64)
    a = nt.srol_n(SEED_TAB[codes], (-idx) % SROL_PERIOD)
    p = np.bitwise_xor.accumulate(a, axis=-1)
    w = p[..., k - 1 :].copy()
    w[..., 1:] ^= p[..., : n - k]
    wi = np.arange(n - k + 1, dtype=np.int64)
    return nt.srol_n(w, (wi + k - 1) % SROL_PERIOD)


def _batch_reverse_np(codes: np.ndarray, k: int) -> np.ndarray:
    n = codes.shape[-1]
    idx = np.arange(n, dtype=np.int64)
    b = nt.srol_n(RC_SEED_TAB[codes], idx % SROL_PERIOD)
    q = np.bitwise_xor.accumulate(b, axis=-1)
    w = q[..., k - 1 :].copy()
    w[..., 1:] ^= q[..., : n - k]
    wi = np.arange(n - k + 1, dtype=np.int64)
    return nt.srol_n(w, (-wi) % SROL_PERIOD)


@dataclass
class SiteSupports:
    """Per-site candidate supports, same layout from both backends."""

    sub_cand: np.ndarray      # [S,4] candidate bases (0-padded)
    gate: np.ndarray          # [S,4] bool: changelast k-mer in BF
    sub_support: np.ndarray   # [S,4] int
    ins_support: np.ndarray   # [S,4,C] int (C = evaluated combo count)
    del_support: np.ndarray   # [S,max_del] int
    n_combos: int


def eval_sites_np(seq_codes: np.ndarray, sites_w: np.ndarray, bf, tables: SiteTables,
                  h: int, n_combos: int | None = None) -> SiteSupports:
    """NumPy evaluator: all candidate supports for a batch of sites.

    `bf` is a host BloomFilter (ops.bloom).  Exactness notes:
      * sub probes: windows j_sub, gate = window 0,
      * ins probes: windows j_ins,
      * del probes: windows j_del with end-of-contig validity masks.
    """
    k = tables.k
    C = tables.n_combos if n_combos is None else n_combos
    prefix, draft, suffix, suf_valid = gather_site_context(seq_codes, sites_w, tables)
    S = len(sites_w)
    n = len(seq_codes)
    p = sites_w + k - 1

    sub_patches, cand = build_sub_patches(prefix, draft, suffix, tables)
    sub_h = window_hashes_np(sub_patches, k, h, np.concatenate(([0], tables.j_sub)))
    sub_pr = bf.contains(sub_h)  # [S,4,1+n_chk]
    gate = sub_pr[..., 0]
    sub_support = sub_pr[..., 1:].sum(axis=-1).astype(np.int32)

    ins_patches = build_ins_patches(prefix, draft, suffix, tables, C)
    ins_h = window_hashes_np(ins_patches, k, h, tables.j_ins)
    ins_support = bf.contains(ins_h).sum(axis=-1).astype(np.int32)

    del_patches = build_del_patches(prefix, suffix, tables)
    del_h = window_hashes_np(del_patches, k, h, tables.j_del)
    del_pr = bf.contains(del_h)  # [S,MD,n_chk_del]
    # validity: j=0 needs p+d <= n-1 (read of s[p+d]); j>0 needs p+d+j+1 <= n-1
    d = np.arange(1, tables.max_del + 1)[None, :, None]
    jj = tables.j_del[None, None, :]
    valid = np.where(
        jj == 0, (p[:, None, None] + d) <= n - 1,
        (p[:, None, None] + d + jj + 1) <= n - 1,
    )
    del_support = (del_pr & valid).sum(axis=-1).astype(np.int32)

    return SiteSupports(
        sub_cand=cand, gate=gate, sub_support=sub_support,
        ins_support=ins_support, del_support=del_support, n_combos=C,
    )
