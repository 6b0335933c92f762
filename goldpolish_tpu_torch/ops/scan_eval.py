"""Fused phase-A: dense scan + hot-site detection + candidate trial tables.

Port counterpart: goldpolish_tpu/ops/scan_eval.py (K2: `build_fused` ->
`run` :235-522, `FusedEval` :525).  One device call per scan chunk computes
everything the editor's host walk needs from phase A (reference: the
per-position probe loop and the per-site trial loop,
subprojects/ntedit/ntedit.cpp:1414-1713):

  1. presence bits of every window (the dense scan, as ops/scan_conv),
  2. the detection masks (clean/eligible/check_missing -> hot) and the
     predicted visited hot sites (cluster heads),
  3. for up to S heads, the candidate-trial support tables the walk's
     decision loop consumes: substitution gates + supports, deletion
     supports, and the needing lane's insertion-combo supports.

The host walker (native `gp_polish_contig`) replays the reference decision
loop from the tables (zero Bloom probes at covered sites) and probes
natively at any site they do not cover: prediction misses cost time, never
correctness.

Hash construction is XOR-delta, as in the JAX program: every candidate
window hash derives from the scan's (fh, rh) (substitutions), from short
rolled chains per site (deletions, per-length insertion references), or
from a constant delta table (all insertion combos).  The insertion scan is
two-stage: an h1-only prescreen bounds each combo's support from above, and
only the first T_SURVIVORS combos whose bound passes get exact full-h
probes.

`scan_eval` launches the four kernels of csrc/scan_eval.cu (kernel 4: a
tile pass, compaction, sites, insertions) for CUDA tensors and runs
`scan_eval_reference`, the plain torch version on int64 lanes
(ops/u64.py), for CPU tensors.  Two deliberate differences from the JAX
program, both toward the host filter that the walker probes (as kernel 2,
ops/scan_conv.py): the window hashes give bytes 1, 3, 4 and 7 their ntHash
seeds, and every filter size is probed at the full 64-bit `hash % bits`
(the JAX `_probe_idx` :153-156 truncates the bit index to 32 bits, which a
filter of 2^32 bits or more would feel).  There is no `probe="mxu"` /
`interpret` choice: one direct-load probe serves every filter size.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import nthash as nt
from . import scan_conv
from . import u64
from .cuda_build import LaunchCounter, check, lib, require_cuda
from .siteeval import SiteTables, make_tables

T_SURVIVORS = 48  # max full-h insertion combos per site (overflow -> host)


# --- constant tables (numpy) --------------------------------------------------
@functools.lru_cache(maxsize=8)
def _sub_delta_tables():
    """Changelast seed deltas for substitution candidates.

    D_F[draft, lane] = fseed[draft] ^ fseed[cand];
    D_R[draft, lane] = rcseed[draft] ^ rcseed[cand]  (pre-rotation).
    Draft chars index by raw byte (uppercased by the caller); lanes by the
    sub_cand table."""
    t = make_tables(32)  # sub_cand is k-independent
    # the seed tables index c & 7 for EVERY byte (non-ACGT included)
    fwd = nt.SEED_TAB.copy()
    rc = nt.RC_SEED_TAB.copy()
    cand = t.sub_cand  # [256, 4]
    d_f = fwd[np.arange(256)][:, None] ^ fwd[cand]
    d_r = rc[np.arange(256)][:, None] ^ rc[cand]
    return d_f.astype(np.uint64), d_r.astype(np.uint64)


@functools.lru_cache(maxsize=8)
def _ins_delta_tables(k: int, jump: int, max_ins: int):
    """Constant insertion-combo deltas D_F/D_R [C, T].

    Probe point t sits after s = j_ins[t] rolls; the window then covers
    patch[s .. s+k-1] with combo char j (1 <= j < L) at patch pos k-1+j.
    fh contribution of pos q is srol^{s+k-1-q}, rh contribution srol^{q-s}:
      D_F[c, t] = XOR_{1<=j<L, j<=s} srol^{s-j}(fseed[cc_j] ^ fseed['A'])
      D_R[c, t] = XOR_{1<=j<L, j<=s} srol^{k-1+j-s}(rcseed[cc_j] ^ rcseed['A'])
    (combo chars past position 0 are shared across index-char rows)."""
    t = make_tables(k, jump, max_ins, 5)
    C = t.n_combos
    s_pts = t.j_ins.astype(np.int64)  # roll counts at probe points
    T = len(s_pts)
    d_f = np.zeros((C, T), np.uint64)
    d_r = np.zeros((C, T), np.uint64)
    fa = np.uint64(nt.SEED_TAB[ord("A")])
    ra = np.uint64(nt.RC_SEED_TAB[ord("A")])
    codes = t.combo_codes[0]  # rows share chars past pos 0
    for c in range(C):
        L = int(t.combo_len[c])
        for ti, s in enumerate(s_pts):
            acc_f = np.uint64(0)
            acc_r = np.uint64(0)
            for j in range(1, L):
                if j > s:
                    continue
                ch = int(codes[c, j])
                fd = np.uint64(nt.SEED_TAB[ch]) ^ fa
                rd = np.uint64(nt.RC_SEED_TAB[ch]) ^ ra
                acc_f ^= nt.srol_n(fd, int(s - j) % nt.SROL_PERIOD)
                acc_r ^= nt.srol_n(rd, int(k - 1 + j - s) % nt.SROL_PERIOD)
            d_f[c, ti] = acc_f
            d_r[c, ti] = acc_r
    return d_f, d_r, t.combo_len.astype(np.int32).copy()


@dataclass
class EvalConfig:
    """Static decision parameters of the fused eval (from the editor
    Config, polish/ntedit_oracle.py)."""

    k: int
    h: int
    jump: int
    max_ins: int
    max_del: int
    thr_edit: float
    thr_missing: float
    s_max: int = 2048
    # insertion-stage site budget: the [s_ins, C, T] combo prescreen is the
    # dominant probe volume, and the walker only reads ins tables at sites
    # whose needing lane exists.  0 -> max(64, s_max/4).  Needing sites
    # beyond the budget get ins_ok=0 (host redo — cost, never correctness).
    s_ins: int = 0

    def resolved_s_ins(self) -> int:
        return self.s_ins or max(64, self.s_max // 4)

    def key(self):
        return (self.k, self.h, self.jump, self.max_ins, self.max_del,
                float(np.float32(self.thr_edit)),
                float(np.float32(self.thr_missing)), self.s_max,
                self.resolved_s_ins())


def _accepted_lut() -> np.ndarray:
    """is_accepted(upper(c)) for every raw byte (ATGC + IUPAC RYSWKMBDHV;
    only bytes 97..122 are upper-cased)."""
    lut = np.zeros(256, np.uint8)
    for ch in b"ATGCRYSWKMBDHV":
        lut[ch] = lut[ch + 32] = 1
    return lut


@dataclass(frozen=True)
class _Consts:
    """The constant tables on one device.  u64 holds, as int64:
    fseed[256] | rseed[256] | D_F sub [256*4] | D_R sub [256*4] |
    D_F ins [C*T] | D_R ins [C*T]; u8 holds sub_cand[256*4] |
    accepted[256] | combo_len[C] — the layout csrc/scan_eval.cu reads."""

    u64: torch.Tensor
    u8: torch.Tensor
    C: int
    T: int

    def part(self, i: int) -> torch.Tensor:
        sizes = [256, 256, 1024, 1024, self.C * self.T, self.C * self.T]
        a = sum(sizes[:i])
        return self.u64[a : a + sizes[i]]


@functools.lru_cache(maxsize=32)
def _device_consts(k: int, jump: int, max_ins: int, max_del: int,
                   device: str) -> _Consts:
    t = make_tables(k, jump, max_ins, max_del)
    d_f_sub, d_r_sub = _sub_delta_tables()
    d_f_ins, d_r_ins, combo_len = _ins_delta_tables(k, jump, max_ins)
    wide = np.concatenate([
        nt.SEED_TAB, nt.RC_SEED_TAB, d_f_sub.ravel(), d_r_sub.ravel(),
        d_f_ins.ravel(), d_r_ins.ravel(),
    ]).astype(np.uint64)
    narrow = np.concatenate([
        t.sub_cand.ravel(), _accepted_lut(), combo_len.astype(np.uint8),
    ]).astype(np.uint8)
    return _Consts(u64.from_u64(wide).to(device),
                   torch.from_numpy(narrow).to(device),
                   t.n_combos, len(t.j_ins))


# --- the plain torch version ---------------------------------------------------
def _changelast(fh, rh, k: int, f_out, f_in, r_out, r_in):
    """ntc64_changelast on int64 lanes with pre-gathered seed values."""
    fh2 = fh ^ f_out ^ f_in
    rh2 = u64.sror(u64.srol(rh) ^ u64.srol_n(r_out ^ r_in, k % nt.SROL_PERIOD))
    return fh2, rh2


def _roll(fh, rh, k: int, f_out, f_in, r_out, r_in):
    """One ntHash roll with pre-gathered seed values."""
    fh2 = u64.srol(fh) ^ f_in ^ u64.srol_n(f_out, k % nt.SROL_PERIOD)
    rh2 = u64.sror(rh ^ u64.srol_n(r_in, k % nt.SROL_PERIOD) ^ r_out)
    return fh2, rh2


def _first_true(mask: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the first n True entries of a 1-D mask, ascending."""
    return torch.nonzero(mask).flatten()[:n]


class EvalOutputs(tuple):
    """The nine outputs (a tuple); `scratch` holds the device scratch the
    kernels used, kept alive as long as the outputs are."""

    scratch = None


def scan_eval_reference(words: torch.Tensor, bits: int, h: int,
                        codes: torch.Tensor, cfg: EvalConfig,
                        tables: SiteTables) -> EvalOutputs:
    """Plain torch version of the fused eval (any device); build_fused's
    `run` (goldpolish_tpu/ops/scan_eval.py:300-520) step by step."""
    scan_eval_reference.calls.add()
    _check_args(bits, h, codes, cfg, tables)
    dev = codes.device
    R, L = codes.shape
    k, jump = cfg.k, cfg.jump
    S, MD, MI = cfg.s_max, cfg.max_del, cfg.max_ins
    SI = cfg.resolved_s_ins()
    C = tables.n_combos
    nw = L - k + 1
    thr_edit = float(np.float32(cfg.thr_edit))
    thr_missing = float(np.float32(cfg.thr_missing))
    cst = _device_consts(k, jump, MI, MD, str(dev))
    fseed, rseed = cst.part(0), cst.part(1)
    d_f_sub, d_r_sub = cst.part(2).view(256, 4), cst.part(3).view(256, 4)
    d_f_ins, d_r_ins = cst.part(4).view(C, cst.T), cst.part(5).view(C, cst.T)
    narrow = cst.u8.to(torch.int64)
    sub_cand = narrow[:1024].view(256, 4)
    accepted_lut = narrow[1024:1280].bool()
    combo_len = narrow[1280 : 1280 + C]
    words = words.to(torch.int64)
    c64 = codes.to(torch.int64)

    def probe_full(base):
        return scan_conv.probe_full_reference(words, bits, base, k, h)

    fh, rh = scan_conv.strand_hashes_reference(codes, k)  # [R, nw]
    present = probe_full(fh + rh)

    # --- detection masks (polish/ntedit_gpu._masks semantics, per row)
    badc = torch.cumsum((~accepted_lut[c64]).to(torch.int32), dim=1)
    badc_pad = torch.nn.functional.pad(badc, (1, 0))
    clean = (badc[:, k - 1 :] - badc_pad[:, :nw]) == 0
    miss = ~present
    cm = torch.zeros(R, nw, dtype=torch.int32, device=dev)
    for kk in range(0, k, jump):
        off = kk + 1
        if off < nw:
            cm[:, : nw - off] += miss[:, off:].to(torch.int32)
    eligible = torch.zeros(R, nw, dtype=torch.bool, device=dev)
    lim = L - 2 * k
    if lim >= 0:
        eligible[:, : lim + 1] = clean[:, k : k + lim + 1]
    hot = clean & miss & eligible & (cm.to(torch.float32) >= thr_missing)

    # --- cluster heads: first hot window with no hot in [w-k+1, w-1]
    hs_pad = torch.nn.functional.pad(torch.cumsum(hot.to(torch.int32), dim=1), (k, 0))
    prev_any = (hs_pad[:, k - 1 : k - 1 + nw] - hs_pad[:, :nw]) > 0
    head = (hot & ~prev_any).reshape(-1)
    n_sites = head.sum().to(torch.int32)
    found = _first_true(head, S).to(torch.int32)
    site = torch.full((S,), -1, dtype=torch.int32, device=dev)
    site[: len(found)] = found
    sidx = site.clamp(min=0).to(torch.int64)  # pad rows evaluate window 0
    r_i = sidx // nw
    w_safe = (sidx % nw).clamp(max=nw - 1)
    p_i = (w_safe + k - 1).clamp(max=L - 1)

    draft = c64[r_i, p_i]
    draft = torch.where((draft >= 97) & (draft <= 122), draft - 32, draft)
    cand = sub_cand[draft]  # [S, 4]
    fh0 = fh[r_i, w_safe]
    rh0 = rh[r_i, w_safe]

    # --- substitutions: gate (j=0) + supports over j_sub
    df, dr = d_f_sub[draft], d_r_sub[draft]  # [S, 4]
    sub_bases = []
    for j in [0] + [int(x) for x in tables.j_sub]:
        wj = (w_safe + j).clamp(max=nw - 1)
        fj = fh[r_i, wj][:, None] ^ u64.srol_n(df, j % nt.SROL_PERIOD)
        rj = rh[r_i, wj][:, None] ^ u64.srol_n(dr, (k - 1 - j) % nt.SROL_PERIOD)
        sub_bases.append(fj + rj)
    sub_pres = probe_full(torch.stack(sub_bases))  # [1+nj, S, 4]
    gate = sub_pres[0]
    sub_sup = sub_pres[1:].sum(dim=0)

    # --- deletions: MD rolled chains from changelast(draft -> s[p+d])
    f_draft, r_draft = fseed[draft], rseed[draft]
    d_off = torch.arange(1, MD + 1, device=dev)
    nxt = c64[r_i[:, None], (p_i[:, None] + d_off).clamp(max=L - 1)]  # [S, MD]
    fh_d, rh_d = _changelast(fh0[:, None], rh0[:, None], k, f_draft[:, None],
                             fseed[nxt], r_draft[:, None], rseed[nxt])
    del_bases = [fh_d + rh_d]
    for kk in range(1, k - 1):
        c_out = c64[r_i, (w_safe + kk - 1).clamp(max=L - 1)]
        c_in = c64[r_i[:, None], (p_i[:, None] + d_off + kk).clamp(max=L - 1)]
        fh_d, rh_d = _roll(fh_d, rh_d, k, fseed[c_out][:, None], fseed[c_in],
                           rseed[c_out][:, None], rseed[c_in])
        if kk % jump == 0:
            del_bases.append(fh_d + rh_d)
    del_sup = probe_full(torch.stack(del_bases)).sum(dim=0)

    # --- insertion lane: first gated candidate whose sub was NOT accepted
    # and with no accepted sub at an earlier lane (zero-padded lanes never)
    accepted = gate & (sub_sup.to(torch.float32) >= thr_edit)
    acc_before = torch.cumsum(accepted.to(torch.int32), dim=1) - accepted.to(torch.int32)
    needs = gate & ~accepted & (acc_before == 0) & (cand != 0)
    any_needs = needs.any(dim=1)
    ins_lane = torch.where(any_needs, torch.argmax(needs.to(torch.int32), dim=1),
                           torch.full_like(site, -1, dtype=torch.int64))

    # --- the first SI needing sites (in site order) get insertion tables
    ins_ok = torch.zeros(S, dtype=torch.uint8, device=dev)
    ins_sup = torch.zeros(S, C, dtype=torch.int8, device=dev)
    sel = _first_true(any_needs & (site >= 0), SI)
    if len(sel):
        r_n, w_n, p_n = r_i[sel], w_safe[sel], p_i[sel]
        fd_n, rd_n = f_draft[sel], r_draft[sel]
        ic = cand[sel].gather(1, ins_lane[sel][:, None])[:, 0]  # index char
        n = len(sel)
        # per-length reference chains: ref combo = index_char + 'A'*(l-1);
        # c_in at roll s: 'A' (s < l), draft (s == l), codes[p+s-l] (s > l)
        fh_i, rh_i = _changelast(
            fh0[sel][:, None], rh0[sel][:, None], k, fd_n[:, None],
            fseed[ic][:, None].expand(n, MI), rd_n[:, None],
            rseed[ic][:, None].expand(n, MI),
        )
        l_grp = torch.arange(1, MI + 1, device=dev)[None, :]
        fa, ra = fseed[ord("A")], rseed[ord("A")]
        j_ins = {int(x) for x in tables.j_ins}
        ref_f, ref_r = [], []
        for s in range(1, k):
            c_out = c64[r_n, (w_n + s - 1).clamp(max=L - 1)]
            suf = c64[r_n[:, None], (p_n[:, None] + s - l_grp).clamp(0, L - 1)]
            f_in = torch.where(s < l_grp, fa, torch.where(s == l_grp, fd_n[:, None],
                                                         fseed[suf]))
            r_in = torch.where(s < l_grp, ra, torch.where(s == l_grp, rd_n[:, None],
                                                         rseed[suf]))
            fh_i, rh_i = _roll(fh_i, rh_i, k, fseed[c_out][:, None], f_in,
                               rseed[c_out][:, None], r_in)
            if s in j_ins:
                ref_f.append(fh_i)
                ref_r.append(rh_i)
        grp = combo_len - 1  # [C] length-group index
        cbase = ((torch.stack(ref_f, dim=-1)[:, grp, :] ^ d_f_ins)
                 + (torch.stack(ref_r, dim=-1)[:, grp, :] ^ d_r_ins))  # [n, C, T]
        # stage 1: the h1 bit alone bounds each combo's support from above
        maybe_cnt = scan_conv.probe_bit_reference(words, bits, cbase).sum(dim=-1)
        can_pass = maybe_cnt.to(torch.float32) >= thr_edit
        n_surv = can_pass.sum(dim=1)
        ins_ok[sel] = (n_surv <= T_SURVIVORS).to(torch.uint8)
        # stage 2: exact full-h counts of the first T_SURVIVORS passing
        # combos, written even where the site overflowed
        rank = torch.cumsum(can_pass.to(torch.int32), dim=1) - can_pass.to(torch.int32)
        surv = can_pass & (rank < T_SURVIVORS)
        exact = torch.zeros(n, C, dtype=torch.int8, device=dev)
        exact[surv] = probe_full(cbase[surv]).sum(dim=-1).to(torch.int8)
        ins_sup[sel] = exact

    return EvalOutputs((
        scan_conv.pack_bits(present), n_sites, site, gate.to(torch.uint8),
        sub_sup.to(torch.int8), del_sup.to(torch.int8), ins_lane.to(torch.int8),
        ins_ok, ins_sup,
    ))


scan_eval_reference.calls = LaunchCounter()


def _check_args(bits: int, h: int, codes: torch.Tensor, cfg: EvalConfig,
                tables: SiteTables) -> None:
    if codes.dim() != 2:
        raise ValueError(f"codes must be [R, L], got shape {tuple(codes.shape)}")
    if (tables.k, tables.jump, tables.max_ins, tables.max_del) != (
            cfg.k, cfg.jump, cfg.max_ins, cfg.max_del):
        raise ValueError("site tables do not match the eval config")
    if not (1 <= cfg.k <= 64 and 1 <= h <= 16 and cfg.jump >= 1
            and 0 <= cfg.max_ins <= 5 and 0 <= cfg.max_del <= 7):
        raise ValueError(f"unsupported eval parameters {cfg}")
    if bits < 1 or bits >= (1 << 62) or cfg.s_max < 1:
        raise ValueError(f"unsupported eval parameters bits={bits} s_max={cfg.s_max}")
    R, L = codes.shape
    if R < 1 or L < cfg.k or R * (L - cfg.k + 1) >= (1 << 31) - 1:
        raise ValueError(f"unsupported eval call shape {tuple(codes.shape)}")


# --- the wrapper -----------------------------------------------------------------
def scan_eval(words: torch.Tensor, bits: int, h: int, codes: torch.Tensor,
              cfg: EvalConfig, tables: SiteTables) -> EvalOutputs:
    """codes uint8 [R, L] -> the nine outputs of the fused eval:

      packed   u8 [R, ceil(nw/8)]   presence bits
      n_sites  i32 []               heads found (may exceed S)
      site     i32 [S]              row-major global window index (pad -1)
      gate     u8 [S, 4]
      sub_sup  i8 [S, 4]
      del_sup  i8 [S, MD]
      ins_lane i8 [S]               lane whose ins table was computed (-1)
      ins_ok   u8 [S]               0 -> survivor overflow or beyond s_ins
      ins_sup  i8 [S, C]            exact counts of the survivors, else 0

    (S = cfg.s_max, C = tables.n_combos).  words int32[ceil(bits/32)] on
    the same device.  CPU tensors run the plain version; CUDA tensors
    launch the four kernels on the current stream."""
    _check_args(bits, h, codes, cfg, tables)
    if codes.device.type == "cpu":
        return scan_eval_reference(words, bits, h, codes, cfg, tables)
    require_cuda(codes, "scan_eval")
    if words.device != codes.device:
        raise ValueError("words and codes must lie on the same device")
    if codes.dtype != torch.uint8 or words.dtype != torch.int32:
        raise TypeError("scan_eval takes uint8 codes and int32 words")
    if words.numel() * 32 < bits:
        raise ValueError("words hold fewer than `bits` bits")
    if codes.shape[0] > 65535:
        raise ValueError("at most 65535 rows per call")
    codes = codes.contiguous()
    words = words.contiguous()
    dev = codes.device
    R, L = codes.shape
    k = cfg.k
    S, SI, C, MD = cfg.s_max, cfg.resolved_s_ins(), tables.n_combos, cfg.max_del
    nw = L - k + 1
    cst = _device_consts(k, cfg.jump, cfg.max_ins, MD, str(dev))
    tf, tr, fclass = scan_conv._device_tables(k, str(dev))

    def out(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    outs = EvalOutputs((
        out(R, (nw + 7) // 8, dtype=torch.uint8), out(dtype=torch.int32),
        out(S, dtype=torch.int32), out(S, 4, dtype=torch.uint8),
        out(S, 4, dtype=torch.int8), out(S, MD, dtype=torch.int8),
        out(S, dtype=torch.int8), out(S, dtype=torch.uint8),
        out(S, C, dtype=torch.int8),
    ))
    kernels = lib()
    outs.scratch = out(kernels.gp_scan_eval_scratch_bytes(R, L, k, S, SI),
                       dtype=torch.uint8)
    rc = kernels.gp_scan_eval(
        words.data_ptr(), bits, h, k, cfg.jump, cfg.max_ins, MD,
        float(np.float32(cfg.thr_edit)), float(np.float32(cfg.thr_missing)),
        S, SI, C, cst.T, codes.data_ptr(), R, L,
        tf.data_ptr(), tr.data_ptr(), fclass.data_ptr(), scan_conv._kmul(k),
        cst.u64.data_ptr(), cst.u8.data_ptr(), outs.scratch.data_ptr(),
        *(o.data_ptr() for o in outs),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(rc, "gp_scan_eval")
    scan_eval.launches.add()
    return outs


scan_eval.launches = LaunchCounter()


class FusedEval:
    """The fused eval for one config and filter size on one device.

    The constant tables upload once per (config, device).  "cuda" with no
    CUDA device raises (never a CPU fallback); "cpu" runs the plain torch
    version and is what the CPU tests use."""

    def __init__(self, cfg: EvalConfig, bits: int, tables: SiteTables,
                 device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"FusedEval(device={str(device)!r}): CUDA is not available")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported eval device {str(device)!r}")
        if device.type == "cuda" and device.index is None:
            # the tables are cached under the name the inputs' device gives
            device = torch.device("cuda", torch.cuda.current_device())
        self.cfg = cfg
        self.bits = int(bits)
        self.tables = tables
        self.device = device
        _device_consts(cfg.k, cfg.jump, cfg.max_ins, cfg.max_del, str(device))
        scan_conv._device_tables(cfg.k, str(device))

    def __call__(self, words: torch.Tensor, codes: torch.Tensor) -> EvalOutputs:
        return scan_eval(words, self.bits, self.cfg.h, codes, self.cfg, self.tables)
