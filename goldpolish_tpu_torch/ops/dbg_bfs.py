"""Whole-search de Bruijn BFS for the gap filler (kernel 3) and DeviceBFS.

Port counterpart: goldpolish_tpu/ops/dbg_bfs.py (K6: _build_kernel
:86-290, DeviceBFS :293-400).  The sealer's Konnector search
(fill/konnector._BidiSearch) is sequential, but the graph it walks is a
pure function of the Bloom filter.  So one device call computes, for a
batch of gaps, every vertex reachable from each gap's start (successors)
and goal (predecessors) within its depth budget, with the vertex's 4-bit
extension mask; the host then replays the exact search against those masks
(konnector.MaskDBG, connect_pairs_batch_masks).  A gap that overflows the
kernel's frontier or log capacity is searched natively on the host.

`dbg_bfs` launches the CUDA kernel of csrc/dbg_bfs.cu for CUDA tensors and
runs `dbg_bfs_reference`, the same level loop in plain torch on int64
lanes (ops/u64.py), for CPU tensors.  Both dedup exactly: the kernel with
a hash set in shared memory, the plain version with torch.unique against
the visited pairs.  The JAX kernel dedups with a 3-bit shadow byte set
whose false positives drop vertices from the log (each drop costs a host
re-run of the gap; its docstring's ~2e-4 per-test estimate is ~5e-3 at its
default 2^15 slots).  The port keeps no shadow set, so the JAX knob
GPTPU_BFS_SHADOW_LOG has no counterpart, and the set of logged vertices is
exactly the host BFS's.  The JAX kernel also drops the all-T 32-mer, which
equals its pad value; the port logs it like any other vertex.

k-mers are 2-bit packed (ops/kmers, k <= 32) and their ntHash state rolls
from parent to child in O(1), so a level costs 4 * h Bloom-bit loads per
frontier vertex.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import nthash as nt
from . import u64
from .cuda_build import LaunchCounter, check, lib, require_cuda
# base codes 0..3 = A, C, G, T; the codec shared with the host packed search
from .kmers import BASES, pack_kmer, unpack_kmer  # noqa: F401 (re-export)
from .scan_conv import _kmul, probe_full_reference


@functools.lru_cache(maxsize=64)
def roll_table(k: int) -> np.ndarray:
    """uint64[16]: F, R, FK, RK of A, C, G, T.

    F and R are the forward and reverse-complement seeds (the JAX
    _FSEED4/_RSEED4), FK and RK the same rotated k times: a successor of u
    with new base b has fh' = srol(fh) ^ F[b] ^ FK[u's first base] and
    rh' = sror(rh ^ RK[b] ^ R[u's first base]) (dbg_bfs.py:103-132)."""
    f = [nt.SEED_TAB_I[b] for b in BASES]
    r = [nt.RC_SEED_TAB_I[b] for b in BASES]
    n = k % nt.SROL_PERIOD
    return np.array(f + r + [nt.srol_n_i(x, n) for x in f + r], np.uint64)


@functools.lru_cache(maxsize=64)
def _device_roll_table(k: int, device: str) -> torch.Tensor:
    return torch.from_numpy(roll_table(k).view(np.int64).copy()).to(device)


def _check_args(bits: int, h: int, k: int, W: int, V: int) -> None:
    if not 1 <= k <= 32:
        raise ValueError(f"dbg_bfs packs k-mers into 64 bits (1 <= k <= 32), got k={k}")
    if h < 1 or not 1 <= bits < (1 << 62) or W < 1 or V < 1:
        raise ValueError(f"unsupported BFS parameters h={h} bits={bits} W={W} V={V}")


def _first_visits(seen_lane, seen_k, lane, kmer) -> torch.Tensor:
    """bool[M]: candidate (lane, kmer) i is in no seen pair and is the first
    of its pair among the candidates — the exact dedup of one level."""
    m = lane.numel()
    dev = lane.device
    if m == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    pairs = torch.stack([torch.cat([seen_lane, lane]), torch.cat([seen_k, kmer])], 1)
    uniq, inv = torch.unique(pairs, dim=0, return_inverse=True)
    ns = seen_lane.numel()
    seen = torch.zeros(uniq.shape[0], dtype=torch.bool, device=dev)
    seen[inv[:ns]] = True
    ci = inv[ns:]
    order = torch.arange(m, device=dev)
    first = torch.full((uniq.shape[0],), m, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, ci, order, "amin")
    return ~seen[ci] & (first[ci] == order)


def dbg_bfs_reference(words, bits: int, h: int, k: int, seed_k, seed_fh, seed_rh,
                      max_d, W: int, V: int):
    """Plain torch version of the BFS kernel (any device), batched over every
    search and both directions.  Same arguments and results as dbg_bfs;
    entries past n_vis are 0."""
    dbg_bfs_reference.calls.add()
    _check_args(bits, h, k, W, V)
    dev = seed_k.device
    G = seed_k.shape[0]
    S = 2 * G
    md = max_d.reshape(S).to(torch.int64)
    tab = _device_roll_table(k, str(dev))
    F, R, FK, RK = tab[0:4], tab[4:8], tab[8:12], tab[12:16]
    bases = torch.arange(4, device=dev)
    kmask = u64.const((1 << (2 * k)) - 1)
    top = 2 * (k - 1)
    first_base = torch.tensor([u64.const(b << top) for b in range(4)], device=dev)
    fwd_lane = (torch.arange(S, device=dev) & 1) == 0
    words64 = words.to(torch.int64)

    vis_k = torch.zeros(S * V, dtype=torch.int64, device=dev)
    vis_m = torch.zeros(S * V, dtype=torch.uint8, device=dev)
    n_vis = torch.zeros(S, dtype=torch.int64, device=dev)
    over = torch.zeros(S, dtype=torch.bool, device=dev)
    # the frontier as flat (lane, k-mer, fh, rh) rows, grouped by lane
    lane = torch.nonzero(md >= 0).flatten()
    fk = seed_k.reshape(S)[lane]
    ffh = seed_fh.reshape(S)[lane]
    frh = seed_rh.reshape(S)[lane]
    seen_lane, seen_k = lane.clone(), fk.clone()
    level = 0
    while lane.numel():
        nf = torch.bincount(lane, minlength=S)
        rank = torch.arange(lane.numel(), device=dev) - (torch.cumsum(nf, 0) - nf)[lane]
        fwd = fwd_lane[lane][:, None]
        out = u64.lsr(fk, top) & 3  # first base: leaves on a successor step
        inn = fk & 3  # last base: leaves on a predecessor step
        ck = torch.where(fwd, ((fk << 2) & kmask)[:, None] | bases,
                         u64.lsr(fk, 2)[:, None] | first_base)
        cfh = torch.where(fwd, u64.srol(ffh)[:, None] ^ F ^ FK[out][:, None],
                          u64.sror((ffh ^ F[inn])[:, None] ^ FK))
        crh = torch.where(fwd, u64.sror(frh[:, None] ^ RK ^ R[out][:, None]),
                          (u64.srol(frh) ^ RK[inn])[:, None] ^ R)
        pres = probe_full_reference(words64, bits, cfh + crh, k, h)  # [N, 4]
        mask = (pres.to(torch.int64) << bases).sum(1)
        pos = n_vis[lane] + rank
        ok = pos < V
        vis_k[(lane * V + pos)[ok]] = fk[ok]
        vis_m[(lane * V + pos)[ok]] = mask[ok].to(torch.uint8)
        n_vis += nf
        over |= n_vis > V
        grow = (level < md) & ~over
        keep = pres & grow[lane][:, None]
        c_lane = lane[:, None].expand(-1, 4)[keep]
        c_k, c_fh, c_rh = ck[keep], cfh[keep], crh[keep]
        new = _first_visits(seen_lane, seen_k, c_lane, c_k)
        c_lane, c_k, c_fh, c_rh = c_lane[new], c_k[new], c_fh[new], c_rh[new]
        over |= torch.bincount(c_lane, minlength=S) > W
        live = ~over[c_lane]
        order = torch.argsort(c_lane[live], stable=True)
        lane = c_lane[live][order]
        fk, ffh, frh = c_k[live][order], c_fh[live][order], c_rh[live][order]
        seen_lane = torch.cat([seen_lane, c_lane])
        seen_k = torch.cat([seen_k, c_k])
        level += 1
    return (vis_k.view(G, 2, V), vis_m.view(G, 2, V),
            n_vis.to(torch.int32).view(G, 2), over.view(G, 2))


dbg_bfs_reference.calls = LaunchCounter()


def dbg_bfs(words, bits: int, h: int, k: int, seed_k, seed_fh, seed_rh, max_d,
            W: int, V: int):
    """Whole-search BFS of G searches, both directions.

    words int32[ceil(bits/32)]: the filter's little-endian u32 words.
    seed_k, seed_fh, seed_rh int64[G, 2] (u64 bits): per search, column 0 the
    start k-mer (expanded by successors) and column 1 the goal k-mer
    (expanded by predecessors), packed, with their ntHash (fh, rh).
    max_d int32[G, 2]: depth budget per direction, -1 = inactive.
    Returns vis_k int64[G, 2, V] (logged k-mers, u64 bits), vis_m
    uint8[G, 2, V] (their 4-bit extension masks), n_vis int32[G, 2] and
    over bool[G, 2] (more than W new children in one level, or more than V
    logged).  Only the first n_vis entries of a direction are defined; their
    order is unspecified.  CPU tensors run the plain version; CUDA tensors
    launch the kernel on the current stream or raise."""
    _check_args(bits, h, k, W, V)
    if seed_k.dim() != 2 or seed_k.shape[1] != 2:
        raise ValueError(f"seeds must be [G, 2], got shape {tuple(seed_k.shape)}")
    for t in (seed_fh, seed_rh, max_d):
        if t.shape != seed_k.shape:
            raise ValueError("seed_k, seed_fh, seed_rh and max_d must share one [G, 2] shape")
    if seed_k.device.type == "cpu":
        return dbg_bfs_reference(words, bits, h, k, seed_k, seed_fh, seed_rh,
                                 max_d, W, V)
    require_cuda(seed_k, "dbg_bfs")
    if any(t.device != seed_k.device for t in (words, seed_fh, seed_rh, max_d)):
        raise ValueError("dbg_bfs: every tensor must lie on one device")
    if words.dtype != torch.int32 or max_d.dtype != torch.int32 or any(
        t.dtype != torch.int64 for t in (seed_k, seed_fh, seed_rh)
    ):
        raise TypeError("dbg_bfs takes int32 words and max_d, int64 seeds")
    if words.numel() * 32 < bits:
        raise ValueError("words hold fewer than `bits` bits")
    G = seed_k.shape[0]
    dev = seed_k.device
    vis_k = torch.empty(G, 2, V, dtype=torch.int64, device=dev)
    vis_m = torch.empty(G, 2, V, dtype=torch.uint8, device=dev)
    n_vis = torch.empty(G, 2, dtype=torch.int32, device=dev)
    over = torch.empty(G, 2, dtype=torch.uint8, device=dev)
    if G == 0:
        return vis_k, vis_m, n_vis, over.view(torch.bool)
    words, seed_k, seed_fh, seed_rh, max_d = (
        t.contiguous() for t in (words, seed_k, seed_fh, seed_rh, max_d)
    )
    tab = _device_roll_table(k, str(dev))
    rc = lib().gp_dbg_bfs(
        words.data_ptr(), bits, h, k, _kmul(k), tab.data_ptr(),
        seed_k.data_ptr(), seed_fh.data_ptr(), seed_rh.data_ptr(),
        max_d.data_ptr(), G, W, V, vis_k.data_ptr(), vis_m.data_ptr(),
        n_vis.data_ptr(), over.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(rc, "gp_dbg_bfs")
    dbg_bfs.launches.add()
    return vis_k, vis_m, n_vis, over.view(torch.bool)


dbg_bfs.launches = LaunchCounter()


class DeviceBFS:
    """Batched whole-search mask precomputation for Konnector gaps.

    One `run` tier is one kernel launch per batch of up to 512 gaps,
    covering every level of every gap.  Returns per-gap {kmer: mask4} dicts
    for both directions (None where the kernel overflowed — search those
    natively).  `device` "cuda" raises without CUDA (never a CPU fallback);
    "cpu" runs the plain torch version and is for tests."""

    def __init__(self, bf, k: int, w_cap: int = 32, v_cap: int = 2048,
                 batch: int = 128, w_cap2: int = 256, device: str = "cuda"):
        if k > 32:
            raise ValueError("DeviceBFS packs k-mers into u64 (k <= 32)")
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported DeviceBFS device {device!r}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"DeviceBFS(device={device!r}): CUDA is not available")
        self.bf = bf
        self.k = k
        self.h = int(bf.hash_num)
        self.bits = int(bf.bits)
        self.W = w_cap
        self.W2 = w_cap2  # wide-retry tier for frontier-cap overflows
        self.V = v_cap
        self.G = batch
        self._words = None

    def words(self) -> torch.Tensor:
        """The filter as int32 words on the device, uploaded once."""
        if self._words is None:
            words = np.ascontiguousarray(self.bf.words_u32(), dtype="<u4")
            self._words = torch.from_numpy(words.view(np.int32).copy()).to(self.device)
        return self._words

    def run(self, searches):
        """searches: list of (start_kmer str, goal_kmer str,
        max_depth_fwd int, max_depth_rev int).  Returns a list of
        (succ_masks dict | None, pred_masks dict | None).

        Two width tiers: most Konnector searches run 1-2 vertices wide
        (thin de Bruijn paths), so the first sweep uses a narrow frontier
        cap; gaps that overflow it retry once at W2 before falling back to
        the host search (None)."""
        out = self._run_tier(searches, self.W)
        retry = [i for i, r in enumerate(out) if r == (None, None)]
        if retry and self.W2 > self.W:
            redo = self._run_tier([searches[i] for i in retry], self.W2)
            for i, r in zip(retry, redo):
                out[i] = r
        return out

    def inputs(self, searches):
        """The leading arguments of dbg_bfs for `searches` (as in run): the
        filter's words, bits, h, k, then seed_k, seed_fh, seed_rh and max_d
        [len(searches), 2] on the device."""
        seeds = np.zeros((3, len(searches), 2), np.uint64)  # k-mer, fh, rh
        md = np.zeros((len(searches), 2), np.int32)
        for i, (s, g, mf, mr) in enumerate(searches):
            for d, kmer in ((0, s), (1, g)):
                seeds[0, i, d] = pack_kmer(kmer)
                seeds[1:, i, d] = nt.ntc64_base_i(kmer.encode(), 0, self.k)
            md[i] = (mf, mr)
        sk, sfh, srh = (u64.from_u64(a).to(self.device) for a in seeds)
        return (self.words(), self.bits, self.h, self.k, sk, sfh, srh,
                torch.from_numpy(md).to(self.device))

    def _run_tier(self, searches, W: int):
        # batches of G gaps as the JAX DeviceBFS cuts them (G doubles up to
        # 512 to take every gap in one call); no padding is needed here
        G = self.G
        while G < len(searches) and G < 512:
            G *= 2
        out = []
        for lo in range(0, len(searches), G):
            chunk = searches[lo : lo + G]
            vis, msk, n_vis, over = dbg_bfs(*self.inputs(chunk), W, self.V)
            vis = u64.to_u64(vis)
            msk = msk.cpu().numpy()
            n_vis = n_vis.cpu().numpy()
            over = over.cpu().numpy().any(axis=1)
            for i in range(len(chunk)):
                if over[i]:
                    out.append((None, None))
                    continue
                # dicts key on PACKED ints — the host search's vertex type
                # (fill/konnector.PackedDBG) — so the replay does zero
                # string conversions
                out.append(tuple(
                    dict(zip(vis[i, d, : n_vis[i, d]].tolist(),
                             msk[i, d, : n_vis[i, d]].tolist()))
                    for d in range(2)
                ))
        return out
