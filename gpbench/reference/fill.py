"""The per-batch multi-k Bloom fill, in plain torch: the benchmark's plain
reference of the port's host fill (bf_builder.BFBuilder.build_batch on
native/gp_native.cpp's gp_fill_bfs_stream).

Semantics (reference src/utils.cpp:96-123, as the port runs it): per k,
every k-window of every chosen read, reads in order and windows in order,
is one operation on that k's 8-bit counting filter (CBF) and plain filter
(BF).  An operation whose h BF bits all read set is skipped (the port's
`skip_promoted`).  Otherwise it reads the minimum m of its h CBF counters;
below the threshold t it raises exactly the counters that equal m to m + 1,
and once the count (m + 1, or m where m >= t) reaches t it sets its h BF
bits.  t is the read's adaptive threshold - 2 + the k's index.

The operations are sequential only where they share a counter or a bit,
so they run here in dependency levels: an operation's level is one more
than the highest level of the earlier operations that touch any of its
counters or bits, the levels are found by relaxation, and each level runs
as one batch of gathers and scatters with no two of its operations
touching one resource.  That is exactly the sequential order's result, on
the card or on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from . import nthash as nt

_OP_BITS = 30  # operations per k and batch below 2^30
_CHUNKS = 64  # operation chunks of the level relaxation
_PART_ENTRIES = 1 << 27  # entries in one sort of _preds


def _i64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _window_tables(k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """[k, 256] int64 tables: the forward hash of a window is the XOR over
    t < k of tf[t, byte at t], the reverse hash that of tr[t, byte at t]."""
    tf = np.stack([nt.srol_n(nt.SEED_TAB, k - 1 - t) for t in range(k)])
    tr = np.stack([nt.srol_n(nt.RC_SEED_TAB, t) for t in range(k)])
    return _i64(tf).to(device), _i64(tr).to(device)


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 lanes holding u64 values."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """u64 value of int64 lanes modulo m (m < 2^31)."""
    if m & (m - 1) == 0:
        return x & (m - 1)
    hi = _lsr(x, 32) % m
    lo = x & 0xFFFFFFFF
    return (hi * ((1 << 32) % m) + lo) % m


def window_hashes(codes: torch.Tensor, starts: torch.Tensor, k: int,
                  hash_num: int) -> torch.Tensor:
    """[n, hash_num] canonical multi-hashes (int64 lanes) of the k-windows
    of `codes` (uint8) that begin at `starts`."""
    tf, tr = _window_tables(k, codes.device)
    f = torch.zeros(starts.shape, dtype=torch.int64, device=codes.device)
    r = torch.zeros_like(f)
    for t in range(k):
        c = codes[starts + t].long()
        f ^= tf[t][c]
        r ^= tr[t][c]
    base = f + r
    out = [base]
    km = (k * int(nt.MULTI_SEED)) & nt.MASK64
    for i in range(1, hash_num):
        mul = i ^ km
        mul = mul - (1 << 64) if mul >= 1 << 63 else mul
        t = base * mul
        out.append(t ^ _lsr(t, nt.MULTI_SHIFT))
    return torch.stack(out, dim=1)


def _preds(columns: list[torch.Tensor], n_res: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(op, pred) pairs, int32: for each operation (row) and each resource
    it touches (columns, resource ids in [0, n_res)), the latest earlier
    operation that touches that resource; pairs without one left out.
    Resources are taken in ranges so that one sort holds at most
    _PART_ENTRIES entries."""
    n = columns[0].numel()
    dev = columns[0].device
    parts = max(1, -(-n * len(columns) // _PART_ENTRIES))
    step = -(-n_res // parts)
    rows = torch.arange(n, device=dev)
    ops, preds = [], []
    for lo in range(0, n_res, step):
        keys = []
        for col in columns:
            m = (col >= lo) & (col < lo + step)
            keys.append(((col[m] - lo).long() << _OP_BITS) | rows[m])
        key = torch.sort(torch.cat(keys)).values
        del keys
        res = key >> _OP_BITS
        op = key & ((1 << _OP_BITS) - 1)
        del key
        same = torch.zeros_like(res, dtype=torch.bool)
        same[1:] = res[1:] == res[:-1]
        del res
        pred = torch.full_like(op, -1)
        pred[1:] = torch.where(same[1:], op[:-1], pred[1:])
        # an operation that names one resource twice depends on the
        # operation before its first mention
        for _ in range(len(columns)):
            dup = same & (pred == op)
            if not bool(dup.any()):
                break
            pred = torch.where(dup, torch.roll(pred, 1), pred)
        keep = pred >= 0
        ops.append(op[keep].int())
        preds.append(pred[keep].int())
    return torch.cat(ops), torch.cat(preds)


def _levels(columns: list[torch.Tensor], n_res: int) -> torch.Tensor:
    """Dependency level of each operation: 0 with no earlier operation on
    any of its resources, else one more than the highest level among the
    latest earlier operation on each."""
    op, pred = _preds(columns, n_res)
    n = columns[0].numel()
    dev = columns[0].device
    # operations in chunks, in order: a chunk's earlier operations have
    # their final levels, so relaxation runs only over its own chains
    level = torch.zeros(n, dtype=torch.int64, device=dev)
    step = max(1, -(-n // _CHUNKS))
    for a in range(0, n, step):
        b = min(n, a + step)
        sel = (op >= a) & (op < b)
        o, p = op[sel].long() - a, pred[sel].long()
        if not o.numel():
            continue
        inner = p >= a
        outer = torch.where(inner, 0, level[p.clamp(max=max(a - 1, 0))] + 1)
        own = torch.zeros(b - a, dtype=torch.int64, device=dev)
        pi = (p - a).clamp(min=0)
        while True:
            vals = torch.where(inner, own[pi] + 1, outer)
            nxt = torch.zeros_like(own).scatter_reduce(
                0, o, vals, reduce="amax", include_self=True)
            if torch.equal(nxt, own):
                break
            own = nxt
        level[a:b] = own
    return level


def fill_k(codes: torch.Tensor, starts: torch.Tensor, thresholds: torch.Tensor,
           k: int, hash_num: int, cbf_bytes: int, bf_bytes: int,
           superset: bool = False) -> np.ndarray:
    """One k's filter: the BF bytes after every window at `starts`, in
    order, with per-window thresholds, went through the CBF -> BF fill.
    superset: promote by per-counter occurrence totals instead, in no
    order (the control: the superset the port's device fill documents)."""
    dev = codes.device
    bits = bf_bytes * 8
    if bits & (bits - 1):
        raise ValueError("the plain filter's bit count must be a power of two")
    bf_bits = torch.zeros(bits, dtype=torch.bool, device=dev)
    if starts.numel():
        hs = window_hashes(codes, starts, k, hash_num)
        c = umod(hs, cbf_bytes).int()
        b = (hs & (bits - 1)).int()
        del hs
        if superset:
            totals = torch.zeros(cbf_bytes, dtype=torch.int64, device=dev)
            flat = c.reshape(-1).long()
            totals.index_add_(0, flat, torch.ones_like(flat))
            keep = totals[c.long()].min(dim=1).values >= thresholds
            bf_bits[b[keep].reshape(-1).long()] = True
            return np.packbits(bf_bits.cpu().numpy(), bitorder="little")
        cols = [c[:, j] for j in range(hash_num)] + [b[:, j] + cbf_bytes for j in range(hash_num)]
        level = _levels(cols, cbf_bytes + bits)
        del cols
        order = torch.sort(level, stable=True)
        bounds = torch.searchsorted(
            order.values, torch.arange(int(order.values[-1]) + 2, device=dev))
        bounds = bounds.tolist()
        cbf = torch.zeros(cbf_bytes, dtype=torch.int16, device=dev)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            idx = order.indices[lo:hi]
            ci, bi, t = c[idx].long(), b[idx].long(), thresholds[idx]
            active = ~bf_bits[bi].all(dim=1)
            ci, bi, t = ci[active], bi[active], t[active]
            vals = cbf[ci]
            m = vals.min(dim=1).values
            below = m < t
            raise_ = (vals == m[:, None]) & below[:, None]
            cbf[ci[raise_]] = (m[:, None] + 1).expand_as(vals)[raise_]
            count = torch.where(below, m + 1, m)
            bf_bits[bi[count >= t].reshape(-1)] = True
    return np.packbits(bf_bits.cpu().numpy(), bitorder="little")


def fill_batch(reads: list[bytes], thresholds: list[int], k_values: list[int],
               hash_num: int, cbf_bytes: int, bf_bytes: int,
               device="cpu", superset: bool = False) -> list[np.ndarray]:
    """Each k's BF bytes for one batch's chosen reads (in order) and their
    adaptive thresholds."""
    if any(t < 4 for t in thresholds):
        raise ValueError("k-mer thresholds are at least 4")
    lens = np.array([len(r) for r in reads], np.int64)
    offsets = np.concatenate(([0], np.cumsum(lens)))
    codes = torch.from_numpy(
        np.frombuffer(b"".join(reads), np.uint8).copy()).to(device)
    thr = torch.tensor(thresholds, dtype=torch.int64)
    out = []
    for ki, k in enumerate(k_values):
        n_win = np.maximum(lens - k + 1, 0)
        if n_win.sum() >= 1 << _OP_BITS:
            raise ValueError("too many windows in one batch")
        read_of = np.repeat(np.arange(len(reads)), n_win)
        first = np.repeat(offsets[:-1] - np.concatenate(([0], np.cumsum(n_win)[:-1])), n_win)
        starts = torch.from_numpy(np.arange(int(n_win.sum())) + first).to(device)
        t = (thr[torch.from_numpy(read_of)] - 2 + ki).to(device)
        out.append(fill_k(codes, starts, t, k, hash_num, cbf_bytes, bf_bytes,
                          superset))
    return out
