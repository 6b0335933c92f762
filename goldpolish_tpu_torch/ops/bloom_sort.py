"""The sort-based device Bloom fill (kernel 5) — the batch's multi-k filters
built on the device from its reads and per-read thresholds.

Port counterpart: goldpolish_tpu/ops/bloom_sort.py (K3).  Per k:

  1. hash every window of the read stream (the reads concatenated) with
     kernel 2's XOR tables; a window that crosses into the next read or
     past the end is a pad (key all-ones, threshold 255),
  2. sort the keys (the hash with its sign bit flipped, as int64),
  3. one representative per distinct k-mer: its count of valid windows and
     its smallest threshold, max(read threshold + ki - 2, 1),
  4. add each count into the h slots (hash mod cbf_size) of int32 totals,
  5. promote a k-mer whose smallest slot total reaches its threshold: set
     its h bits.

A stream above `chunk_bases` runs the two-phase build: phase A runs steps
1-4 per group of whole reads and keeps each group's representatives, phase
B sorts the representatives of all groups, keeps the smallest threshold of
each k-mer and promotes against the global totals.  Both give the same bits.

The result is a documented superset of the host fill (the JAX module's
docstring says why) and equals the JAX `device_fill_bfs_sorted` bit for bit,
with two differences that no test input reaches, both in ROADMAP.md queue 3:
a valid window whose hash is exactly 2^64 - 1 is counted alone (the JAX run
also counts its halo grid's pads), and slots and bits are indexed in 64
bits (the JAX build casts them to int32).  The halo'd power-of-two row grid
(`PackedReadStream.codes`) is an XLA shape bucket and has no counterpart;
the upload is the raw read bytes, from a pinned buffer.

Each step has a wrapper that launches its part of csrc/bloom_sort.cu for
CUDA tensors and runs its plain torch version (`*_reference`, int64 lanes,
ops/u64.py) for CPU tensors.  `device_fill_bfs_sorted_reference` runs the
whole fill with the plain versions on any device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import bloom, u64
from .cuda_build import LaunchCounter, check, lib, require_cuda
from .scan_conv import _device_tables, _kmul, strand_hashes_reference

KHALO = 32      # the JAX build's row halo; it supports any k <= KHALO + 1
MAX_THR = 15    # per-read thresholds must fit 4 bits (reference caps at 13)
# default chunk bound of the two-phase build; GPTPU_SORT_CHUNK_BASES
# overrides it.  Results are bit-identical at any chunking.
DEFAULT_CHUNK_BASES = 1 << 21
PAD_KEY = (1 << 63) - 1  # the key of hash 2^64 - 1, and of every pad window
PAD_THR = 255
RUN_BLOCK = 1024  # sorted elements per block of the run kernels


def _stream(device):
    """The handle of the current CUDA stream, where a wrapper launches."""
    return torch.cuda.current_stream(device).cuda_stream


def _hashes(base: torch.Tensor, k: int, h: int) -> list[torch.Tensor]:
    """The h ntHash values of each base hash (nte64)."""
    kmul = _kmul(k)
    out = [base]
    for i in range(1, h):
        t = base * u64.const(i ^ kmul)
        out.append(t ^ u64.lsr(t, 27))
    return out


# -- 1. window keys -----------------------------------------------------------


def window_keys_reference(codes: torch.Tensor, offsets: torch.Tensor,
                          thrs: torch.Tensor, k: int, delta: int):
    """(keys int64[n], thr uint8[n]) of every stream window (plain torch)."""
    window_keys_reference.calls.add()
    n = codes.numel()
    keys = torch.full((n,), PAD_KEY, dtype=torch.int64, device=codes.device)
    thr = torch.full((n,), PAD_THR, dtype=torch.uint8, device=codes.device)
    nw = n - k + 1
    if nw <= 0:
        return keys, thr
    fh, rh = strand_hashes_reference(codes[None, :], k)
    p = torch.arange(nw, dtype=torch.int64, device=codes.device)
    r = torch.searchsorted(offsets[1:], p, right=True)
    valid = p + k <= offsets[r + 1]
    t = torch.clamp(thrs[r].to(torch.int32) + delta, min=1)
    keys[:nw] = torch.where(valid, (fh + rh)[0] ^ u64.SIGN, PAD_KEY)
    thr[:nw] = torch.where(valid, t, PAD_THR).to(torch.uint8)
    return keys, thr


window_keys_reference.calls = LaunchCounter()


def window_keys(codes: torch.Tensor, offsets: torch.Tensor, thrs: torch.Tensor,
                k: int, delta: int):
    """codes uint8[n] (the reads concatenated), offsets int64[n_reads + 1]
    (strictly rising), thrs uint8[n_reads] -> (keys int64[n], thr uint8[n]).
    CPU tensors run the plain version; CUDA tensors launch `bs_keys`."""
    if codes.device.type == "cpu":
        return window_keys_reference(codes, offsets, thrs, k, delta)
    require_cuda(codes, "window_keys")
    if (codes.dtype, offsets.dtype, thrs.dtype) != (torch.uint8, torch.int64, torch.uint8):
        raise TypeError("window_keys takes uint8 codes, int64 offsets, uint8 thrs")
    if not 1 <= k <= KHALO + 1 or thrs.numel() + 1 != offsets.numel() or thrs.numel() < 1:
        raise ValueError(f"window_keys: bad k={k} or read count")
    if offsets.device != codes.device or thrs.device != codes.device:
        raise ValueError("window_keys: tensors on different devices")
    n = codes.numel()
    keys = torch.empty(n, dtype=torch.int64, device=codes.device)
    thr = torch.empty(n, dtype=torch.uint8, device=codes.device)
    tf, tr, fclass = _device_tables(k, str(codes.device))
    rc = lib().gp_bs_keys(codes.data_ptr(), n, offsets.data_ptr(), thrs.numel(),
                          thrs.data_ptr(), k, delta, tf.data_ptr(), tr.data_ptr(),
                          fclass.data_ptr(), keys.data_ptr(), thr.data_ptr(),
                          _stream(codes.device))
    check(rc, "gp_bs_keys")
    window_keys.launches.add()
    return keys, thr


window_keys.launches = LaunchCounter()


# -- 3. distinct runs of the sorted keys --------------------------------------


def distinct_runs_reference(keys: torch.Tensor, thr: torch.Tensor):
    """Sorted keys int64[n], thr uint8[n] -> one representative per run:
    (key int64[m], count int32[m] of elements with thr < 255, smallest
    thr int32[m], 255 where none)."""
    distinct_runs_reference.calls.add()
    rep_key, inv = torch.unique_consecutive(keys, return_inverse=True)
    m = rep_key.numel()
    t = thr.to(torch.int32)
    cnt = torch.zeros(m, dtype=torch.int32, device=keys.device)
    cnt.index_add_(0, inv, (t < PAD_THR).to(torch.int32))
    rep_thr = torch.full((m,), PAD_THR, dtype=torch.int32, device=keys.device)
    rep_thr.scatter_reduce_(0, inv, t, "amin")
    return rep_key, cnt, rep_thr


distinct_runs_reference.calls = LaunchCounter()


def distinct_runs(keys: torch.Tensor, thr: torch.Tensor):
    """As distinct_runs_reference.  CUDA tensors launch `bs_run_flags` and
    `bs_block_scan`, read the run count back (it sizes the outputs), then
    `bs_rep_init` and `bs_run_write`."""
    if keys.device.type == "cpu":
        return distinct_runs_reference(keys, thr)
    require_cuda(keys, "distinct_runs")
    if keys.dtype != torch.int64 or thr.dtype != torch.uint8 or thr.shape != keys.shape:
        raise TypeError("distinct_runs takes int64 keys and uint8 thr of one shape")
    n = keys.numel()
    if not 1 <= n < (1 << 31) - 1:
        raise ValueError(f"distinct_runs: {n} elements")
    keys, thr = keys.contiguous(), thr.contiguous()
    dev = keys.device
    nblk = -(-n // RUN_BLOCK)
    scratch = torch.empty(2 * nblk + 1, dtype=torch.int32, device=dev)
    blk_cnt, blk_off, n_runs = scratch[:nblk], scratch[nblk:2 * nblk], scratch[2 * nblk:]
    L = lib()
    check(L.gp_bs_run_count(keys.data_ptr(), n, blk_cnt.data_ptr(), blk_off.data_ptr(),
                            n_runs.data_ptr(), _stream(dev)), "gp_bs_run_count")
    m = int(n_runs.item())
    rep_key = torch.empty(m, dtype=torch.int64, device=dev)
    rep_cnt = torch.empty(m, dtype=torch.int32, device=dev)
    rep_thr = torch.empty(m, dtype=torch.int32, device=dev)
    check(L.gp_bs_run_write(keys.data_ptr(), thr.data_ptr(), n, blk_off.data_ptr(), m,
                            rep_key.data_ptr(), rep_cnt.data_ptr(), rep_thr.data_ptr(),
                            _stream(dev)), "gp_bs_run_write")
    distinct_runs.launches.add()
    return rep_key, rep_cnt, rep_thr


distinct_runs.launches = LaunchCounter()


# -- 4. slot totals -------------------------------------------------------------


def _live_hashes(rep_key, rep_cnt, k: int, h: int):
    live = rep_cnt > 0
    return live, _hashes(rep_key[live] ^ u64.SIGN, k, h)


def slot_add_reference(rep_key, rep_cnt, k: int, h: int, cbf_size: int,
                       totals: torch.Tensor) -> None:
    """totals int32[cbf_size] += count at the h slots of each live
    representative (in place)."""
    slot_add_reference.calls.add()
    live, hs = _live_hashes(rep_key, rep_cnt, k, h)
    for hv in hs:
        totals.index_add_(0, u64.umod(hv, cbf_size), rep_cnt[live])


slot_add_reference.calls = LaunchCounter()


def _check_reps(name, rep_key, *rest):
    require_cuda(rep_key, name)
    if rep_key.dtype != torch.int64 or any(t.dtype != torch.int32 for t in rest):
        raise TypeError(f"{name} takes int64 keys and int32 counts, thresholds, totals")
    if any(t.device != rep_key.device or not t.is_contiguous() for t in rest):
        raise ValueError(f"{name}: tensors on different devices or not contiguous")


def slot_add(rep_key, rep_cnt, k: int, h: int, cbf_size: int,
             totals: torch.Tensor) -> None:
    """As slot_add_reference; CUDA tensors launch `bs_slot_add`."""
    if rep_key.device.type == "cpu":
        return slot_add_reference(rep_key, rep_cnt, k, h, cbf_size, totals)
    _check_reps("slot_add", rep_key, rep_cnt, totals)
    if totals.numel() != cbf_size or rep_cnt.shape != rep_key.shape:
        raise ValueError("slot_add: totals must hold cbf_size slots")
    if rep_key.numel() == 0:
        return None
    rc = lib().gp_bs_slot_add(rep_key.data_ptr(), rep_cnt.data_ptr(), rep_key.numel(),
                              h, _kmul(k), cbf_size, totals.data_ptr(),
                              _stream(rep_key.device))
    check(rc, "gp_bs_slot_add")
    slot_add.launches.add()
    return None


slot_add.launches = LaunchCounter()


# -- 5. promotion -------------------------------------------------------------


def promote_reference(rep_key, rep_cnt, rep_thr, k: int, h: int, cbf_size: int,
                      totals: torch.Tensor, bits: int, words: torch.Tensor) -> None:
    """words int32[bits / 32] |= the h bits of each live representative
    whose smallest slot total reaches its threshold (in place)."""
    promote_reference.calls.add()
    live, hs = _live_hashes(rep_key, rep_cnt, k, h)
    mins = torch.stack([totals[u64.umod(hv, cbf_size)] for hv in hs]).amin(dim=0)
    ok = mins >= rep_thr[live]
    setbits = torch.zeros(bits, dtype=torch.bool, device=words.device)
    for hv in hs:
        hv = hv[ok]
        setbits[hv & (bits - 1) if bits & (bits - 1) == 0 else u64.umod(hv, bits)] = True
    weights = 1 << torch.arange(32, dtype=torch.int64, device=words.device)
    packed = (setbits.view(-1, 32).to(torch.int64) * weights).sum(dim=1)
    words |= (packed - ((packed >> 31) << 32)).to(torch.int32)  # wrap to int32


promote_reference.calls = LaunchCounter()


def promote(rep_key, rep_cnt, rep_thr, k: int, h: int, cbf_size: int,
            totals: torch.Tensor, bits: int, words: torch.Tensor) -> None:
    """As promote_reference; CUDA tensors launch `bs_promote`."""
    if rep_key.device.type == "cpu":
        return promote_reference(rep_key, rep_cnt, rep_thr, k, h, cbf_size, totals,
                                 bits, words)
    _check_reps("promote", rep_key, rep_cnt, rep_thr, totals, words)
    if totals.numel() != cbf_size or words.numel() * 32 != bits:
        raise ValueError("promote: totals or words of the wrong size")
    if rep_key.numel() == 0:
        return None
    rc = lib().gp_bs_promote(rep_key.data_ptr(), rep_cnt.data_ptr(), rep_thr.data_ptr(),
                             rep_key.numel(), h, _kmul(k), cbf_size, totals.data_ptr(),
                             bits, words.data_ptr(), _stream(rep_key.device))
    check(rc, "gp_bs_promote")
    promote.launches.add()
    return None


promote.launches = LaunchCounter()


# -- the fill -----------------------------------------------------------------

KERNEL_OPS = (window_keys, distinct_runs, slot_add, promote)
PLAIN_OPS = (window_keys_reference, distinct_runs_reference, slot_add_reference,
             promote_reference)


def sorted_runs(ops, keys: torch.Tensor, thr: torch.Tensor):
    """Sort the keys, carry their thresholds along, one representative per
    run.  The sort is torch.sort, as the JAX program uses the compiler's."""
    keys_s, order = torch.sort(keys)
    return ops[1](keys_s, thr[order])


def count_k(ops, stream_t, k: int, delta: int, h: int, cbf_size: int,
            totals: torch.Tensor):
    """Steps 1-4 for one k on one uploaded stream: adds into totals and
    returns the representatives (key, count, smallest threshold)."""
    keys, thr = ops[0](*stream_t, k, delta)
    reps = sorted_runs(ops, keys, thr)
    ops[2](reps[0], reps[1], k, h, cbf_size, totals)
    return reps


def fill_k(ops, stream_t, k: int, delta: int, h: int, cbf_size: int, bits: int):
    """One k's single-dispatch fill: filter words int32[bits / 32]."""
    dev = stream_t[0].device
    totals = torch.zeros(cbf_size, dtype=torch.int32, device=dev)
    reps = count_k(ops, stream_t, k, delta, h, cbf_size, totals)
    words = torch.zeros(bits // 32, dtype=torch.int32, device=dev)
    ops[3](*reps, k, h, cbf_size, totals, bits, words)
    return words


def upload_stream(reads: list[bytes], thrs: list[int], device: torch.device):
    """(codes uint8[n], offsets int64[n_reads + 1], thrs uint8[n_reads]) on
    `device`; the bases go through a pinned buffer to a CUDA device."""
    lens = np.fromiter((len(r) for r in reads), np.int64, len(reads))
    offsets = np.zeros(len(reads) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    codes = torch.frombuffer(bytearray(b"".join(reads)), dtype=torch.uint8)
    if device.type == "cuda":
        codes = codes.pin_memory()
    return (codes.to(device, non_blocking=True),
            torch.from_numpy(offsets).to(device),
            torch.from_numpy(np.asarray(thrs, np.uint8)).to(device))


def _groups(reads, thrs, chunk_bases: int):
    """Split at read boundaries into groups of at most chunk_bases bases (a
    longer read is a group of its own), as the JAX build does."""
    groups, cur_r, cur_t, cur_n = [], [], [], 0
    for r, t in zip(reads, thrs):
        if cur_n and cur_n + len(r) > chunk_bases:
            groups.append((cur_r, cur_t))
            cur_r, cur_t, cur_n = [], [], 0
        cur_r.append(r)
        cur_t.append(t)
        cur_n += len(r)
    if cur_r:
        groups.append((cur_r, cur_t))
    return groups


def _to_filter(words: torch.Tensor, bf_bytes: int, h: int, k: int) -> bloom.BloomFilter:
    bf = bloom.BloomFilter(bf_bytes, h, k)
    bf.array[:] = words.cpu().numpy().view(np.uint8)
    return bf


def _fill(ops, reads, thrs, k_values, hash_num, cbf_bytes, bf_bytes, chunk_bases,
          device):
    if any(k > KHALO + 1 for k in k_values):
        raise ValueError(
            f"sorted device build supports k <= {KHALO + 1}"
            f" (KHALO + 1); got {k_values}"
        )
    if len(reads) != len(thrs):
        raise ValueError("reads and thresholds must align")
    if MAX_THR + len(k_values) - 2 >= PAD_THR:
        raise ValueError(f"at most {PAD_THR - MAX_THR + 1} k values")
    if bf_bytes % 4:
        raise ValueError("bf_bytes must be a multiple of 4 (whole u32 words)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device fill on {device}: CUDA is not available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported fill device {device}")
    if not reads:
        return [bloom.BloomFilter(bf_bytes, hash_num, k) for k in k_values]
    # per-slot totals are int32: a stream this large could wrap a slot
    # negative and demote a frequent k-mer; refuse it
    total_bases = sum(len(r) for r in reads)
    if total_bases >= (1 << 31):
        raise ValueError(
            "read stream >= 2^31 bases: int32 slot totals could overflow;"
            " split the batch"
        )
    if not all(0 < t <= MAX_THR for t in thrs):
        raise ValueError(f"thresholds must be in 1..{MAX_THR}")
    if chunk_bases is None:
        chunk_bases = int(os.environ.get("GPTPU_SORT_CHUNK_BASES", DEFAULT_CHUNK_BASES))
    # zero-length reads hold no k-mer, and drop out so offsets rise strictly
    keep = [(r, t) for r, t in zip(reads, thrs) if len(r)]
    reads, thrs = [r for r, _ in keep], [t for _, t in keep]
    if not reads:
        return [bloom.BloomFilter(bf_bytes, hash_num, k) for k in k_values]
    bits = bf_bytes * 8
    if total_bases <= chunk_bases:
        st = upload_stream(reads, thrs, device)
        return [
            _to_filter(fill_k(ops, st, k, ki - 2, hash_num, cbf_bytes, bits),
                       bf_bytes, hash_num, k)
            for ki, k in enumerate(k_values)
        ]
    # ---- chunked two-phase build ----
    totals = {k: torch.zeros(cbf_bytes, dtype=torch.int32, device=device)
              for k in k_values}
    reps: dict[int, list] = {k: [] for k in k_values}
    for g_reads, g_thrs in _groups(reads, thrs, chunk_bases):
        st = upload_stream(g_reads, g_thrs, device)
        for ki, k in enumerate(k_values):
            key, _cnt, thr = count_k(ops, st, k, ki - 2, hash_num, cbf_bytes, totals[k])
            reps[k].append((key, thr.to(torch.uint8)))
    bfs = []
    for k in k_values:
        rk, rc, rt = sorted_runs(ops, torch.cat([a for a, _ in reps[k]]),
                                 torch.cat([b for _, b in reps[k]]))
        words = torch.zeros(bits // 32, dtype=torch.int32, device=device)
        ops[3](rk, rc, rt, k, hash_num, cbf_bytes, totals[k], bits, words)
        bfs.append(_to_filter(words, bf_bytes, hash_num, k))
    return bfs


def _on_side_stream(fn, device):
    """Run fn() on a CUDA stream of its own (so a fill overlaps the scan
    pipes' streams); the filters' D2H synchronises only that stream."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return fn()
    with torch.cuda.stream(torch.cuda.Stream(device)):
        return fn()


def device_fill_bfs_sorted(reads: list[bytes], thrs: list[int],
                           k_values: list[int], hash_num: int,
                           cbf_bytes: int, bf_bytes: int,
                           chunk_bases: int | None = None,
                           device: str = "cuda") -> list[bloom.BloomFilter]:
    """Full multi-k fill from per-read thresholds -> one host
    bloom.BloomFilter per k (no CBFs: the slot totals live only on the
    device).  device "cuda" runs kernel 5 on a stream of its own and raises
    without CUDA; "cpu" runs the plain versions (tests)."""
    return _on_side_stream(lambda: _fill(
        KERNEL_OPS, reads, thrs, k_values, hash_num, cbf_bytes, bf_bytes,
        chunk_bases, device), device)


def device_fill_bfs_sorted_reference(reads: list[bytes], thrs: list[int],
                                     k_values: list[int], hash_num: int,
                                     cbf_bytes: int, bf_bytes: int,
                                     chunk_bases: int | None = None,
                                     device: str = "cpu") -> list[bloom.BloomFilter]:
    """The same fill with the plain torch versions on any device."""
    return _on_side_stream(lambda: _fill(
        PLAIN_OPS, reads, thrs, k_values, hash_num, cbf_bytes, bf_bytes,
        chunk_bases, device), device)
