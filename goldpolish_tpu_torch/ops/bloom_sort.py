"""The device Bloom fill (kernel 5) — the batch's multi-k filters built on
the device from its reads and per-read thresholds, with no sort.

Port counterpart: goldpolish_tpu/ops/bloom_sort.py (K3).  The JAX program
hashes every window of the read stream, sorts the hashes so that each
distinct k-mer becomes one run, adds each run's count into the h slots of
the counting-filter totals and promotes a k-mer whose smallest slot total
reaches its smallest threshold.  The port computes the same bits in two
passes over the windows of the stream (the reads concatenated; a window
that crosses into the next read or past the end is not valid), per k:

  A. `count`: every valid window adds 1 to each of its h slots (hash mod
     cbf_size) of int32 totals — a slot two of its hashes share gets 2, as
     the JAX `repeat(cnt, h)` scatter gives;
  B. `promote`, once pass A has seen every window: a valid window whose
     smallest slot total reaches its threshold, max(read threshold + ki -
     2, 1), sets its h bits.

A k-mer x with cnt(x) valid windows adds cnt(x) at each of its slots in
both, and it promotes in the JAX program iff its smallest slot total
reaches the smallest threshold among its windows, which is iff it does so
for one of its windows.  So the bits are the JAX program's, and a stream
above `chunk_bases` (pass A over every group of whole reads, then pass B
over every group, the uploads kept on the device between) gives the same
bits as single dispatch.

The result is a documented superset of the host fill (the JAX module's
docstring says why) and equals the JAX `device_fill_bfs_sorted` bit for bit,
with two differences that no test input reaches, both in ROADMAP.md queue 3:
no pad window is ever hashed or counted (in the JAX program a valid window
whose hash is exactly 2^64 - 1 shares its run with every pad of the halo'd
row grid), and slots and bits are indexed in 64 bits (the JAX build casts
them to int32).  The row grid (`PackedReadStream.codes`) is an XLA shape
bucket and has no counterpart.

The upload is always the raw read bytes, from a pinned buffer.  The JAX
`_stream_arrays` sends a group 2-bit packed (with up to 8192 non-ACGT
bytes beside it) and expands it on the device (`_stream_onehot_packed`);
that route has no counterpart here.  It gives the raw route's filters
(but for bytes 1, 3, 4 and 7, which it classes as seedless, ROADMAP.md
queue 3), and on the H100 packing a batch costs far more host time than
it saves in copies (ROADMAP.md, "Not to port").

`count` and `promote` launch csrc/bloom_sort.cu for CUDA tensors and run
their plain torch versions (`*_reference`, int64 lanes, ops/u64.py) for CPU
tensors.  `device_fill_bfs_sorted_reference` runs the whole fill with the
plain versions on any device.  The names keep the JAX module's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import bloom, u64
from .cuda_build import LaunchCounter, check, lib, require_cuda
from .scan_conv import _device_tables, _kmul, bit_index, strand_hashes_reference

KHALO = 32      # the JAX build's row halo; it supports any k <= KHALO + 1
MAX_THR = 15    # per-read thresholds must fit 4 bits (reference caps at 13)
# default chunk bound of the chunked build; GPTPU_SORT_CHUNK_BASES
# overrides it.  Results are bit-identical at any chunking.
DEFAULT_CHUNK_BASES = 1 << 21


def _hashes(base: torch.Tensor, k: int, h: int) -> list[torch.Tensor]:
    """The h ntHash values of each base hash (nte64)."""
    kmul = _kmul(k)
    out = [base]
    for i in range(1, h):
        t = base * u64.const(i ^ kmul)
        out.append(t ^ u64.lsr(t, 27))
    return out


# -- the plain versions -------------------------------------------------------


def valid_windows_reference(codes: torch.Tensor, offsets: torch.Tensor,
                            thrs: torch.Tensor, k: int, delta: int):
    """(base int64[m], thr int32[m]): the canonical hash and the threshold
    max(thrs[read] + delta, 1) of every window that lies inside its read,
    in stream order."""
    nw = codes.numel() - k + 1
    if nw <= 0:
        return (torch.zeros(0, dtype=torch.int64, device=codes.device),
                torch.zeros(0, dtype=torch.int32, device=codes.device))
    fh, rh = strand_hashes_reference(codes[None, :], k)
    p = torch.arange(nw, dtype=torch.int64, device=codes.device)
    r = torch.searchsorted(offsets[1:], p, right=True)
    valid = p + k <= offsets[r + 1]
    thr = torch.clamp(thrs[r].to(torch.int32) + delta, min=1)
    return (fh + rh)[0][valid], thr[valid]


def count_hashes_reference(base: torch.Tensor, k: int, h: int, cbf_size: int,
                           totals: torch.Tensor) -> None:
    """Pass A on given window hashes: totals int32[cbf_size] += 1 at each
    of the h slots of every hash (in place)."""
    ones = torch.ones(base.numel(), dtype=torch.int32, device=base.device)
    for hv in _hashes(base, k, h):
        totals.index_add_(0, u64.umod(hv, cbf_size), ones)


def promote_hashes_reference(base: torch.Tensor, thr: torch.Tensor, k: int, h: int,
                             cbf_size: int, totals: torch.Tensor, bits: int,
                             words: torch.Tensor) -> None:
    """Pass B on given window hashes: words int32[bits / 32] |= the h bits
    of every hash whose smallest slot total is >= its thr (in place)."""
    hs = _hashes(base, k, h)
    mins = torch.stack([totals[u64.umod(hv, cbf_size)] for hv in hs]).amin(dim=0)
    ok = mins >= thr
    setbits = torch.zeros(bits, dtype=torch.bool, device=words.device)
    for hv in hs:
        hv = hv[ok]
        setbits[bit_index(bits, hv)] = True
    weights = 1 << torch.arange(32, dtype=torch.int64, device=words.device)
    packed = (setbits.view(-1, 32).to(torch.int64) * weights).sum(dim=1)
    words |= (packed - ((packed >> 31) << 32)).to(torch.int32)  # wrap to int32


def count_reference(codes, offsets, thrs, k: int, h: int, cbf_size: int,
                    totals: torch.Tensor) -> None:
    """Pass A over one uploaded stream (plain torch)."""
    count_reference.calls.add()
    base, _thr = valid_windows_reference(codes, offsets, thrs, k, 0)
    count_hashes_reference(base, k, h, cbf_size, totals)


count_reference.calls = LaunchCounter()


def promote_reference(codes, offsets, thrs, k: int, delta: int, h: int,
                      cbf_size: int, totals: torch.Tensor, bits: int,
                      words: torch.Tensor) -> None:
    """Pass B over one uploaded stream (plain torch)."""
    promote_reference.calls.add()
    base, thr = valid_windows_reference(codes, offsets, thrs, k, delta)
    promote_hashes_reference(base, thr, k, h, cbf_size, totals, bits, words)


promote_reference.calls = LaunchCounter()


# -- the kernels ---------------------------------------------------------------


def _check_stream(name, codes, offsets, thrs, k, totals, cbf_size):
    require_cuda(codes, name)
    if (codes.dtype, offsets.dtype, thrs.dtype, totals.dtype) != (
            torch.uint8, torch.int64, torch.uint8, torch.int32):
        raise TypeError(f"{name} takes uint8 codes, int64 offsets, uint8 thrs, "
                        "int32 totals")
    if not 1 <= k <= KHALO + 1 or thrs.numel() + 1 != offsets.numel() or thrs.numel() < 1:
        raise ValueError(f"{name}: bad k={k} or read count")
    if any(t.device != codes.device or not t.is_contiguous()
           for t in (codes, offsets, thrs, totals)):
        raise ValueError(f"{name}: tensors on different devices or not contiguous")
    if totals.numel() != cbf_size:
        raise ValueError(f"{name}: totals must hold cbf_size slots")


def count(codes, offsets, thrs, k: int, h: int, cbf_size: int,
          totals: torch.Tensor) -> None:
    """codes uint8[n] (the reads concatenated), offsets int64[n_reads + 1]
    (strictly rising), thrs uint8[n_reads]: totals int32[cbf_size] += 1 at
    each of the h slots of every valid window.  CPU tensors run the plain
    version; CUDA tensors launch `bf_count`."""
    if codes.device.type == "cpu":
        return count_reference(codes, offsets, thrs, k, h, cbf_size, totals)
    _check_stream("count", codes, offsets, thrs, k, totals, cbf_size)
    if codes.numel() < k:
        return None
    tf, tr, fclass = _device_tables(k, str(codes.device))
    rc = lib().gp_bf_count(codes.data_ptr(), codes.numel(), offsets.data_ptr(),
                           thrs.numel(), k, tf.data_ptr(), tr.data_ptr(),
                           fclass.data_ptr(), h, _kmul(k), cbf_size, totals.data_ptr(),
                           torch.cuda.current_stream(codes.device).cuda_stream)
    check(rc, "gp_bf_count")
    count.launches.add()
    return None


count.launches = LaunchCounter()


def promote(codes, offsets, thrs, k: int, delta: int, h: int, cbf_size: int,
            totals: torch.Tensor, bits: int, words: torch.Tensor) -> None:
    """After `count` over every stream of the batch: words int32[bits / 32]
    |= the h bits of every valid window whose smallest slot total reaches
    max(thrs[read] + delta, 1).  CPU tensors run the plain version; CUDA
    tensors launch `bf_promote`."""
    if codes.device.type == "cpu":
        return promote_reference(codes, offsets, thrs, k, delta, h, cbf_size, totals,
                                 bits, words)
    _check_stream("promote", codes, offsets, thrs, k, totals, cbf_size)
    if words.dtype != torch.int32 or words.device != codes.device or \
            words.numel() * 32 != bits or not words.is_contiguous():
        raise ValueError("promote: words must be int32[bits / 32] on the codes' device")
    if codes.numel() < k:
        return None
    tf, tr, fclass = _device_tables(k, str(codes.device))
    rc = lib().gp_bf_promote(codes.data_ptr(), codes.numel(), offsets.data_ptr(),
                             thrs.numel(), thrs.data_ptr(), k, delta, tf.data_ptr(),
                             tr.data_ptr(), fclass.data_ptr(), h, _kmul(k), cbf_size,
                             totals.data_ptr(), bits, words.data_ptr(),
                             torch.cuda.current_stream(codes.device).cuda_stream)
    check(rc, "gp_bf_promote")
    promote.launches.add()
    return None


promote.launches = LaunchCounter()


# -- the fill -----------------------------------------------------------------

KERNEL_OPS = (count, promote)
PLAIN_OPS = (count_reference, promote_reference)


def fill_k(ops, streams, k: int, delta: int, h: int, cbf_size: int, bits: int):
    """One k's fill over the uploaded streams of a batch: pass A over every
    stream, then pass B over every stream -> filter words int32[bits / 32]."""
    dev = streams[0][0].device
    totals = torch.zeros(cbf_size, dtype=torch.int32, device=dev)
    for st in streams:
        ops[0](*st, k, h, cbf_size, totals)
    words = torch.zeros(bits // 32, dtype=torch.int32, device=dev)
    for st in streams:
        ops[1](*st, k, delta, h, cbf_size, totals, bits, words)
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
    groups = [(reads, thrs)] if total_bases <= chunk_bases else \
        _groups(reads, thrs, chunk_bases)
    streams = [upload_stream(g_reads, g_thrs, device) for g_reads, g_thrs in groups]
    return [
        _to_filter(fill_k(ops, streams, k, ki - 2, hash_num, cbf_bytes, bf_bytes * 8),
                   bf_bytes, hash_num, k)
        for ki, k in enumerate(k_values)
    ]


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
