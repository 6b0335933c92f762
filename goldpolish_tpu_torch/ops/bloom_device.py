"""Device-resident Bloom filter words and the device probes and build (K4).

Port counterpart: goldpolish_tpu/ops/bloom_jax.py: `to_device_words` (:23),
`probe_words` (:28), `probe_kmers` (:45), `build_words` (:54) and
`probe_kmers_packed` (:115); `counted_build_words` is not to port.  The
packed probe computes kernel 2's function (canonical ntHash of every
k-window, h hashes, the filter test, presence packed 8 windows to a byte in
little-endian bit order, pad bits 0), so it runs through
ops/scan_conv.scan_present_packed: the CUDA kernel for CUDA tensors, its
plain torch version for CPU tensors.  probe_words, probe_kmers and
build_words are plain torch code on tensors of any device: probe_kmers is
the plain version of the sealer's extension probe (ops/dbg_extend.py),
probe_words what the mesh (K9) will need, build_words completes K4.

Hashes are uint64 held in int64 lanes (ops/u64.py).  A bit count that is
not a power of two is probed and set at the full 64-bit `hash % bits`; the
JAX probe casts that index to uint32 (bloom_jax.py:39) and the JAX build to
int32 (:67-69), which differ only for filters of 2^32 and 2^31 bits or more.
"""

from __future__ import annotations

import numpy as np
import torch

from . import nthash_device as ntd
from .cuda_build import to_device
from .scan_conv import bit_index, probe_bit_reference, scan_present_packed

MAX_ROWS = 65535  # kernel 2's rows per call (csrc/scan_conv.cu: grid.y)


def to_device_words(bf, device: str) -> torch.Tensor:
    """Upload a host BloomFilter's bit array as int32 words (the bits of its
    little-endian uint32 words) to `device`, through pinned memory."""
    return to_device(np.ascontiguousarray(bf.words_u32()).view(np.int32), device)


def probe_words(words: torch.Tensor, bits: int, hashes: torch.Tensor) -> torch.Tensor:
    """Membership of hash tuples: hashes int64 [..., h] (uint64 bits) ->
    bool [...], True where all h bits are set in words int32 [ceil(bits/32)]."""
    return probe_bit_reference(words.to(torch.int64), bits, hashes).all(-1)


def probe_kmers(words: torch.Tensor, bits: int, hash_num: int, k: int,
                codes: torch.Tensor) -> torch.Tensor:
    """Presence of every k-window of codes uint8 [..., n] -> bool [..., n-k+1]."""
    base = ntd.canonical_hashes(codes, k)
    return probe_words(words, bits, ntd.multi_hashes(base, k, hash_num))


def build_words(bits: int, hashes: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """A plain filter's words from hash tuples: hashes int64 [..., h]
    (uint64 bits), mask an optional bool [...] selecting the tuples to set
    (the others set nothing).  Returns int32 [ceil(bits/32)] on the hashes'
    device, the bits of the little-endian uint32 words."""
    idx = bit_index(bits, hashes)
    if mask is not None:
        idx = idx[mask]
    nwords = -(-bits // 32)
    bitarr = torch.zeros(nwords * 32, dtype=torch.uint8, device=hashes.device)
    bitarr[idx.reshape(-1)] = 1
    pows = torch.ones(32, dtype=torch.int64, device=hashes.device) << torch.arange(
        32, device=hashes.device)
    words = (bitarr.view(nwords, 32).to(torch.int64) * pows).sum(1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def probe_kmers_packed(words: torch.Tensor, bits: int, hash_num: int, k: int,
                       codes: torch.Tensor) -> torch.Tensor:
    """Presence of every k-window of codes uint8 [..., n] (n >= k), packed:
    uint8 [..., ceil((n-k+1)/8)], window w at bit w & 7 of byte w >> 3
    (unpack with np.unpackbits(..., bitorder='little')).  Rows go to kernel
    2 in chunks of at most MAX_ROWS."""
    lead, n = codes.shape[:-1], codes.shape[-1]
    rows = codes.reshape(-1, n)
    out = [scan_present_packed(words, bits, hash_num, k, rows[i : i + MAX_ROWS])
           for i in range(0, max(1, rows.shape[0]), MAX_ROWS)]
    packed = torch.cat(out) if len(out) > 1 else out[0]
    return packed.reshape(*lead, packed.shape[-1])
