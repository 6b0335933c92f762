"""Device-resident Bloom filter words and the packed dense probe (K4).

Port counterpart: goldpolish_tpu/ops/bloom_jax.py, only what the editor's
`jax` backend calls: `to_device_words` (:23) and `probe_kmers_packed`
(:115).  The packed probe computes kernel 2's function (canonical ntHash of
every k-window, h hashes, the filter test, presence packed 8 windows to a
byte in little-endian bit order, pad bits 0), so it runs through
ops/scan_conv.scan_present_packed: the CUDA kernel for CUDA tensors, its
plain torch version for CPU tensors.  probe_words, probe_kmers and
build_words are not ported yet (the sealer's device arm needs them,
ROADMAP.md queue 1); counted_build_words is not to port.

A bit count that is not a power of two is probed at the full 64-bit
`hash % bits`; the JAX probe casts that index to uint32 (bloom_jax.py:39),
which differs only for filters of 2^32 bits or more.
"""

from __future__ import annotations

import numpy as np
import torch

from .scan_conv import scan_present_packed

MAX_ROWS = 65535  # kernel 2's rows per call (csrc/scan_conv.cu: grid.y)


def to_device_words(bf, device: str) -> torch.Tensor:
    """Upload a host BloomFilter's bit array as int32 words (the bits of its
    little-endian uint32 words) to `device`."""
    words = np.ascontiguousarray(bf.words_u32()).view(np.int32)
    return torch.from_numpy(words.copy()).to(device)


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
