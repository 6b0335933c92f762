"""The plain Bloom filter the reference's editor and sealer probe.

Semantics of btllib's KmerBloomFilter as the pipeline uses it: bit index
= hash % (bytes * 8), bit i in byte i >> 3 at position i & 7.

Frozen copy of goldpolish_tpu_torch/ops/bloom.py's BloomFilter for the
benchmark's plain reference (NumPy and Python only; it imports nothing of
the port).  The counting filter and the fill are reference/fill.py's.
"""

from __future__ import annotations

import numpy as np


class BloomFilter:
    """Plain Bloom filter over precomputed 64-bit hash tuples."""

    def __init__(self, bytes_size: int, hash_num: int, k: int = 0):
        self.bytes = int(bytes_size)
        self.bits = np.uint64(self.bytes * 8)
        self._bits_i = self.bytes * 8
        self.hash_num = int(hash_num)
        self.k = int(k)
        self.array = np.zeros(self.bytes, dtype=np.uint8)

    def insert(self, hashes: np.ndarray) -> None:
        """Set bits for hash tuples; hashes is uint64[..., hash_num]."""
        idx = (hashes.reshape(-1) % self.bits).astype(np.int64)
        np.bitwise_or.at(self.array, idx >> 3, np.uint8(1) << (idx & 7).astype(np.uint8))

    def contains(self, hashes: np.ndarray) -> np.ndarray:
        """True where all hash_num bits are set; hashes uint64[..., hash_num]."""
        idx = (hashes % self.bits).astype(np.int64)
        bits = (self.array[idx >> 3] >> (idx & 7).astype(np.uint8)) & 1
        return bits.all(axis=-1)

    def contains_one(self, hashes) -> bool:
        return bool(self.contains(np.asarray(hashes, dtype=np.uint64)[None, :])[0])

    def contains_tuple(self, hashes) -> bool:
        """Scalar probe over a tuple of python-int hashes (the editor's
        dirty-zone hot path — plain int arithmetic, no numpy overhead)."""
        bits = self._bits_i
        arr = self.array
        for h in hashes:
            b = h % bits
            if not (arr[b >> 3] >> (b & 7)) & 1:
                return False
        return True
