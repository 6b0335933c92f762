"""Bloom filters: plain + 8-bit counting, host (NumPy) and device (JAX) paths.

Semantics follow btllib's KmerBloomFilter / KmerCountingBloomFilter8 as used
by the reference pipeline:

 * bit/counter index = hash % (bytes * 8)  (one counter per byte for the CBF),
   byte-addressed little-endian bit layout (bit i lives in byte i>>3 at
   position i&7) — a uint32 little-endian view preserves bit indexing, which
   is what the device probe path uses.
 * `insert_thresh_contains(hashes, t)` implements conservative-update
   counting: read the minimum counter over the hash slots; if below t,
   increment exactly the minimum slots and report the post-increment count,
   else report the saturated count without inserting.  The reference promotes
   a k-mer into the plain BF when this reported count reaches the per-k
   escalating threshold (reference: src/utils.cpp:96-123).
 * Default sizes: 10 MiB CBF + 512 KiB BF, 4 hashes
   (reference: src/goldpolish_targeted_bfs.cpp:270-272).

Note: btllib is not vendored or linked; these are from-scratch
reimplementations whose behavior is pinned by this package's own tests.
The 512 KiB default makes the bit count a power of two, so the device probe
reduces the modulo to a mask.

Port counterpart: goldpolish_tpu/ops/bloom.py, copied with only the imports renamed
(this package must import without jax).
"""

from __future__ import annotations

import json
import os

import numpy as np

DEFAULT_CBF_BYTES = 10 * 1024 * 1024
DEFAULT_BF_BYTES = 512 * 1024
DEFAULT_HASH_NUM = 4

_MAGIC = "GPTPU_BF1"


def _alloc_u8(nbytes: int) -> np.ndarray:
    """Zeroed uint8 array for filter storage, huge-page-backed when large.

    The fill loop (native fill_read_one_k) is random-access bound over the
    CBF+BF working set (~56 MiB at production sizes for a 4-k sweep); on
    4 KiB pages nearly every probe also misses the dTLB and pays a page
    walk.  An anonymous mmap with MADV_HUGEPAGE (honored under THP
    'madvise' mode) measured ~1.1x on the single-thread fill.  The mmap
    object stays alive as the array's .base; falls back to np.zeros when
    mmap/madvise is unavailable."""
    if nbytes >= (2 << 20):
        try:
            import mmap

            # MAP_PRIVATE matters twice over: THP under shmem_enabled=never
            # ignores MADV_HUGEPAGE on MAP_SHARED|MAP_ANONYMOUS (the
            # mmap.mmap(-1, n) default), and MAP_SHARED would turn fork-pool
            # COW into live cross-process mutation of filter arrays.
            m = mmap.mmap(
                -1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
            )
        except (OSError, ValueError, AttributeError):
            return np.zeros(nbytes, dtype=np.uint8)
        try:
            m.madvise(mmap.MADV_HUGEPAGE)
        except (OSError, AttributeError):
            pass  # advice failed; the mmap itself is still fine to use
        return np.frombuffer(m, dtype=np.uint8)
    return np.zeros(nbytes, dtype=np.uint8)


class BloomFilter:
    """Plain Bloom filter over precomputed 64-bit hash tuples."""

    def __init__(self, bytes_size: int = DEFAULT_BF_BYTES, hash_num: int = DEFAULT_HASH_NUM, k: int = 0):
        self.bytes = int(bytes_size)
        self.bits = np.uint64(self.bytes * 8)
        self._bits_i = self.bytes * 8
        self.hash_num = int(hash_num)
        self.k = int(k)
        self.array = _alloc_u8(self.bytes)

    # -- host path ------------------------------------------------------------
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

    @property
    def pop_count(self) -> int:
        return int(np.unpackbits(self.array).sum())

    # -- device view ----------------------------------------------------------
    def words_u32(self) -> np.ndarray:
        """uint32 little-endian word view (bit i -> word i>>5, bit i&31)."""
        return self.array.view("<u4")

    # -- serialization (own format; the reference round-trips BFs through
    #    /dev/shm files, reference: scripts/goldpolish:517-518) ---------------
    def save(self, path: str) -> None:
        header = {
            "magic": _MAGIC,
            "type": "bf",
            "bytes": self.bytes,
            "hash_num": self.hash_num,
            "k": self.k,
        }
        with open(path, "wb") as f:
            f.write((json.dumps(header) + "\n").encode())
            f.write(self.array.tobytes())

    @classmethod
    def load(cls, path: str) -> "BloomFilter":
        with open(path, "rb") as f:
            try:
                header = json.loads(f.readline().decode())
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                raise ValueError(
                    f"{path}: not a {_MAGIC} Bloom filter file (bad header)"
                ) from e
            if header.get("magic") != _MAGIC or header.get("type") != "bf":
                raise ValueError(f"{path}: not a {_MAGIC} Bloom filter file")
            bf = cls(header["bytes"], header["hash_num"], header["k"])
            data = f.read(bf.bytes)
        bf.array = np.frombuffer(data, dtype=np.uint8).copy()
        return bf


class CountingBloomFilter8:
    """8-bit counting Bloom filter with conservative (minimum) updates."""

    def __init__(self, bytes_size: int = DEFAULT_CBF_BYTES, hash_num: int = DEFAULT_HASH_NUM, k: int = 0):
        self.bytes = int(bytes_size)
        self.size = np.uint64(self.bytes)  # one uint8 counter per byte
        self.hash_num = int(hash_num)
        self.k = int(k)
        self.counters = _alloc_u8(self.bytes)

    def contains(self, hashes: np.ndarray) -> np.ndarray:
        """Minimum counter over the hash slots; hashes uint64[..., hash_num]."""
        idx = (hashes % self.size).astype(np.int64)
        return self.counters[idx].min(axis=-1)

    def insert_thresh_contains(self, hashes: np.ndarray, threshold: int) -> int:
        """Conservative insert capped at `threshold`; returns resulting count.

        Single hash tuple (uint64[hash_num]).  Mirrors the reference call
        pattern in fill_bfs (reference: src/utils.cpp:114-118).
        """
        idx = (np.asarray(hashes, dtype=np.uint64) % self.size).astype(np.int64)
        vals = self.counters[idx]
        m = int(vals.min())
        if m >= threshold:
            return m
        self.counters[idx[vals == m]] = m + 1
        return m + 1


def fill_bfs(
    seq_codes: np.ndarray,
    hash_num: int,
    k_values: list[int],
    kmer_threshold: int,
    cbfs: list[CountingBloomFilter8],
    bfs: list[BloomFilter],
) -> None:
    """Host oracle of the reference BF fill (reference: src/utils.cpp:96-123).

    Per k (in order), every k-mer of the read is inserted into the counting
    BF with an escalating threshold (kmer_threshold-2 for the first k, +1 per
    subsequent k) and promoted into the plain BF once the count reaches the
    threshold.  Insertion order is the read's k-mer order — required for
    determinism of the conservative-update dynamics.

    Slow (python loop per k-mer): used as test oracle and small-input
    fallback.  The production path is the native builder
    (goldpolish_tpu_torch/native) or the device builder (ops/bloom_jax.py).
    """
    from . import nthash as nt

    if kmer_threshold < 4:
        raise ValueError("kmer_threshold must be >= 4 (reference utils.cpp:105)")
    thresh = kmer_threshold - 2
    for k, cbf, bf in zip(k_values, cbfs, bfs):
        if len(seq_codes) >= k:
            base = nt.canonical_hashes(seq_codes, k)
            all_hashes = nt.multi_hashes(base, k, hash_num)
            for hs in all_hashes:
                if cbf.insert_thresh_contains(hs, thresh) >= thresh:
                    bf.insert(hs[None, :])
        thresh += 1


# --- "BlOOMFXX" interop (the reference's vendored ntEdit BloomFilter.hpp) ----
# Packed on-disk header (reference: subprojects/ntedit/lib/BloomFilter.hpp:32-41,
# #pragma pack(1)): magic[8] hlen:u32 size:u64(bits) nhash:u32 kmer:u32
# dFPR:f64 nEntry:u64 tEntry:u64, followed by (size+7)/8 raw filter bytes.
# That filter addresses bit i as byte i/8, bit (7 - i%8) — MSB-first within
# the byte (BloomFilter.hpp:81) — while this package (and btllib) use
# LSB-first (bit i&7), so conversion reverses the bits of every byte.
# btllib's own .bf container is NOT re-implemented: its source is not
# vendored in the reference tree and is unavailable in this environment to
# match byte-for-byte; the vendored format here is the one the reference
# ships and the one we can pin exactly.
_NTEDIT_MAGIC = b"BlOOMFXX"
_NTEDIT_HEADER = "<8sIQIIdQQ"

_BITREV = np.array(
    [int(f"{i:08b}"[::-1], 2) for i in range(256)], dtype=np.uint8
)


def save_ntedit_bf(bf: BloomFilter, path: str) -> None:
    """Write in the reference's vendored ntEdit BloomFilter format."""
    import struct

    header = struct.pack(
        _NTEDIT_HEADER, _NTEDIT_MAGIC, struct.calcsize(_NTEDIT_HEADER),
        bf.bytes * 8, bf.hash_num, bf.k,
        float((bf.pop_count / (bf.bytes * 8)) ** bf.hash_num), 0, 0,
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(_BITREV[bf.array].tobytes())


def load_ntedit_bf(path: str) -> BloomFilter:
    """Read a vendored-ntEdit-format filter into this package's layout."""
    import struct

    hlen = struct.calcsize(_NTEDIT_HEADER)
    with open(path, "rb") as f:
        raw = f.read(hlen)
        magic, _hl, size, nhash, kmer, _fpr, _ne, _te = struct.unpack(
            _NTEDIT_HEADER, raw
        )
        if magic != _NTEDIT_MAGIC:
            raise ValueError(f"{path}: not a {_NTEDIT_MAGIC!r} Bloom filter")
        if size % 8:
            raise ValueError(
                f"{path}: bit count {size} is not byte-aligned; this "
                "package's probes index bits as bytes*8"
            )
        data = np.frombuffer(f.read((size + 7) // 8), np.uint8)
    bf = BloomFilter(size // 8, nhash, kmer)
    bf.array = _BITREV[data].copy()
    return bf


# --- btllib KmerBloomFilter container (best-effort interop) ------------------
# The reference's per-batch .bf artifacts are btllib::KmerBloomFilter files:
# written by the BF-builder server (reference: src/goldpolish_targeted_bfs.cpp
# :139 `bfs[i]->save(...)`) and loaded by ntedit-gr, which reads k and
# hash_num back from the header (reference: subprojects/ntedit/ntedit.cpp
# :2012-2022).  btllib's container is a cpptoml-serialized header —
# `[BTLKmerBloomFilter_v6]` section with bytes/hash_num/k keys (cpptoml
# tables are std::map, so keys emit in alphabetical order), terminated by
# `[HeaderEnd]\n` — followed by the raw filter byte array.  btllib's bit
# layout is LSB-first within each byte (BIT_MASKS = 1<<0..1<<7) and probes
# index `hash % (bytes*8)`, both identical to this package's BloomFilter,
# so the payload copies byte-for-byte with no bit reversal.
#
# CAVEAT (documented, PARITY.md): btllib is absent from this environment and
# the reference tree does not vendor it, so this writer/reader is
# best-effort from the btllib v1.x container spec and is pinned only by
# round-trip self-tests here — a byte-level diff against a real
# btllib-produced file is unverifiable offline.  The reader is tolerant
# (any [BTL*BloomFilter_v*] signature, indentation- and order-insensitive
# key=value pairs); the writer emits the cpptoml layout (4-space-indented
# keys, alphabetical).
_BTLLIB_KBF_SIGNATURE = "[BTLKmerBloomFilter_v6]"
_BTLLIB_HEADER_END = b"[HeaderEnd]"


def save_btllib_bf(bf: BloomFilter, path: str) -> None:
    """Write in the btllib KmerBloomFilter v6 container (best-effort)."""
    lines = [_BTLLIB_KBF_SIGNATURE]
    for key, val in (("bytes", bf.bytes), ("hash_num", bf.hash_num),
                     ("k", bf.k)):
        lines.append(f"    {key} = {val}")
    lines.append("[HeaderEnd]")
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode())
        f.write(bf.array.tobytes())


def load_btllib_bf(path: str, k: int | None = None) -> BloomFilter:
    """Read a btllib plain Bloom-filter container into this package's
    layout.  A header without `k` raises unless the caller passes `k`
    (the JAX package's loader takes 0 there)."""
    fields: dict[str, int] = {}
    with open(path, "rb") as f:
        saw_end = False
        while True:
            line = f.readline()
            if not line:
                break
            s = line.strip()
            if s == _BTLLIB_HEADER_END:
                saw_end = True
                break
            if s.startswith(b"[") or b"=" not in s:
                continue
            key, _, val = s.partition(b"=")
            try:
                fields[key.strip().decode()] = int(val.strip())
            except ValueError:
                continue  # non-integer metadata: ignore
        if not saw_end:
            raise ValueError(f"{path}: no {_BTLLIB_HEADER_END.decode()}"
                             " terminator — not a btllib Bloom filter file")
        if "bytes" not in fields or "hash_num" not in fields:
            raise ValueError(
                f"{path}: btllib header missing bytes/hash_num fields"
            )
        if "k" not in fields and k is None:
            raise ValueError(f"{path}: btllib header has no k field; pass k=")
        bf = BloomFilter(fields["bytes"], fields["hash_num"],
                         fields["k"] if "k" in fields else k)
        data = f.read(bf.bytes)
    if len(data) != bf.bytes:
        raise ValueError(
            f"{path}: truncated filter payload ({len(data)} of {bf.bytes}"
            " bytes)"
        )
    bf.array = np.frombuffer(data, dtype=np.uint8).copy()
    return bf


def load_any(path: str) -> BloomFilter:
    """Load a filter in any supported on-disk format (by magic)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        head = f.read(64)
    if head.startswith(_NTEDIT_MAGIC):
        return load_ntedit_bf(path)
    first = head.split(b"\n", 1)[0].strip()
    if (first.startswith(b"[BTL") and b"BloomFilter" in first):
        if b"Counting" in first or b"Seed" in first:
            # their payloads are not a plain bit array (the JAX package's
            # load_any reads them as one)
            raise ValueError(
                f"{path}: {first.decode(errors='replace')} is not a plain Bloom "
                "filter container"
            )
        return load_btllib_bf(path)
    return BloomFilter.load(path)
