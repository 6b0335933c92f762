"""The fused dense scan (kernel 2) and the device scanner that runs it.

Port counterpart: goldpolish_tpu/ops/scan_conv.py (K1,
scan_present_packed_gather :190 and scan_present_packed_mxu :228, and
DeviceScanner :274).  For every k-window of byte codes [B, L] the scan
computes the canonical ntHash, derives h hashes, probes the Bloom filter
and packs presence 8 windows per byte, little-endian.

The JAX version computes the window hash as a bit-sliced convolution on the
MXU; the port computes the same XOR sums directly:

    fh(w) = XOR_j TF[j][class(s[w+j])]    TF[j][c] = srol^(k-1-j)(seed_c)
    rh(w) = XOR_j TR[j][s[w+j] & 7]       TR[j][c] = srol^j(seedTab[c])

(goldpolish_tpu/ops/scan_conv.py:59-77 builds the same tables as bit
columns).  class(c) is read from ntHash's 256-entry seed table, so every
byte value hashes as ops/nthash.py does.  Two deliberate differences from
the JAX scan, both toward the host filter that the walker probes:

* bytes 1, 3, 4 and 7 carry forward seeds in ntHash's table
  (ops/nthash.py:56-66); the JAX one-hot (scan_conv.py:90-97) classes them
  as "no seed", the port does not;
* a bit count that is not a power of two is probed at the full 64-bit
  `hash % bits` (ops/bloom.py:89), not at the JAX `lo32 % bits`
  (scan_conv.py:196-199).

`scan_present_packed` launches the CUDA kernel of csrc/scan_conv.cu for
CUDA tensors and runs `scan_present_packed_reference`, the plain torch
version on int64 lanes (ops/u64.py), for CPU tensors.

`DeviceScanner.enable_eval` arms the fused phase-A eval of ops/scan_eval.py
(K2, the JAX scanner's `enable_eval` :378-458); `scan_eval_packed` then runs
it.  The scanner shards its rows over devices as the JAX scanner's mesh
does (K9: `_sharded_scan` :333-375 and the eval's shard_map :399-423): the
filter is replicated and each shard runs kernel 2 or kernel 4 on its own
rows.  Its shards are the GPUs of this process, never those of other hosts
(the JAX scanner's mesh spans `jax.devices()`, every host's in a
multi-process run).

`scan_present_packed2` (kernel 8, csrc/scan_conv.cu) is the same scan over
the 2-bit packed transfer of the JAX package (scan_present_packed2_gather
:206 and scan_present_packed2_mxu :247, `_classes_from_packed` :104, the
scanner's `scan_packed2` :498-527 and its "scan2" shard_map :357-366): base
i of a row in bits 2 * (i & 3) of byte i >> 2 (A, C, G, T = 0-3, lowercase
packed as uppercase), plus per row the positions and raw bytes of every
other byte (native.pack2); an entry whose position is not in [0, L) is
padding.  The port writes the raw bytes back before hashing, so the packed
route gives the raw route's bits on every byte value, the seeded bytes 1,
3, 4 and 7 too (the JAX route classes every exception as seedless,
scan_conv.py:130).  `scan_present_packed2_reference` is its plain version.
The filter's words go to each device through pinned memory
(cuda_build.to_device).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from . import nthash as nt
from . import u64
from .cuda_build import LaunchCounter, check, lib, require_cuda, to_device

NO_CLASS = 4  # forward class of a byte without a seed


@functools.lru_cache(maxsize=64)
def _xor_tables(k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(TF uint64[k, 4], TR uint64[k, 8], fclass uint8[256]) of the scan."""
    fwd = [nt.SEED_A, nt.SEED_C, nt.SEED_G, nt.SEED_T]
    tf = np.array(
        [[int(nt.srol_n(np.uint64(s), k - 1 - j)) for s in fwd] for j in range(k)],
        np.uint64,
    ).reshape(k, 4)
    tr = np.array(
        [[int(nt.srol_n(nt.SEED_TAB[c], j)) for c in range(8)] for j in range(k)],
        np.uint64,
    ).reshape(k, 8)
    fclass = np.full(256, NO_CLASS, np.uint8)
    for cls, s in enumerate(fwd):
        fclass[nt.SEED_TAB == np.uint64(s)] = cls
    return tf, tr, fclass


@functools.lru_cache(maxsize=64)
def _device_tables(k: int, device: str):
    """The scan tables as tensors on `device` (int64 lanes, uint8 classes)."""
    tf, tr, fclass = _xor_tables(k)
    return (
        torch.from_numpy(tf.view(np.int64).copy()).to(device),
        torch.from_numpy(tr.view(np.int64).copy()).to(device),
        torch.from_numpy(fclass.copy()).to(device),
    )


def _kmul(k: int) -> int:
    """k * MULTI_SEED mod 2^64 (ntHash's extra-hash multiplier base)."""
    return (k * int(nt.MULTI_SEED)) & ((1 << 64) - 1)


def pack_bits(pres: torch.Tensor) -> torch.Tensor:
    """bool [B, n] -> uint8 [B, ceil(n/8)], little-endian bit order."""
    b, n = pres.shape
    pad = (-n) % 8
    if pad:
        pres = torch.cat([pres, pres.new_zeros(b, pad)], dim=1)
    weights = 1 << torch.arange(8, device=pres.device, dtype=torch.int32)
    grouped = pres.reshape(b, -1, 8).to(torch.int32) * weights
    return grouped.sum(dim=-1).to(torch.uint8)


def strand_hashes_reference(codes: torch.Tensor, k: int):
    """(fh, rh) int64 [B, L-k+1] of every window of codes [B, L] (L >= k),
    from the XOR tables of the kernel."""
    b, length = codes.shape
    nw = length - k + 1
    tf, tr, fclass = _device_tables(k, str(codes.device))
    tf5 = torch.cat([tf, tf.new_zeros(k, 1)], dim=1)  # class 4 -> no seed
    c = codes.to(torch.int64)
    clsf = fclass.to(torch.int64)[c]
    clsr = c & 7
    fh = torch.zeros(b, nw, dtype=torch.int64, device=codes.device)
    rh = torch.zeros_like(fh)
    for j in range(k):
        fh ^= tf5[j][clsf[:, j : j + nw]]
        rh ^= tr[j][clsr[:, j : j + nw]]
    return fh, rh


def bit_index(bits: int, hv: torch.Tensor) -> torch.Tensor:
    """The filter bit of each hash: a mask for a power-of-two filter, the
    unsigned 64-bit `hash % bits` otherwise."""
    if not 1 <= bits < (1 << 62):
        raise ValueError(f"unsupported filter size: {bits} bits")
    return hv & (bits - 1) if bits & (bits - 1) == 0 else u64.umod(hv, bits)


def probe_bit_reference(words64: torch.Tensor, bits: int,
                        hv: torch.Tensor) -> torch.Tensor:
    """The filter bit of each hash (words64: the int32 words as int64)."""
    idx = bit_index(bits, hv)
    return ((words64[idx >> 5] >> (idx & 31)) & 1).bool()


def probe_full_reference(words64: torch.Tensor, bits: int, base: torch.Tensor,
                         k: int, h: int) -> torch.Tensor:
    """All h hashes of each canonical base hash (any shape) present."""
    kmul = _kmul(k)
    pres = probe_bit_reference(words64, bits, base)
    for i in range(1, h):
        t = base * u64.const(i ^ kmul)
        pres &= probe_bit_reference(words64, bits, t ^ u64.lsr(t, nt.MULTI_SHIFT))
    return pres


def _scan_reference(words: torch.Tensor, bits: int, h: int, k: int,
                    codes: torch.Tensor) -> torch.Tensor:
    b, length = codes.shape
    if length - k + 1 <= 0:
        return torch.zeros(b, 0, dtype=torch.uint8, device=codes.device)
    fh, rh = strand_hashes_reference(codes, k)
    return pack_bits(probe_full_reference(words.to(torch.int64), bits, fh + rh, k, h))


def scan_present_packed_reference(words: torch.Tensor, bits: int, h: int, k: int,
                                  codes: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the fused scan (any device)."""
    scan_present_packed_reference.calls.add()
    return _scan_reference(words, bits, h, k, codes)


scan_present_packed_reference.calls = LaunchCounter()

# the code byte of each 2-bit class: A, C, G, T
_ACGT = np.frombuffer(b"ACGT", np.uint8)


def unpack2_reference(L: int, packed: torch.Tensor, exc_idx: torch.Tensor,
                      exc_byte: torch.Tensor) -> torch.Tensor:
    """The code bytes uint8 [B, L] of a 2-bit packed call: the bases of
    packed uint8 [B, >= ceil(L/4)] as 'A', 'C', 'G', 'T', then the raw
    byte of each exception whose position lies in [0, L)."""
    b = packed.shape[0]
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    cls = ((packed[..., None] >> shifts) & 3).reshape(b, -1)[:, :L]
    codes = torch.from_numpy(_ACGT.copy()).to(packed.device)[cls.to(torch.int64)]
    idx = exc_idx.to(torch.int64)
    keep = (idx >= 0) & (idx < L)
    rows = torch.arange(b, device=packed.device)[:, None].expand_as(idx)
    codes[rows[keep], idx[keep]] = exc_byte[keep].to(torch.uint8)
    return codes


def scan_present_packed2_reference(words: torch.Tensor, bits: int, h: int, k: int,
                                   L: int, packed: torch.Tensor, exc_idx: torch.Tensor,
                                   exc_byte: torch.Tensor) -> torch.Tensor:
    """Plain torch version of kernel 8 (any device): the rows decoded
    (unpack2_reference), then the plain scan."""
    scan_present_packed2_reference.calls.add()
    return _scan_reference(words, bits, h, k, unpack2_reference(L, packed, exc_idx,
                                                                exc_byte))


scan_present_packed2_reference.calls = LaunchCounter()


def scan_present_packed(words: torch.Tensor, bits: int, h: int, k: int,
                        codes: torch.Tensor) -> torch.Tensor:
    """codes uint8 [B, L] -> packed presence uint8 [B, ceil((L-k+1)/8)].

    words int32[ceil(bits/32)] on the same device.  CPU tensors run the
    plain version; CUDA tensors launch the kernel on the current stream."""
    if codes.dim() != 2:
        raise ValueError(f"codes must be [B, L], got shape {tuple(codes.shape)}")
    if k < 1 or h < 1 or bits < 1 or bits >= (1 << 62):
        raise ValueError(f"unsupported scan parameters k={k} h={h} bits={bits}")
    if codes.device.type == "cpu":
        return scan_present_packed_reference(words, bits, h, k, codes)
    require_cuda(codes, "scan_present_packed")
    if words.device != codes.device:
        raise ValueError("words and codes must lie on the same device")
    if codes.dtype != torch.uint8 or words.dtype != torch.int32:
        raise TypeError("scan_present_packed takes uint8 codes and int32 words")
    if words.numel() * 32 < bits:
        raise ValueError("words hold fewer than `bits` bits")
    if codes.shape[0] > 65535:
        raise ValueError("at most 65535 rows per call")
    codes = codes.contiguous()
    words = words.contiguous()
    b, length = codes.shape
    nw = max(0, length - k + 1)
    out = torch.empty(b, (nw + 7) // 8, dtype=torch.uint8, device=codes.device)
    if nw == 0 or b == 0:
        return out
    tf, tr, fclass = _device_tables(k, str(codes.device))
    rc = lib().gp_scan_present_packed(
        words.data_ptr(), bits, h, k, codes.data_ptr(), b, length,
        tf.data_ptr(), tr.data_ptr(), fclass.data_ptr(), _kmul(k),
        out.data_ptr(), torch.cuda.current_stream(codes.device).cuda_stream,
    )
    check(rc, "gp_scan_present_packed")
    scan_present_packed.launches.add()
    return out


scan_present_packed.launches = LaunchCounter()


def scan_present_packed2(words: torch.Tensor, bits: int, h: int, k: int, L: int,
                         packed: torch.Tensor, exc_idx: torch.Tensor,
                         exc_byte: torch.Tensor) -> torch.Tensor:
    """The scan over a 2-bit packed call (the argument order of the JAX
    scan_present_packed2_gather): packed uint8 [B, ceil(L/4)] (wider rows
    are read up to L), exc_idx int64 [B, E] and exc_byte uint8 [B, E] the
    positions and raw bytes of the non-ACGT bytes (positions outside [0, L)
    are padding; no position twice in a row) -> packed presence uint8
    [B, ceil((L-k+1)/8)], the raw scan's bits of the decoded rows.

    CPU tensors run the plain version; CUDA tensors launch kernel 8 on the
    current stream."""
    if packed.dim() != 2 or exc_idx.dim() != 2 or exc_byte.shape != exc_idx.shape \
            or exc_idx.shape[0] != packed.shape[0]:
        raise ValueError("packed must be [B, P], exc_idx and exc_byte [B, E]")
    if packed.shape[1] * 4 < L:
        raise ValueError(f"packed rows of {packed.shape[1]} bytes hold fewer than L={L} bases")
    if k < 1 or h < 1 or bits < 1 or bits >= (1 << 62):
        raise ValueError(f"unsupported scan parameters k={k} h={h} bits={bits}")
    if packed.device.type == "cpu":
        return scan_present_packed2_reference(words, bits, h, k, L, packed, exc_idx,
                                              exc_byte)
    require_cuda(packed, "scan_present_packed2")
    if not all(t.device == packed.device for t in (words, exc_idx, exc_byte)):
        raise ValueError("words, packed and the exceptions must lie on the same device")
    if (packed.dtype != torch.uint8 or exc_byte.dtype != torch.uint8
            or exc_idx.dtype != torch.int64 or words.dtype != torch.int32):
        raise TypeError("scan_present_packed2 takes uint8 packed rows and exception "
                        "bytes, int64 exception positions and int32 words")
    if words.numel() * 32 < bits:
        raise ValueError("words hold fewer than `bits` bits")
    if packed.shape[0] > 65535:
        raise ValueError("at most 65535 rows per call")
    packed, exc_idx, exc_byte, words = (t.contiguous()
                                        for t in (packed, exc_idx, exc_byte, words))
    b, p = packed.shape
    nw = max(0, L - k + 1)
    out = torch.empty(b, (nw + 7) // 8, dtype=torch.uint8, device=packed.device)
    if nw == 0 or b == 0:
        return out
    tf, tr, fclass = _device_tables(k, str(packed.device))
    L_ = lib()
    n_scratch = L_.gp_scan_packed2_scratch_bytes(k, b, L)
    scratch = (torch.empty(n_scratch, dtype=torch.uint8, device=packed.device)
               if n_scratch else None)
    rc = L_.gp_scan_present_packed2(
        words.data_ptr(), bits, h, k, packed.data_ptr(), b, L, p, exc_idx.data_ptr(),
        exc_byte.data_ptr(), exc_idx.shape[1], tf.data_ptr(), tr.data_ptr(),
        fclass.data_ptr(), _kmul(k), scratch.data_ptr() if scratch is not None else None,
        out.data_ptr(), torch.cuda.current_stream(packed.device).cuda_stream,
    )
    check(rc, "gp_scan_present_packed2")
    scan_present_packed2.launches.add()
    return out


scan_present_packed2.launches = LaunchCounter()


def shard_devices(device: str, devices=None) -> list[torch.device]:
    """The devices a scanner shards over: `devices` as given (repeats
    allowed: two shards may share one card); else every GPU this process
    sees for "cuda"; else the one device `device` names.  A CUDA device
    without CUDA raises (never a CPU fallback)."""
    names = list(devices) if devices is not None else [device]
    if not names:
        raise ValueError("a scanner needs at least one device")
    out = [torch.device(d) for d in names]
    if any(d.type not in ("cuda", "cpu") for d in out):
        raise ValueError(f"unsupported scanner devices {names!r}")
    if any(d.type == "cuda" for d in out) and not torch.cuda.is_available():
        raise RuntimeError(f"DeviceScanner(devices={names!r}): CUDA is not available")
    if devices is None and out[0] == torch.device("cuda"):
        out = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return out


def on_device(dev: torch.device):
    """Make `dev` the current CUDA device (kernels launch on the current
    device's streams); nothing for the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


class DeviceScanner:
    """Holds a Bloom filter's device residency and runs fused scans.

    One direct-load probe serves every filter size, so unlike the JAX
    scanner (probe_kind, scan_conv.py:263-271) there is no probe choice.

    The filter is uploaded once, as int32 words, to each shard's device
    (shard_devices: "cuda" shards over every GPU of this process, "cuda:N"
    and "cpu" are one shard, `devices` lists them).  A call's rows are
    padded to a multiple of the shard count and split in order: shard s
    takes rows [s * R/n, (s + 1) * R/n).  As in the JAX scanner, the
    packing of the scan pipe (polish/scanpipe.py) already carries the k-1
    halos, so shards need no exchange.  "cuda" with no CUDA device raises
    (never a CPU fallback); "cpu" runs the plain torch versions and is what
    the CPU tests use."""

    def __init__(self, bf, device: str = "cuda", devices=None):
        self._init(np.asarray(bf.words_u32()), int(bf.bits), int(bf.hash_num),
                   device, devices)

    @classmethod
    def from_words(cls, words_u32: np.ndarray, bits: int, h: int,
                   device: str = "cuda", devices=None) -> "DeviceScanner":
        """Scanner over a filter's little-endian u32 words (e.g. the JAX
        package's BloomFilter.words_u32())."""
        self = cls.__new__(cls)
        self._init(np.asarray(words_u32), int(bits), int(h), device, devices)
        return self

    def _init(self, words_u32: np.ndarray, bits: int, h: int, device: str,
              devices):
        self.devices = shard_devices(device, devices)
        self.device = self.devices[0]
        self.bits = bits
        self.h = h
        words = np.ascontiguousarray(words_u32, dtype="<u4").view(np.int32)
        # the filter replicated: one copy per distinct device, each through
        # pinned memory
        copies = {d: to_device(words, d) for d in dict.fromkeys(self.devices)}
        self._shard_words = [copies[d] for d in self.devices]
        self._evals = None

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    # -- fused phase-A (scan + hot-site detect + candidate eval) ------------
    def enable_eval(self, eval_cfg, site_tables, force: bool = False) -> None:
        """Arm the fused scan+eval (ops/scan_eval.FusedEval) on every
        shard's device.  `force` is the JAX scanner's argument, kept for
        its callers; it changes nothing, as there."""
        from . import scan_eval

        evals = {d: scan_eval.FusedEval(eval_cfg, self.bits, site_tables, d)
                 for d in dict.fromkeys(self.devices)}
        self._evals = [evals[d] for d in self.devices]

    @property
    def eval_enabled(self) -> bool:
        return self._evals is not None

    @property
    def eval_shards(self) -> int:
        """Shard count of scan_eval_packed outputs (1 = unsharded).  When
        >1, the site-ish outputs stack per shard, as the JAX scanner's:
        site int32 [n, S] with SHARD-ROW-LOCAL indices, n_sites int32 [n],
        and the consumer maps shard s, local row r to global row
        s * rows_per_shard + r."""
        return self.n_shards if self.eval_enabled else 1

    @property
    def preferred_rows(self) -> int:
        """Scan-call row count the pipeline should use (>= 1 per shard)."""
        return max(4, self.n_shards)

    def scan_shard(self, s: int, codes: torch.Tensor, k: int) -> torch.Tensor:
        """Kernel 2 on shard s's rows `codes` (uint8 [r, L] on its device),
        asynchronously on the current stream of that device."""
        return scan_present_packed(self._shard_words[s], self.bits, self.h, k, codes)

    def scan2_shard(self, s: int, packed: torch.Tensor, exc_idx: torch.Tensor,
                    exc_byte: torch.Tensor, k: int, L: int) -> torch.Tensor:
        """Kernel 8 on shard s's packed rows (on its device), as scan_shard."""
        return scan_present_packed2(self._shard_words[s], self.bits, self.h, k, L,
                                    packed, exc_idx, exc_byte)

    def eval_shard(self, s: int, codes: torch.Tensor, k: int):
        """The fused eval (kernel 4) on shard s's rows, as scan_shard."""
        if self._evals is None:
            raise RuntimeError("the fused eval is not armed (enable_eval)")
        fused = self._evals[s]
        if k != fused.cfg.k:
            raise ValueError(f"eval armed for k={fused.cfg.k}, called with k={k}")
        return fused(self._shard_words[s], codes)

    @staticmethod
    def _as_rows(codes, dtype=np.uint8) -> torch.Tensor:
        if isinstance(codes, np.ndarray):
            codes = torch.from_numpy(np.ascontiguousarray(codes, dtype))
        if codes.dim() == 1:
            codes = codes[None, :]
        return codes

    # -- the split of a call's rows over the shards (the scan pipe's too) ---
    def padded_rows(self, rows: int) -> int:
        """A call of `rows` rows padded to a multiple of the shard count."""
        return -(-rows // self.n_shards) * self.n_shards

    @staticmethod
    def pad_byte(fused: bool) -> int:
        """The byte of the pad rows: 'A' for the fused eval (pad windows
        probe like real sequence and any heads they produce fall outside
        every segment, as the JAX scanner's :449-460), 0 for the plain scan
        (:475-485)."""
        return ord("A") if fused else 0

    def split_rows(self, codes):
        """A padded call's rows (tensor [padded_rows, L]) as the shards'
        parts, in order: shard s takes rows [s * R/n, (s + 1) * R/n)."""
        return codes.chunk(self.n_shards)

    def _run_shards(self, codes, k: int, fused: bool) -> tuple[int, list]:
        """(rows, each shard's outputs): the rows padded to a multiple of
        the shard count, kernel 4 (`fused`) or kernel 2 on each shard's
        part with its device current."""
        codes = self._as_rows(codes)
        b = codes.shape[0]
        total = self.padded_rows(b)
        if total > b:
            codes = torch.cat([codes, codes.new_full((total - b, codes.shape[1]),
                                                     self.pad_byte(fused))])
        launch = self.eval_shard if fused else self.scan_shard
        outs = []
        for s, (dev, rows) in enumerate(zip(self.devices, self.split_rows(codes))):
            with on_device(dev):
                outs.append(launch(s, rows.to(dev), k))
        return b, outs

    def scan_eval_packed(self, codes, k: int):
        """Fused scan+eval call: codes uint8 [R, L] (numpy or tensor) ->
        the nine outputs of ops/scan_eval.FusedEval, as tensors on the
        scanner's first device; with several shards, packed holds every
        padded row in order and the other eight stack on a leading shard
        axis (see eval_shards).  On CUDA the kernels run asynchronously on
        the current stream of each device."""
        _b, outs = self._run_shards(codes, k, fused=True)
        if self.n_shards == 1:
            return outs[0]
        from .scan_eval import EvalOutputs

        dev = self.device
        merged = EvalOutputs((
            torch.cat([o[0].to(dev) for o in outs]),
            *(torch.stack([o[i].to(dev) for o in outs]) for i in range(1, 9)),
        ))
        merged.scratch = outs  # each shard's scratch, alive with the outputs
        return merged

    def scan_packed(self, codes, k: int) -> torch.Tensor:
        """codes uint8 [B, L] or [L] (numpy or tensor) -> packed presence
        uint8 [B, ceil(nw/8)] on the scanner's first device, the rows in
        order.  On CUDA the kernel runs asynchronously on the current
        stream of each device."""
        b, outs = self._run_shards(codes, k, fused=False)
        if self.n_shards == 1:
            return outs[0]
        return torch.cat([o.to(self.device) for o in outs])[:b]

    def scan_packed2(self, packed, exc_idx, exc_byte, k: int, L: int) -> torch.Tensor:
        """The 2-bit packed variant of scan_packed (the JAX scanner's
        :498-527): packed uint8 [B, ceil(L/4)] with the exceptions exc_idx
        int64 [B, E] and exc_byte uint8 [B, E] (numpy or tensors) -> packed
        presence uint8 [B, ceil((L-k+1)/8)] on the first device.  Pad rows
        are packed 'A' with padding exceptions (position L), as the JAX
        scanner pads them; each shard runs kernel 8 on its rows."""
        packed = self._as_rows(packed)
        exc_idx, exc_byte = self._as_rows(exc_idx, np.int64), self._as_rows(exc_byte)
        b = packed.shape[0]
        pad = self.padded_rows(b) - b
        if pad:
            packed = torch.cat([packed, packed.new_zeros(pad, packed.shape[1])])
            exc_idx = torch.cat([exc_idx, exc_idx.new_full((pad, exc_idx.shape[1]), L)])
            exc_byte = torch.cat([exc_byte, exc_byte.new_zeros(pad, exc_byte.shape[1])])
        outs = []
        for s, (dev, *parts) in enumerate(zip(self.devices, *(
                self.split_rows(t) for t in (packed, exc_idx, exc_byte)))):
            with on_device(dev):
                outs.append(self.scan2_shard(s, *(t.to(dev) for t in parts), k, L))
        if self.n_shards == 1:
            return outs[0]
        return torch.cat([o.to(self.device) for o in outs])[:b]

    @staticmethod
    def unpack_present(packed: np.ndarray, nw: int) -> np.ndarray:
        """Packed u8 row -> bool[nw]."""
        return np.unpackbits(packed, bitorder="little")[:nw].astype(bool)
