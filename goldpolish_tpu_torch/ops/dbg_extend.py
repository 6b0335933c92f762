"""The sealer's 4-way extension probe (kernel 7, K8's device call).

Port counterpart: goldpolish_tpu/fill/konnector.py, DeviceDBG.prefetch
(:265-299): for every vertex of a lockstep round's frontier, which of its
four one-base extensions pass the h-hash Bloom test of their canonical
ntHash.  Vertices are k bytes of any value; successor rows come first:

  successor row v:    extension b = v[1:] + "ACGT"[b]
  predecessor row v:  extension b = "ACGT"[b] + v[:-1]

and bit b of the row's output byte is set when extension b is present.

`dbg_extend4` launches the CUDA kernel of csrc/dbg_extend.cu for CUDA
tensors and runs `dbg_extend4_reference`, the plain torch version that
builds the [R, 4, k] extension rows as DeviceDBG.prefetch does and probes
them with ops/bloom_device.probe_kmers, for CPU tensors.  Two differences
from the JAX call, neither visible in the result: only the R rows are
probed (the JAX call pads 4R extensions to a power-of-two bucket of at
least 64, which spares XLA a compile per shape), and a bit count that is
not a power of two is probed at the full 64-bit `hash % bits` (the JAX
probe casts that index to uint32, a fault for filters of 2^32 bits or
more).
"""

from __future__ import annotations

import torch

from . import bloom_device
from .cuda_build import LaunchCounter, check, lib, require_cuda
from .scan_conv import _device_tables, _kmul

MAX_K = 64  # csrc/nthash_roll.cuh: kGpMaxK
MAX_H = 16  # csrc/dbg_extend.cu: kExtMaxH

_BASES = torch.tensor(list(b"ACGT"), dtype=torch.uint8)
_LAUNCHES = LaunchCounter()  # kernel 7's launches (dbg_extend4.launches)


def _check(bits: int, hash_num: int, k: int, verts: torch.Tensor, n_succ: int) -> None:
    if not 1 <= k <= MAX_K or not 1 <= hash_num <= MAX_H or not 1 <= bits < (1 << 62):
        raise ValueError(f"unsupported extension probe parameters k={k} "
                         f"h={hash_num} bits={bits}")
    if verts.dim() != 2 or verts.shape[1] != k:
        raise ValueError(f"verts must be [R, k={k}], got {tuple(verts.shape)}")
    if not 0 <= n_succ <= verts.shape[0]:
        raise ValueError(f"n_succ={n_succ} outside 0..{verts.shape[0]}")


def dbg_extend4_reference(words: torch.Tensor, bits: int, hash_num: int, k: int,
                          verts: torch.Tensor, n_succ: int) -> torch.Tensor:
    """Plain torch version of the extension probe (any device): uint8 [R]."""
    dbg_extend4_reference.calls.add()
    _check(bits, hash_num, k, verts, n_succ)
    R, dev = verts.shape[0], verts.device
    bases = _BASES.to(dev)[None, :, None].expand(R, 4, 1)
    shared = verts[:, None].expand(R, 4, k)
    succ = torch.cat([shared[:n_succ, :, 1:], bases[:n_succ]], -1)
    pred = torch.cat([bases[n_succ:], shared[n_succ:, :, :-1]], -1)
    ext = torch.cat([succ, pred])  # [R, 4, k]
    pres = bloom_device.probe_kmers(words, bits, hash_num, k, ext)[..., 0]
    weights = torch.tensor([1, 2, 4, 8], dtype=torch.int32, device=dev)
    return (pres.to(torch.int32) * weights).sum(-1).to(torch.uint8)


dbg_extend4_reference.calls = LaunchCounter()


def dbg_extend4(words: torch.Tensor, bits: int, hash_num: int, k: int,
                verts: torch.Tensor, n_succ: int) -> torch.Tensor:
    """The four extensions' presence of each vertex of verts uint8 [R, k]
    (successor rows first, n_succ of them) against words int32
    [ceil(bits/32)] on the same device: uint8 [R], bit b for base
    "ACGT"[b].  CPU tensors run the plain version; CUDA tensors launch the
    kernel on the current stream (no synchronisation)."""
    if verts.device.type == "cpu":
        return dbg_extend4_reference(words, bits, hash_num, k, verts, n_succ)
    require_cuda(verts, "dbg_extend4")
    _check(bits, hash_num, k, verts, n_succ)
    if words.device != verts.device:
        raise ValueError("words and verts must lie on the same device")
    if verts.dtype != torch.uint8 or words.dtype != torch.int32:
        raise TypeError("dbg_extend4 takes uint8 verts and int32 words")
    if words.numel() * 32 < bits:
        raise ValueError("words hold fewer than `bits` bits")
    R, dev = verts.shape[0], verts.device
    out = torch.empty(R, dtype=torch.uint8, device=dev)
    if R == 0:
        return out
    verts, words = verts.contiguous(), words.contiguous()
    tf, tr, fclass = _device_tables(k, str(dev))
    rc = lib().gp_dbg_extend4(
        words.data_ptr(), bits, hash_num, k, verts.data_ptr(), R, n_succ,
        out.data_ptr(), tf.data_ptr(), tr.data_ptr(), fclass.data_ptr(), _kmul(k),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(rc, "gp_dbg_extend4")
    _LAUNCHES.add()
    return out


dbg_extend4.launches = _LAUNCHES
