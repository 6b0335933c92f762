"""Bloom probe of low-32-bit hash tuples: kernel 1 and its plain version.

Port counterpart: goldpolish_tpu/ops/bloom_pallas.py.  Its four Pallas
kernels (_probe_kernel :36, _probe_mxu_kernel :129, _probe_mxu_i8_kernel
:255, _probe_mxu_i8_chunked_kernel :274) all compute

    present[i] = AND_j bit(words, lo32[i, j] & (bits - 1))

for a power-of-two bit count; the one-hot matmul and byte planes exist only
because Mosaic cannot gather across vector registers.  On Hopper the probe
is a direct word load, so all four become the one CUDA kernel of
csrc/bloom_probe.cu, whose bit test and probe rounds (csrc/bloom_probe.cuh)
the scan kernels (ops/scan_conv.py) share.  The kernel reads a row's 4
hashes as one 16-byte load where the tuples' data_ptr() is 16-byte aligned
(a view's may not be), else one 4-byte load a hash.

Tensors: words int32[bits/32] (the little-endian u32 words of
BloomFilter.words_u32, same bits), lo32 int32[N, h] (the low 32 bits of
each hash, same bits), result bool[N].  A CPU tensor runs the plain torch
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .cuda_build import LaunchCounter, check, lib, require_cuda


def _check_bits(bits: int) -> None:
    if bits <= 0 or bits & (bits - 1) or bits > (1 << 32):
        raise ValueError(f"probe_lo32 needs a power-of-two bit count <= 2^32, got {bits}")


def probe_lo32_reference(words: torch.Tensor, bits: int,
                         lo32: torch.Tensor) -> torch.Tensor:
    """Plain torch version (bloom_pallas.probe_lo32_reference :102-106)."""
    probe_lo32_reference.calls.add()
    _check_bits(bits)
    idx = lo32.to(torch.int64) & (bits - 1)
    word = words[idx >> 5].to(torch.int64)
    return ((word >> (idx & 31)) & 1).bool().all(dim=-1)


probe_lo32_reference.calls = LaunchCounter()


def probe_lo32(words: torch.Tensor, bits: int, lo32: torch.Tensor) -> torch.Tensor:
    """present bool[N] of lo32 int32[N, h] against words int32[bits/32]."""
    _check_bits(bits)
    if lo32.dim() != 2:
        raise ValueError(f"lo32 must be [N, h], got shape {tuple(lo32.shape)}")
    if lo32.device.type == "cpu":
        return probe_lo32_reference(words, bits, lo32)
    require_cuda(lo32, "probe_lo32")
    if words.device != lo32.device:
        raise ValueError("words and lo32 must lie on the same device")
    if words.dtype != torch.int32 or lo32.dtype != torch.int32:
        raise TypeError("probe_lo32 takes int32 words and int32 lo32")
    if words.numel() * 32 < bits:
        raise ValueError("words hold fewer than `bits` bits")
    words = words.contiguous()
    lo32 = lo32.contiguous()
    n, h = lo32.shape
    out = torch.empty(n, dtype=torch.bool, device=lo32.device)
    if n == 0:
        return out
    if h < 1:
        raise ValueError("probe_lo32 needs at least one hash per row")
    rc = lib().gp_probe_lo32(
        words.data_ptr(), bits, lo32.data_ptr(), n, h, out.data_ptr(),
        torch.cuda.current_stream(lo32.device).cuda_stream,
    )
    check(rc, "gp_probe_lo32")
    probe_lo32.launches.add()
    return out


probe_lo32.launches = LaunchCounter()
