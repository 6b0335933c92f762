"""The sealer's extension probe (kernel 7, K8's device call), walking
unbranched chains.

Port counterpart: goldpolish_tpu/fill/konnector.py, DeviceDBG.prefetch
(:265-299): for every vertex of a lockstep round's frontier, which of its
four one-base extensions pass the h-hash Bloom test of their canonical
ntHash.  Vertices are k bytes of any value; successor rows come first:

  successor row v:    extension b = v[1:] + "ACGT"[b]
  predecessor row v:  extension b = "ACGT"[b] + v[:-1]

and bit b of the row's mask is set when extension b is present.

The chain form goes on from there: while a row's mask has exactly one bit
set and fewer than D masks are written, the row moves to that extension
and probes its four extensions in turn.  Its output is uint8 [R, D + 1]:
masks 0 .. len-1 of the chain (the rest 0), then len (1 .. D) in column D.
Graph membership is a pure function of the filter, so every mask equals
the one a later one-level probe of that vertex would give: DeviceDBG
caches the whole chain, and a search whose path does not branch asks for a
round every D levels, not every level (csrc/dbg_extend.cu says what bounds
each).  D = 1 is the one-level probe, `dbg_extend4`, with uint8 [R] out.

`dbg_extend_chain` and `dbg_extend4` launch the CUDA kernel of
csrc/dbg_extend.cu for CUDA tensors, and run the plain torch versions for
CPU tensors: `dbg_extend4_reference`, which builds the [R, 4, k] extension
rows as DeviceDBG.prefetch does and probes them with
ops/bloom_device.probe_kmers, and `dbg_extend_chain_reference`, which calls
it once per level on the rows still walking.  Two differences from the JAX
call, neither visible in the result: only the R rows are probed (the JAX
call pads 4R extensions to a power-of-two bucket of at least 64, which
spares XLA a compile per shape), and a bit count that is not a power of two
is probed at the full 64-bit `hash % bits` (the JAX probe casts that index
to uint32, a fault for filters of 2^32 bits or more).
"""

from __future__ import annotations

import numpy as np
import torch

from . import bloom_device
from .cuda_build import LaunchCounter, check, lib, require_cuda, to_device, to_host
from .scan_conv import _device_tables, _kmul

MAX_H = 16  # csrc/dbg_extend.cu: kExtMaxH
MAX_STEPS = 64  # csrc/dbg_extend.cu: kExtMaxD
# D, the levels one DeviceDBG round walks from each frontier vertex (PERF.md
# §6: measured at 8, 16, 32 and 64 with chip_trace.py --chain-steps)
CHAIN_STEPS = 32

_BASES = torch.tensor(list(b"ACGT"), dtype=torch.uint8)
_LAUNCHES = LaunchCounter()  # kernel 7's launches, at any D


def _check(bits: int, hash_num: int, k: int, verts: torch.Tensor, n_succ: int,
           steps: int = 1) -> None:
    if k < 1 or not 1 <= hash_num <= MAX_H or not 1 <= bits < (1 << 62):
        raise ValueError(f"unsupported extension probe parameters k={k} "
                         f"h={hash_num} bits={bits}")
    if not 1 <= steps <= MAX_STEPS:
        raise ValueError(f"steps={steps} outside 1..{MAX_STEPS}")
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


def dbg_extend_chain_reference(words: torch.Tensor, bits: int, hash_num: int, k: int,
                               verts: torch.Tensor, n_succ: int,
                               steps: int) -> torch.Tensor:
    """Plain torch version of the chain walk (any device): uint8
    [R, steps + 1], one dbg_extend4_reference call per level."""
    dbg_extend_chain_reference.calls.add()
    _check(bits, hash_num, k, verts, n_succ, steps)
    R, dev = verts.shape[0], verts.device
    out = torch.zeros(R, steps + 1, dtype=torch.uint8, device=dev)
    rows = torch.arange(R, device=dev)  # the rows still walking, ascending
    cur = verts.clone()
    bases = _BASES.to(dev)
    for j in range(steps):
        masks = dbg_extend4_reference(words, bits, hash_num, k, cur[rows],
                                      int((rows < n_succ).sum()))
        out[rows, j] = masks
        out[rows, steps] = j + 1
        single = (masks > 0) & ((masks & (masks - 1)) == 0)  # one bit set
        rows, masks = rows[single], masks[single]
        if j + 1 == steps or not len(rows):
            break
        b = bases[torch.log2(masks.float()).long()][:, None]
        succ = rows < n_succ
        cur[rows] = torch.where(succ[:, None], torch.cat([cur[rows, 1:], b], 1),
                                torch.cat([b, cur[rows, :-1]], 1))
    return out


dbg_extend_chain_reference.calls = LaunchCounter()


def _launch(words: torch.Tensor, bits: int, hash_num: int, k: int, verts: torch.Tensor,
            n_succ: int, steps: int, out: torch.Tensor, name: str) -> torch.Tensor:
    """Kernel 7 into out uint8 [R, steps] (masks) or [R, steps + 1] (with
    the chains' lengths), on the current stream."""
    require_cuda(verts, name)
    _check(bits, hash_num, k, verts, n_succ, steps)
    if words.device != verts.device:
        raise ValueError("words and verts must lie on the same device")
    if verts.dtype != torch.uint8 or words.dtype != torch.int32:
        raise TypeError(f"{name} takes uint8 verts and int32 words")
    if words.numel() * 32 < bits:
        raise ValueError("words hold fewer than `bits` bits")
    R, dev = verts.shape[0], verts.device
    if R == 0:
        return out
    verts, words = verts.contiguous(), words.contiguous()
    tf, tr, fclass = _device_tables(k, str(dev))
    rc = lib().gp_dbg_extend(
        words.data_ptr(), bits, hash_num, k, verts.data_ptr(), R, n_succ, steps,
        out.numel() // R, out.data_ptr(), tf.data_ptr(), tr.data_ptr(),
        fclass.data_ptr(), _kmul(k), torch.cuda.current_stream(dev).cuda_stream,
    )
    check(rc, f"gp_dbg_extend ({name})")
    _LAUNCHES.add()
    return out


def dbg_extend4(words: torch.Tensor, bits: int, hash_num: int, k: int,
                verts: torch.Tensor, n_succ: int) -> torch.Tensor:
    """The four extensions' presence of each vertex of verts uint8 [R, k]
    (successor rows first, n_succ of them) against words int32
    [ceil(bits/32)] on the same device: uint8 [R], bit b for base
    "ACGT"[b].  CPU tensors run the plain version; CUDA tensors launch the
    kernel at D = 1 on the current stream (no synchronisation)."""
    if verts.device.type == "cpu":
        return dbg_extend4_reference(words, bits, hash_num, k, verts, n_succ)
    out = torch.empty(verts.shape[0], dtype=torch.uint8, device=verts.device)
    return _launch(words, bits, hash_num, k, verts, n_succ, 1, out, "dbg_extend4")


dbg_extend4.launches = _LAUNCHES


def dbg_extend_chain(words: torch.Tensor, bits: int, hash_num: int, k: int,
                     verts: torch.Tensor, n_succ: int, steps: int) -> torch.Tensor:
    """The unbranched chain of up to `steps` levels from each vertex of
    verts uint8 [R, k] (successor rows first, n_succ of them), against
    words int32 [ceil(bits/32)] on the same device: uint8 [R, steps + 1],
    the masks of the chain's vertices, then its length (module docstring).
    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (no synchronisation)."""
    if verts.device.type == "cpu":
        return dbg_extend_chain_reference(words, bits, hash_num, k, verts, n_succ, steps)
    out = torch.empty(verts.shape[0], steps + 1, dtype=torch.uint8, device=verts.device)
    return _launch(words, bits, hash_num, k, verts, n_succ, steps, out,
                   "dbg_extend_chain")


dbg_extend_chain.launches = _LAUNCHES


def probe_chains(words: torch.Tensor, bits: int, hash_num: int, k: int,
                 verts: np.ndarray, n_succ: int) -> np.ndarray:
    """One DeviceDBG round: the host's vertex rows verts uint8 [R, k] up
    to the device of `words` (through pinned memory on CUDA), one
    dbg_extend_chain of CHAIN_STEPS levels, and its output back into host
    memory (pinned on CUDA; the call waits for it): uint8 [R, D + 1]."""
    dev_verts = to_device(verts, words.device)
    return to_host(dbg_extend_chain(words, bits, hash_num, k, dev_verts, n_succ,
                                    CHAIN_STEPS)).numpy()
