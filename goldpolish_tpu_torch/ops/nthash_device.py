"""ntHash v1 of every window as torch tensor code (the device ntHash, K5).

Port counterpart: goldpolish_tpu/ops/nthash_jax.py (srol_n :37, cumxor
:49, _window_xor :65, forward_hashes / reverse_hashes / canonical_hashes /
strand_hashes :73-103, nte64 / multi_hashes :106-121).  The same
closed-form prefix-XOR formulation (see ops/nthash.py), on int64 lanes that
hold the uint64 bits (ops/u64.py): add, multiply and xor wrap as uint64
does, right shifts are masked to be logical.

These are the plain torch versions that the site eval's plain version
(ops/siteeval_device.eval_sites_device_reference) hashes its patches with.
On the card the hash is fused into kernel 2 (ops/scan_conv.py) and the site
eval kernel (csrc/site_eval.cu), so this module launches no kernel of its
own.  Every function takes codes or hashes on any device and is
shape-polymorphic over leading dimensions.
"""

from __future__ import annotations

import functools

import torch

from . import nthash as _ref
from . import u64

SROL_PERIOD = _ref.SROL_PERIOD
MULTI_SHIFT = _ref.MULTI_SHIFT


@functools.lru_cache(maxsize=8)
def _seed_tables(device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(SEED_TAB, RC_SEED_TAB) as int64 [256] on `device`."""
    return (u64.from_u64(_ref.SEED_TAB).to(device),
            u64.from_u64(_ref.RC_SEED_TAB).to(device))


def srol_n(v: torch.Tensor, n) -> torch.Tensor:
    """srol^n with per-element rotation counts (n: int64 tensor or int,
    broadcast against v)."""
    n = torch.as_tensor(n, dtype=torch.int64, device=v.device)
    s31, s33 = n % 31, n % 33
    hi = u64.lsr(v, 33)  # < 2^31, so the shifts below are logical
    lo = v & u64.MASK33
    hi = ((hi << s31) | (hi >> (31 - s31))) & u64.MASK31
    lo = ((lo << s33) | (lo >> (33 - s33))) & u64.MASK33
    return (hi << 33) | lo


def cumxor(a: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix-XOR along the last axis (Hillis-Steele, log-depth)."""
    n = a.shape[-1]
    shift = 1
    while shift < n:
        a = a ^ torch.cat([a.new_zeros(a.shape[:-1] + (shift,)), a[..., : n - shift]], -1)
        shift *= 2
    return a


def _window_xor(prefix: torch.Tensor, k: int) -> torch.Tensor:
    """XOR over each k-window given a prefix-XOR array (last axis)."""
    n = prefix.shape[-1]
    w = prefix[..., k - 1 :].clone()
    w[..., 1:] ^= prefix[..., : n - k]
    return w


def forward_hashes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Forward-strand hash of every k-window; codes uint8 [..., n]."""
    n = codes.shape[-1]
    seed, _ = _seed_tables(str(codes.device))
    idx = torch.arange(n, device=codes.device)
    a = srol_n(seed[codes.long()], (-idx) % SROL_PERIOD)
    w = _window_xor(cumxor(a), k)
    wi = torch.arange(n - k + 1, device=codes.device)
    return srol_n(w, (wi + k - 1) % SROL_PERIOD)


def reverse_hashes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse-strand hash of every k-window; codes uint8 [..., n]."""
    n = codes.shape[-1]
    _, rc_seed = _seed_tables(str(codes.device))
    idx = torch.arange(n, device=codes.device)
    b = srol_n(rc_seed[codes.long()], idx % SROL_PERIOD)
    w = _window_xor(cumxor(b), k)
    wi = torch.arange(n - k + 1, device=codes.device)
    return srol_n(w, (-wi) % SROL_PERIOD)


def canonical_hashes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical (fh + rh, wrapping) hash of every k-window."""
    return forward_hashes(codes, k) + reverse_hashes(codes, k)


def strand_hashes(codes: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(forward, reverse) hashes of every k-window."""
    return forward_hashes(codes, k), reverse_hashes(codes, k)


def nte64(base_hash: torch.Tensor, k: int, i: int) -> torch.Tensor:
    """Extra hash i (>= 1) from the canonical base hash (nthash.hpp:261-266)."""
    t = base_hash * u64.const(i ^ (k * int(_ref.MULTI_SEED)))
    return t ^ u64.lsr(t, MULTI_SHIFT)


def multi_hashes(base_hash: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """All m hashes; appends a trailing axis of size m."""
    return torch.stack([base_hash] + [nte64(base_hash, k, i) for i in range(1, m)], -1)
