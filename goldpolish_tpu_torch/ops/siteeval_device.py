"""Batched site evaluation on the device (K7): the `jax` editor's eval.

Port counterpart: goldpolish_tpu/ops/siteeval_jax.py (_probe :27,
_window_probes :36, _kernel / run :44-143, eval_sites_jax :145-198).  For
every hot site of a contig (window start w, tail p = w + k - 1) the device
builds the candidates' patched sequences from the contig's codes, hashes
their checked windows and probes the filter (ops/siteeval.py, "Patch
geometry"):

  sub  c:    prefix(k-1) + cand[c] + suffix[:k]            gate = window 0,
             sub_sup = windows j_sub present
  ins  c, m: prefix(k-1) + combo m of cand[c]'s row + draft + suffix
             ins_sup = windows j_ins present
  del  d:    prefix(k-1) + suffix[d : d+k]                  raw probes at j_del

with prefix = codes[w : p], draft = codes[p] upper-cased, suffix[j] =
codes[p+1+j] (0 at or past the contig's length n, whatever the buffer
holds there) and cand = sub_cand[draft] (zero-padded: padded lanes are
hashed and probed with byte 0, as in the JAX program).

`site_eval_packed` launches the CUDA kernel of csrc/site_eval.cu for CUDA
tensors and runs `eval_sites_device_reference`, the plain torch version
that builds the patch tensors as `run` does and hashes them with
ops/nthash_device, for CPU tensors; it returns the four outputs back to
back in one uint8 buffer (`unpack_outputs` views it as the four), and
`site_eval` returns those views.  `eval_sites_device` is eval_sites_jax,
with one copy back per call into pinned memory: the deletion validity
mask, the draft's upper-casing and the sub_cand lookup stay on the host.

Two differences from the JAX program, neither visible in the result: only
the S given sites are computed (the JAX program pads them to a shape bucket
and slices the padded rows off), and a bit count that is not a power of two
is probed at the full 64-bit `hash % bits` (the JAX `_probe` casts the
index to uint32, a fault for filters of 2^32 bits or more).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import nthash_device as ntd
from .cuda_build import LaunchCounter, check, lib, require_cuda, to_device, to_host
from .scan_conv import _device_tables, _kmul, probe_bit_reference
from .siteeval import SiteSupports, SiteTables

REF_SITES = 32  # sites per step of the plain version (bounds its memory)


def _check(k: int, h: int, bits: int, tables: SiteTables, n_combos: int) -> None:
    if not 1 <= k <= 64 or h < 1 or bits < 1 or bits >= (1 << 62):
        raise ValueError(f"unsupported site eval parameters k={k} h={h} bits={bits}")
    if not 1 <= n_combos <= tables.n_combos:
        raise ValueError(f"n_combos={n_combos} outside 1..{tables.n_combos}")
    if tables.max_ins > tables.max_del + 2:
        # the insertion patch's suffix would read past suffix_len
        raise ValueError("site eval needs max_ins <= max_del + 2")


_TABLES: dict = {}  # (id(tables), device) -> (tables, tensors)


def _tables(tables: SiteTables, device: str) -> dict:
    """The site tables as tensors on `device`, cached per tables object
    (make_tables caches those); `js` holds the checked windows of the three
    kinds back to back: [0] + j_sub, j_ins, j_del."""
    hit = _TABLES.get((id(tables), device))
    if hit is not None and hit[0] is tables:
        return hit[1]
    base_row = np.zeros(256, np.int64)
    for bi, b in enumerate(b"ACGT"):
        base_row[b] = bi
    js = np.concatenate([[0], tables.j_sub, tables.j_ins, tables.j_del]).astype(np.int32)
    on = functools.partial(torch.as_tensor, device=device)
    out = {
        "sub_cand": on(np.ascontiguousarray(tables.sub_cand)),
        "combo_codes": on(np.ascontiguousarray(tables.combo_codes)),
        "combo_len": on(tables.combo_len.astype(np.int32)),
        "base_row": on(base_row),
        "js": on(js),
        "j_sub": on(np.concatenate([[0], tables.j_sub]).astype(np.int64)),
        "j_ins": on(tables.j_ins.astype(np.int64)),
        "j_del": on(tables.j_del.astype(np.int64)),
    }
    _TABLES[(id(tables), device)] = (tables, out)
    return out


def _window_probes(words64, bits, patches, k, h, j_idx):
    """All h hashes of the checked windows j_idx of each patch present."""
    base = ntd.canonical_hashes(patches, k)[..., j_idx]
    return probe_bit_reference(words64, bits, ntd.multi_hashes(base, k, h)).all(-1)


def _eval_chunk(words64, bits, h, codes, n, sites, tables, C, t):
    """`run` of siteeval_jax.py on the sites given."""
    k, MI, MD = tables.k, tables.max_ins, tables.max_del
    dev = codes.device
    S = sites.shape[0]
    p = sites + k - 1
    pref = codes[sites[:, None] + torch.arange(k - 1, device=dev)]  # [S, k-1]
    draft = codes[p]
    draft = torch.where((draft >= 97) & (draft <= 122), draft - 32, draft)
    suf_idx = p[:, None] + 1 + torch.arange(tables.suffix_len, device=dev)
    suffix = torch.where(suf_idx < n, codes[suf_idx.clamp(max=codes.shape[0] - 1)],
                         torch.zeros((), dtype=torch.uint8, device=dev))
    cand = t["sub_cand"][draft.long()]  # [S, 4]

    sub_patches = torch.cat([pref[:, None].expand(S, 4, k - 1), cand[:, :, None],
                             suffix[:, None, :k].expand(S, 4, k)], -1)
    sub_pr = _window_probes(words64, bits, sub_patches, k, h, t["j_sub"])
    gate, sub_sup = sub_pr[..., 0], sub_pr[..., 1:].sum(-1, dtype=torch.int8)

    combos = t["combo_codes"][:, :C][t["base_row"][cand.long()]]  # [S, 4, C, MI]
    rel = torch.arange(tables.L_ins - (k - 1), device=dev)[None, :]
    cl = t["combo_len"][:C, None].long()  # [C, 1]
    is_combo, is_draft = rel < cl, rel == cl
    suf_off = (rel - cl - 1).clamp(min=0)  # [C, L-k+1]
    combo_vals = torch.take_along_dim(
        combos, rel.clamp(max=MI - 1).expand(S, 4, C, rel.shape[1]), dim=3)
    suf_vals = suffix[:, suf_off][:, None]  # [S, 1, C, L-k+1]
    tail = torch.where(is_combo, combo_vals,
                       torch.where(is_draft, draft[:, None, None, None], suf_vals))
    ins_patches = torch.cat([pref[:, None, None].expand(S, 4, C, k - 1), tail], -1)
    ins_sup = _window_probes(words64, bits, ins_patches, k, h,
                             t["j_ins"]).sum(-1, dtype=torch.int8)

    didx = torch.arange(MD, device=dev)[:, None] + torch.arange(k, device=dev)[None, :]
    del_patches = torch.cat([pref[:, None].expand(S, MD, k - 1), suffix[:, didx]], -1)
    del_pr = _window_probes(words64, bits, del_patches, k, h, t["j_del"])
    return gate, sub_sup, ins_sup, del_pr


def eval_sites_device_reference(words: torch.Tensor, bits: int, h: int,
                                codes: torch.Tensor, n: int, sites: torch.Tensor,
                                tables: SiteTables, n_combos: int):
    """Plain torch version of the site eval kernel (any device): (gate bool
    [S, 4], sub_sup int8 [S, 4], ins_sup int8 [S, 4, C], del_pr bool
    [S, max_del, len(j_del)]), REF_SITES sites at a time."""
    eval_sites_device_reference.calls.add()
    _check(tables.k, h, bits, tables, n_combos)
    t = _tables(tables, str(codes.device))
    words64 = words.to(torch.int64)
    parts = [_eval_chunk(words64, bits, h, codes, n, sites[i : i + REF_SITES],
                         tables, n_combos, t)
             for i in range(0, sites.shape[0], REF_SITES)]
    if not parts:
        return tuple(torch.empty(shape, dtype=dtype, device=codes.device)
                     for shape, dtype in _shapes(0, tables, n_combos))
    return tuple(torch.cat(col) for col in zip(*parts))


eval_sites_device_reference.calls = LaunchCounter()


def _shapes(S: int, tables: SiteTables, C: int):
    """(shape, dtype) of gate, sub_sup, ins_sup and del_pr for S sites, in
    the order the packed buffer holds them."""
    return (((S, 4), torch.bool), ((S, 4), torch.int8), ((S, 4, C), torch.int8),
            ((S, tables.max_del, len(tables.j_del)), torch.bool))


def pack_outputs(outs) -> torch.Tensor:
    """The four outputs as one uint8 buffer, back to back (the layout of
    site_eval_packed)."""
    return torch.cat([o.contiguous().view(torch.uint8).reshape(-1) for o in outs])


def unpack_outputs(buf: torch.Tensor, S: int, tables: SiteTables, C: int):
    """(gate, sub_sup, ins_sup, del_pr): views of the packed uint8 buffer
    of S sites (site_eval_packed), on its device."""
    shapes = _shapes(S, tables, C)
    sizes = [int(np.prod(shape)) for shape, _dtype in shapes]
    if sum(sizes) != buf.numel():
        raise ValueError(f"a packed buffer of {buf.numel()} bytes, {sum(sizes)} expected")
    parts = torch.split(buf, sizes)
    return tuple(p.view(dtype).view(shape) for p, (shape, dtype) in zip(parts, shapes))


def site_eval_packed(words: torch.Tensor, bits: int, h: int, codes: torch.Tensor, n: int,
                     sites: torch.Tensor, tables: SiteTables, n_combos: int) -> torch.Tensor:
    """The four raw outputs of eval_sites_device_reference for the hot
    sites `sites` (int64 [S], window starts) of a contig whose codes
    (uint8, at least n of them; bytes past n are never read as sequence)
    lie on the device of `words` (int32 [ceil(bits/32)]), as one uint8
    buffer (unpack_outputs), so a caller copies them back at once.  CPU
    tensors run the plain version; CUDA tensors launch the kernel on the
    current stream (no synchronisation)."""
    k = tables.k
    if codes.dim() != 1 or sites.dim() != 1 or not 1 <= n <= codes.shape[0]:
        raise ValueError(f"codes [L >= n] and sites [S] expected, got "
                         f"{tuple(codes.shape)}, {tuple(sites.shape)}, n={n}")
    if codes.device.type == "cpu":
        return pack_outputs(eval_sites_device_reference(words, bits, h, codes, n, sites,
                                                        tables, n_combos))
    require_cuda(codes, "site_eval")
    _check(k, h, bits, tables, n_combos)
    if words.device != codes.device or sites.device != codes.device:
        raise ValueError("words, codes and sites must lie on the same device")
    if codes.dtype != torch.uint8 or words.dtype != torch.int32 or sites.dtype != torch.int64:
        raise TypeError("site_eval takes uint8 codes, int32 words and int64 sites")
    if words.numel() * 32 < bits:
        raise ValueError("words hold fewer than `bits` bits")
    S, dev = sites.shape[0], codes.device
    nbytes = sum(int(np.prod(shape)) for shape, _dtype in _shapes(S, tables, n_combos))
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    if S == 0:
        return buf
    gate, sub_sup, ins_sup, del_pr = unpack_outputs(buf, S, tables, n_combos)
    codes, words, sites = codes.contiguous(), words.contiguous(), sites.contiguous()
    t = _tables(tables, str(dev))
    tf, tr, fclass = _device_tables(k, str(dev))
    # the insertion windows' hash parts, written and read by the kernel
    parts = torch.empty(lib().gp_site_eval_parts_bytes(S, len(tables.j_ins), tables.max_ins,
                                                       n_combos) // 8,
                        dtype=torch.int64, device=dev)
    rc = lib().gp_site_eval(
        words.data_ptr(), bits, h, k, codes.data_ptr(), n, sites.data_ptr(), S,
        tf.data_ptr(), tr.data_ptr(), fclass.data_ptr(), _kmul(k),
        t["sub_cand"].data_ptr(), t["combo_codes"].data_ptr(), tables.n_combos,
        t["combo_len"].data_ptr(), n_combos, tables.max_ins, tables.max_del,
        t["js"].data_ptr(),
        len(tables.j_sub), len(tables.j_ins), len(tables.j_del),
        gate.data_ptr(), sub_sup.data_ptr(), ins_sup.data_ptr(), del_pr.data_ptr(),
        parts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    check(rc, "gp_site_eval")
    _LAUNCHES.add()
    return buf


_LAUNCHES = LaunchCounter()  # kernel 6's launches
site_eval_packed.launches = _LAUNCHES


def site_eval(words: torch.Tensor, bits: int, h: int, codes: torch.Tensor, n: int,
              sites: torch.Tensor, tables: SiteTables, n_combos: int):
    """site_eval_packed's four outputs (gate bool [S, 4], sub_sup int8
    [S, 4], ins_sup int8 [S, 4, C], del_pr bool [S, max_del, len(j_del)]),
    as views of its buffer."""
    buf = site_eval_packed(words, bits, h, codes, n, sites, tables, n_combos)
    return unpack_outputs(buf, sites.shape[0], tables, n_combos)


site_eval.launches = _LAUNCHES


def eval_sites_device(seq_codes: np.ndarray, sites_w: np.ndarray, words: torch.Tensor,
                      bits: int, tables: SiteTables, h: int, n_combos: int | None = None,
                      s_bucket: int = 256, codes_dev: torch.Tensor | None = None
                      ) -> SiteSupports:
    """Device evaluator with eval_sites_jax's signature; the same
    SiteSupports as siteeval.eval_sites_np.

    seq_codes: the contig's host codes (n = len(seq_codes)); codes_dev: the
    same codes already on the device of `words`, possibly zero-padded (the
    editor uploads a contig once for all its eval calls), else uploaded
    here.  s_bucket is the JAX program's shape bucket: nothing here is
    compiled per shape, so only the S sites are computed."""
    k = tables.k
    C = tables.n_combos if n_combos is None else n_combos
    n = len(seq_codes)
    sites_w = np.asarray(sites_w, np.int64)
    if len(sites_w) and (sites_w.min() < 0 or sites_w.max() + k - 1 >= n):
        raise ValueError(f"sites must be windows of the contig (0 <= w <= {n - k})")
    dev = words.device
    if codes_dev is None:
        codes_dev = torch.from_numpy(np.array(seq_codes, np.uint8)).to(dev)
    sites = to_device(sites_w, dev)
    buf = to_host(site_eval_packed(words, bits, h, codes_dev, n, sites, tables, C))
    gate, sub_sup, ins_sup, del_pr = (
        o.numpy() for o in unpack_outputs(buf, len(sites_w), tables, C))
    # deletion validity masks (end-of-contig roll bounds) on the host
    p = sites_w + k - 1
    d = np.arange(1, tables.max_del + 1)[None, :, None]
    jj = tables.j_del[None, None, :]
    valid = np.where(jj == 0, (p[:, None, None] + d) <= n - 1,
                     (p[:, None, None] + d + jj + 1) <= n - 1)
    draft = seq_codes[p]
    draft = np.where((draft >= 97) & (draft <= 122), draft - 32, draft).astype(np.uint8)
    return SiteSupports(
        sub_cand=tables.sub_cand[draft], gate=gate,
        sub_support=sub_sup.astype(np.int32), ins_support=ins_sup.astype(np.int32),
        del_support=(del_pr & valid).sum(axis=-1).astype(np.int32), n_combos=C,
    )
