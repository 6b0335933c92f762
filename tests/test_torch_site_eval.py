"""ops/siteeval_device (K7, the batched site eval) against the JAX package's
siteeval_jax (its jitted program `run` and eval_sites_jax) and the host
eval_sites_np.  Integer hashing: every comparison is exact, every lane
(the zero-padded candidate lanes too).

The JAX side runs on the CPU as its own tests run it, with a site bucket
of 16 (`s_bucket`: the JAX program's padded rows are sliced off, so the
bucket does not change the result, and the default 256 takes GBs on the
CPU at 341 combos).  The JAX package is imported only where it is compared
with, so the CUDA cases also run where jax is not installed (`pytest
--noconftest -m cuda`)."""

import numpy as np
import pytest
import torch

from goldpolish_tpu_torch.ops import bloom, siteeval, siteeval_device as sd
from goldpolish_tpu_torch.ops import nthash as nt

JUMP = 3
JAX_BUCKET = 16
_FIELDS = ("sub_cand", "gate", "sub_support", "ins_support", "del_support")


def _inputs(k, h, nbytes, seed=0, n=700):
    """A draft with substitutions, IUPAC codes, N and lowercase bytes, a
    filter of its truth's k-mers, and sites: error windows, the odd bytes'
    windows and the last windows of the contig (suffixes past its end)."""
    rng = np.random.default_rng([k, h, seed])
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    bf = bloom.BloomFilter(nbytes, h, k)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(truth, k), k, h))
    draft = truth.copy()
    for p in (150, 300, 450):
        draft[p] = ord("A") if draft[p] != ord("A") else ord("G")
    draft[200], draft[230], draft[260], draft[400] = ord("N"), ord("r"), ord("Y"), ord("a")
    draft[500:520] |= 32  # lowercase run
    sites = [100, 150 - k + 1, 300 - k + 1, 450 - k + 1, 230 - k + 1, 260 - k + 1,
             400 - k + 1, 510 - k + 1, n - k, n - k - 3, n - 2 * k, n - k - 7]
    return draft, bf, np.array(sites, np.int64)


def _jax_outputs(draft, bf, sites, tables, h, C, codes_dev):
    """(raw outputs of the JAX program for the S sites, eval_sites_jax)."""
    import jax.numpy as jnp

    from goldpolish_tpu.ops import siteeval as jse
    from goldpolish_tpu.ops import siteeval_jax

    jt = jse.make_tables(tables.k, tables.jump, tables.max_ins, tables.max_del)
    words = jnp.asarray(bf.words_u32())
    run = siteeval_jax._kernel(
        jt.k, h, jt.jump, int(bf.bits), C, jt.max_ins, jt.max_del, jt.suffix_len,
        tuple(jt.j_sub.tolist()), tuple(jt.j_ins.tolist()), tuple(jt.j_del.tolist()),
        jt.sub_cand.tobytes(), jt.combo_codes.tobytes(), jt.combo_len.tobytes(),
    )
    padded = np.zeros(JAX_BUCKET, np.int64)
    padded[: len(sites)] = sites
    raw = run(jnp.asarray(codes_dev), jnp.asarray(padded), jnp.int64(len(draft)), words)
    raw = [np.asarray(o)[: len(sites)] for o in raw]
    sup = siteeval_jax.eval_sites_jax(draft, sites, words, int(bf.bits), jt, h, C,
                                      s_bucket=JAX_BUCKET,
                                      codes_dev=jnp.asarray(codes_dev))
    return raw, sup


def _assert_supports_equal(got, want):
    for f in _FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.n_combos == want.n_combos


@pytest.mark.parametrize("C", [21, 341])
@pytest.mark.parametrize("k,h,nbytes", [
    (20, 1, 49160), (20, 4, 1 << 12), (32, 1, 1 << 12), (32, 4, 12292),
])
def test_plain_matches_jax_and_numpy(k, h, nbytes, C):
    draft, bf, sites = _inputs(k, h, nbytes)
    tables = siteeval.make_tables(k, JUMP)
    codes_dev = np.zeros(1024, np.uint8)  # the editor's zero-padded bucket
    codes_dev[: len(draft)] = draft
    words = torch.from_numpy(bf.words_u32().view(np.int32).copy())
    raw = sd.site_eval(words, int(bf.bits), h, torch.from_numpy(codes_dev), len(draft),
                       torch.from_numpy(sites), tables, C)
    want_raw, want_jax = _jax_outputs(draft, bf, sites, tables, h, C, codes_dev)
    for g, w in zip(raw, want_raw):
        assert g.shape == w.shape and np.array_equal(g.numpy(), w)
    got = sd.eval_sites_device(draft, sites, words, int(bf.bits), tables, h, C,
                               codes_dev=torch.from_numpy(codes_dev))
    _assert_supports_equal(got, want_jax)
    _assert_supports_equal(got, siteeval.eval_sites_np(draft, sites, bf, tables, h, C))
    assert 0 < raw[0].float().mean() < 1 and 0 < raw[2].float().mean()


def _mk(seq_len, seed, k=32, h=4):
    """tests/test_siteeval.py:_mk: a truth filter and a draft with three
    substitutions."""
    rng = np.random.default_rng(seed)
    truth = "".join(rng.choice(list("ACGT")) for _ in range(seq_len))
    bf = bloom.BloomFilter(1 << 16, h, k)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(nt.encode(truth), k), k, h))
    draft = bytearray(truth.encode())
    for p in (150, 300, 450):
        draft[p] = ord("A") if draft[p] != ord("A") else ord("G")
    return nt.encode(bytes(draft).decode()), bf


def _words(bf):
    return torch.from_numpy(bf.words_u32().view(np.int32).copy())


# tests/test_siteeval.py:186
def test_eval_matches_numpy_v2():
    k, h = 32, 4
    codes, bf = _mk(900, 7)
    tables = siteeval.make_tables(k, JUMP)
    sites = np.array([100, 150 - k + 1, 300 - k + 1, 450 - k + 1, 700], np.int64)
    for C in (21, tables.n_combos):
        want = siteeval.eval_sites_np(codes, sites, bf, tables, h, n_combos=C)
        got = sd.eval_sites_device(codes, sites, _words(bf), int(bf.bits), tables, h, C)
        _assert_supports_equal(got, want)


# tests/test_siteeval.py:208
def test_eval_reuses_codes_dev():
    k, h = 32, 4
    codes, bf = _mk(600, 8)
    tables = siteeval.make_tables(k, JUMP)
    padded = np.zeros(1024, np.uint8)
    padded[: len(codes)] = codes
    padded[len(codes):] = ord("A")  # never read as sequence: past the contig
    sites = np.array([50, 200], np.int64)
    want = siteeval.eval_sites_np(codes, sites, bf, tables, h, n_combos=21)
    calls = sd.eval_sites_device_reference.calls.value
    got = sd.eval_sites_device(codes, sites, _words(bf), int(bf.bits), tables, h, 21,
                               codes_dev=torch.from_numpy(padded))
    _assert_supports_equal(got, want)
    assert sd.eval_sites_device_reference.calls.value == calls + 1


def test_refusals():
    codes, bf = _mk(600, 8)
    tables = siteeval.make_tables(32, JUMP)
    with pytest.raises(ValueError, match="windows of the contig"):
        sd.eval_sites_device(codes, np.array([len(codes) - 31]), _words(bf),
                             int(bf.bits), tables, 4, 21)
    with pytest.raises(ValueError, match="n_combos"):
        sd.eval_sites_device(codes, np.array([5]), _words(bf), int(bf.bits), tables, 4, 342)
    with pytest.raises(ValueError, match="max_ins"):
        sd.eval_sites_device(codes, np.array([5]), _words(bf), int(bf.bits),
                             siteeval.make_tables(32, JUMP, max_ins=5, max_del=2), 4, 21)
    with pytest.raises(ValueError, match="unsupported"):
        sd.site_eval(_words(bf), int(bf.bits), 4, torch.from_numpy(codes), len(codes),
                     torch.tensor([5]), siteeval.make_tables(65, JUMP), 21)


def test_packed_output_unpacks_to_the_four():
    """site_eval_packed's one buffer (what the editor copies back once per
    call) views as the plain version's four arrays, byte for byte."""
    draft, bf, sites = _inputs(32, 4, 1 << 12)
    tables = siteeval.make_tables(32, JUMP)
    args = (_words(bf), int(bf.bits), 4, torch.from_numpy(draft), len(draft),
            torch.from_numpy(sites), tables, 21)
    want = sd.eval_sites_device_reference(*args)
    buf = sd.site_eval_packed(*args)
    assert buf.dtype == torch.uint8 and buf.dim() == 1
    assert buf.numel() == sum(w.numel() for w in want)
    got = sd.unpack_outputs(buf, len(sites), tables, 21)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
    assert torch.equal(sd.pack_outputs(want), buf)
    assert all(g.numel() == 0 for g in sd.unpack_outputs(
        sd.site_eval_packed(*args[:5], torch.zeros(0, dtype=torch.int64), tables, 21),
        0, tables, 21))
    with pytest.raises(ValueError, match="packed buffer"):
        sd.unpack_outputs(buf[:-1], len(sites), tables, 21)


def _dense_words(bits: int, seed: int) -> torch.Tensor:
    """Filter words with each bit set at p = 0.75: most windows pass the
    first hash, so the kernel's later rounds of loads run often."""
    rng = np.random.default_rng(seed)
    n = -(-bits // 32)
    a, b = (rng.integers(0, 2**32, n, dtype=np.uint64) for _ in range(2))
    return torch.from_numpy((a | b).astype(np.uint32).view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("C", [21, 341])
@pytest.mark.parametrize("k,h,nbytes", [
    (20, 1, 49160), (20, 4, 1 << 12), (32, 4, 1 << 12), (32, 4, 12292), (24, 6, 1 << 13),
    (20, 3, 1 << 12), (32, 5, 49160), (32, 8, 1 << 13), (24, 1, 1 << 13), (32, 3, 12292),
    (20, 5, 1 << 12), (24, 8, 49160),
])
def test_cuda_kernel_matches_plain(k, h, nbytes, C, dense):
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    draft, bf, sites = _inputs(k, h, nbytes)
    tables = siteeval.make_tables(k, JUMP)
    words = _dense_words(int(bf.bits), k * h) if dense else _words(bf)
    args = (words, int(bf.bits), h, torch.from_numpy(draft), len(draft),
            torch.from_numpy(sites), tables, C)
    want = sd.eval_sites_device_reference(*args)
    launches = sd.site_eval.launches.value
    got = sd.site_eval(*(a.cuda() if isinstance(a, torch.Tensor) else a for a in args))
    torch.cuda.synchronize()
    assert sd.site_eval.launches.value == launches + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    if dense:  # most gates pass the first hash and some fail a later one
        assert 0 < want[0].float().mean() < 1
