"""ops/nthash_device (K5) and ops/bloom_device (K4) of the port against the
JAX package's nthash_jax and bloom_jax, run on the CPU as their own tests
run them (through jit).  Integer hashing: every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goldpolish_tpu.ops import bloom as jbloom
from goldpolish_tpu.ops import bloom_jax
from goldpolish_tpu.ops import nthash as jnt
from goldpolish_tpu.ops import nthash_jax as ntj
from goldpolish_tpu_torch.ops import bloom, bloom_device, u64
from goldpolish_tpu_torch.ops import nthash as nt
from goldpolish_tpu_torch.ops import nthash_device as ntd

_fwd = jax.jit(ntj.forward_hashes, static_argnums=1)
_rev = jax.jit(ntj.reverse_hashes, static_argnums=1)


def _port(fn, codes, *args):
    return u64.to_u64(fn(torch.from_numpy(codes), *args))


# tests/test_nthash_jax.py:19, and the full byte alphabet
@pytest.mark.parametrize("k", [20, 32, 64])
@pytest.mark.parametrize("alphabet", ["ACGTacgtNRn", "all"])
def test_hashes_match_jax(k, alphabet):
    rng = np.random.default_rng(k)
    n = 257
    if alphabet == "all":
        codes = rng.integers(0, 256, n).astype(np.uint8)
    else:
        codes = np.frombuffer(alphabet.encode(), np.uint8)[
            rng.integers(0, len(alphabet), n)].copy()
    jc = jnp.asarray(codes)
    assert np.array_equal(_port(ntd.forward_hashes, codes, k), np.asarray(_fwd(jc, k)))
    assert np.array_equal(_port(ntd.reverse_hashes, codes, k), np.asarray(_rev(jc, k)))
    want = np.asarray(ntj.canonical_hashes_jit(jc, k))
    assert np.array_equal(_port(ntd.canonical_hashes, codes, k), want)
    assert np.array_equal(want, jnt.canonical_hashes(codes, k))
    f, r = ntd.strand_hashes(torch.from_numpy(codes), k)
    assert np.array_equal(u64.to_u64(f + r), want)


# tests/test_nthash_jax.py:33
def test_batched_leading_dims():
    k = 16
    rng = np.random.default_rng(0)
    batch = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (2, 4, 100))].copy()
    want = np.asarray(ntj.canonical_hashes_jit(jnp.asarray(batch), k))
    assert np.array_equal(_port(ntd.canonical_hashes, batch, k), want)


# tests/test_nthash_jax.py:44
@pytest.mark.parametrize("k,m", [(32, 5), (20, 1), (64, 4)])
def test_multi_hashes(k, m):
    base = np.array([1, 2, 0xDEADBEEF, 2**63, 2**64 - 1], dtype=np.uint64)
    got = u64.to_u64(ntd.multi_hashes(u64.from_u64(base), k, m))
    assert np.array_equal(got, np.asarray(ntj.multi_hashes_jit(jnp.asarray(base), k, m)))


def test_srol_n_and_cumxor_match_jax():
    rng = np.random.default_rng(3)
    v = rng.integers(0, 2**64, 300, dtype=np.uint64)
    n = rng.integers(0, 5000, 300)
    got = u64.to_u64(ntd.srol_n(u64.from_u64(v), torch.from_numpy(n)))
    assert np.array_equal(got, np.asarray(ntj.srol_n(jnp.asarray(v), jnp.asarray(n))))
    a = rng.integers(0, 2**64, (3, 37), dtype=np.uint64)
    got = u64.to_u64(ntd.cumxor(u64.from_u64(a)))
    assert np.array_equal(got, np.asarray(ntj.cumxor(jnp.asarray(a))))


# -- bloom_device.probe_kmers_packed (kernel 2's plain version on the CPU) ----


def _filter(codes, k, h, nbytes):
    """A port filter and the same bits as a JAX-package filter, with every
    second window of `codes` rows in them."""
    bf = bloom.BloomFilter(nbytes, h, k)
    for row in codes.reshape(-1, codes.shape[-1]):
        bf.insert(nt.multi_hashes(nt.canonical_hashes(row, k), k, h)[::2])
    jbf = jbloom.BloomFilter(nbytes, h, k)
    jbf.array[:] = bf.array
    return bf, jbf


@pytest.mark.parametrize("k,h,nbytes", [
    (20, 4, 1 << 14), (32, 4, 1 << 16), (32, 1, 49160), (24, 3, 12292),
])
def test_probe_kmers_packed_matches_jax(k, h, nbytes):
    """The full byte alphabet, a power-of-two filter and two that are not;
    rows whose window count is no multiple of 8 (pad bits compared too)."""
    rng = np.random.default_rng([k, h, nbytes])
    codes = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (3, 517))].copy()
    wild = rng.random(codes.shape) < 0.05
    codes[wild] = rng.integers(0, 256, int(wild.sum()))
    bf, jbf = _filter(codes, k, h, nbytes)
    want = np.asarray(bloom_jax.probe_kmers_packed_jit(
        jnp.asarray(jbf.words_u32()), int(jbf.bits), h, k, jnp.asarray(codes)))
    words = bloom_device.to_device_words(bf, "cpu")
    got = bloom_device.probe_kmers_packed(words, int(bf.bits), h, k,
                                          torch.from_numpy(codes)).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)
    one = bloom_device.probe_kmers_packed(words, int(bf.bits), h, k,
                                          torch.from_numpy(codes[1])).numpy()
    assert np.array_equal(one, want[1])
    assert 0 < np.unpackbits(got).mean() < 1


def test_probe_kmers_packed_chunks_rows_past_kernel_limit():
    """More rows than kernel 2 takes in one call (bloom_device.MAX_ROWS):
    the rows go in chunks and come back in order."""
    k, h = 5, 2
    rng = np.random.default_rng(11)
    rows = bloom_device.MAX_ROWS + 3
    codes = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (rows, 14))].copy()
    bf, jbf = _filter(codes[:: 97], k, h, 1 << 10)
    want = np.asarray(bloom_jax.probe_kmers_packed_jit(
        jnp.asarray(jbf.words_u32()), int(jbf.bits), h, k, jnp.asarray(codes)))
    got = bloom_device.probe_kmers_packed(bloom_device.to_device_words(bf, "cpu"),
                                          int(bf.bits), h, k, torch.from_numpy(codes))
    assert np.array_equal(got.numpy(), want)
    assert 0 < np.unpackbits(want[-3:]).mean() < 1
