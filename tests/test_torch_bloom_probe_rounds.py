"""Kernel 1 (ops/bloom_probe) at the filter sizes `-b 1` builds, and its
edge sweep.

The plain torch probe runs on CPU tensors and is held, exactly, against
the JAX package's Pallas int8 probe in interpret mode (one chunk at 512
KiB and 1 MiB, two at 2 MiB) and against bloom_pallas.probe_lo32_reference
at h = 1-8.  The CUDA cases hold the kernel against the plain version on
chip_smoke's edge sweep (n around the 4-row run and the 128-row warp
segment, h = 1-8, tuples at an aligned address and at a 4-byte offset) and
skip here: the kernel has no interpret mode (run them on the card with
`pytest --noconftest -m cuda`)."""

import numpy as np
import pytest
import torch

import chip_smoke
from goldpolish_tpu_torch.ops import bloom_probe

SIZES = (512 << 10, 1 << 20, 2 << 20)


def _pallas():
    import jax.numpy as jnp
    from goldpolish_tpu.ops import bloom_pallas

    return jnp, bloom_pallas


def _inputs(nbytes: int, h: int, n: int = 700):
    """A p = 0.75 filter of nbytes bytes and n rows of h lo32 hashes, half
    of them rows whose every bit is set (so each round has live rows)."""
    rng = np.random.default_rng([nbytes, h])
    words = chip_smoke.random_words(rng, nbytes * 8).view(np.uint32)
    lo = rng.integers(0, 2**32, (n, h), dtype=np.uint64).astype(np.uint32)
    set_bits = np.flatnonzero(np.unpackbits(words.view(np.uint8), bitorder="little"))
    lo[::2] = rng.choice(set_bits, (len(lo[::2]), h)).astype(np.uint32)
    lo[::2] |= rng.integers(0, 2**8, lo[::2].shape, dtype=np.uint32) << 24 & ~np.uint32(
        nbytes * 8 - 1)
    return words, lo


def _plain(words, nbytes, lo):
    return bloom_probe.probe_lo32(torch.from_numpy(words.view(np.int32).copy()),
                                  nbytes * 8,
                                  torch.from_numpy(lo.view(np.int32).copy())).numpy()


@pytest.mark.parametrize("h", range(1, 9))
@pytest.mark.parametrize("nbytes", SIZES)
def test_plain_probe_matches_pallas_and_reference(nbytes, h):
    jnp, bloom_pallas = _pallas()
    words, lo = _inputs(nbytes, h)
    got = _plain(words, nbytes, lo)
    planes = jnp.asarray(bloom_pallas.words_to_planes_i8(words))
    pallas = np.asarray(bloom_pallas.probe_lo32_mxu_i8(planes, nbytes * 8, jnp.asarray(lo),
                                                       interpret=True))
    ref = np.asarray(bloom_pallas.probe_lo32_reference(jnp.asarray(words), nbytes * 8,
                                                       jnp.asarray(lo)))
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, ref)
    assert got[::2].all() and 0 < got.mean() < 1


def test_edge_sweep_covers_the_run_and_the_segment():
    cases = chip_smoke.probe_edge_cases()
    ns = {n for n, _h, _b, _o in cases}
    assert {1, 3, 4, 5, 127, 128, 129} <= ns
    assert {h for _n, h, _b, _o in cases} == set(range(1, 9))
    assert {o for _n, h, _b, o in cases if h == 4} == {0, 1}


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.probe_edge_cases(), ids=str)
def test_cuda_kernel1_edges(case):
    """The kernel against its plain version on one edge case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    launches = bloom_probe.probe_lo32.launches.value
    chip_smoke.probe_edge_check(case)
    assert bloom_probe.probe_lo32.launches.value > launches
