"""parallel/mesh.py of the port (K9's per-host grid) against the JAX
package's on conftest's 8 CPU devices: the (dp, sp) factorisation, the
haloed windows, and the sharded scan step (kernel 2's plain version in each
cell) with its summed stats.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goldpolish_tpu.parallel import mesh as jmesh
from goldpolish_tpu_torch.ops import bloom
from goldpolish_tpu_torch.ops import nthash as nt
from goldpolish_tpu_torch.parallel import mesh

CPUS = ("cpu",) * 8


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shape_matches_jax(n):
    want = jmesh.make_mesh(n)
    got = mesh.make_mesh(n, devices=CPUS)
    assert got.devices.shape == want.devices.shape
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)


@pytest.mark.parametrize("n,dp", [(8, 1), (8, 2), (8, 8), (6, 3), (4, 4)])
def test_make_mesh_given_dp_matches_jax(n, dp):
    want = jmesh.make_mesh(n, dp=dp)
    got = mesh.make_mesh(n, dp=dp, devices=CPUS)
    assert got.shape == dict(want.shape)


def test_make_mesh_refusals():
    with pytest.raises(RuntimeError, match="needs 9 devices"):
        mesh.make_mesh(9, devices=CPUS)
    with pytest.raises(ValueError, match="dp=3"):
        mesh.make_mesh(8, dp=3, devices=CPUS)
    if not torch.cuda.is_available():
        # no CUDA: the default grid (this process's GPUs) raises
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.make_mesh()


@pytest.mark.parametrize("sp,k,length", [(1, 20, 100), (2, 32, 1001), (4, 24, 999),
                                         (8, 32, 64)])
def test_haloed_windows_bytes_match_jax(sp, k, length):
    rng = np.random.default_rng(sp * 1000 + length)
    codes = rng.integers(0, 256, (3, length), dtype=np.uint8)
    got = mesh.haloed_windows(codes, sp, k)
    want = jmesh.haloed_windows(codes, sp, k)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _scenario(k, h, seed):
    """8 rows of ACGT (with N and lowercase bytes) and a filter holding
    every second window of row 0 and every window of row 5."""
    rng = np.random.default_rng(seed)
    codes = np.frombuffer(b"ACGTNacgt", np.uint8)[
        rng.choice(9, (8, 1203), p=[0.22] * 4 + [0.04] + [0.02] * 4)].copy()
    bf = bloom.BloomFilter(1 << 14, h, k)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(codes[0], k), k, h)[::2])
    bf.insert(nt.multi_hashes(nt.canonical_hashes(codes[5], k), k, h))
    return codes, bf


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("k,h", [(32, 4), (21, 2)])
def test_sharded_scan_step_matches_jax(n, k, h):
    codes, bf = _scenario(k, h, n + k)
    words = bf.words_u32()
    jm = jmesh.make_mesh(n)
    sp = jm.shape["sp"]
    windows = jmesh.haloed_windows(codes, sp, k)
    present, stats = jmesh.sharded_scan_step(jm, k, h, int(bf.bits))(
        jmesh.replicate(jm, jnp.asarray(words)), jmesh.shard_windows(jm, windows))
    want_p, want_s = np.asarray(present), np.asarray(stats)

    tm = mesh.make_mesh(n, devices=CPUS)
    step = mesh.sharded_scan_step(tm, k, h, int(bf.bits))
    got_p, got_s = step(mesh.replicate(tm, words), mesh.shard_windows(tm, windows))
    assert got_p.dtype == torch.bool and got_s.dtype == torch.int64
    assert np.array_equal(got_p.numpy(), want_p)
    assert np.array_equal(got_s.numpy(), want_s)
    assert 0 < int(want_s[0, 1]) < int(want_s[0, 0])  # mixed presence
    # the step also takes the plain arrays (it replicates and shards them)
    again_p, again_s = step(words, windows)
    assert torch.equal(again_p, got_p) and torch.equal(again_s, got_s)


def test_shard_windows_refuses_a_mismatch():
    tm = mesh.make_mesh(4, devices=CPUS)  # dp 2, sp 2
    with pytest.raises(ValueError, match="do not shard"):
        mesh.shard_windows(tm, np.zeros((3, 2, 40), np.uint8))
    with pytest.raises(ValueError, match="do not shard"):
        mesh.shard_windows(tm, np.zeros((4, 1, 40), np.uint8))
