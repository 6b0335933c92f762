"""The sealer's lockstep device DBG of the port (fill/konnector.DeviceDBG,
K8, on the extension probe of ops/dbg_extend.py, kernel 7) and the rest of
K4 (ops/bloom_device.probe_words, probe_kmers, build_words) against the JAX
package's DeviceDBG and bloom_jax, on the CPU.

The port runs on device="cpu", so its plain torch versions run; the JAX
side runs on the JAX CPU backend, as tests/test_sealer.py and
tests/test_bloom.py run it.  Both packages get the same filter bytes.
Every comparison is exact (tolerance 0: bits, masks, bytes, counters).
The CUDA case needs the card and skips here; the JAX package is imported
only by the tests that compare with it, so the CUDA case also runs where
jax is not installed (`pytest --noconftest -m cuda`)."""

import numpy as np
import pytest
import torch

from goldpolish_tpu_torch.config import PipelineConfig
from goldpolish_tpu_torch.fill import konnector, sealer
from goldpolish_tpu_torch.ops import bloom, bloom_device, dbg_extend, u64
from goldpolish_tpu_torch.ops import nthash as nt
from goldpolish_tpu_torch.pipeline import bulk

K, H = 32, 4
NON_POW2 = 49160  # filter bytes: 393,280 bits, no power of two


def _jax():
    import jax.numpy as jnp

    from goldpolish_tpu.fill import konnector as jkon
    from goldpolish_tpu.fill import sealer as jsealer
    from goldpolish_tpu.ops import bloom as jbloom
    from goldpolish_tpu.ops import bloom_jax

    return jnp, jkon, jsealer, jbloom, bloom_jax


def _genome(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _filter(truth: str, k: int = K, h: int = H, nbytes: int = 1 << 17):
    bf = bloom.BloomFilter(nbytes, h, k)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(nt.encode(truth), k), k, h))
    return bf


def _jax_filter(bf):
    jbloom = _jax()[3]
    jbf = jbloom.BloomFilter(bf.bytes, bf.hash_num, bf.k)
    jbf.array[:] = bf.array
    return jbf


def _words(bf, device="cpu"):
    return bloom_device.to_device_words(bf, device)


def _mixed(rng, seq: str) -> np.ndarray:
    """seq's codes with lowercase, N and IUPAC bytes sprinkled in."""
    codes = nt.encode(seq).copy()
    r = rng.random(len(codes))
    codes[r < 0.03] |= 32
    codes[r < 0.01] = ord("N")
    codes[r < 0.005] = ord("R")
    return codes


# -- the rest of K4: probe_words, probe_kmers, build_words --------------------


# tests/test_bloom.py:87 and :92
@pytest.mark.parametrize("k", [20, 32, 40])
@pytest.mark.parametrize("h", [1, 3, 4])
@pytest.mark.parametrize("nbytes", [1 << 16, NON_POW2])
def test_probe_words_and_kmers_match_jax(nbytes, h, k):
    jnp, _jkon, _jsealer, _jbloom, bloom_jax = _jax()
    rng = np.random.default_rng([nbytes, h, k])
    codes = _mixed(rng, _genome(rng, 1500))
    hashes = nt.multi_hashes(nt.canonical_hashes(codes, k), k, h)
    bf = bloom.BloomFilter(nbytes, h, k)
    bf.insert(hashes[::2])  # half in, half out
    jwords = jnp.asarray(bf.words_u32())
    want = np.asarray(bloom_jax.probe_words_jit(jwords, int(bf.bits), jnp.asarray(hashes)))
    got = bloom_device.probe_words(_words(bf), int(bf.bits), u64.from_u64(hashes))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, bf.contains(hashes)) and want.any() and not want.all()
    rows = codes[: 3 * 480].reshape(3, 480)  # leading dimensions
    want2 = np.asarray(bloom_jax.probe_kmers_jit(jwords, int(bf.bits), h, k,
                                                 jnp.asarray(rows)))
    got2 = bloom_device.probe_kmers(_words(bf), int(bf.bits), h, k, torch.from_numpy(rows))
    assert got2.shape == (3, 480 - k + 1) and np.array_equal(got2.numpy(), want2)


# tests/test_bloom.py:107, with the mask the JAX fill gives it
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nbytes", [1 << 16, NON_POW2])
def test_build_words_matches_jax(nbytes, masked):
    jnp, _jkon, _jsealer, _jbloom, bloom_jax = _jax()
    k = 24
    rng = np.random.default_rng([nbytes, masked])
    hashes = nt.multi_hashes(nt.canonical_hashes(nt.encode(_genome(rng, 3000)), k), k, H)
    hashes = hashes[:2976].reshape(2, -1, H)  # leading dimensions
    mask = rng.random(hashes.shape[:-1]) < 0.5 if masked else None
    bits = nbytes * 8
    want = np.asarray(bloom_jax.build_words_jit(
        bits, jnp.asarray(hashes), mask=None if mask is None else jnp.asarray(mask)))
    got = bloom_device.build_words(bits, u64.from_u64(hashes),
                                   None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy().view(np.uint32), want)
    host = bloom.BloomFilter(nbytes, H, k)
    host.insert(hashes[mask] if masked else hashes.reshape(-1, H))
    assert np.array_equal(want, host.words_u32())


# -- kernel 7's plain version against the JAX DeviceDBG's probe ---------------


def _frontier(rng, truth: str, R: int, k: int):
    """R k-mers of truth (a few with lowercase, N or IUPAC bytes), the
    first (R + 1) // 2 successor rows."""
    starts = rng.integers(0, len(truth) - k, R)
    verts = np.stack([_mixed(rng, truth[s : s + k]) if i % 7 == 0
                      else nt.encode(truth[s : s + k]) for i, s in enumerate(starts)]
                     ) if R else np.zeros((0, k), np.uint8)
    return verts, (R + 1) // 2


def _jax_ext_rows(verts: np.ndarray, n_succ: int) -> np.ndarray:
    """DeviceDBG.prefetch's [rows, 4, k] extension rows (konnector.py:276-285)."""
    rows, k = verts.shape
    ext = np.empty((rows, 4, k), np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    ext[:n_succ, :, : k - 1] = verts[:n_succ, None, 1:]
    ext[:n_succ, :, k - 1] = bases
    ext[n_succ:, :, 1:] = verts[n_succ:, None, :-1]
    ext[n_succ:, :, 0] = bases
    return ext


@pytest.mark.parametrize("k", [20, 32, 40])
@pytest.mark.parametrize("R", [0, 1, 1000])
def test_extension_probe_matches_jax(R, k):
    jnp, _jkon, _jsealer, _jbloom, bloom_jax = _jax()
    rng = np.random.default_rng([R, k])
    truth = _genome(rng, 3000)
    bf = _filter(truth, k)
    verts, n_succ = _frontier(rng, truth, R, k)
    want = np.zeros(R, np.uint8)
    if R:
        pres = np.asarray(bloom_jax.probe_kmers_jit(
            jnp.asarray(bf.words_u32()), int(bf.bits), H, k,
            jnp.asarray(_jax_ext_rows(verts, n_succ).reshape(4 * R, k))))[:, 0]
        want = (pres.reshape(R, 4) * np.array([1, 2, 4, 8])).sum(1).astype(np.uint8)
    calls = dbg_extend.dbg_extend4_reference.calls.value
    launches = dbg_extend.dbg_extend4.launches.value
    got = dbg_extend.dbg_extend4(_words(bf), int(bf.bits), H, k, torch.from_numpy(verts),
                                 n_succ)
    assert dbg_extend.dbg_extend4_reference.calls.value == calls + 1
    assert dbg_extend.dbg_extend4.launches.value == launches
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    if R > 1:
        assert (want == 0).any() and (want != 0).any()


def test_extension_probe_refusals():
    bf = bloom.BloomFilter(1 << 12, H, 65)
    verts = torch.zeros(4, 65, dtype=torch.uint8)
    with pytest.raises(ValueError, match="unsupported"):
        dbg_extend.dbg_extend4(_words(bf), int(bf.bits), H, 65, verts, 2)
    with pytest.raises(ValueError, match="unsupported"):
        dbg_extend.dbg_extend4(_words(bf), int(bf.bits), 17, 32, verts[:, :32], 2)
    with pytest.raises(ValueError, match="verts must be"):
        dbg_extend.dbg_extend4(_words(bf), int(bf.bits), H, 32, verts, 2)
    with pytest.raises(ValueError, match="n_succ"):
        dbg_extend.dbg_extend4(_words(bf), int(bf.bits), H, 32, verts[:, :32], 5)


# -- DeviceDBG -----------------------------------------------------------------


# tests/test_sealer.py:169, against the JAX DeviceDBG as well
def test_device_dbg_matches_jax_and_host():
    _jnp, jkon, _jsealer, _jbloom, _bj = _jax()
    rng = np.random.default_rng(9)
    truth = _genome(rng, 2000)
    bf = _filter(truth)
    host = konnector.DBG(bf, K)
    want = jkon.DeviceDBG(_jax_filter(bf), K)
    dev = konnector.DeviceDBG(bf, K, device="cpu")
    kmers = [truth[i : i + K] for i in range(0, 500, 7)]
    far = [truth[i : i + K] for i in range(1200, 1500, 50)]  # on no chain below
    calls = dbg_extend.dbg_extend_chain_reference.calls.value
    # prefetch half as a frontier batch, leave the rest to miss-path calls;
    # each prefetch also caches the unbranched chain from every vertex
    dev.prefetch(kmers[::2], kmers[1::2])
    want.prefetch(kmers[::2], kmers[1::2])
    assert dbg_extend.dbg_extend_chain_reference.calls.value == calls + 1
    # kmers[0]'s successors from its own row, its predecessors from the
    # chain of kmers[1] (7 bases after it)
    assert dev.is_cached(kmers[0], True) and dev.is_cached(kmers[0], False)
    misses = 0
    for km in kmers + far:
        misses += (not dev.is_cached(km, True)) + (not dev.is_cached(km, False))
        assert dev.successors(km) == host.successors(km) == want.successors(km), km
        assert dev.predecessors(km) == host.predecessors(km) == want.predecessors(km), km
    assert misses >= 2 * len(far)
    assert dbg_extend.dbg_extend_chain_reference.calls.value == calls + 1 + misses


def test_device_dbg_refuses_cuda_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        konnector.DeviceDBG(bloom.BloomFilter(1 << 12, H, K), K)


def _gapped(truth: str) -> str:
    return (truth[:700] + truth[700:760].lower() + truth[760:1500]
            + truth[1500:1580].lower() + truth[1580:2200] + "N" * 30 + truth[2230:])


# tests/test_sealer.py:185, against the JAX package's jax backend
def test_seal_records_jax_backend_matches_jax_package():
    _jnp, _jkon, jsealer, _jbloom, _bj = _jax()
    rng = np.random.default_rng(10)
    truth = _genome(rng, 3000)
    ks = [32, 28]
    bfs = {k: _filter(truth, k) for k in ks}
    records = [("c1 x", _gapped(truth))]
    cfg = sealer.SealerConfig(k_values=ks, flank_length=32, verbose=False)
    jcfg = jsealer.SealerConfig(k_values=ks, flank_length=32, verbose=False)
    trace, jtrace = [], []
    calls = dbg_extend.dbg_extend4_reference.calls.value
    got = sealer.seal_records(records, bfs, cfg, trace_out=trace, backend="jax",
                              device="cpu")
    assert dbg_extend.dbg_extend4_reference.calls.value > calls
    want = jsealer.seal_records(records, {k: _jax_filter(bf) for k, bf in bfs.items()},
                                jcfg, trace_out=jtrace, backend="jax")
    assert got == want
    assert trace == jtrace
    assert got == sealer.seal_records(records, bfs, cfg)  # the host search
    assert got[1]["gaps_found"] == 3 and got[1]["gaps_closed"] == 3
    assert got[0][0][1].upper() == truth


# tests/test_sealer.py:205: lockstep equals serial, and the JAX lockstep
def test_connect_pairs_batch_matches_serial():
    _jnp, jkon, _jsealer, _jbloom, _bj = _jax()
    rng = np.random.default_rng(12)
    truth = _genome(rng, 4000)
    bf = _filter(truth)
    params = konnector.ConnectPairsParams(
        max_merged_seq_len=300, max_paths=10, max_branches=1000, max_cost=100000)
    pairs = [(truth[s : s + 64], konnector.revcomp(truth[s + 120 : s + 184]))
             for s in range(100, 3600, 500)]
    serial = [konnector.connect_pairs(konnector.DBG(bf, K), r1, r2, params)
              for r1, r2 in pairs]
    jparams = jkon.ConnectPairsParams(
        max_merged_seq_len=300, max_paths=10, max_branches=1000, max_cost=100000)
    jbatch = jkon.connect_pairs_batch(jkon.DeviceDBG(_jax_filter(bf), K), pairs, jparams)
    batch = konnector.connect_pairs_batch(konnector.DeviceDBG(bf, K, device="cpu"),
                                          pairs, params)
    assert all(s.path_result == "FOUND_PATH" for s in serial)
    for s, b, j in zip(serial, batch, jbatch):
        for field in ("path_result", "merged_seqs", "consensus", "cost",
                      "num_nodes_visited"):
            assert getattr(b, field) == getattr(s, field) == getattr(j, field), field


def test_jax_sealer_k_bound_at_startup(tmp_path):
    """The extension probe takes k <= 64: a larger k on the jax backend with
    the sealer on raises before any batch; with --no-sealer it is not the
    sealer's to refuse."""
    cfg = PipelineConfig(seqs_to_polish="d.fa", polishing_seqs="r.fq",
                         output_seqs=str(tmp_path / "o.fa"), k_values=[65, 32],
                         backend="jax", device="cpu")
    with pytest.raises(ValueError, match="k <= 64"):
        bulk.check_ported(cfg)
    cfg.run_sealer = False
    bulk.check_ported(cfg)


# -- kernel 7 on the card --------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 1000, 1 << 16])
@pytest.mark.parametrize("k", [20, 32, 40])
@pytest.mark.parametrize("nbytes", [1 << 20, NON_POW2])
def test_cuda_kernel_matches_plain(nbytes, k, R):
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    rng = np.random.default_rng([nbytes, k, R])
    truth = _genome(rng, 20_000)
    bf = _filter(truth, k, nbytes=nbytes)
    verts, n_succ = _frontier(rng, truth, R, k)
    verts = torch.from_numpy(verts)
    want = dbg_extend.dbg_extend4_reference(_words(bf), int(bf.bits), H, k, verts, n_succ)
    launches = dbg_extend.dbg_extend4.launches.value
    got = dbg_extend.dbg_extend4(_words(bf, "cuda"), int(bf.bits), H, k, verts.cuda(),
                                 n_succ)
    torch.cuda.synchronize()
    assert dbg_extend.dbg_extend4.launches.value == launches + 1
    assert torch.equal(got.cpu(), want)
