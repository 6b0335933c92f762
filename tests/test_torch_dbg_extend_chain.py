"""Kernel 7's chain design (ops/dbg_extend.dbg_extend_chain, the lockstep
DeviceDBG's probe) on the CPU: its plain version against the one-level
probe iterated along each row's unique extension, column 0 against the JAX
package's bloom_jax.probe_kmers, DeviceDBG's searches against the JAX
package's DeviceDBG and the host DBG, and the rounds an unbranched search
takes.  Every comparison is exact (tolerance 0: masks, lengths, results).

The port runs on device="cpu", so its plain torch versions run; the JAX
side runs on the JAX CPU backend, as tests/test_sealer.py runs it.  The
CUDA cases (kernel against plain) need the card and skip here; the JAX
package is imported only by the tests that compare with it, so they also
run where jax is not installed (`pytest --noconftest -m cuda`)."""

import math

import numpy as np
import pytest
import torch

from goldpolish_tpu_torch.fill import konnector
from goldpolish_tpu_torch.ops import bloom, bloom_device, dbg_extend
from goldpolish_tpu_torch.ops import nthash as nt

H = 4
NON_POW2 = 49160  # filter bytes: 393,280 bits, no power of two
ACGT = b"ACGT"


def _genome(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _insert(bf, seq: str) -> None:
    k = bf.k
    bf.insert(nt.multi_hashes(nt.canonical_hashes(nt.encode(seq), k), k, bf.hash_num))


BRANCH_AT = range(300, 2700, 400)


def _graph(rng, k: int, nbytes: int = 1 << 18):
    """A filter of a 3 kbp truth's k-mers, with a branch at each of
    BRANCH_AT (a copy of 2k bases of the truth with base p changed), and
    the truth."""
    truth = _genome(rng, 3000)
    bf = bloom.BloomFilter(nbytes, H, k)
    _insert(bf, truth)
    for p in BRANCH_AT:
        alt = "ACGT"[("ACGT".index(truth[p]) + 1) % 4]
        _insert(bf, truth[p - k : p] + alt + truth[p + 1 : p + k])
    return bf, truth


def _rows(rng, truth: str, k: int, R: int, n_succ: int) -> np.ndarray:
    """R vertices of the truth (the first n_succ successor rows): clean
    ones; ones with an N, IUPAC or lowercase byte where a walk drops it
    first (position 0 of a successor row, k - 1 of a predecessor row) or
    keeps it (an interior byte: a dead end); ones a few levels before a
    branch; random ones (no extension)."""
    rows = []
    odd = np.frombuffer(b"NRYnacgt", np.uint8)
    for i in range(R):
        succ = i < n_succ
        s = int(rng.integers(0, len(truth) - k))
        kind = i % 8
        if kind in (3, 7):  # a branch t levels on
            p, t = BRANCH_AT[int(rng.integers(0, len(BRANCH_AT)))], int(rng.integers(0, 4))
            s = p - k - t if succ else p + 1 + t
        v = np.frombuffer(truth[s : s + k].encode(), np.uint8).copy()
        if kind in (1, 5):  # the byte the walk drops first
            v[0 if succ else k - 1] = odd[rng.integers(0, len(odd))]
        elif kind == 2:  # an interior byte
            v[int(rng.integers(1, k - 1))] = odd[rng.integers(0, len(odd))]
        elif kind == 6:  # off the graph
            v = np.frombuffer(_genome(rng, k).encode(), np.uint8).copy()
        rows.append(v)
    return np.stack(rows)


def _iterated(words, bits, k, verts: np.ndarray, n_succ: int, steps: int) -> np.ndarray:
    """The chain of every row, one dbg_extend4_reference call per row and
    level, along the unique extension: uint8 [R, steps + 1]."""
    out = np.zeros((len(verts), steps + 1), np.uint8)
    for r, v in enumerate(verts):
        succ = r < n_succ
        v = v.copy()
        for j in range(steps):
            m = int(dbg_extend.dbg_extend4_reference(
                words, bits, H, k, torch.from_numpy(v[None]), int(succ))[0])
            out[r, j], out[r, steps] = m, j + 1
            if j + 1 == steps or bin(m).count("1") != 1:
                break
            b = ACGT[m.bit_length() - 1]
            v = np.concatenate([v[1:], [b]] if succ else [[b], v[:-1]]).astype(np.uint8)
    return out


@pytest.mark.parametrize("direction", ["succ", "pred", "mixed"])
@pytest.mark.parametrize("steps", [1, 8, 32])
@pytest.mark.parametrize("k", [20, 32, 64])
def test_chain_plain_matches_iterated_probe(k, steps, direction):
    rng = np.random.default_rng([k, steps, ["succ", "pred", "mixed"].index(direction)])
    bf, truth = _graph(rng, k)
    n_succ = {"succ": 48, "pred": 0, "mixed": 24}[direction]
    verts = _rows(rng, truth, k, 48, n_succ)
    words, bits = bloom_device.to_device_words(bf, "cpu"), int(bf.bits)
    want = _iterated(words, bits, k, verts, n_succ, steps)
    calls = dbg_extend.dbg_extend_chain_reference.calls.value
    launches = dbg_extend.dbg_extend_chain.launches.value
    got = dbg_extend.dbg_extend_chain(words, bits, H, k, torch.from_numpy(verts),
                                      n_succ, steps)
    assert dbg_extend.dbg_extend_chain_reference.calls.value == calls + 1
    assert dbg_extend.dbg_extend_chain.launches.value == launches
    assert got.dtype == torch.uint8 and got.shape == (48, steps + 1)
    assert np.array_equal(got.numpy(), want)
    # the chains stop at a dead end, at a branch and after the full D
    lens = want[:, steps].astype(int)
    last = want[np.arange(48), lens - 1]
    assert (last == 0).any() and (lens >= 1).all()
    if steps > 1:
        assert (lens == steps).any()
        assert ((lens < steps) & (np.vectorize(lambda m: bin(m).count("1"))(last) >= 2)).any()
    # masks past a chain's end are 0; column 0 is the one-level probe
    assert not any(want[r, lens[r] : steps].any() for r in range(48))
    one = dbg_extend.dbg_extend4(words, bits, H, k, torch.from_numpy(verts), n_succ)
    assert np.array_equal(got[:, 0].numpy(), one.numpy())


def _jax_ext_rows(verts: np.ndarray, n_succ: int) -> np.ndarray:
    """DeviceDBG.prefetch's [rows, 4, k] extension rows (konnector.py:276-285)."""
    rows, k = verts.shape
    ext = np.empty((rows, 4, k), np.uint8)
    bases = np.frombuffer(ACGT, np.uint8)
    ext[:n_succ, :, : k - 1] = verts[:n_succ, None, 1:]
    ext[:n_succ, :, k - 1] = bases
    ext[n_succ:, :, 1:] = verts[n_succ:, None, :-1]
    ext[n_succ:, :, 0] = bases
    return ext


@pytest.mark.parametrize("nbytes", [1 << 18, NON_POW2])
@pytest.mark.parametrize("k", [20, 32, 64])
def test_chain_column0_matches_jax_probe(k, nbytes):
    import jax.numpy as jnp

    from goldpolish_tpu.ops import bloom_jax

    rng = np.random.default_rng([k, nbytes])
    bf, truth = _graph(rng, k, nbytes)
    verts = _rows(rng, truth, k, 64, 32)
    pres = np.asarray(bloom_jax.probe_kmers(
        jnp.asarray(bf.words_u32()), int(bf.bits), H, k,
        jnp.asarray(_jax_ext_rows(verts, 32).reshape(4 * 64, k))))[:, 0]
    want = (pres.reshape(64, 4) * np.array([1, 2, 4, 8])).sum(1).astype(np.uint8)
    got = dbg_extend.dbg_extend_chain(bloom_device.to_device_words(bf, "cpu"),
                                      int(bf.bits), H, k, torch.from_numpy(verts), 32, 8)
    assert np.array_equal(got[:, 0].numpy(), want)
    assert (want == 0).any() and (want != 0).any()


def _gaps(truth: str, starts, apart: int) -> list[tuple[str, str]]:
    """(read1, read2) flanks of 64 bp, `apart` bp apart, at each start."""
    return [(truth[s : s + 64], konnector.revcomp(truth[s + 64 + apart : s + 128 + apart]))
            for s in starts]


# each case's params, filter bytes and flank distance, and the result some
# search of it must end with; the memory-limit case on a dense filter, whose
# false positives branch the search past the 1,000 edges between checks
_SEARCHES = {
    "found": (dict(max_merged_seq_len=400, max_paths=10, max_branches=1000,
                   max_cost=100000), 1 << 18, 120, "FOUND_PATH"),
    "max_cost": (dict(max_merged_seq_len=400, max_paths=10, max_branches=1000,
                      max_cost=150), 1 << 18, 120, "MAX_COST_EXCEEDED"),
    "mem_limit": (dict(max_merged_seq_len=1000, max_paths=10, max_branches=100000,
                       max_cost=1000000, mem_limit=20_000), 1 << 11, 700,
                  "EXCEEDED_MEM_LIMIT"),
}


@pytest.mark.parametrize("case", list(_SEARCHES))
def test_connect_pairs_batch_matches_jax_and_host(case):
    from goldpolish_tpu.fill import konnector as jkon
    from goldpolish_tpu.ops import bloom as jbloom

    fields, nbytes, apart, want_result = _SEARCHES[case]
    rng = np.random.default_rng(len(case))
    truth = _genome(rng, 4000)
    bf = bloom.BloomFilter(nbytes, H, 32)
    _insert(bf, truth)
    pairs = _gaps(truth, range(100, 3000, 600), apart)
    params = konnector.ConnectPairsParams(**fields)
    jbf = jbloom.BloomFilter(bf.bytes, bf.hash_num, bf.k)
    jbf.array[:] = bf.array
    jbatch = jkon.connect_pairs_batch(jkon.DeviceDBG(jbf, 32), pairs,
                                      jkon.ConnectPairsParams(**fields))
    batch = konnector.connect_pairs_batch(konnector.DeviceDBG(bf, 32, device="cpu"),
                                          pairs, params)
    host = [konnector.connect_pairs(konnector.DBG(bf, 32), r1, r2, params)
            for r1, r2 in pairs]
    assert [b.path_result for b in batch].count(want_result) >= 1
    for b, j, s in zip(batch, jbatch, host):
        for f in ("path_result", "merged_seqs", "consensus", "cost", "num_nodes_visited",
                  "max_active_branches", "read_mismatches", "path_mismatches"):
            assert getattr(b, f) == getattr(j, f) == getattr(s, f), (case, f)


def _rounds(bf, pair, params) -> int:
    """Kernel 7 calls (prefetch rounds) of connect_pairs_batch on one gap."""
    calls = dbg_extend.dbg_extend_chain_reference.calls.value
    res = konnector.connect_pairs_batch(konnector.DeviceDBG(bf, 32, device="cpu"),
                                        [pair], params)
    assert res[0].path_result == "FOUND_PATH"
    return dbg_extend.dbg_extend_chain_reference.calls.value - calls


def test_unbranched_path_rounds(monkeypatch):
    """A gap of ~600 bp on an unbranched path: each search direction walks
    L ~ 300 levels; the chains answer them in at most ceil(L / D) + 2
    rounds, the one-level probe (D = 1) takes at least L."""
    rng = np.random.default_rng(30)
    truth = _genome(rng, 1200)
    bf = bloom.BloomFilter(1 << 18, H, 32)
    _insert(bf, truth)
    pair = (truth[100:164], konnector.revcomp(truth[760:824]))
    params = konnector.ConnectPairsParams(max_merged_seq_len=1000)
    # L: the deepest level either direction of the host search reached
    _res, search = konnector._prepare_search(konnector.DBG(bf, 32), *pair, params)
    search.run()
    L = max(max(d.values()) for d in search.depth)
    assert 280 <= L <= 320
    D = dbg_extend.CHAIN_STEPS
    assert _rounds(bf, pair, params) <= math.ceil(L / D) + 2
    monkeypatch.setattr(dbg_extend, "CHAIN_STEPS", 1)
    assert _rounds(bf, pair, params) >= L


# -- kernel 7 on the card --------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 8, dbg_extend.CHAIN_STEPS])
@pytest.mark.parametrize("R", [1, 51, 512, 1 << 16])
@pytest.mark.parametrize("nbytes", [1 << 20, NON_POW2])
def test_cuda_chain_matches_plain(nbytes, R, steps):
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    k = 32 if R % 2 else 20
    rng = np.random.default_rng([nbytes, R, steps])
    bf, truth = _graph(rng, k, nbytes)
    verts = torch.from_numpy(_rows(rng, truth, k, R, R // 2))
    args = (int(bf.bits), H, k)
    want = dbg_extend.dbg_extend_chain_reference(
        bloom_device.to_device_words(bf, "cpu"), *args, verts, R // 2, steps)
    launches = dbg_extend.dbg_extend_chain.launches.value
    got = dbg_extend.dbg_extend_chain(bloom_device.to_device_words(bf, "cuda"), *args,
                                      verts.cuda(), R // 2, steps)
    torch.cuda.synchronize()
    assert dbg_extend.dbg_extend_chain.launches.value == launches + 1
    assert torch.equal(got.cpu(), want)
