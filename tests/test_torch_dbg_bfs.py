"""ops/dbg_bfs (kernel 3, the sealer's whole-search BFS) against the JAX
package's DeviceBFS and the host BFS, on the CPU.

The plain torch version runs on CPU tensors; the JAX kernel runs on the
JAX CPU backend, as tests/test_dbg_bfs.py runs it.  Mask dictionaries are
compared exactly; the mask replay and seal_records(backend="hybrid") must
equal the host search field by field.  The CUDA case needs the card and
skips here; the JAX package is imported only by the tests that compare
with it, so the CUDA case also runs where jax is not installed
(`pytest --noconftest -m cuda`).  The mixed batch (inactive, depth 0, thin,
wide and overflowing searches in one call) is chip_smoke.mixed_bfs_batch,
the batch the smoke run gives the kernel on the card."""

import dataclasses
from collections import deque

import numpy as np
import pytest
import torch

import chip_smoke
from goldpolish_tpu_torch.fill import konnector, sealer
from goldpolish_tpu_torch.ops import bloom, dbg_bfs, u64
from goldpolish_tpu_torch.ops import nthash as nt
from goldpolish_tpu_torch.ops.dbg_bfs import DeviceBFS, pack_kmer, unpack_kmer

K, H = 24, 4


def _jax():
    from goldpolish_tpu.fill import konnector as jkon
    from goldpolish_tpu.ops import bloom as jbloom
    from goldpolish_tpu.ops import dbg_bfs as jbfs

    return jkon, jbloom, jbfs


def _filter(truth: bytes, k: int, bytes_size: int, h: int = H):
    bf = bloom.BloomFilter(bytes_size, h, k)
    codes = np.frombuffer(truth, np.uint8)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(codes, k), k, h))
    return bf


def _jax_filter(bf):
    _jkon, jbloom, _jbfs = _jax()
    jbf = jbloom.BloomFilter(bf.bytes, bf.hash_num, bf.k)
    jbf.array[:] = bf.array
    return jbf


def _genome(n, seed):
    rng = np.random.default_rng(seed)
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes()


def _genome_bf(n=20_000, seed=2):
    truth = _genome(n, seed)
    return truth.decode(), _filter(truth, K, 1 << 16)


def _ref_masks(dbg, seed_kmer: str, max_depth: int, forward: bool):
    """Host BFS (tests/test_dbg_bfs.py:35-56): every vertex reachable within
    max_depth with its 4-bit extension mask, keyed by packed k-mer."""
    masks = {}
    depth = {seed_kmer: 0}
    q = deque([seed_kmer])
    while q:
        u = q.popleft()
        nbrs = dbg.successors(u) if forward else dbg.predecessors(u)
        m = 0
        for v in nbrs:
            m |= 1 << "ACGT".index(v[-1] if forward else v[0])
        masks[pack_kmer(u)] = m
        if depth[u] < max_depth:
            for v in nbrs:
                if v not in depth:
                    depth[v] = depth[u] + 1
                    q.append(v)
    return masks


@pytest.mark.parametrize("kmer", ["ACGT" * 6, "T" * 24, "GATTACAGATTACAGATTACAGAT"])
def test_pack_roundtrip(kmer):
    _jkon, _jbloom, jbfs = _jax()
    assert unpack_kmer(pack_kmer(kmer), K) == kmer
    assert pack_kmer(kmer) == jbfs.pack_kmer(kmer)


def test_roll_table_matches_jax_seeds():
    _jkon, _jbloom, jbfs = _jax()
    for k in (20, 24, 28, 32):
        tab = dbg_bfs.roll_table(k)
        assert list(tab[0:4]) == list(jbfs._FSEED4)
        assert list(tab[4:8]) == list(jbfs._RSEED4)
        assert list(tab[8:12]) == [nt.srol_n_i(int(x), k) for x in jbfs._FSEED4]


_SEARCHES = ((500, 12, 10), (3000, 20, 20), (7777, 6, 18))


@pytest.mark.parametrize("search", _SEARCHES)
def test_plain_masks_match_jax_and_host(search):
    jkon, _jbloom, jbfs = _jax()
    truth, bf = _genome_bf()
    off, md_f, md_r = search
    start, goal = truth[off : off + K], truth[off + 40 : off + 40 + K]
    dbg = konnector.DBG(bf, K)
    ref = (_ref_masks(dbg, start, md_f, True), _ref_masks(dbg, goal, md_r, False))
    calls = dbg_bfs.dbg_bfs_reference.calls.value
    launches = dbg_bfs.dbg_bfs.launches.value
    got = DeviceBFS(bf, K, w_cap=128, v_cap=1024, batch=4, device="cpu").run(
        [(start, goal, md_f, md_r)]
    )
    assert dbg_bfs.dbg_bfs_reference.calls.value == calls + 1
    assert dbg_bfs.dbg_bfs.launches.value == launches
    want = jbfs.DeviceBFS(_jax_filter(bf), K, w_cap=128, v_cap=1024, batch=4).run(
        [(start, goal, md_f, md_r)]
    )
    assert got == [ref]
    assert got == want


def test_plain_batch_of_searches_matches_host():
    """Many searches in one call (grouped frontier rows), ragged depths,
    an inactive pad, and a non-power-of-two filter (full hash % bits)."""
    truth_b = _genome(30_000, 7)
    truth = truth_b.decode()
    bf = _filter(truth_b, K, 49_160)
    dbg = konnector.DBG(bf, K)
    searches = [(truth[o : o + K], truth[o + 70 : o + 70 + K], 3 + o % 17, 25 - o % 11)
                for o in range(100, 29_000, 1_900)]
    out = DeviceBFS(bf, K, batch=4, device="cpu").run(searches)
    for (s, g, mf, mr), pair in zip(searches, out):
        assert pair == (_ref_masks(dbg, s, mf, True), _ref_masks(dbg, g, mr, False))
    seeds = [torch.zeros(2, 2, dtype=torch.int64) for _ in range(3)]
    md = torch.tensor([[0, -1], [-1, -1]], dtype=torch.int32)
    vis, msk, n_vis, over = dbg_bfs.dbg_bfs(
        torch.from_numpy(bf.words_u32().view(np.int32).copy()), int(bf.bits), H, K,
        *seeds, md, 8, 16,
    )
    assert n_vis.tolist() == [[1, 0], [0, 0]] and not over.any()


def test_overflow_is_none_none():
    truth, _bf = _genome_bf()
    bf2 = bloom.BloomFilter(1 << 10, H, K)
    bf2.array[:] = 0xFF  # every extension exists: the frontier quadruples
    start, goal = truth[100 : 100 + K], truth[200 : 200 + K]
    out = DeviceBFS(bf2, K, w_cap=32, v_cap=128, batch=2, device="cpu").run(
        [(start, goal, 30, 30), (start, goal, 1, 0)]
    )
    assert out[0] == (None, None)
    assert out[1] == ({pack_kmer(start): 15, **{
        pack_kmer(start[1:] + b): 15 for b in "ACGT"}}, {pack_kmer(goal): 15})
    _jkon, _jbloom, jbfs = _jax()
    want = jbfs.DeviceBFS(_jax_filter(bf2), K, w_cap=32, v_cap=128, batch=2).run(
        [(start, goal, 30, 30), (start, goal, 1, 0)]
    )
    assert out == want


def test_all_t_32mer_is_logged():
    """At k = 32 the all-T k-mer packs to 2^64 - 1, the JAX kernel's pad
    value, so the JAX kernel never logs it (the host replay then misses and
    re-runs the gap natively).  The port's exact visited set keeps it."""
    k = 32
    truth = _genome(300, 11)
    seq = truth[:150] + b"T" * 40 + truth[150:]
    bf = _filter(seq, k, 1 << 14)
    start = seq[120 : 120 + k].decode()
    dbg = konnector.DBG(bf, k)
    want = _ref_masks(dbg, start, 60, True)
    assert (1 << 64) - 1 in want
    (got, _pred), = DeviceBFS(bf, k, device="cpu").run([(start, start, 60, 0)])
    assert got == want
    _jkon, _jbloom, jbfs = _jax()
    (jgot, _p), = jbfs.DeviceBFS(_jax_filter(bf), k).run([(start, start, 60, 0)])
    assert (1 << 64) - 1 not in jgot
    assert {v: m for v, m in got.items() if v != (1 << 64) - 1} == jgot


def _ref_levels(dbg, seed_kmer: str, max_depth: int, forward: bool):
    """Host BFS by levels, with no caps: ({packed k-mer: mask}, the frontier
    size of every level 0..max_depth that has a vertex)."""
    masks, sizes = {}, []
    seen = {seed_kmer}
    frontier = [seed_kmer]
    for level in range(max_depth + 1):
        if not frontier:
            break
        sizes.append(len(frontier))
        nxt = []
        for u in frontier:
            nbrs = dbg.successors(u) if forward else dbg.predecessors(u)
            masks[pack_kmer(u)] = sum(
                1 << "ACGT".index(v[-1] if forward else v[0]) for v in nbrs)
            if level < max_depth:
                for v in nbrs:
                    if v not in seen:
                        seen.add(v)
                        nxt.append(v)
        frontier = nxt
    return masks, sizes


def _expect_over(sizes, max_depth: int, W: int, V: int) -> bool:
    """dbg_bfs's overflow rule on an uncapped search's level sizes: more
    than V vertices logged, or a level that yields more than W new ones."""
    n_vis = 0
    for level, nf in enumerate(sizes):
        n_vis += nf
        if n_vis > V:
            return True
        if level < max_depth and level + 1 < len(sizes) and sizes[level + 1] > W:
            return True
    return False


# (W, V) -> searches of chip_smoke.mixed_bfs_batch that overflow
_MIXED_CAPS = {(32, 64): 4, (32, 2048): 3, (256, 2048): 2}


@pytest.mark.parametrize("k", [24, 32])
@pytest.mark.parametrize("caps", sorted(_MIXED_CAPS))
def test_plain_mixed_batch_matches_host(k, caps):
    """One call that mixes inactive directions, depth 0, thin searches, a
    frontier of 16 (two passes of 8 vertices, under W), frontiers over W,
    logs over V and an odd G, held against the uncapped host BFS: the
    overflow flags follow the rule, every other log is the host's."""
    W, V = caps
    bf, searches = chip_smoke.mixed_bfs_batch(k)
    assert len(searches) % 2 == 1
    dbg = konnector.DBG(bf, k)
    bfs = DeviceBFS(bf, k, device="cpu")
    vis, msk, n_vis, over = dbg_bfs.dbg_bfs(*bfs.inputs(searches), W, V)
    vis = u64.to_u64(vis)
    widest = 0
    for g, (start, goal, md_f, md_r) in enumerate(searches):
        for d, (seed, md) in enumerate(((start, md_f), (goal, md_r))):
            if md < 0:
                assert n_vis[g, d] == 0 and not over[g, d]
                continue
            masks, sizes = _ref_levels(dbg, seed, md, d == 0)
            assert bool(over[g, d]) == _expect_over(sizes, md, W, V), (g, d)
            if not over[g, d]:
                n = int(n_vis[g, d])
                assert dict(zip(vis[g, d, :n].tolist(), msk[g, d, :n].tolist())) == masks
                assert n == len(masks)
                widest = max(widest, *sizes)
    assert int(over.any(dim=1).sum()) == _MIXED_CAPS[caps]
    assert n_vis[2].tolist() == [1, 0]  # depth 0 beside an inactive direction
    assert widest >= 16  # a clean search wider than one pass of 8 vertices


def _gap_scenario(n=40_000, seed=9, n_gaps=6):
    truth = _genome(n, seed)
    bf = _filter(truth, K, 1 << 17)
    pairs = []
    for i in range(n_gaps):
        p = 2000 + i * 5000
        gap = 40 + 17 * i
        pairs.append((truth[p - 100 : p].decode(),
                      konnector.revcomp(truth[p + gap : p + gap + 100].decode())))
    return truth, bf, pairs


def test_mask_replay_equals_probing_search():
    jkon, _jbloom, _jbfs = _jax()
    _truth, bf, pairs = _gap_scenario()
    kw = dict(max_merged_seq_len=400, max_paths=10, max_branches=1000, max_cost=100_000)
    dbg = konnector.DBG(bf, K)
    params = konnector.ConnectPairsParams(**kw)
    want = konnector.connect_pairs_batch(dbg, pairs, params)
    got = konnector.connect_pairs_batch_masks(
        dbg, pairs, params, DeviceBFS(bf, K, batch=4, device="cpu")
    )
    jwant = jkon.connect_pairs_batch(jkon.DBG(_jax_filter(bf), K), pairs,
                                     jkon.ConnectPairsParams(**kw))
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in jwant]
    assert sum(1 for w in want if w.path_result == "FOUND_PATH") >= 4


@pytest.mark.parametrize("gap_chars", ["lower", "n"])
def test_seal_records_hybrid_cpu_equals_host(gap_chars):
    n = 12_000
    truth = _genome(n, 31)
    ks = [24, 20]
    bfs_by_k = {k: _filter(truth, k, 1 << 16) for k in ks}
    seq = bytearray(truth)
    for p in (2000, 6_500, 9_900):
        seq[p : p + 50] = truth[p : p + 50].lower() if gap_chars == "lower" else b"N" * 50
    records = [("ctg1 test", bytes(seq).decode()), ("ctg2", truth[:3000].decode())]
    cfg = sealer.SealerConfig(k_values=ks, max_gap_length=200)
    out_host, stats_host = sealer.seal_records(records, bfs_by_k, cfg)
    launches = dbg_bfs.dbg_bfs.launches.value
    calls = dbg_bfs.dbg_bfs_reference.calls.value
    out_dev, stats_dev = sealer.seal_records(
        records, bfs_by_k, cfg, backend="hybrid", device="cpu"
    )
    assert out_dev == out_host
    assert stats_dev == stats_host
    assert stats_host["gaps_closed"] == 3
    assert out_dev[0][1].upper() == truth.decode()
    assert dbg_bfs.dbg_bfs_reference.calls.value > calls
    assert dbg_bfs.dbg_bfs.launches.value == launches


def test_cuda_device_raises_without_cuda(monkeypatch):
    _truth, bf = _genome_bf()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceBFS(bf, K, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sealer.seal_records([("c", "ACGT" * 20 + "nnnn" + "ACGT" * 20)], {K: bf},
                            sealer.SealerConfig(k_values=[K]), backend="hybrid")
    with pytest.raises(ValueError):
        DeviceBFS(bf, 33, device="cpu")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    truth_b = _genome(200_000, 5)
    truth = truth_b.decode()
    for k, bf_bytes in ((24, 1 << 18), (32, 49_160)):
        bf = _filter(truth_b, k, bf_bytes)
        searches = [(truth[o : o + k], truth[o + 90 : o + 90 + k], 40 + o % 50, 60)
                    for o in range(0, 190_000, 1_500)]
        for W in (32, 256):
            cpu = DeviceBFS(bf, k, w_cap=W, w_cap2=W, device="cpu")._run_tier(searches, W)
            launches = dbg_bfs.dbg_bfs.launches.value
            gpu = DeviceBFS(bf, k, w_cap=W, w_cap2=W, device="cuda")._run_tier(searches, W)
            torch.cuda.synchronize()
            assert dbg_bfs.dbg_bfs.launches.value == launches + 1
            assert gpu == cpu
    words = torch.from_numpy(bf.words_u32().view(np.int32).copy())
    seeds = u64.from_u64(np.full((2, 2), (1 << 64) - 1, np.uint64))
    md = torch.tensor([[5, 5], [0, -1]], dtype=torch.int32)
    want = dbg_bfs.dbg_bfs_reference(words, int(bf.bits), H, 32, seeds, seeds, seeds, md, 32, 64)
    got = dbg_bfs.dbg_bfs(words.cuda(), int(bf.bits), H, 32, seeds.cuda(), seeds.cuda(),
                          seeds.cuda(), md.cuda(), 32, 64)
    assert torch.equal(got[2].cpu(), want[2]) and torch.equal(got[3].cpu(), want[3])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [24, 32])
@pytest.mark.parametrize("caps", sorted(_MIXED_CAPS))
def test_cuda_kernel_matches_plain_mixed_batch(k, caps):
    """The twin of test_plain_mixed_batch_matches_host on the card: the
    kernel's logs, counts and overflow flags equal the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    W, V = caps
    bf, searches = chip_smoke.mixed_bfs_batch(k)
    want = dbg_bfs.dbg_bfs_reference(*DeviceBFS(bf, k, device="cpu").inputs(searches), W, V)
    launches = dbg_bfs.dbg_bfs.launches.value
    got = dbg_bfs.dbg_bfs(*DeviceBFS(bf, k, device="cuda").inputs(searches), W, V)
    torch.cuda.synchronize()
    assert dbg_bfs.dbg_bfs.launches.value == launches + 1
    assert chip_smoke.bfs_err(chip_smoke.canonical_bfs(got),
                              chip_smoke.canonical_bfs(want)) == 0
    assert int(want[3].any(dim=1).sum()) == _MIXED_CAPS[caps]
