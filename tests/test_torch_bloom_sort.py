"""The port's sort-based device fill (ops/bloom_sort, kernel 5) against the
JAX package's device_fill_bfs_sorted, on the CPU.

Every case feeds both the same seeded reads and thresholds and requires the
filter bytes equal (tolerance 0: integer hashing, counting and bit sets),
for the single dispatch and the chunked two-phase build: the cases of
tests/test_bloom_sort.py.  Streams stay under one JAX row bucket (16 kbp)
where the case allows, so the JAX programs compile once per k.  The `cuda`
cases hold kernel 5 against the plain version on the card and skip here."""

import numpy as np
import pytest
import torch

from goldpolish_tpu.ops import bloom_sort as jbs
from goldpolish_tpu_torch import native
from goldpolish_tpu_torch.ops import bloom
from goldpolish_tpu_torch.ops import nthash as nt
from goldpolish_tpu_torch.ops import bloom_sort as tbs

H = 4
CBF_BYTES = 1 << 20
BF_BYTES = 1 << 17
SINGLE = 1 << 40


def _genome(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes()


def _reads_cov(truth: bytes, cov: int, frag: int = 1500):
    reads = []
    for rep in range(cov):
        off = rep * (frag // max(cov, 1))
        reads.append(truth[: frag + 32])
        for s in range(off, len(truth), frag):
            reads.append(truth[s : s + frag + 32])
    return reads


def _both(reads, thrs, ks, chunk_bases=SINGLE):
    """(JAX filters, port plain filters), asserting them byte-equal."""
    want = jbs.device_fill_bfs_sorted(reads, thrs, ks, H, CBF_BYTES, BF_BYTES,
                                      chunk_bases=chunk_bases)
    got = tbs.device_fill_bfs_sorted(reads, thrs, ks, H, CBF_BYTES, BF_BYTES,
                                     chunk_bases=chunk_bases, device="cpu")
    for k, w, g in zip(ks, want, got):
        assert (g.bytes, g.hash_num, g.k) == (w.bytes, w.hash_num, w.k)
        assert bytes(g.array) == bytes(w.array), (k, chunk_bases)
    return want, got


def _host_fill(reads, thrs, ks):
    cbfs = [bloom.CountingBloomFilter8(CBF_BYTES, H, k) for k in ks]
    bfs = [bloom.BloomFilter(BF_BYTES, H, k) for k in ks]
    native.fill_bfs_stream(reads, thrs, H, ks, cbfs, bfs)
    return bfs


@pytest.mark.parametrize("chunk_bases", [SINGLE, 4096])
def test_equals_jax_single_and_chunked(chunk_bases):
    """tests/test_bloom_sort.py::test_sorted_chunked_equals_single_dispatch:
    both builds equal the JAX build and each other."""
    reads = _reads_cov(_genome(11, 9000), 5)
    thrs = [5] * len(reads)
    _want, got = _both(reads, thrs, [32, 28], chunk_bases)
    single = tbs.device_fill_bfs_sorted(reads, thrs, [32, 28], H, CBF_BYTES,
                                        BF_BYTES, chunk_bases=SINGLE, device="cpu")
    for a, b in zip(got, single):
        assert bytes(a.array) == bytes(b.array)
        assert a.pop_count > 0


def test_superset_of_host_fill():
    reads = _reads_cov(_genome(1, 9000), 6)
    thrs = [5] * len(reads)
    _want, got = _both(reads, thrs, [32, 28])
    for d, hh in zip(got, _host_fill(reads, thrs, [32, 28])):
        assert np.all((hh.array & ~d.array) == 0)
        extra = np.unpackbits(d.array & ~hh.array).sum()
        assert extra / max(1, np.unpackbits(hh.array).sum()) < 0.05


@pytest.mark.parametrize("chunk_bases", [SINGLE, 3000])
def test_mixed_thresholds_smallest_wins(chunk_bases):
    """Reads of thresholds 4 and 9 over shared k-mers, within one chunk and
    across chunks: a k-mer promotes at its smallest threshold."""
    truth = _genome(12, 8000)
    reads_lo = _reads_cov(truth[:5000], 4)
    reads_hi = _reads_cov(truth[2500:], 8)
    reads = reads_lo + reads_hi
    thrs = [4] * len(reads_lo) + [9] * len(reads_hi)
    _both(reads, thrs, [32, 28], chunk_bases)


def test_empty_read_does_not_raise_next_threshold():
    reads_real = _reads_cov(_genome(7, 6000), 6)
    _both([b""] + reads_real, [13] + [5] * len(reads_real), [32])
    _both([b""] + reads_real, [13] + [5] * len(reads_real), [32], 4096)


def test_full_alphabet():
    """Lowercase, N and IUPAC bytes hash alike in both builds (reads hold no
    control bytes, where kernel 2's tables and the JAX one-hot differ)."""
    tl = bytearray(_genome(6, 9000))
    for p in range(50, 8900, 137):
        tl[p] = ord("acgtNRYn"[p % 8])
    t2 = bytes(tl)
    reads = [t2[s : s + 1500 + 32] for s in range(0, 7500, 300)]
    _both(reads, [4] * len(reads), [32, 28])


@pytest.mark.parametrize("thr", [1, 2])
def test_low_threshold_clamp(thr):
    """Thresholds 1 and 2 push k = 32's effective threshold to <= 0, which
    clamps to 1; mixed with threshold 9 the smallest still wins."""
    reads = _reads_cov(_genome(13, 6000), 3)
    _want, got = _both(reads, [thr] * len(reads), [32, 28])
    assert got[0].pop_count > 0
    _both(reads, [thr] * 3 + [9] * (len(reads) - 3), [32])


@pytest.mark.parametrize("seed", range(4))
def test_randomized_soak(seed):
    """Mixed lengths (empty and shorter than k among them), mixed
    thresholds, shared and unique content."""
    rng = np.random.default_rng(100 + seed)
    base = _genome(200 + seed, 4000)
    reads, thrs = [], []
    for _ in range(int(rng.integers(5, 25))):
        if rng.random() < 0.15:
            r = _genome(int(rng.integers(1 << 30)), int(rng.integers(0, 900)))
        else:
            a = int(rng.integers(0, 3500))
            r = base[a : a + int(rng.integers(10, 1200))]
        reads.append(r)
        thrs.append(int(rng.integers(4, 14)))
    ks = [32, 28][: 1 + seed % 2]
    _both(reads, thrs, ks)
    _both(reads, thrs, ks, 2000)


def test_edge_cases():
    # k == KHALO + 1, the largest supported k
    reads = _reads_cov(_genome(4, 5000), 5)
    _want, got = _both(reads, [4] * len(reads), [33])
    assert got[0].pop_count > 0
    # reads shorter than k, and no reads at all, give empty filters
    _want, got = _both([b"ACGTACGT"], [4], [32])
    assert got[0].pop_count == 0
    _want, got = _both([], [], [32])
    assert got[0].pop_count == 0
    with pytest.raises(ValueError, match="k <= 33"):
        tbs.device_fill_bfs_sorted([b"A" * 100], [4], [40], H, CBF_BYTES, BF_BYTES,
                                   device="cpu")


def test_stream_checks():
    with pytest.raises(ValueError, match="1..15"):
        tbs.device_fill_bfs_sorted([b"A" * 100], [16], [32], H, CBF_BYTES, BF_BYTES,
                                   device="cpu")
    with pytest.raises(ValueError, match="1..15"):
        tbs.device_fill_bfs_sorted([b"A" * 100], [0], [32], H, CBF_BYTES, BF_BYTES,
                                   device="cpu")
    big = b"A" * (1 << 20)  # one object, 2048 references: 2^31 bases
    with pytest.raises(ValueError, match="2\\^31"):
        tbs.device_fill_bfs_sorted([big] * 2048, [4] * 2048, [32], H, CBF_BYTES,
                                   BF_BYTES, device="cpu")
    assert tbs.KHALO == jbs.KHALO and tbs.MAX_THR == jbs.MAX_THR
    assert tbs.DEFAULT_CHUNK_BASES == jbs.DEFAULT_CHUNK_BASES


def test_chunk_env_override(monkeypatch):
    """GPTPU_SORT_CHUNK_BASES sets the default chunk: the chunked path runs
    (pass A over several groups, then pass B over each) and gives the same
    bits."""
    reads = _reads_cov(_genome(11, 9000), 5)
    thrs = [5] * len(reads)
    single = tbs.device_fill_bfs_sorted(reads, thrs, [32], H, CBF_BYTES, BF_BYTES,
                                        device="cpu")
    monkeypatch.setenv("GPTPU_SORT_CHUNK_BASES", "4096")
    counts = tbs.count_reference.calls.value
    promotes = tbs.promote_reference.calls.value
    chunked = tbs.device_fill_bfs_sorted(reads, thrs, [32], H, CBF_BYTES, BF_BYTES,
                                         device="cpu")
    assert bytes(single[0].array) == bytes(chunked[0].array)
    groups = len(tbs._groups(reads, thrs, 4096))
    assert groups > 2
    assert tbs.count_reference.calls.value - counts == groups
    assert tbs.promote_reference.calls.value - promotes == groups


def test_slot_collisions_count_twice():
    """Two of a window's h hashes on one slot add 2 there, as the JAX
    repeat(cnt, h) scatter does: with one slot, one window counts h; with a
    3-slot counting filter every 4-hash k-mer has a collision, and the
    promotion (thresholds near the totals) equals the JAX build's."""
    totals = torch.zeros(1, dtype=torch.int32)
    tbs.count_hashes_reference(torch.tensor([123456789], dtype=torch.int64), 32, H, 1,
                               totals)
    assert totals.tolist() == [H]
    truth = _genome(21, 400)
    reads = [truth[a : a + 40] for a in range(0, 360, 40)]
    for thr in (6, 12, 15):
        want = jbs.device_fill_bfs_sorted(reads, [thr] * len(reads), [32, 28], H, 3,
                                          BF_BYTES, chunk_bases=SINGLE)
        got = tbs.device_fill_bfs_sorted(reads, [thr] * len(reads), [32, 28], H, 3,
                                         BF_BYTES, chunk_bases=SINGLE, device="cpu")
        for w, g in zip(want, got):
            assert bytes(g.array) == bytes(w.array), thr


@pytest.mark.parametrize("chunk_bases", [SINGLE, 1400])
def test_three_thresholds_across_chunks(chunk_bases):
    """One k-mer seen three times, in reads of thresholds 9, 5 and 12 (at
    k = 32: 7, 3 and 10), the last in another chunk: it promotes at the
    smallest, and not once the 5 is a 6; the reads' own k-mers never do."""
    shared = _genome(22, 60)
    pads = [_genome(23 + i, 600) for i in range(3)]
    reads = [pads[0] + shared, shared + pads[1], pads[2] + shared]
    assert len(tbs._groups(reads, [9, 5, 12], 1400)) == 2
    for thrs, promoted in (([9, 5, 12], True), ([9, 6, 12], False)):
        _want, got = _both(reads, thrs, [32], chunk_bases)
        bf = got[0]
        hs = nt.multi_hashes(nt.canonical_hashes(np.frombuffer(shared, np.uint8), 32),
                             32, H)
        assert bf.contains(hs).all() == promoted
        assert not bf.contains(nt.multi_hashes(
            nt.canonical_hashes(np.frombuffer(pads[1], np.uint8), 32), 32, H)).any()


def test_hash_all_ones_counts_once():
    """A valid window whose canonical hash is 2^64 - 1 counts once at each
    of its slots and promotes like any other; pads are never counted (the
    JAX run of that hash would also count every pad of its row grid, a
    reference fault not copied: ROADMAP queue 3)."""
    ones = torch.tensor([-1], dtype=torch.int64)  # 2^64 - 1 as int64
    slots = tbs.u64.umod(torch.stack(tbs._hashes(ones, 32, H))[:, 0], 97)
    totals = torch.zeros(97, dtype=torch.int32)
    tbs.count_hashes_reference(ones, 32, H, 97, totals)
    want = torch.zeros(97, dtype=torch.int32)
    want.index_add_(0, slots, torch.ones(H, dtype=torch.int32))
    assert torch.equal(totals, want)
    words = torch.zeros(BF_BYTES // 4, dtype=torch.int32)
    for thr, n_set in ((2, 0), (1, 1)):
        tbs.promote_hashes_reference(ones, torch.tensor([thr], dtype=torch.int32), 32,
                                     H, 97, totals, BF_BYTES * 8, words)
        assert (int(np.unpackbits(words.numpy().view(np.uint8)).sum()) > 0) == n_set


def test_window_keys_reference_marks_read_ends():
    """Windows that cross into the next read or past the end are not valid;
    a window's threshold is its read's plus delta, clamped to 1."""
    codes = torch.frombuffer(bytearray(b"ACGTACGTAC" + b"GGTTCCA"), dtype=torch.uint8)
    offsets = torch.tensor([0, 10, 17], dtype=torch.int64)
    thrs = torch.tensor([3, 9], dtype=torch.uint8)
    base, thr = tbs.valid_windows_reference(codes, offsets, thrs, 4, -2)
    valid = [p for p in range(17) if (p + 4 <= 10) or (10 <= p and p + 4 <= 17)]
    fh, rh = tbs.strand_hashes_reference(codes[None, :], 4)
    assert base.tolist() == (fh + rh)[0][valid].tolist()
    assert thr.tolist() == [1 if p < 10 else 7 for p in valid]


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the no-CUDA refusal cannot show")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbs.device_fill_bfs_sorted([b"ACGT" * 20], [4], [32], H, CBF_BYTES,
                                   BF_BYTES, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_bases", [SINGLE, 4096])
def test_cuda_kernel_matches_plain(chunk_bases):
    """Kernel 5 equals the plain version on the card, single and chunked,
    with a non-power-of-two filter beside the power-of-two one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    truth = _genome(12, 8000)
    reads = _reads_cov(truth[:5000], 4) + _reads_cov(truth[2500:], 8)
    thrs = [4] * 18 + [9] * (len(reads) - 18)
    ks = [32, 28, 24, 20]
    for bf_bytes in (BF_BYTES, 49160):
        before = [f.launches.value for f in tbs.KERNEL_OPS]
        got = tbs.device_fill_bfs_sorted(reads, thrs, ks, H, CBF_BYTES + 12, bf_bytes,
                                         chunk_bases=chunk_bases, device="cuda")
        assert all(f.launches.value > b for f, b in zip(tbs.KERNEL_OPS, before))
        want = tbs.device_fill_bfs_sorted_reference(
            reads, thrs, ks, H, CBF_BYTES + 12, bf_bytes, chunk_bases=chunk_bases)
        for g, w in zip(got, want):
            assert bytes(g.array) == bytes(w.array)
            assert g.pop_count > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_cuda_kernel_matches_plain_soak(seed):
    """Kernel 5 against the plain version on the card: mixed read lengths
    (empty and shorter than k among them), mixed thresholds, k = 33 and 20,
    h = 3, a non-power-of-two filter, single and chunked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    rng = np.random.default_rng(300 + seed)
    base = _genome(400 + seed, 6000)
    reads, thrs = [], []
    for _ in range(60):
        a = int(rng.integers(0, 5500))
        reads.append(base[a : a + int(rng.integers(0, 1500))])
        thrs.append(int(rng.integers(1, 16)))
    for chunk_bases in (SINGLE, 2000):
        args = (reads, thrs, [33, 20], 3, CBF_BYTES + 12, 49160)
        got = tbs.device_fill_bfs_sorted(*args, chunk_bases=chunk_bases, device="cuda")
        want = tbs.device_fill_bfs_sorted_reference(*args, chunk_bases=chunk_bases)
        for g, w in zip(got, want):
            assert bytes(g.array) == bytes(w.array)
            assert g.pop_count > 0
