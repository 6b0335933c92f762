"""The sealer's native search round (fill/konnector._native_round, native
gp_konnect_pairs) against the port's Python search, its plain version, on
the CPU.

Each case builds a seeded filter and flank pairs that drive the search to
one outcome, at k = 20, 24, 28 and 32, and runs connect_pairs_batch twice:
as it stands (the native round takes the pairs) and with _native_round
disabled (every pair through _prepare_search, _BidiSearch and
_finish_search).  Every SearchResult field must be equal: the result, cost,
nodes visited, peak branches, anchor positions, merged sequences in path
order and the consensus.  The fallbacks (k = 47, fix_errors) are held to
the JAX package's results, seal_records to its forced-Python bytes, and two
threads sealing at once to a serial run."""

import dataclasses
import threading

import numpy as np
import pytest

from goldpolish_tpu_torch.fill import konnector, sealer
from goldpolish_tpu_torch.ops import bloom
from goldpolish_tpu_torch.ops import nthash as nt

H = 4
KS = (20, 24, 28, 32)
NO_LIMIT = konnector.NO_LIMIT


def _genome(rng, n: int) -> str:
    return "".join(rng.choice(list("ACGT"), n))


def _bf(seqs, k: int, size: int) -> bloom.BloomFilter:
    bf = bloom.BloomFilter(size, H, k)
    for s in seqs:
        if len(s) >= k:
            bf.insert(nt.multi_hashes(nt.canonical_hashes(nt.encode(s), k), k, H))
    return bf


def _snp(g: str, positions) -> str:
    s = list(g)
    for p in positions:
        s[p] = "ACGT"[("ACGT".index(s[p]) + 1) % 4]
    return "".join(s)


def _pair(g: str, a: int, gap: int, flank: int = 40) -> tuple[str, str]:
    """Flanks around g[a + flank : a + flank + gap], the right one
    reverse-complemented, as the sealer passes them."""
    b = a + flank + gap
    return g[a : a + flank], konnector.revcomp(g[b : b + flank])


def _case(name: str, k: int):
    """(filter, pairs, params, check of the Python results, pairs the
    native round should take)."""
    rng = np.random.default_rng([KS.index(k), len(name), sum(map(ord, name))])
    g = _genome(rng, 2400)
    a, gap = 200, 150
    params = konnector.ConnectPairsParams(max_paths=10, max_branches=1000,
                                          max_cost=100000, mem_limit=500 << 20)
    sparse = 1 << 17
    pairs = [_pair(g, a, gap)]

    def found(n_paths):
        return lambda rs: all(r.path_result == "FOUND_PATH"
                              and len(r.merged_seqs) == n_paths for r in rs)

    def result(code, anchored=True):
        return lambda rs: all(r.path_result == code and r.found_start == anchored
                              for r in rs)

    if name == "one_path":
        return _bf([g], k, sparse), pairs, params, found(1), 1
    if name == "several_paths":
        alt = _snp(g, [a + 40 + gap // 2])
        return _bf([g, alt], k, sparse), pairs, params, found(2), 1
    if name == "no_path":
        cut = a + 40 + gap // 2
        return (_bf([g[:cut], g[cut + 1 :]], k, sparse), pairs, params,
                result("NO_PATH"), 1)
    if name == "too_many_paths":
        gap = 320
        alt = _snp(g, range(a + 40 + 10, a + 40 + gap - 10, k + 8))
        params.max_paths = 2
        return (_bf([g, alt], k, sparse), [_pair(g, a, gap)], params,
                result("TOO_MANY_PATHS"), 1)
    if name == "too_many_branches":
        params.max_branches = 8
        return _bf([g], k, 1 << 9), pairs, params, result("TOO_MANY_BRANCHES"), 1
    if name == "cost_exceeded":
        params.max_cost = 12
        return _bf([g], k, sparse), pairs, params, result("MAX_COST_EXCEEDED"), 1
    if name == "mem_exceeded":
        params.max_branches = NO_LIMIT
        params.mem_limit = 4000
        return (_bf([g], k, 1 << 9), pairs, params, result("EXCEEDED_MEM_LIMIT"), 1)
    if name == "identical_anchors":
        read1 = g[a : a + k + 4]
        return (_bf([g], k, sparse), [(read1, konnector.revcomp(read1))], params,
                lambda rs: found(1)(rs) and rs[0].cost == 0, 1)
    if name == "no_anchor":
        return _bf([], k, sparse), pairs, params, result("NO_PATH", False), 1
    if name == "dirty_flanks":
        # N, IUPAC and lower-case bytes away from the anchors (native), and
        # a flank whose best run ends at an N: its anchor window holds the
        # N, does not pack, and goes to the Python search
        left, right = _pair(g, a - 30, gap + 30, flank=70)
        dirty = (left[:3] + "N" + left[4:9] + "R" + left[10:], right[:2] + "Yc" + right[4:])
        stray = _genome(rng, k)
        fallback = (stray + "N" + g[a + 40 - (k + 1) : a + 40], right)
        return (_bf([g], k, sparse), [dirty, fallback], params,
                lambda rs: found(1)(rs[:1]) and not rs[1].start_kmer_pos < 0, 1)
    if name == "preserve_reads":
        params.preserve_reads = True
        left, right = pairs[0]
        # a missing window near the left flank's end: its end-anchored scan
        # stops there
        broken = (left[:-3] + _snp(left[-3:], [0]), right)
        return (_bf([g], k, sparse), [pairs[0], broken], params,
                lambda rs: found(1)(rs[:1]) and rs[1].path_result != "FOUND_PATH", 2)
    raise AssertionError(name)


CASES = ("one_path", "several_paths", "no_path", "too_many_paths",
         "too_many_branches", "cost_exceeded", "mem_exceeded",
         "identical_anchors", "no_anchor", "dirty_flanks", "preserve_reads")


def _python(monkeypatch, fn, *args, **kw):
    with monkeypatch.context() as m:
        m.setattr(konnector, "_native_round", lambda *a: None)
        return fn(*args, **kw)


def _fields(results):
    return [dataclasses.asdict(r) for r in results]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", CASES)
def test_native_round_matches_python_search(case, k, monkeypatch):
    bf, pairs, params, check, n_native = _case(case, k)
    dbg = konnector.DBG(bf, k)
    tally = {}
    got = konnector.connect_pairs_batch(dbg, pairs, params, tally=tally)
    want = _python(monkeypatch, konnector.connect_pairs_batch, dbg, pairs, params)
    assert check(want), _fields(want)
    assert _fields(got) == _fields(want)
    assert tally == {"native": n_native}
    # the serial connect_pairs takes the same native round
    assert _fields([konnector.connect_pairs(dbg, *p, params) for p in pairs]) == _fields(want)


def test_native_round_grows_its_path_buffers(monkeypatch):
    """Pairs whose paths overflow the first output buffers (64 KiB of
    sequence, 1024 paths): the round resumes at the pair that did not fit,
    and nothing is lost."""
    rng = np.random.default_rng(7)
    g = _genome(rng, 3000)
    dbg = konnector.DBG(_bf([g], 32, 1 << 17), 32)
    params = konnector.ConnectPairsParams(max_merged_seq_len=1200, max_paths=10,
                                          max_branches=1000, max_cost=100000)
    # long gaps overflow the sequence buffer; identical-anchor pairs (one
    # k-mer path each, no search) the path count
    pairs = [_pair(g, a, 900) for a in range(100, 1900, 20)]
    pairs += [(g[a : a + 36], konnector.revcomp(g[a : a + 36])) for a in range(1100)]
    got = konnector.connect_pairs_batch(dbg, pairs, params)
    want = _python(monkeypatch, konnector.connect_pairs_batch, dbg, pairs, params)
    assert sum(len(r.merged_seqs) for r in want) > 1024
    assert sum(len(r.merged_seqs[0]) for r in want[:90] if r.merged_seqs) > 1 << 16
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("case", ["k47", "fix_errors"])
def test_fallbacks_run_the_python_search(case):
    """k > 32 and fix_errors leave every pair to the Python search, with
    the JAX package's results."""
    from goldpolish_tpu.fill import konnector as jkon
    from goldpolish_tpu.ops import bloom as jbloom

    k = 47 if case == "k47" else 32
    rng = np.random.default_rng(47)
    g = _genome(rng, 2400)
    bf = _bf([g], k, 1 << 17)
    jbf = jbloom.BloomFilter(1 << 17, H, k)
    jbf.array[:] = bf.array
    left, right = _pair(g, 200, 150, flank=60)
    # the second left flank has no window of the graph: fix_errors corrects it
    pairs = [(left, right), (_snp(left, [30]), right)]
    params = konnector.ConnectPairsParams(max_paths=10, max_branches=1000,
                                          max_cost=100000,
                                          fix_errors=case == "fix_errors")
    jparams = jkon.ConnectPairsParams(**dataclasses.asdict(params))
    tally = {}
    got = konnector.connect_pairs_batch(konnector.DBG(bf, k), pairs, params, tally=tally)
    want = jkon.connect_pairs_batch(jkon.DBG(jbf, k), pairs, jparams)
    assert tally == {"native": 0}
    assert got[0].path_result == "FOUND_PATH"
    assert _fields(got) == _fields(want)


def _draft_and_filters(seed: int):
    """A small gpbench draft (n gaps and errors), soft-masked as bulk
    masks it, and filters at k = 32, 28, 24, 20 filled from its reads."""
    from gpbench import generate
    from goldpolish_tpu_torch import native
    from goldpolish_tpu_torch.polish import mask

    traffic = {"contigs": 2,
               "draft": {"error_every_bp": 700, "gap_every_bp": 6000, "gap_len": 60},
               "reads": {"coverage": 20, "error_rate": 0.01, "mix": [0.4, 0.3, 0.3],
                         "n50_bp": 4000, "sigma": 0.5, "min_bp": 1000, "max_bp": 9000}}
    rng = np.random.default_rng(seed)
    truths = generate.make_genome(rng, 60000, traffic["contigs"])
    drafts = [(n, generate.make_draft(rng, t, traffic).decode()) for n, t in truths]
    reads, _paf = generate.make_reads(rng, truths, traffic)
    ks = list(KS[::-1])
    cbfs = [bloom.CountingBloomFilter8(1 << 20, H, k) for k in ks]
    bfs = [bloom.BloomFilter(1 << 17, H, k) for k in ks]
    native.fill_bfs_stream([s for _n, s in reads], [4] * len(reads), H, ks, cbfs, bfs)
    records = [(n, mask.mask_short_runs(s, ks[0], soft=True)) for n, s in drafts]
    return records, dict(zip(ks, bfs))


def test_seal_records_native_equals_python(monkeypatch):
    """seal_records' bytes and counters with the native round equal those
    of the forced Python search; every search is native at k <= 32."""
    records, bfs = _draft_and_filters(2400000024)
    cfg = sealer.SealerConfig()
    tally = {}
    got = sealer.seal_records(records, bfs, cfg, tally=tally)
    want_tally = {}
    want = _python(monkeypatch, sealer.seal_records, records, bfs, cfg, tally=want_tally)
    assert got == want
    assert got[1]["gaps_closed"] > 0
    assert tally["native"] == tally["searches"] == want_tally["searches"] > 0
    assert want_tally["native"] == 0


def test_two_threads_seal_at_once_as_serially():
    """Two batches sealed on two threads at once (their native rounds
    overlap outside the interpreter lock) give a serial run's bytes."""
    batches = [_draft_and_filters(seed) for seed in (2400000031, 2400000032)]
    cfg = sealer.SealerConfig()
    serial = [sealer.seal_records(r, b, cfg) for r, b in batches]
    for _round in range(3):
        got = [None, None]
        start = threading.Barrier(2)

        def run(i):
            start.wait()
            got[i] = sealer.seal_records(*batches[i], cfg)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert got == serial
