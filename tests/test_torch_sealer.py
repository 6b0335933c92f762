"""The port's host sealer (fill/{nw,konnector,extend,sealer}, polish/reports)
against the JAX package's, on the CPU.

The cases of tests/test_sealer.py, tests/test_extend.py and the sealer
trace of tests/test_reports.py, each run through both packages on the same
input (filters built once with numpy and handed to both): results,
counters and SearchResult fields must be equal, and the reference
expectations of the original cases still hold on the port."""

import dataclasses

import numpy as np
import pytest

from goldpolish_tpu.fill import extend as jext
from goldpolish_tpu.fill import konnector as jkon
from goldpolish_tpu.fill import nw as jnw
from goldpolish_tpu.fill import sealer as jsl
from goldpolish_tpu.ops import bloom as jbloom
from goldpolish_tpu.ops import nthash as jnt
from goldpolish_tpu.polish import reports as jreports
from goldpolish_tpu_torch.fill import extend, konnector, nw, sealer
from goldpolish_tpu_torch.ops import bloom
from goldpolish_tpu_torch.polish import reports

K, H = 32, 4


def _genome(rng, n):
    return "".join(rng.choice(list("ACGT")) for _ in range(n))


def _bfs(truth: str, k=K, bytes_size=1 << 17, h=H):
    """(JAX BloomFilter, port BloomFilter) holding the same bits."""
    jbf = jbloom.BloomFilter(bytes_size, h, k)
    if truth:
        base = jnt.canonical_hashes(jnt.encode(truth), k)
        jbf.insert(jnt.multi_hashes(base, k, h))
    bf = bloom.BloomFilter(bytes_size, h, k)
    bf.array[:] = jbf.array
    return jbf, bf


def _fields(res) -> dict:
    return dataclasses.asdict(res)


# --- NW alignment ------------------------------------------------------------
@pytest.mark.parametrize("pair", [
    ("ACGTACGT", "ACGTACGT"), ("ACGA", "ACGT"), ("ACGTTT", "ACTTT"),
    ("ACGTNACGTRY", "ACGTAACCTGC"), ("acgtACGT", "ACGTACGTT"),
])
def test_nw_align_global_matches_jax(pair):
    got = nw.align_global(*pair)
    assert got == jnw.align_global(*pair)
    m, aln = got
    assert len(aln["query_align"]) == len(aln["target_align"])
    if pair == ("ACGA", "ACGT"):
        assert aln["match_align"] == "ACGW" and m == 3  # A|T -> W


@pytest.mark.parametrize("n_seqs", [2, 3, 4])
def test_nw_align_multi_matches_jax(n_seqs):
    rng = np.random.default_rng(n_seqs)
    base = _genome(rng, 40)
    seqs = [base]
    for i in range(1, n_seqs):
        s = list(base)
        s[5 + 7 * i] = "ACGT"[("ACGT".index(s[5 + 7 * i]) + i) % 4]
        if i % 2:
            del s[20]
        seqs.append("".join(s))
    got = nw.align_multi(seqs)
    assert got == jnw.align_multi(seqs)
    if n_seqs > 2:
        assert got[0] == 0  # reference quirk: min-from-zero for 3+ seqs


# --- Konnector primitives ----------------------------------------------------
@pytest.mark.parametrize("case", ["present", "empty_filter", "anchor_to_end", "dirty"])
def test_get_start_kmer_pos_matches_jax(case):
    rng = np.random.default_rng(0)
    truth = _genome(rng, 300)
    jbf, bf = _bfs("" if case == "empty_filter" else truth)
    flank = truth[100:200]
    if case == "anchor_to_end":
        flank = flank[:60] + _genome(rng, 40)
    if case == "dirty":
        flank = flank[:50] + "N" + flank[51:80].lower() + flank[80:]
    end = case == "anchor_to_end"
    got = konnector.get_start_kmer_pos(konnector.DBG(bf, K), flank, 3, end)
    assert got == jkon.get_start_kmer_pos(jkon.DBG(jbf, K), flank, 3, end)
    if case == "present":
        assert got == len(flank) - K - 2  # the 3rd hit from the gap side
    if case in ("empty_filter", "anchor_to_end"):
        assert got == konnector.NO_MATCH


@pytest.mark.parametrize("case", ["mid_error", "clean", "short"])
def test_correct_single_base_error_matches_jax(case):
    k, h = 16, 3
    rng = np.random.default_rng(4)
    truth = "".join(rng.choice(list("ACGT"), 300))
    jbf, bf = _bfs(truth, k=k, bytes_size=1 << 14, h=h)
    read = truth[:28]
    if case == "mid_error":
        read = read[:14] + ("A" if read[14] != "A" else "C") + read[15:]
    if case == "short":
        read = read[:10]
    got = konnector.correct_single_base_error(konnector.DBG(bf, k), read)
    assert got == jkon.correct_single_base_error(jkon.DBG(jbf, k), read)
    if case == "mid_error":
        assert got[0] and got[1] == truth[:28]


def _fix_preserve_case(case):
    k, h = 16, 3
    rng = np.random.default_rng(4)
    truth = "".join(rng.choice(list("ACGT"), 300))
    jbf, bf = _bfs(truth, k=k, bytes_size=1 << 14, h=h)
    left = truth[:28]
    right = konnector.revcomp(truth[240:])
    bad = left[:14] + ("A" if left[14] != "A" else "C") + left[15:]
    kw = dict(max_merged_seq_len=400, max_paths=2, max_branches=200, max_cost=50000)
    read1 = left
    if case == "bad_anchor":
        read1 = bad
    elif case == "fix_errors":
        read1 = bad
        kw["fix_errors"] = True
    elif case == "preserve_reads":
        kw["preserve_reads"] = True
    return truth, jbf, bf, k, read1, right, kw


def _saturated_case(case):
    k = 16
    rng = np.random.default_rng(0)
    jbf = jbloom.BloomFilter(1 << 10, 2, k)
    jbf.array[:] = 0xFF  # every probe hits -> maximal branching
    bf = bloom.BloomFilter(1 << 10, 2, k)
    bf.array[:] = 0xFF
    left = "".join(rng.choice(list("ACGT"), 40))
    right = "".join(rng.choice(list("ACGT"), 40))
    if case == "mem_limit_tiny":
        kw = dict(max_merged_seq_len=300, max_paths=1000000,
                  max_branches=1000000, max_cost=10_000_000, mem_limit=50_000)
    else:
        kw = dict(max_merged_seq_len=300, max_paths=2, max_branches=100,
                  max_cost=100000, mem_limit=500 * 1024 * 1024)
    return None, jbf, bf, k, left, right, kw


def _bridge_case(_case):
    rng = np.random.default_rng(2)
    truth = _genome(rng, 500)
    jbf, bf = _bfs(truth)
    kw = dict(max_merged_seq_len=800 + 2 * 32, max_paths=10,
              max_branches=1000, max_cost=100000)
    return truth, jbf, bf, K, truth[140:200], konnector.revcomp(truth[250:310]), kw


@pytest.mark.parametrize("case", [
    "bridges_gap", "mem_limit_tiny", "mem_limit_default", "bad_anchor",
    "fix_errors", "preserve_reads",
])
def test_connect_pairs_matches_jax(case):
    if case == "bridges_gap":
        truth, jbf, bf, k, r1, r2, kw = _bridge_case(case)
    elif case.startswith("mem_limit"):
        truth, jbf, bf, k, r1, r2, kw = _saturated_case(case)
    else:
        truth, jbf, bf, k, r1, r2, kw = _fix_preserve_case(case)
    got = konnector.connect_pairs(konnector.DBG(bf, k), r1, r2,
                                  konnector.ConnectPairsParams(**kw))
    want = jkon.connect_pairs(jkon.DBG(jbf, k), r1, r2, jkon.ConnectPairsParams(**kw))
    assert _fields(got) == _fields(want)
    if case == "bridges_gap":
        assert got.path_result == "FOUND_PATH"
        assert (got.merged_seqs[0] if len(got.merged_seqs) == 1
                else got.consensus).upper() in truth
    elif case == "mem_limit_tiny":
        assert got.path_result == "EXCEEDED_MEM_LIMIT"
    elif case == "mem_limit_default":
        assert got.path_result != "EXCEEDED_MEM_LIMIT"
    elif case == "bad_anchor":
        assert got.path_result == "NO_PATH" and not got.found_start
    elif case == "fix_errors":
        assert got.path_result == "FOUND_PATH" and got.consensus.upper() == truth
    else:
        merged = got.merged_seqs[0].upper()
        assert got.path_result == "FOUND_PATH" and merged == truth


def test_connect_pairs_batch_matches_serial_and_jax():
    rng = np.random.default_rng(12)
    truth = _genome(rng, 4000)
    jbf, bf = _bfs(truth)
    kw = dict(max_merged_seq_len=300, max_paths=10, max_branches=1000,
              max_cost=100000)
    pairs = [(truth[s : s + 64], konnector.revcomp(truth[s + 120 : s + 184]))
             for s in range(100, 3600, 500)]
    params = konnector.ConnectPairsParams(**kw)
    serial = [konnector.connect_pairs(konnector.DBG(bf, K), r1, r2, params)
              for r1, r2 in pairs]
    batch = konnector.connect_pairs_batch(konnector.DBG(bf, K), pairs, params)
    want = jkon.connect_pairs_batch(jkon.DBG(jbf, K), pairs,
                                    jkon.ConnectPairsParams(**kw))
    assert [_fields(r) for r in batch] == [_fields(r) for r in serial]
    assert [_fields(r) for r in batch] == [_fields(r) for r in want]
    assert sum(r.path_result == "FOUND_PATH" for r in batch) >= 4


@pytest.mark.parametrize("k", [16, 32, 47])
def test_native_extend4_matches_python_and_jax(k):
    rng = np.random.default_rng(12)
    truth = "".join(rng.choice(list("ACGT"), 2000))
    jbf, bf = _bfs(truth, k=k, bytes_size=1 << 14, h=3)
    dbg = konnector.DBG(bf, k)
    assert dbg._ext4 is not None
    dbg_py = konnector.DBG(bf, k)
    dbg_py._ext4 = None
    jdbg = jkon.DBG(jbf, k)
    for s in range(0, 1500, 97):
        kmer = truth[s : s + k]
        assert dbg.successors(kmer) == dbg_py.successors(kmer) == jdbg.successors(kmer)
        assert (dbg.predecessors(kmer) == dbg_py.predecessors(kmer)
                == jdbg.predecessors(kmer))


# --- Sealer ------------------------------------------------------------------
def _gap_tuple(flanks):
    return [(left, right, dataclasses.astuple(gap)) for left, right, gap in flanks]


@pytest.mark.parametrize("case", ["lower", "plain", "trailing_gap", "several"])
def test_find_flanks_matches_jax(case):
    seq = "ACGTACGTACGT" + "acgtn" * 4 + "TTTTGGGGCCCC"
    kw = dict(flank_length=10)
    if case == "plain":
        seq = "ACGTACGTACGTacgt" + "N" * 7 + "TTTTGGGGCCCCnnACGTAC"
        kw["lower"] = False
    elif case == "trailing_gap":
        seq = "ACGTACGT" + "nnnn"
        kw["flank_length"] = 5
    elif case == "several":
        seq = "ACGTACGTAC" + "nnn" + "GGT" + "NN" + "ACGTTTGCAAGT" + "ry" + "CCCA"
    got = sealer.find_flanks("c1", seq, sealer.SealerConfig(**kw))
    want = jsl.find_flanks("c1", seq, jsl.SealerConfig(**kw))
    assert _gap_tuple(got) == _gap_tuple(want)
    if case == "lower":
        assert len(got) == 1 and got[0][2].gap_start == 12 and got[0][2].gap_size == 20
    if case == "trailing_gap":
        assert got == []


def _seal_scenario(case):
    if case == "fills_masked_gap":
        rng = np.random.default_rng(3)
        truth = _genome(rng, 1200)
        ks = [32, 28]
        filt = {k: _bfs(truth, k=k) for k in ks}
        draft = truth[:500] + truth[500:560].lower() + truth[560:]
        return truth, ks, filt, [("ctg1 c", draft)]
    if case == "unclosable":
        rng = np.random.default_rng(4)
        truth = _genome(rng, 600)
        other = _genome(rng, 600)
        draft = truth[:300] + truth[300:330].lower() + truth[330:]
        return truth, [32], {32: _bfs(other)}, [("c1", draft)]
    if case == "n_gap":
        rng = np.random.default_rng(5)
        truth = _genome(rng, 800)
        draft = truth[:400] + "N" * 30 + truth[430:]
        return truth, [32], {32: _bfs(truth)}, [("c1", draft)]
    rng = np.random.default_rng(10)  # two gaps, two records, two k
    truth = _genome(rng, 3000)
    ks = [32, 28]
    filt = {k: _bfs(truth, k=k) for k in ks}
    draft = (truth[:700] + truth[700:760].lower() + truth[760:1500]
             + truth[1500:1580].lower() + truth[1580:])
    return truth, ks, filt, [("c1 x", draft), ("c2", truth[:900] + "nn" + truth[902:])]


@pytest.mark.parametrize("case", ["fills_masked_gap", "unclosable", "n_gap",
                                  "two_gaps_two_records"])
def test_seal_records_matches_jax(case):
    truth, ks, filt, records = _seal_scenario(case)
    trace, jtrace = [], []
    out, stats = sealer.seal_records(
        records, {k: f[1] for k, f in filt.items()},
        sealer.SealerConfig(k_values=ks, flank_length=32), trace_out=trace,
    )
    jout, jstats = jsl.seal_records(
        records, {k: f[0] for k, f in filt.items()},
        jsl.SealerConfig(k_values=ks, flank_length=32), trace_out=jtrace,
    )
    assert out == jout
    assert stats == jstats
    assert trace == jtrace
    # the 15 reference counters per k, the konnector-heritage ones zero
    assert len(sealer.COUNTER_NAMES) == 15
    for k in ks:
        assert set(stats[k]) == set(sealer.COUNTER_NAMES)
        for name in ("traversalMemExceeded", "readPairsProcessed", "readPairsMerged"):
            assert stats[k][name] == 0
    if case == "fills_masked_gap":
        assert stats["gaps_found"] == 1 and stats["gaps_closed"] >= 1
        assert out[0][0] == "ctg1 c" and out[0][1].upper() == truth
    elif case == "unclosable":
        assert stats["gaps_closed"] == 0 and out[0][1] == records[0][1]
    elif case == "n_gap":
        assert stats["gaps_closed"] == 1 and out[0][1].upper() == truth
    else:
        assert stats["gaps_found"] == 3


def test_seal_records_jax_backend_refuses():
    """backend="jax" (the lockstep DeviceDBG) refuses a CUDA device without
    CUDA, never a CPU fallback; on device="cpu" it runs and equals the JAX
    package's jax backend (tests/test_torch_device_dbg.py has the rest)."""
    import torch

    truth, ks, filt, records = _seal_scenario("n_gap")
    bfs = {k: f[1] for k, f in filt.items()}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sealer.seal_records(records, bfs, sealer.SealerConfig(k_values=ks),
                                backend="jax")
    out, stats = sealer.seal_records(records, bfs, sealer.SealerConfig(k_values=ks),
                                     backend="jax", device="cpu")
    assert (out, stats) == jsl.seal_records(
        records, {k: f[0] for k, f in filt.items()}, jsl.SealerConfig(k_values=ks),
        backend="jax")
    assert stats["gaps_closed"] == 1 and out[0][1].upper() == truth


# --- Greedy extension (tests/test_extend.py) ---------------------------------
def _dbgs(truth: str):
    jbf, bf = _bfs(truth)
    return jkon.DBG(jbf, K), konnector.DBG(bf, K)


@pytest.mark.parametrize("case", ["forward", "reverse", "length_cap", "no_bubbles"])
def test_extend_seq_matches_jax(case):
    seed = {"forward": 0, "reverse": 1, "length_cap": 2, "no_bubbles": 0}[case]
    n = {"forward": 400, "reverse": 300, "length_cap": 500, "no_bubbles": 400}[case]
    rng = np.random.default_rng(seed)
    truth = "".join(rng.choice(list("ACGT")) for _ in range(n))
    jdbg, dbg = _dbgs(truth)
    args = {
        "forward": (truth[100:150], dict(forward=True)),
        "reverse": (truth[200:250], dict(forward=False)),
        "length_cap": (truth[:60], dict(forward=True, max_len=100)),
        "no_bubbles": (truth[100:150], dict(forward=True, pop_bubbles=False)),
    }[case]
    out, reason, extended = extend.extend_seq(dbg, args[0], **args[1])
    jout, jreason, jextended = jext.extend_seq(jdbg, args[0], **args[1])
    assert (out, reason.value, extended) == (jout, jreason.value, jextended)
    if case in ("forward", "no_bubbles"):
        assert out == truth[100 : 400 - extend.FP_TRIM]
        assert reason == extend.ExtendResult.DEAD_END
    elif case == "reverse":
        assert extended and out == truth[extend.FP_TRIM : 250]
    else:
        assert reason == extend.ExtendResult.LENGTH_LIMIT and len(out) == 100


@pytest.mark.parametrize("case", ["longest_run", "homopolymer", "foreign"])
def test_trim_read_matches_jax(case):
    rng = np.random.default_rng(3 if case == "longest_run" else 4)
    n = 300 if case == "longest_run" else 100
    truth = "".join(rng.choice(list("ACGT")) for _ in range(n))
    jdbg, dbg = _dbgs(truth)
    if case == "longest_run":
        other = "".join(rng.choice(list("ACGT")) for _ in range(100))
        read = other[:50] + truth[50:250] + other[50:]
    elif case == "homopolymer":
        read = "T" * 80
    else:
        read = "".join(rng.choice(list("ACGT")) for _ in range(80))
    got = extend.trim_read(dbg, read)
    assert got == jext.trim_read(jdbg, read)
    if case == "longest_run":
        assert truth[82:218] in got and len(got) < len(read)
    if case == "foreign":
        assert got == ""


# --- Reports (tests/test_reports.py) -----------------------------------------
_SUBS = [
    {"pos": 9, "draft_char": ord("A"), "sub_base": ord("G"), "num_support": 7,
     "altbase1": ord("T"), "altsupp1": 3},
    {"pos": 20, "draft_char": ord("C"), "sub_base": ord("T"), "num_support": 9},
]
_TRACE = [{"k": 32, "read_id": "c_10_5", "search_result": "FOUND_PATH",
           "search_cost": 42, "num_paths": 1, "path_lengths": "37",
           "start_kmer_pos": 3, "end_kmer_pos": 1, "nodes_visited": 99,
           "max_breadth": 4}]


@pytest.mark.parametrize("writer", ["sealer_trace", "changes_tsv", "vcf"])
def test_reports_match_jax(tmp_path, writer):
    def write(mod, path):
        if writer == "sealer_trace":
            mod.write_sealer_trace(path, _TRACE)
        elif writer == "changes_tsv":
            mod.write_changes_tsv(path, [("ctg1", _SUBS)], k=32, jump=3)
        else:
            mod.write_vcf(path, [("ctg1", _SUBS)], "draft.fa")

    got, want = tmp_path / "port", tmp_path / "jax"
    write(reports, str(got))
    write(jreports, str(want))
    assert got.read_bytes() == want.read_bytes()
    lines = got.read_text().splitlines()
    if writer == "sealer_trace":
        assert lines[0].split("\t")[0] == "k"
        assert lines[1].split("\t")[2] == "FOUND_PATH"
