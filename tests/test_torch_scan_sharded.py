"""The port's DeviceScanner sharded over several devices (K9: the JAX
scanner's mesh, goldpolish_tpu/ops/scan_conv.py:284-458) against the JAX
scanner on conftest's 8 CPU devices and against the port's one-shard
scanner: the plain scan's rows, the fused eval's per-shard outputs (one
shard over s_max), the scan pipe's shard merge, and the hybrid engine's
bytes with the eval armed and not.  Shards are CPU devices here (the plain
versions of kernels 2 and 4).  Every comparison is exact."""

import numpy as np
import pytest
import torch

from goldpolish_tpu_torch.ops import bloom
from goldpolish_tpu_torch.ops import nthash as nt
from goldpolish_tpu_torch.ops import scan_conv as tsc
from goldpolish_tpu_torch.ops import scan_eval as tse
from goldpolish_tpu_torch.ops import siteeval
from goldpolish_tpu_torch.polish import scanpipe
from goldpolish_tpu_torch.polish.multik import ntedit_config_for_k
from goldpolish_tpu_torch.polish.ntedit_gpu import NtEditGPU
from test_torch_scan_eval import NAMES, _ecfg_kw, _engine_scenario, _scenario


def _cpus(n):
    return ("cpu",) * n


def _scan_inputs(k, h):
    """9 rows of ACGT with N (the JAX conv scan misclasses bytes 1, 3, 4
    and 7, tests/test_torch_scan.py) and a filter of row 0's windows."""
    rng = np.random.default_rng(k)
    codes = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, (9, 3000))].copy()
    bf = bloom.BloomFilter(1 << 14, h, k)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(codes[0], k), k, h))
    return codes, bf


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("rows", [3, 8, 9])
def test_scan_packed_matches_jax_mesh_and_one_shard(n, rows):
    from goldpolish_tpu.ops import scan_conv as jsc

    k, h = 28, 4
    codes, bf = _scan_inputs(k, h)
    jax_scanner = jsc.DeviceScanner(bf)
    assert jax_scanner.n_devices == 8  # the JAX scanner's mesh
    want = np.asarray(jax_scanner.scan_packed(codes[:rows], k))
    one = tsc.DeviceScanner(bf, "cpu").scan_packed(codes[:rows], k).numpy()
    sharded = tsc.DeviceScanner(bf, "cpu", devices=_cpus(n))
    assert sharded.n_shards == n and sharded.preferred_rows == max(4, n)
    calls = tsc.scan_present_packed_reference.calls.value
    got = sharded.scan_packed(codes[:rows], k).numpy()
    # one call of kernel 2's plain version per shard, pad rows included
    assert tsc.scan_present_packed_reference.calls.value - calls == n
    assert got.shape == want.shape == (rows, -(-(3000 - k + 1) // 8))
    assert np.array_equal(got, want) and np.array_equal(got, one)


def _eval_rows(k):
    """7 rows of 3,000 bytes with k-1 halos cut from a draft with errors
    every 150 bp (the last padded with 'A'); row 3 carries extra errors."""
    draft, bf = _scenario(24000, k, 4, 1, 1 << 14, 150)
    codes = np.frombuffer(draft, np.uint8)
    rows, w = [], 0
    for _ in range(7):
        row = np.full(3000, ord("A"), np.uint8)
        seg = codes[w : w + 3000]
        row[: len(seg)] = seg
        rows.append(row)
        w += 3000 - k + 1
    rows = np.stack(rows)
    rows[3, 100:2800:37] ^= 2  # A<->C, G<->T
    return rows, bf


def _armed(scanner_cls_args, kw, jax=False):
    if jax:
        from goldpolish_tpu.ops import scan_conv as jsc
        from goldpolish_tpu.ops import scan_eval as jse
        from goldpolish_tpu.ops import siteeval as jsite

        scanner = jsc.DeviceScanner(*scanner_cls_args)
        ecfg = jse.EvalConfig(**kw)
        scanner.enable_eval(ecfg, jsite.make_tables(ecfg.k, ecfg.jump, ecfg.max_ins,
                                                    ecfg.max_del))
        return scanner
    bf, devices = scanner_cls_args
    scanner = tsc.DeviceScanner(bf, "cpu", devices=devices)
    ecfg = tse.EvalConfig(**kw)
    scanner.enable_eval(ecfg, siteeval.make_tables(ecfg.k, ecfg.jump, ecfg.max_ins,
                                                   ecfg.max_del))
    return scanner


def test_scan_eval_packed_per_shard_matches_jax_mesh():
    """Eight shards, one row each (the eighth a pad row of 'A'): all nine
    outputs, shard by shard, equal the JAX scanner's shard_map'd eval, in a
    call where some shards find more heads than s_max and others fewer."""
    k = 32
    rows, bf = _eval_rows(k)
    kw = _ecfg_kw(k, 4, s_max=16, s_ins=8)
    want = [np.asarray(x) for x in _armed((bf,), kw, jax=True).scan_eval_packed(rows, k)]
    scanner = _armed((bf, _cpus(8)), kw)
    assert scanner.eval_shards == 8
    got = [x.numpy() for x in scanner.scan_eval_packed(rows, k)]
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and np.array_equal(g, w), name
    n_sites = got[1]
    assert n_sites.shape == (8,) and got[2].shape == (8, 16)
    assert (n_sites > 16).any() and ((n_sites > 0) & (n_sites <= 16)).any()


def _pipe_out(scanner, jobs, k):
    pipe = scanpipe.ScanPipe(scanner, k, row_windows=2000, rows=scanner.preferred_rows)
    return list(pipe.run(jobs))


def test_scanpipe_merge_matches_one_shard():
    """The pipe's shard merge (scanpipe.merge_shards): with s_max above
    every shard's heads, eight shards yield the presence and the interior
    site tables of one shard, job by job."""
    k = 32
    draft, bf = _scenario(40000, k, 4, 9, 1 << 14, 150)
    codes = np.frombuffer(draft, np.uint8)
    jobs = [(i, codes[a:b]) for i, (a, b) in enumerate(
        [(0, 9000), (9000, 9020), (9020, 25000), (25000, len(codes))])]
    kw = _ecfg_kw(k, 4, s_max=256)
    want = _pipe_out(_armed((bf, None), kw), jobs, k)
    got = _pipe_out(_armed((bf, _cpus(8)), kw), jobs, k)
    assert [j for j, *_ in got] == [j for j, *_ in want] == [0, 1, 2, 3]
    n_tables = 0
    for (_j, pres, tabs), (_w, wpres, wtabs) in zip(got, want):
        assert np.array_equal(pres, wpres)
        assert (tabs is None) == (wtabs is None)
        if tabs is not None:
            n_tables += len(tabs[0])
            for a, b in zip(tabs, wtabs):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    assert n_tables > 20
    # and the plain scan's pipe, which pads a call's rows with 0
    plain = tsc.DeviceScanner(bf, "cpu", devices=_cpus(3))
    for (_j, pres), (_w, wpres, _t) in zip(_pipe_out(plain, jobs, k), want):
        assert np.array_equal(pres, wpres)


@pytest.mark.parametrize("dev_eval", ["1", "0"], ids=["eval_on", "eval_off"])
def test_hybrid_polish_many_eight_shards_matches_jax_hybrid(monkeypatch, dev_eval):
    """NtEditGPU(devices=8 CPUs) polish_many, the scan pinned to the
    device: byte-identical to the JAX package's hybrid engine on its
    8-device mesh, with the eval armed and not."""
    from goldpolish_tpu.ops import bloom as jbloom
    from goldpolish_tpu.polish import multik as jmultik
    from goldpolish_tpu.polish import scanpipe as jscanpipe
    from goldpolish_tpu.polish.ntedit_tpu import NtEditTPU

    monkeypatch.setenv("GPTPU_FORCE_DEVICE_SCAN", "1")
    monkeypatch.setenv("GPTPU_DEVICE_EVAL", dev_eval)
    # eval-off calls: 8 rows of 2^14 windows in both packages
    monkeypatch.setattr(jscanpipe, "ROW_WINDOWS", 1 << 14)
    monkeypatch.setattr(scanpipe, "ROW_WINDOWS", 1 << 14)
    bf, drafts = _engine_scenario()
    jbf = jbloom.BloomFilter(1 << 16, 4, 32)
    jbf.array[:] = bf.array
    jeng = NtEditTPU(jmultik.ntedit_config_for_k(32), jbf, backend="hybrid")
    want = [o for o, _r, _e in jeng.polish_many(drafts)]
    assert jeng._scanner.n_devices == 8
    eng = NtEditGPU(ntedit_config_for_k(32), bf, backend="hybrid", device="cpu",
                    devices=_cpus(8))
    got = eng.polish_many(drafts)
    assert eng._scanner.n_shards == 8
    assert eng._scanner.eval_enabled == (dev_eval == "1")
    assert [o for o, _r, _e in got] == want
    if dev_eval == "1":
        assert sum(e.n_table_hits for _o, _r, e in got) > 20


def test_shard_devices():
    assert tsc.shard_devices("cpu") == [torch.device("cpu")]
    assert tsc.shard_devices("cuda", ("cpu", "cpu")) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="at least one"):
        tsc.shard_devices("cpu", ())
    with pytest.raises(ValueError, match="unsupported"):
        tsc.shard_devices("meta")
    if not torch.cuda.is_available():
        # no CUDA: every CUDA shard list raises, never a CPU fallback
        for device, devices in (("cuda", None), ("cuda:0", None),
                                ("cpu", ("cuda:0", "cuda:0")), ("cpu", ("cpu", "cuda"))):
            with pytest.raises(RuntimeError, match="CUDA"):
                tsc.DeviceScanner(bloom.BloomFilter(1 << 10, 2, 20), device, devices)


@pytest.mark.cuda
@pytest.mark.parametrize("eval_on", [True, False], ids=["eval", "scan"])
def test_cuda_two_shards_on_one_card_match_one_shard(eval_on):
    """Two shards on cuda:0 (each with its own stream and pinned slots in
    the pipe, kernels 2 and 4 on their rows) yield the one-shard pipe's
    presence and tables, job by job."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    k = 32
    draft, bf = _scenario(40000, k, 4, 9, 1 << 14, 150)
    codes = np.frombuffer(draft, np.uint8)
    jobs = [(i, codes[a:b]) for i, (a, b) in enumerate(
        [(0, 9000), (9000, 9020), (9020, 25000), (25000, len(codes))])]
    kw = _ecfg_kw(k, 4, s_max=256)

    def scanner(devices):
        if eval_on:
            return _armed((bf, devices), kw)
        return tsc.DeviceScanner(bf, "cpu", devices=devices)

    want = _pipe_out(scanner(None), jobs, k)
    got = _pipe_out(scanner(("cuda:0", "cuda:0")), jobs, k)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g[0] == w[0] and np.array_equal(g[1], w[1])
        if eval_on:
            assert (g[2] is None) == (w[2] is None)
            for a, b in zip(g[2] or (), w[2] or ()):
                assert np.array_equal(a, b)
