"""The port's bulk slice end to end against the JAX package, on the CPU.

run_bulk and cli.main of goldpolish_tpu_torch (backend numpy, and backend
hybrid, the default, with the plain torch fused eval on device="cpu" forced on with
GPTPU_FORCE_DEVICE_SCAN) must write, with the sealer on (the default),
the bytes of tests/golden/expected_polished.fa that tests/test_golden.py
pins for the JAX package, and with the sealer off the same bytes as the
JAX package's run_bulk with the same config and backend numpy.  The JAX
package's own hybrid would shard over the conftest mesh's 8 CPU devices and
arm the fused eval; tests/test_backend_invariance.py already pins its
backends equal."""

import os
import threading

import numpy as np
import pytest

from goldpolish_tpu.config import PipelineConfig as JaxConfig
from goldpolish_tpu.ops import bloom as jbloom
from goldpolish_tpu.ops import nthash as jnt
from goldpolish_tpu.pipeline import bulk as jax_bulk
from goldpolish_tpu.polish import ntedit_oracle as jne
from goldpolish_tpu.polish.ntedit_tpu import NtEditTPU
from goldpolish_tpu_torch import cli
from goldpolish_tpu_torch.bf_builder import BFBuilder
from goldpolish_tpu_torch.config import PipelineConfig
from goldpolish_tpu_torch.io import fasta
from goldpolish_tpu_torch.ops import bloom, bloom_sort, scan_eval
from goldpolish_tpu_torch.pipeline import bulk
from goldpolish_tpu_torch.polish import ntedit_oracle as ne
from goldpolish_tpu_torch.polish import scanpipe
from goldpolish_tpu_torch.polish.ntedit_gpu import NtEditGPU

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def _golden(config_cls, out_dir, concurrency, run_sealer=False, **kw):
    return config_cls(
        seqs_to_polish=os.path.join(GOLD, "draft.fa"),
        polishing_seqs=os.path.join(GOLD, "reads.fq"),
        output_seqs=os.path.join(out_dir, "polished.fa"),
        k_values=[32, 28],
        batch_size=2,
        mappings_path=os.path.join(GOLD, "map.paf"),
        workspace=os.path.join(out_dir, "ws"),
        max_concurrent_batches=concurrency,
        run_sealer=run_sealer,
        **kw,
    )


def _expected_golden() -> bytes:
    with open(os.path.join(GOLD, "expected_polished.fa"), "rb") as f:
        return f.read()


def _jax_bytes(tmp_path, concurrency):
    out = tmp_path / f"jax_c{concurrency}"
    out.mkdir()
    cfg = _golden(JaxConfig, str(out), concurrency, backend="numpy")
    jax_bulk.run_bulk(cfg)
    with open(cfg.output_seqs, "rb") as f:
        return f.read()


@pytest.mark.parametrize("concurrency", [1, 3])
@pytest.mark.parametrize("backend", ["numpy", "hybrid"])
def test_run_bulk_matches_jax_package(tmp_path, monkeypatch, backend,
                                      concurrency):
    want = _jax_bytes(tmp_path, concurrency)
    if backend == "hybrid":
        monkeypatch.setenv("GPTPU_FORCE_DEVICE_SCAN", "1")
    out = tmp_path / "port"
    out.mkdir()
    cfg = _golden(PipelineConfig, str(out), concurrency, backend=backend,
                  device="cpu")
    calls = scan_eval.scan_eval_reference.calls.value
    totals = bulk.run_bulk(cfg)
    assert totals["contigs"] == 4
    with open(cfg.output_seqs, "rb") as f:
        assert f.read() == want
    # the hybrid pipe runs the fused eval, armed by default
    scanned = scan_eval.scan_eval_reference.calls.value - calls
    assert (scanned > 0) == (backend == "hybrid")


@pytest.mark.parametrize("concurrency", [1, 3])
@pytest.mark.parametrize("backend", ["numpy", "hybrid"])
def test_run_bulk_with_sealer_matches_golden(tmp_path, monkeypatch, backend,
                                             concurrency):
    """The default chain (ntEdit -> mask -> sealer -> upper) reproduces the
    golden bytes (the config of tests/test_golden.py)."""
    if backend == "hybrid":
        monkeypatch.setenv("GPTPU_FORCE_DEVICE_SCAN", "1")
    cfg = _golden(PipelineConfig, str(tmp_path), concurrency, run_sealer=True,
                  backend=backend, device="cpu")
    totals = bulk.run_bulk(cfg)
    assert totals["contigs"] == 4
    assert "sealer_s" in totals["timing"]
    with open(cfg.output_seqs, "rb") as f:
        assert f.read() == _expected_golden()


def _one_batch(pkg_bulk, cfg, workspace):
    target_index, reads_index = pkg_bulk.build_indexes(cfg, workspace)
    builder = pkg_bulk.BFBuilder(
        target_index, reads_index, pkg_bulk.resolve_mappings(cfg, target_index),
        cfg.k_values, hash_num=cfg.hash_num, cbf_bytes=cfg.cbf_bytes,
        bf_bytes=cfg.bf_bytes,
        subsample_max_mapped_seqs_per_target_10kbp=cfg.resolved_subsample(),
    )
    records = [(r.name, r.seq) for r in fasta.read_seqs(cfg.seqs_to_polish)][:2]
    return pkg_bulk.polish_batch_records(records, builder, cfg)


def test_polish_batch_records_reports_sealer_stats(tmp_path):
    """One batch through the chain: records, sealer stats and stage timings
    as the JAX package reports them."""
    got = _one_batch(bulk, _golden(PipelineConfig, str(tmp_path), 1, run_sealer=True,
                                   backend="numpy"),
                     str(tmp_path))
    want = _one_batch(jax_bulk, _golden(JaxConfig, str(tmp_path), 1, run_sealer=True),
                      str(tmp_path))
    assert got.records == want.records
    assert got.stats["sealer"] == want.stats["sealer"]
    assert vars(got.stats["ntedit"]) == vars(want.stats["ntedit"])
    assert set(got.stats["timing"]) == set(want.stats["timing"])
    assert "sealer_s" in got.stats["timing"]


def _golden_argv(tmp_path, out):
    return [os.path.join(GOLD, "draft.fa"), os.path.join(GOLD, "reads.fq"), out,
            "-k", "32", "-k", "28", "-b", "2",
            "--mappings", os.path.join(GOLD, "map.paf"), "-m", str(tmp_path / "ws")]


def test_cli_default_sealer_matches_golden(tmp_path):
    """The host path (--backend numpy) with the sealer on, the default
    chain, writes the golden bytes."""
    out = str(tmp_path / "cli.fa")
    rc = cli.main(_golden_argv(tmp_path, out) + ["--backend", "numpy"])
    assert rc == 0
    with open(out, "rb") as f:
        assert f.read() == _expected_golden()


def test_cli_defaults_to_the_card():
    """The CLI's defaults are the hybrid backend on CUDA; the host path and
    the CPU device are explicit."""
    args = cli.build_parser().parse_args(["d.fa", "r.fq", "o.fa"])
    assert (args.backend, args.device) == ("hybrid", "cuda")
    cfg = cli.args_to_config(args)
    assert (cfg.backend, cfg.device) == ("hybrid", "cuda")
    assert (PipelineConfig().backend, PipelineConfig().device) == ("hybrid", "cuda")
    args = cli.build_parser().parse_args(["d.fa", "r.fq", "o.fa", "--backend", "numpy"])
    assert args.backend == "numpy"


def test_cli_default_raises_without_cuda(tmp_path, monkeypatch):
    """With default flags and no CUDA the run refuses at startup: no CPU
    fallback, no output written.  --process-pool names --backend numpy."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "cli.fa")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(_golden_argv(tmp_path, out))
    assert not os.path.exists(out)
    with pytest.raises(ValueError, match="--backend numpy"):
        cli.main(_golden_argv(tmp_path, out) + ["--device", "cpu", "--process-pool"])


def test_cli_hybrid_no_sealer_matches_jax_package(tmp_path, monkeypatch):
    want = _jax_bytes(tmp_path, 4)
    monkeypatch.setenv("GPTPU_FORCE_DEVICE_SCAN", "1")
    out = str(tmp_path / "cli.fa")
    rc = cli.main([
        os.path.join(GOLD, "draft.fa"), os.path.join(GOLD, "reads.fq"), out,
        "-k", "32", "-k", "28", "-b", "2",
        "--mappings", os.path.join(GOLD, "map.paf"),
        "-m", str(tmp_path / "ws"),
        "--backend", "hybrid", "--device", "cpu", "--no-sealer",
    ])
    assert rc == 0
    with open(out, "rb") as f:
        assert f.read() == want


def test_pipelined_polish_many_shape_fuzz(monkeypatch):
    """Contig-size mixes (sub-k, exactly k, k+1, power-of-two edges, an N
    byte inside a draft) through the pipelined scan, serial and fork pool,
    match the JAX package's numpy backend."""
    rng = np.random.default_rng(99)
    k, h = 32, 3
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 40000)].copy()
    jbf = jbloom.BloomFilter(1 << 18, h, k)
    jbf.insert(jnt.multi_hashes(jnt.canonical_hashes(truth, k), k, h))
    bf = bloom.BloomFilter(1 << 18, h, k)
    bf.array[:] = jbf.array
    sizes = [10, k, k + 1, 255, 256, 257, 1000, 7000]
    drafts = []
    a = 0
    for n in sizes:
        d = bytearray(truth[a : a + n].tobytes())
        if n > 3 * k:
            p = n // 2
            d[p] = ord("A") if d[p] != ord("A") else ord("C")
            d[p + 40] = ord("N")
        drafts.append(bytes(d))
        a += n
    want = [
        NtEditTPU(jne.Config(k=k, h=h, use_ratio=True, mode=1, mask=1), jbf,
                  backend="numpy").polish_contig(d)[0]
        for d in drafts
    ]
    monkeypatch.setenv("GPTPU_FORCE_DEVICE_SCAN", "1")
    monkeypatch.setattr(scanpipe, "ROW_WINDOWS", 512)  # many calls + ramp
    cfg = ne.Config(k=k, h=h, use_ratio=True, mode=1, mask=1)
    eng = NtEditGPU(cfg, bf, backend="hybrid", device="cpu")
    assert eng._scanner is None  # lazy: no upload until device use
    got = eng.polish_many(drafts)
    assert eng._scanner is not None
    assert [o for o, _r, _e in got] == want
    got_pool = eng.polish_many(drafts, processes=2, shard_bases=3000)
    assert [o for o, _r, _e in got_pool] == want


def test_unported_paths_refuse(tmp_path, monkeypatch):
    cfg = _golden(PipelineConfig, str(tmp_path), 1, backend="numpy")
    cfg.device_bf_build = True  # acts only with the jax backend
    with pytest.raises(ValueError, match="device_bf_build"):
        bulk.run_bulk(cfg)
    cfg.device_bf_build = False
    # the jax backend with its sealer arm (the lockstep device DBG) runs
    jax_cfg = _golden(PipelineConfig, str(tmp_path), 1, run_sealer=True, backend="jax",
                      device="cpu")
    assert bulk.run_bulk(jax_cfg)["contigs"] == 4
    with open(jax_cfg.output_seqs, "rb") as f:
        assert f.read() == _expected_golden()
    with pytest.raises(NotImplementedError, match="targeted"):
        cli.main(["d.fa", "r.fq", "o.fa", "--target", "--no-sealer"])
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    with pytest.raises(NotImplementedError, match="multi-host"):
        bulk.run_bulk(cfg)


# -- the overlapped device fill (--fill-overlap, kernel 5's plain version) ----


def _synthetic(tmp_path, n_contigs=4, contig_len=3000, coverage=12, seed=0):
    """tests/test_pipeline.py's synthetic drafts (sub/del/ins every 331 bp)
    and tiled high-phred reads with a PAF; returns the files and truths."""
    rng = np.random.default_rng(seed)
    truths, drafts = [], []
    for _c in range(n_contigs):
        t = "".join(rng.choice(list("ACGT")) for _ in range(contig_len))
        d = list(t)
        for p in range(100, contig_len - 100, 331):
            d[p] = ("ACGT"[("ACGT".index(d[p]) + 1) % 4], "", d[p] + "T")[p % 3]
        truths.append(t)
        drafts.append("".join(d))
    draft, reads, paf = (str(tmp_path / n) for n in ("draft.fa", "reads.fq", "map.paf"))
    with open(draft, "w") as f:
        f.write("".join(f">ctg{c}\n{d}\n" for c, d in enumerate(drafts)))
    with open(reads, "w") as rf, open(paf, "w") as pf:
        rn = 0
        for c, t in enumerate(truths):
            for _rep in range(coverage):
                for s in range(0, contig_len, 750):
                    e = min(contig_len, s + 1500)
                    if e - s < 200:
                        continue
                    rf.write(f"@r{rn}\n{t[s:e]}\n+\n{'I' * (e - s)}\n")
                    pf.write(f"r{rn}\t{e-s}\t0\t{e-s}\t+\tctg{c}\t{contig_len}\t"
                             f"{s}\t{e}\t{e-s}\t{e-s}\t60\n")
                    rn += 1
    return draft, reads, paf, truths


def _overlap_cfg(tmp_path, k_values=(32, 28), concurrency=1):
    draft, reads, paf, truths = _synthetic(tmp_path)
    cfg = PipelineConfig(
        seqs_to_polish=draft, polishing_seqs=reads,
        output_seqs=str(tmp_path / "polished_ov.fa"), k_values=list(k_values),
        batch_size=1, mappings_path=paf, workspace=str(tmp_path / "ws"),
        max_concurrent_batches=concurrency, backend="hybrid", device="cpu",
        fill_overlap=True,
    )
    return cfg, truths


def _recovered(cfg, truths) -> bool:
    recs = list(fasta.read_seqs(cfg.output_seqs))
    return [r.seq.rstrip("Nn") for r in recs] == [t.strip("N") for t in truths]


def test_fill_overlap_polishes_to_truth(tmp_path, monkeypatch):
    """tests/test_pipeline.py::test_bulk_pipeline_fill_overlap on the port:
    the tail claimer fills batches with the plain device fill, the host
    lookahead the front; a device-filled batch is consumed and every contig
    comes back to the truth.  The first polish waits for the first device
    fill to finish, so the hedge cannot win that batch."""
    monkeypatch.setenv("GPTPU_FORCE_DEVICE_SCAN", "1")
    filled = threading.Event()
    dev_fill, polish = BFBuilder.build_batch_device, bulk.polish_batch_records

    def fill_then_signal(self, ids, device="cuda"):
        out = dev_fill(self, ids, device=device)
        filled.set()
        return out

    def polish_after_fill(*args, **kw):
        filled.wait(timeout=120)
        return polish(*args, **kw)

    monkeypatch.setattr(BFBuilder, "build_batch_device", fill_then_signal)
    monkeypatch.setattr(bulk, "polish_batch_records", polish_after_fill)
    cfg, truths = _overlap_cfg(tmp_path)
    calls = bloom_sort.promote_reference.calls.value
    totals = bulk.run_bulk(cfg)
    assert totals["contigs"] == 4
    assert totals["device_filled_batches"] >= 1
    assert bloom_sort.promote_reference.calls.value > calls
    assert totals["timing"]["bf_fill_bg_s"] >= 0
    assert _recovered(cfg, truths)


def _blocking_device(monkeypatch, release: threading.Event, fail=False):
    """Patch the device fill to wait for `release`, then fill (or raise)."""
    orig = BFBuilder.build_batch_device
    claimed = []

    def slow(self, ids, device="cuda"):
        claimed.append(tuple(ids))
        release.wait(timeout=120)
        if fail:
            raise RuntimeError("device fill failed")
        return orig(self, ids, device=device)

    monkeypatch.setattr(BFBuilder, "build_batch_device", slow)
    return claimed


def test_fill_overlap_hedge_takes_host_filters(tmp_path, monkeypatch):
    """A device fill still running when its batch is due is hedged by a
    host fill: the run finishes with the host's filters (the device fill
    blocks until after run_bulk returns, so no timing is involved)."""
    release = threading.Event()
    claimed = _blocking_device(monkeypatch, release)
    cfg, truths = _overlap_cfg(tmp_path)
    try:
        totals = bulk.run_bulk(cfg)
    finally:
        release.set()
    assert claimed, "the device claimer never fired"
    assert totals["device_filled_batches"] == 0
    assert totals["contigs"] == 4 and _recovered(cfg, truths)


def test_fill_overlap_failed_hedge_waits_for_device(tmp_path, monkeypatch):
    """Repair of goldpolish_tpu/pipeline/bulk.py:481: a host hedge that
    fails does not win; the consumer waits for the device fill and uses it
    (the JAX package returns the failed hedge and raises)."""
    release = threading.Event()
    claimed = _blocking_device(monkeypatch, release)
    host = BFBuilder.build_batch

    def failing_host(self, ids):
        if tuple(ids) in claimed:  # only the hedge fills a claimed batch
            release.set()
            raise RuntimeError("host hedge failed")
        return host(self, ids)

    monkeypatch.setattr(BFBuilder, "build_batch", failing_host)
    cfg, truths = _overlap_cfg(tmp_path)
    try:
        totals = bulk.run_bulk(cfg)
    finally:
        release.set()
    assert release.is_set() and claimed
    assert totals["device_filled_batches"] >= 1
    assert totals["contigs"] == 4 and _recovered(cfg, truths)


def test_fill_overlap_device_failure_raises(tmp_path, monkeypatch):
    """A failed device fill reaches the consumer: no host fill masks it."""
    release = threading.Event()
    release.set()
    _blocking_device(monkeypatch, release, fail=True)
    cfg, _truths = _overlap_cfg(tmp_path)
    with pytest.raises(RuntimeError, match="device fill failed"):
        bulk.run_bulk(cfg)


def test_fill_overlap_late_device_failure_fails_run(tmp_path, monkeypatch):
    """A device fill that fails after its batch took the hedge's host
    filters still fails the run: the claimed batch's polish waits until
    the claimer has failed, so the failure lands after the consumer."""
    release = threading.Event()
    claimed = _blocking_device(monkeypatch, release, fail=True)
    polish = bulk.polish_batch_records

    def polish_then_fail_device(records, *args, **kw):
        if tuple(h.split()[0] for h, _ in records) in claimed:
            release.set()
            for t in threading.enumerate():
                if t.name == "bf-fill-dev":
                    t.join(timeout=120)
        return polish(records, *args, **kw)

    monkeypatch.setattr(bulk, "polish_batch_records", polish_then_fail_device)
    cfg, _truths = _overlap_cfg(tmp_path)
    with pytest.raises(RuntimeError, match="device fill failed"):
        bulk.run_bulk(cfg)
    assert claimed and os.path.exists(cfg.output_seqs)


def test_fill_overlap_k_bound_at_startup(tmp_path):
    """Repair of goldpolish_tpu/pipeline/bulk.py:254: the startup k bound is
    bloom_sort.KHALO + 1, checked before any work."""
    cfg, _truths = _overlap_cfg(tmp_path, k_values=(34, 32))
    with pytest.raises(ValueError, match=f"k <= {bloom_sort.KHALO + 1}"):
        bulk.run_bulk(cfg)
    assert not os.path.exists(cfg.workspace)
