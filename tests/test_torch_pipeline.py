"""The port's bulk pipeline paths that tests/test_pipeline.py covers for the
JAX package (:76 checkpoint, :148 the process pool, :231 the lookahead
fill), on goldpolish_tpu_torch, each against the JAX package's bytes for
the same config.  The port runs its host backend (numpy), which the
process pool requires.  Then the lookahead's fill pool: its worker rule,
and several batches filled at once to the same bytes."""

import os
import threading

import pytest

from goldpolish_tpu.config import PipelineConfig as JaxConfig
from goldpolish_tpu.pipeline import bulk as jax_bulk
from goldpolish_tpu_torch.config import PipelineConfig
from goldpolish_tpu_torch.pipeline import bulk
from test_pipeline import _write_synthetic


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _jax_bytes(tmp_path, **kw) -> bytes:
    out = str(tmp_path / "jax.fa")
    jax_bulk.run_bulk(JaxConfig(output_seqs=out, **kw))
    return _read(out)


# tests/test_pipeline.py:76
def test_bulk_pipeline_checkpoint_resume(tmp_path):
    draft, reads, paf, _truths = _write_synthetic(tmp_path, n_contigs=2)
    common = dict(seqs_to_polish=draft, polishing_seqs=reads, k_values=[32],
                  batch_size=1, mappings_path=paf, workspace=str(tmp_path),
                  run_sealer=False)
    want = _jax_bytes(tmp_path, **common)
    out, ckpt = str(tmp_path / "polished.fa"), str(tmp_path / "manifest.jsonl")
    stats = bulk.run_bulk(PipelineConfig(output_seqs=out, checkpoint=ckpt, backend="numpy",
                                         **common))
    assert stats["resumed_batches"] == 0
    # a completed run cleans its checkpoint state (manifest and replay files)
    assert not os.path.exists(ckpt) and not os.path.exists(ckpt + ".batches")
    assert _read(out) == want


# tests/test_pipeline.py:148
def test_bulk_pipeline_process_pool(tmp_path):
    draft, reads, paf, _truths = _write_synthetic(tmp_path, n_contigs=4)
    common = dict(seqs_to_polish=draft, polishing_seqs=reads, k_values=[32],
                  batch_size=1, mappings_path=paf, workspace=str(tmp_path),
                  max_concurrent_batches=3, run_sealer=False)
    want = _jax_bytes(tmp_path, **common)
    outs = [str(tmp_path / "p1.fa"), str(tmp_path / "p2.fa")]
    bulk.run_bulk(PipelineConfig(output_seqs=outs[0], backend="numpy", **common))
    bulk.run_bulk(PipelineConfig(output_seqs=outs[1], backend="numpy", process_pool=True,
                                 **common))
    assert _read(outs[0]) == _read(outs[1]) == want


# tests/test_pipeline.py:231
def test_bulk_pipeline_lookahead_fill_identical(tmp_path):
    draft, reads, paf, _truths = _write_synthetic(tmp_path)
    common = dict(seqs_to_polish=draft, polishing_seqs=reads, k_values=[32, 28],
                  batch_size=1, mappings_path=paf, workspace=str(tmp_path),
                  max_concurrent_batches=2)
    want = _jax_bytes(tmp_path, **common)
    out_la, out_inline = str(tmp_path / "la.fa"), str(tmp_path / "inline.fa")
    totals = bulk.run_bulk(PipelineConfig(output_seqs=out_la, lookahead_fill=True,
                                          backend="numpy", **common))
    assert totals["timing"].get("bf_fill_bg_s", 0) > 0  # fills ran off the path
    assert totals["timing"].get("bf_build_s", 1.0) < 0.05  # nothing inline
    bulk.run_bulk(PipelineConfig(output_seqs=out_inline, lookahead_fill=False,
                                 backend="numpy", **common))
    assert _read(out_la) == _read(out_inline) == want


@pytest.mark.parametrize("cores, n_k, batches, done, want", [
    (8, 4, range(4), (), 3),
    (8, 2, range(4), (), 4),
    (4, 4, range(4), (), 1),
    (64, 4, range(3), (), 3),
    (8, 4, [0], (), 1),
    (8, 4, range(4), {0, 1, 3}, 1),
], ids=["8cores_4k", "8cores_2k", "4cores_4k", "64cores_3batches", "one_batch",
        "all_but_one_resumed"])
def test_fill_workers_rule(cores, n_k, batches, done, want):
    """Fills at once until their threads (one per k) number 1.5 times the
    cores, at most the batches not done, at least one."""
    assert bulk.fill_workers(cores, n_k, batches, done) == want


def test_usable_cores_from_affinity_or_cpu_count(monkeypatch):
    """The affinity mask's cores; the machine's count where the platform
    has no affinity call (one process: no ranks to share with)."""
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 2, 5}, raising=False)
    assert bulk.usable_cores() == 3
    monkeypatch.delattr(os, "sched_getaffinity")
    monkeypatch.setattr(os, "cpu_count", lambda: 6)
    assert bulk.usable_cores() == 6


def test_lookahead_fills_batches_at_once(tmp_path, monkeypatch):
    """At 8 cores and 2 k the lookahead fills the 4 batches 4 at once: each
    fill first waits at a barrier of two, which only fills running
    together pass (one fill thread breaks it).  The output equals a
    one-worker run's (1 core) and the JAX package's, and fills started
    beside another (fill.build's inflight)."""
    draft, reads, paf, _truths = _write_synthetic(tmp_path, n_contigs=4)
    common = dict(seqs_to_polish=draft, polishing_seqs=reads, k_values=[32, 28],
                  batch_size=1, mappings_path=paf, workspace=str(tmp_path))
    want = _jax_bytes(tmp_path, **common)
    outs = [str(tmp_path / "one.fa"), str(tmp_path / "many.fa")]
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0}, raising=False)
    one = bulk.run_bulk(PipelineConfig(output_seqs=outs[0], backend="numpy", **common))
    assert one["fill_workers"] == 1

    inner, pair = bulk.build_batch_bfs, threading.Barrier(2, timeout=30)

    def paired(builder, cfg, ids):
        pair.wait()
        return inner(builder, cfg, ids)

    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)))
    monkeypatch.setattr(bulk, "build_batch_bfs", paired)
    many = bulk.run_bulk(PipelineConfig(output_seqs=outs[1], backend="numpy", **common))
    spans = many["trace"]["spans"]
    (run,) = [s for s in spans if s[0] == "bulk.run"]
    assert many["fill_workers"] == run[3]["fill_workers"] == 4
    inflight = [s[3]["inflight"] for s in spans if s[0] == "fill.build"]
    assert len(inflight) == 4 and max(inflight) >= 2
    assert _read(outs[0]) == _read(outs[1]) == want
