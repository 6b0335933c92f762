"""The port's bulk pipeline paths that tests/test_pipeline.py covers for the
JAX package (:76 checkpoint, :148 the process pool, :231 the lookahead
fill), on goldpolish_tpu_torch, each against the JAX package's bytes for
the same config.  The port runs its host backend (numpy), which the
process pool requires."""

import os

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
