"""Checkpoint / resume of the port's bulk pipeline against the JAX package:
the cases of tests/test_resume.py (:58, :87, :100, :121, :196) on
goldpolish_tpu_torch.  Done batches replay from disk and are never
polished again; every polished batch's bytes equal the JAX package's run
of the same config.  The port runs its host backend (numpy): the replay
plumbing is the same for every backend."""

import json
import os
import signal
import subprocess
import sys
import time

from goldpolish_tpu.config import PipelineConfig as JaxConfig
from goldpolish_tpu.pipeline import bulk as jax_bulk
from goldpolish_tpu_torch.config import PipelineConfig
from goldpolish_tpu_torch.parallel import distributed as dist
from goldpolish_tpu_torch.pipeline import bulk
from test_resume import _scenario

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(cls, tmp_path, draft, reads, paf, out, ckpt=None, batch_size=2, **kw):
    if cls is PipelineConfig:
        kw.setdefault("backend", "numpy")
    return cls(seqs_to_polish=draft, polishing_seqs=reads, output_seqs=str(out),
               mappings_path=paf, k_values=[32, 28], batch_size=batch_size,
               run_sealer=False, workspace=str(tmp_path / "ws"), checkpoint=ckpt, **kw)


def _jax_ref(tmp_path, draft, reads, paf, **kw) -> str:
    """The JAX package's uninterrupted run: the bytes every resume equals."""
    out = tmp_path / "jax_ref.fa"
    jax_bulk.run_bulk(_cfg(JaxConfig, tmp_path, draft, reads, paf, out, **kw))
    return out.read_text()


def _checkpoint_batch(tmp_path, batch: int, sentinel) -> str:
    """A manifest recording `batch` done, with a replay file of sentinel
    records (proof that the resume replays instead of polishing)."""
    ckpt = str(tmp_path / "ckpt.jsonl")
    os.makedirs(ckpt + ".batches")
    with open(ckpt, "w") as f:
        f.write(json.dumps({"batch": batch}) + "\n")
    dist.write_batch_output(os.path.join(ckpt + ".batches", "out"), batch, sentinel)
    return ckpt


# tests/test_resume.py:58
def test_single_host_resume_skips_done_batches(tmp_path):
    draft, reads, paf = _scenario(tmp_path)
    ref = _jax_ref(tmp_path, draft, reads, paf)
    ckpt = _checkpoint_batch(tmp_path, 0, [("ctg0 SENTINEL", "ACGT" * 8),
                                           ("ctg1 SENTINEL", "TTTT" * 8)])
    stats = bulk.run_bulk(_cfg(PipelineConfig, tmp_path, draft, reads, paf,
                               tmp_path / "res.fa", ckpt))
    res = (tmp_path / "res.fa").read_text()
    assert stats["resumed_batches"] == 1
    assert res.startswith(">ctg0 SENTINEL\n")
    assert res.split(">ctg2")[1] == ref.split(">ctg2")[1]
    assert not os.path.exists(ckpt) and not os.path.exists(ckpt + ".batches")


# tests/test_resume.py:87
def test_resume_declines_when_replay_file_missing(tmp_path):
    draft, reads, paf = _scenario(tmp_path)
    ref = _jax_ref(tmp_path, draft, reads, paf)
    ckpt = str(tmp_path / "ckpt.jsonl")
    with open(ckpt, "w") as f:
        f.write(json.dumps({"batch": 0}) + "\n")  # done but no replay file
    stats = bulk.run_bulk(_cfg(PipelineConfig, tmp_path, draft, reads, paf,
                               tmp_path / "res.fa", ckpt))
    assert stats["resumed_batches"] == 0
    assert (tmp_path / "res.fa").read_text() == ref


# tests/test_resume.py:100
def test_reaper_resumes_from_progress(tmp_path):
    from goldpolish_tpu.parallel import distributed as jdist

    batches = [[(f"b{i}", "ACGT" * (i + 1))] for i in range(4)]
    texts = []
    for name, mod in (("port", dist), ("jax", jdist)):
        out = str(tmp_path / f"{name}.fa")
        for i in (0, 1):
            mod.write_batch_output(out, i, batches[i])
        mod.reap(out, 2, resumable=True)
        with open(mod.reap_progress_path(out), "w") as f:
            f.write("2")  # a run that died after reaping batches 0-1
        assert mod.reaped_through(out) == 2
        for i in (2, 3):
            mod.write_batch_output(out, i, batches[i])
        mod.reap(out, 4, resumable=True)
        assert not os.path.exists(mod.reap_progress_path(out))
        assert mod.reaped_through(out) == 0
        with open(out) as f:
            texts.append(f.read())
    assert texts[0] == texts[1] == "".join(f">b{i}\n{'ACGT' * (i + 1)}\n" for i in range(4))


# tests/test_resume.py:121: the port's run in a subprocess, each batch slowed,
# killed with SIGKILL once the manifest shows two batches; the in-process
# resume re-polishes nothing recorded done and writes the JAX package's bytes
_KILLED_RUN = """
import sys, time
sys.modules["jax"] = None
sys.path.insert(0, {root!r})
from goldpolish_tpu_torch.config import PipelineConfig
from goldpolish_tpu_torch.pipeline import bulk as B
_orig = B.polish_batch_records
def slow(records, builder, cfg, batch_bfs=None):
    time.sleep(0.35)
    return _orig(records, builder, cfg, batch_bfs)
B.polish_batch_records = slow
B.run_bulk(PipelineConfig(
    seqs_to_polish={draft!r}, polishing_seqs={reads!r}, output_seqs={out!r},
    mappings_path={paf!r}, k_values=[32, 28], batch_size=1, run_sealer=False,
    workspace={ws!r}, checkpoint={ckpt!r}, max_concurrent_batches=2,
    backend="numpy",
))
"""


def test_sigkill_midrun_resume_byte_identical(tmp_path):
    draft, reads, paf = _scenario(tmp_path, n_contigs=10, contig_len=6000, coverage=10)
    ref = _jax_ref(tmp_path, draft, reads, paf, batch_size=1, max_concurrent_batches=2)
    out, ckpt = str(tmp_path / "res.fa"), str(tmp_path / "ck.jsonl")
    p = subprocess.Popen([sys.executable, "-c", _KILLED_RUN.format(
        root=ROOT, draft=draft, reads=reads, out=out, paf=paf,
        ws=str(tmp_path / "wsk"), ckpt=ckpt)])
    deadline = time.time() + 120
    while time.time() < deadline and p.poll() is None:
        if os.path.exists(ckpt) and len(open(ckpt).read().strip().splitlines()) >= 2:
            break
        time.sleep(0.05)
    p.send_signal(signal.SIGKILL)
    p.wait()
    done_before = len(open(ckpt).read().strip().splitlines()) if os.path.exists(ckpt) else 0
    assert 2 <= done_before < 10, done_before  # the kill landed mid-run
    stats = bulk.run_bulk(_cfg(PipelineConfig, tmp_path, draft, reads, paf, out, ckpt,
                               batch_size=1, max_concurrent_batches=2))
    assert stats["resumed_batches"] == done_before
    assert open(out).read() == ref
    assert not os.path.exists(ckpt)


# tests/test_resume.py:196
def test_resume_lookahead_never_prefills_done_batches(tmp_path, monkeypatch):
    draft, reads, paf = _scenario(tmp_path)
    ref = _jax_ref(tmp_path, draft, reads, paf)
    ckpt = _checkpoint_batch(tmp_path, 1, [("ctg2 SENTINEL", "ACGT" * 8),
                                           ("ctg3 SENTINEL", "TTTT" * 8)])
    fills: list = []
    orig = bulk.build_batch_bfs

    def counting(builder, cfg, ids):
        fills.append(tuple(ids))
        return orig(builder, cfg, ids)

    monkeypatch.setattr(bulk, "build_batch_bfs", counting)
    stats = bulk.run_bulk(_cfg(PipelineConfig, tmp_path, draft, reads, paf,
                               tmp_path / "res.fa", ckpt))
    res = (tmp_path / "res.fa").read_text()
    assert stats["resumed_batches"] == 1
    assert ">ctg2 SENTINEL\n" in res
    assert sorted(fills) == [("ctg0", "ctg1"), ("ctg4", "ctg5")]
    assert res.split(">ctg2")[0] == ref.split(">ctg2")[0]
    assert res.split(">ctg4")[1] == ref.split(">ctg4")[1]
