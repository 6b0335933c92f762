"""The port's batch primitives (parallel/distributed.py and the checkpoint
manifest of pipeline/engine.py) against the JAX package's: the single-host
cases of tests/test_distributed.py, each run through both packages, the
files they leave compared byte for byte, and the port's rendezvous over
torch.distributed in one process.  Two-process runs, and their resume
after a failure, are in tests/test_torch_multihost.py."""

import os
import threading

import pytest

from goldpolish_tpu.parallel import distributed as jdist
from goldpolish_tpu_torch.io import fasta
from goldpolish_tpu_torch.parallel import distributed as dist

BOTH = pytest.mark.parametrize("mod", [dist, jdist], ids=["port", "jax"])


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# tests/test_distributed.py:11
def test_host_owns_batch_round_robin():
    owners = [[h for h in range(3) if dist.host_owns_batch(i, h, 3)] for i in range(6)]
    assert owners == [[0], [1], [2], [0], [1], [2]]
    assert all(dist.host_owns_batch(i, h, n) == jdist.host_owns_batch(i, h, n)
               for n in (1, 2, 3, 5) for h in range(n) for i in range(12))
    assert dist.batch_path("o.fa", 7) == jdist.batch_path("o.fa", 7)


# tests/test_distributed.py:18
def test_write_and_reap_ordered(tmp_path):
    outs = []
    for mod in (dist, jdist):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        out = str(d / "merged.fa")
        mod.write_batch_output(out, 2, [("c3", "GGG")])
        mod.write_batch_output(out, 0, [("c1", "AAA"), ("c1b", "CCC")])
        t = threading.Thread(target=mod.reap, args=(out, 3))
        t.start()
        mod.write_batch_output(out, 1, [("c2", "TTT")])
        t.join(timeout=30)
        assert not t.is_alive()
        assert [r.id for r in fasta.read_seqs(out)] == ["c1", "c1b", "c2", "c3"]
        assert not [f for f in os.listdir(d) if ".batch" in f]
        outs.append(_read(out))
    assert outs[0] == outs[1]


# tests/test_distributed.py:35
@BOTH
def test_reap_aborts_on_empty_batch(tmp_path, mod):
    out = str(tmp_path / "m.fa")
    open(mod.batch_path(out, 0), "w").close()
    with pytest.raises(RuntimeError):
        mod.reap(out, 1, timeout=5)


# tests/test_distributed.py:42
@BOTH
def test_reap_timeout(tmp_path, mod):
    with pytest.raises(TimeoutError):
        mod.reap(str(tmp_path / "m.fa"), 1, poll_interval=0.05, timeout=0.3)


# tests/test_distributed.py:48
def test_init_distributed_noop_single_host(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert dist.init_distributed() == jdist.init_distributed() == (0, 1)


def test_init_distributed_joins_and_leaves_a_group(monkeypatch):
    """A configured coordinator joins a gloo group (here of one process,
    from the JAX package's variables) and shutdown_distributed leaves it."""
    import socket

    import torch.distributed as tdist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    try:
        assert dist.init_distributed() == (0, 1)
        assert tdist.is_initialized() and tdist.get_backend() == "gloo"
    finally:
        dist.shutdown_distributed()
    assert not tdist.is_initialized()
    with pytest.raises(ValueError, match="outside"):
        dist.init_distributed(f"127.0.0.1:{port}", 2, 2)


def test_configured_hosts_and_target_refusal(monkeypatch):
    """configured_hosts reads the hosts before any rendezvous; check_ported
    keeps --target on one host."""
    from goldpolish_tpu_torch.config import PipelineConfig
    from goldpolish_tpu_torch.pipeline import bulk

    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    assert dist.configured_hosts() == 1
    cfg = PipelineConfig(target=True, backend="numpy")
    bulk.check_ported(cfg)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    assert dist.configured_hosts() == 4
    assert dist.configured_hosts(num_processes=1) == 1
    with pytest.raises(ValueError, match="--target runs on one host"):
        bulk.check_ported(cfg)
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    bulk.check_ported(cfg)


# tests/test_distributed.py:53
def test_reap_resume_no_duplicate_after_crash_windows(tmp_path):
    """Both crash windows of the reaper (a batch appended and progress
    saved but its file not yet removed; a torn append past the recorded
    offset) resume without duplicate or lost records, to the same bytes
    in both packages."""
    outs = []
    for mod in (dist, jdist):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        out = str(d / "m.fa")
        for i in range(4):
            mod.write_batch_output(out, i, [(f"c{i}", "ACGT" * (i + 1))])
        mod.reap(out, 2, resumable=True)
        progress = mod.reap_progress_path(out)
        with open(progress, "w") as f:
            f.write(f"2 {os.path.getsize(out)}")
        assert mod.reaped_through(out) == 2
        mod.write_batch_output(out, 1, [("c1", "ACGTACGT")])
        with open(out, "a") as f:
            f.write(">c2 partial\nACG")
        mod.reap(out, 4, resumable=True)
        recs = list(fasta.read_seqs(out))
        assert [r.id for r in recs] == ["c0", "c1", "c2", "c3"]
        assert [r.seq for r in recs] == ["ACGT" * (i + 1) for i in range(4)]
        assert not os.path.exists(progress)
        outs.append(_read(out))
    assert outs[0] == outs[1]


# tests/test_distributed.py:86
def test_manifest_mark_idempotent(tmp_path):
    from goldpolish_tpu.pipeline.engine import CheckpointManifest as JaxManifest
    from goldpolish_tpu_torch.pipeline.engine import CheckpointManifest

    for name, cls in (("port", CheckpointManifest), ("jax", JaxManifest)):
        path = str(tmp_path / f"{name}.jsonl")
        m = cls(path)
        m.mark(3)
        m.mark(3)  # a re-polished batch must not duplicate the line
        m.close()
        assert len(open(path).readlines()) == 1
    # one line each, the same batch (each line also carries its wall time)
    assert CheckpointManifest(str(tmp_path / "port.jsonl")).done == JaxManifest(
        str(tmp_path / "jax.jsonl")).done == {3}
