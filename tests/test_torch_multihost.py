"""Multi-host runs of the port: two `python -m goldpolish_tpu_torch.cli`
processes joined over torch.distributed (gloo at 127.0.0.1), each
polishing its round-robin share of batches on the CPU (`--device cpu`),
host 0's reaper merging the per-batch files in order.  The merged bytes
must equal a one-process run of the port and the JAX package's single-host
run, on tests/test_multihost.py's scenario, in every arm of the port: the
numpy backend (also with --process-pool), hybrid with the device scan
pinned (the eval armed, the eval off, --fill-overlap) and jax (also with
device_bf_build; the two arms that fill filters on the device are held to
their one-process run only), and numpy with the sealer on, whose
"<id> " headers the merge must keep.  The JAX package's own two-process
hybrid run fails there (its scanner's mesh spans both processes' devices,
goldpolish_tpu/ops/scan_conv.py:298-317); the port's scanner shards over
its own process's devices only.  Then two failures with --checkpoint: rank
1 killed mid-run, and a published batch file lost before the reaper read
it; both ranks rerun and resume to the same bytes."""

import os
import signal
import socket
import subprocess
import sys
import time

import pytest

from goldpolish_tpu.config import PipelineConfig
from goldpolish_tpu.pipeline import bulk as jbulk
from test_multihost import _scenario

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120  # each rank process
FORCE = {"GPTPU_FORCE_DEVICE_SCAN": "1"}

NO_SEALER = ("--no-sealer",)
# the port's arms: (backend, environment, CLI flags, patch)
ARMS = {
    "numpy": ("numpy", {}, NO_SEALER, None),
    "numpy_process_pool": ("numpy", {}, ("--process-pool", *NO_SEALER), None),
    "hybrid": ("hybrid", FORCE, NO_SEALER, None),
    "hybrid_eval_off": ("hybrid", {**FORCE, "GPTPU_DEVICE_EVAL": "0"}, NO_SEALER, None),
    "hybrid_fill_overlap": ("hybrid", FORCE, ("--fill-overlap", *NO_SEALER), None),
    "jax": ("jax", {}, NO_SEALER, None),
    "jax_device_bf_build": ("jax", {}, NO_SEALER, {"PATCH": "device_bf_build"}),
    # the sealer renames every record "<id> <comment>", here "ctg0 "
    "numpy_sealer": ("numpy", {}, (), None),
}
# held to their one-process run only: the device fills' filters are a
# documented superset of the host fill's, and the JAX run has no sealer
OWN_ONLY = ("hybrid_fill_overlap", "jax_device_bf_build", "numpy_sealer")

# a rank started with a test-only patch: the script patches the port, then
# runs the CLI (sys.argv[1:]); PATCH selects the patch
_PATCH_SCRIPT = """
import dataclasses, os, sys, time
sys.path.insert(0, {repo!r})
from goldpolish_tpu_torch import cli
from goldpolish_tpu_torch.parallel import distributed as dist
from goldpolish_tpu_torch.pipeline import bulk

patch, arg = os.environ["PATCH"], os.environ.get("PATCH_ARG", "")
if patch == "device_bf_build":
    # PipelineConfig.device_bf_build, which the CLI does not expose
    run_bulk = bulk.run_bulk
    bulk.run_bulk = lambda cfg: run_bulk(dataclasses.replace(cfg, device_bf_build=True))
elif patch == "die_at_ctg3":
    # rank 1 dies (as if killed) when it reaches its second batch
    polish = bulk.polish_batch_records

    def polish_or_die(records, *a, **kw):
        if records[0][0].split()[0] == "ctg3":
            os._exit(9)
        return polish(records, *a, **kw)

    bulk.polish_batch_records = polish_or_die
elif patch == "hold_batch0":
    # rank 0 publishes batch 0 only once the file `arg` exists
    write = dist.write_batch_output

    def held(out, index, records):
        while index == 0 and not os.path.exists(arg):
            time.sleep(0.05)
        write(out, index, records)

    dist.write_batch_output = held
elif patch == "empty_batch1":
    # rank 1 publishes batch 1 as an empty file
    write = dist.write_batch_output

    def empty(out, index, records):
        write(out, index, [] if index == 1 else records)

    dist.write_batch_output = empty
sys.exit(cli.main(sys.argv[1:]))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _argv(files, out, ws, backend, *extra):
    draft, reads, paf = files
    return [draft, reads, out, "--mappings", paf, "-k", "32", "-b", "1",
            "--device", "cpu", "--backend", backend, "-m", ws, *extra]


def _start(argv, env, patch=None):
    cmd = ([sys.executable, "-c", _PATCH_SCRIPT.format(repo=REPO), *argv] if patch
           else [sys.executable, "-m", "goldpolish_tpu_torch.cli", *argv])
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _env(extra=None, rank=None, port=None, **patch):
    env = {**os.environ, "PYTHONPATH": REPO, **(extra or {}), **patch}
    for key in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        env.pop(key, None)
    if rank is not None:
        env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank))
    return env


def _finish(p, timeout=TIMEOUT_S):
    """(returncode, stderr) of a started rank; killed at the timeout."""
    try:
        _o, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        _o, err = p.communicate()
        return "timeout", err
    return p.returncode, err


def _run_ranks(tmp_path, name, backend, extra_env=None, extra=(),
               checkpoint=False, patches=(None, None)):
    """Start the two ranks of one run (each with its own --checkpoint
    file if `checkpoint`); returns the merged output's path and the
    processes."""
    port = _free_port()
    out = str(tmp_path / f"{name}.fa")
    procs = []
    for rank in range(2):
        ck = ["--checkpoint", str(tmp_path / f"ck_{name}{rank}")] if checkpoint else []
        procs.append(_start(
            _argv(_files(tmp_path), out, str(tmp_path / f"ws_{name}{rank}"), backend,
                  *extra, *ck),
            _env(extra_env, rank, port, **(patches[rank] or {})), patches[rank]))
    return out, procs


def _files(tmp_path):
    return tuple(str(tmp_path / n) for n in ("draft.fa", "reads.fa", "map.paf"))


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The scenario, the JAX package's single-host bytes (numpy backend)
    and the port's one-process bytes per arm (the runs side by side)."""
    tmp = tmp_path_factory.mktemp("multihost")
    files = _scenario(tmp)
    assert files == _files(tmp)
    draft, reads, paf = files
    procs = {}
    for arm, (backend, env, extra, patch) in ARMS.items():
        argv = _argv(files, str(tmp / f"single_{arm}.fa"), str(tmp / f"ws_{arm}"),
                     backend, *extra)
        procs[arm] = _start(argv, _env(env, **(patch or {})), patch)
    jax_out = str(tmp / "jax_single.fa")
    jbulk.run_bulk(PipelineConfig(
        seqs_to_polish=draft, polishing_seqs=reads, output_seqs=jax_out,
        mappings_path=paf, k_values=[32], batch_size=1, run_sealer=False,
        workspace=str(tmp / "ws_jax")))
    ports = {}
    for arm, p in procs.items():
        rc, err = _finish(p)
        assert rc == 0, err[-2000:]
        ports[arm] = _read(str(tmp / f"single_{arm}.fa"))
    return tmp, _read(jax_out), ports


@pytest.mark.parametrize("arm", list(ARMS))
def test_two_ranks_match_one_process_and_jax(reference, arm):
    tmp, jax_bytes, ports = reference
    backend, env, extra, patch = ARMS[arm]
    out, procs = _run_ranks(tmp, f"multi_{arm}", backend, env, extra,
                            patches=(patch, patch))
    results = [_finish(p) for p in procs]
    assert [rc for rc, _e in results] == [0, 0], [e[-2000:] for _rc, e in results]
    if arm not in OWN_ONLY:
        assert ports[arm] == jax_bytes
    assert _read(out) == ports[arm]
    if arm == "numpy_sealer":
        # the reaper appends each batch's bytes as they are: the JAX
        # package's reaper rewrites the records and drops the space
        assert _read(out).startswith(b">ctg0 \n")
    # batch i went to rank i % 2, and no batch file is left behind
    for rank, (_rc, err) in enumerate(results):
        assert f"host {rank} of 2 joined" in err
    assert not [f for f in os.listdir(tmp) if f.startswith(f"multi_{arm}.fa.")]


def test_cuda_without_cuda_raises_in_every_rank(reference):
    """--device cuda on a host without CUDA: each rank refuses at startup
    (never a CPU fallback), before it would wait for the other."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the no-CUDA refusal cannot show")
    tmp = reference[0]
    port = _free_port()
    procs = []
    for rank in range(2):
        argv = _argv(_files(tmp), str(tmp / "cuda.fa"), str(tmp / f"ws_cuda{rank}"),
                     "hybrid", *NO_SEALER)
        argv[argv.index("--device") + 1] = "cuda"
        procs.append(_start(argv, _env(None, rank, port)))
    for rc, err in (_finish(p, timeout=60) for p in procs):
        assert rc not in (0, "timeout") and "CUDA is not available" in err, err[-2000:]
    assert not os.path.exists(tmp / "cuda.fa")


def test_target_refused_on_many_hosts(reference):
    """--target keeps one host: its gap files sit next to the output, where
    every host would write, read and delete them.  Each rank refuses at
    startup, before the rendezvous, and leaves no file behind."""
    tmp = reference[0]
    port = _free_port()
    procs = []
    for rank in range(2):
        argv = _argv(_files(tmp), str(tmp / "target.fa"), str(tmp / f"ws_target{rank}"),
                     "numpy", "--target", *NO_SEALER)
        procs.append(_start(argv, _env(None, rank, port)))
    for rc, err in (_finish(p, timeout=60) for p in procs):
        assert rc not in (0, "timeout") and "--target runs on one host" in err, err[-2000:]
        assert "joined" not in err
    assert not [f for f in os.listdir(tmp)
                if f.startswith("target.fa") or f.startswith("GoldPolish-Target_work")]


def test_reaper_failure_fails_host_0(reference):
    """An empty published batch aborts the reaper (the reaper contract);
    the abort fails host 0's run, which the JAX package's reaper thread
    would swallow, leaving a truncated output behind an exit code of 0."""
    tmp = reference[0]
    out, procs = _run_ranks(tmp, "empty", "numpy", extra=NO_SEALER,
                            patches=(None, {"PATCH": "empty_batch1"}))
    (rc0, err0), (rc1, err1) = (_finish(p) for p in procs)
    assert rc1 == 0, err1[-2000:]
    assert rc0 not in (0, "timeout") and "batch 1 output is empty" in err0, err0[-2000:]


def _wait_for(cond, what: str, timeout=TIMEOUT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _reaped(out: str) -> int:
    try:
        with open(out + ".reaped") as f:
            return int(f.read().split()[0])
    except (OSError, IndexError, ValueError):
        return 0


def _kill(p):
    p.send_signal(signal.SIGKILL)
    p.communicate(timeout=30)


def _rerun_and_check(reference, name, extra):
    tmp, jax_bytes, ports = reference
    out, procs = _run_ranks(tmp, name, "numpy", extra=extra, checkpoint=True)
    results = [_finish(p) for p in procs]
    assert [rc for rc, _e in results] == [0, 0], [e[-2000:] for _rc, e in results]
    assert _read(out) == ports["numpy"] == jax_bytes
    # the run is complete: progress, checkpoints and batch files are gone
    assert not [f for f in os.listdir(tmp)
                if f.startswith(f"{name}.fa.") or f.startswith(f"ck_{name}")]
    return results


def test_rank_killed_mid_run_resumes_to_same_bytes(reference):
    """Rank 1 dies at its second batch (batch 3) after publishing batch 1;
    rank 0's reaper merges 0-2 and waits; rank 0 is killed.  Both rerun with
    the same --checkpoint: rank 1 polishes only batch 3, rank 0 none."""
    tmp = reference[0]
    name, extra = "killed", ("--concurrency", "1", *NO_SEALER)
    out, procs = _run_ranks(tmp, name, "numpy", extra=extra, checkpoint=True,
                            patches=(None, {"PATCH": "die_at_ctg3"}))
    rc1, err1 = _finish(procs[1])
    assert rc1 == 9, err1[-2000:]
    try:
        _wait_for(lambda: _reaped(out) == 3, "the reaper to merge batches 0-2")
    finally:
        _kill(procs[0])
    results = _rerun_and_check(reference, name, extra)
    assert "resuming: 1 batches already complete" in results[1][1]
    assert "reaper resuming at batch 3" in results[0][1]


def test_lost_batch_file_resumes_to_same_bytes(reference):
    """Rank 1 publishes batch 1, records it done and dies at batch 3; batch
    1's file is deleted before the reaper can read it (rank 0 holds batch 0
    back until then); the reaper merges batch 0 and waits; rank 0 is
    killed.  On the rerun rank 1 re-polishes batch 1 (recorded done, but
    neither reaped nor published) and batch 3."""
    tmp = reference[0]
    name, extra = "lost", ("--concurrency", "1", *NO_SEALER)
    release = str(tmp / "release_batch0")
    out, procs = _run_ranks(tmp, name, "numpy", extra=extra, checkpoint=True,
                            patches=({"PATCH": "hold_batch0", "PATCH_ARG": release},
                                     {"PATCH": "die_at_ctg3"}))
    rc1, err1 = _finish(procs[1])
    assert rc1 == 9, err1[-2000:]
    os.remove(out + ".batch000001")
    open(release, "w").close()
    try:
        _wait_for(lambda: _reaped(out) == 1, "the reaper to merge batch 0")
        _wait_for(lambda: os.path.exists(out + ".batch000002"), "batch 2")
    finally:
        _kill(procs[0])
    results = _rerun_and_check(reference, name, extra)
    assert "resuming: 1 batches already complete" in results[1][1]
    assert "reaper resuming at batch 1" in results[0][1]
