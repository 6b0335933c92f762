"""The port's benchmark, bench_torch.py, on the CPU at a small size
(200 kbp, 2 contigs, 2 batches, 2 processes, --device cpu: the plain torch
versions of the kernels).  A subprocess run prints a last line with every
key of bench.py's line and the port's kernel launches, recovers the truth,
and imports no jax and nothing of goldpolish_tpu.  In-process, against the
JAX package's bench.py on the same seed, tolerance 0 throughout: the
scenario's truths, drafts and reads; the host fill's filter words; the
device fill's words (the plain fill against the JAX bloom_sort on the
CPU); one _chain_fn pass of the port's numpy and hybrid engines (the
device scan pinned) against the JAX bench's numpy engines.  A failing
device fill fails the overlap stream and is never replaced by a host fill,
and --device cuda raises without CUDA."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"GPTPU_BENCH_BASES": "200000", "GPTPU_BENCH_CONTIGS": "2",
         "GPTPU_BENCH_BATCHES": "2", "GPTPU_BENCH_PROCS": "2"}
KEYS = ("metric", "value", "unit", "vs_baseline", "arms", "arm_spread", "locks",
        "fill", "pipeline_rate", "noisy_rate", "recovered", "scan", "platform",
        "kernel_launches")
ARMS = ("baseline_1t", "host_all", "calibration", "adaptive", "forced_device",
        "fill_ab", "pipeline_host", "pipeline_overlap")
KERNELS = ("scan_eval", "scan_present_packed", "scan_present_packed2", "site_eval",
           "dbg_extend", "fill_count", "fill_promote")

# the bench run as a subprocess; the modules it imported go to stderr
_RUN = """
import json, sys
sys.path.insert(0, {repo!r})
import bench_torch
rc = bench_torch.main(["--device", "cpu"])
print("MODULES " + json.dumps(sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "goldpolish_tpu"))),
    file=sys.stderr)
sys.exit(rc)
"""


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def benches():
    return _load("bench_torch"), _load("bench")


@pytest.fixture(scope="module")
def scenarios(benches):
    port, jax = benches
    n_bases, n_contigs, n_batches = (int(SMALL[k]) for k in (
        "GPTPU_BENCH_BASES", "GPTPU_BENCH_CONTIGS", "GPTPU_BENCH_BATCHES"))
    return (port.build_scenario(n_bases, n_contigs, n_batches),
            jax.build_scenario(n_bases, n_contigs, n_batches))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run many small torch ops; one intra-op thread
    keeps the suite's parallel workers from oversubscribing the cores (the
    subprocess run gets OMP_NUM_THREADS=1 for the same reason)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_bench_line_on_cpu():
    env = {**os.environ, **SMALL, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    env.pop("GPTPU_BENCH_BACKEND", None)
    res = subprocess.run([sys.executable, "-c", _RUN.format(repo=REPO)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert not [k for k in KEYS if k not in line]
    assert "partial" not in line
    assert line["metric"] == "polished_bases_per_sec_chip"
    assert line["unit"] == "bases/s/chip"
    assert line["recovered"] is True
    assert line["platform"] == "cpu"
    assert set(line["arms"]) == {"baseline_1t", "host_all", "adaptive", "forced_device"}
    assert line["value"] > 0 and line["pipeline_rate"] > 0 and line["noisy_rate"] > 0
    assert line["fill"]["device_superset_of_host"] is True
    assert line["fill"]["overlap_fills"]["dev"] + line["fill"]["overlap_fills"]["host"] == 2
    # one class per k; 100 kbp batches are below the A/B's sampling gate
    assert sorted(line["locks"]) == ["k28/h4/cpu/bf_bytes_bitlen20/grain8",
                                     "k32/h4/cpu/bf_bytes_bitlen20/grain8"]
    # the plain versions ran: no kernel launched on the CPU
    assert sorted(line["kernel_launches"]) == sorted(ARMS)
    assert all(sorted(c) == sorted(KERNELS) and not any(c.values())
               for c in line["kernel_launches"].values())
    modules = [ln for ln in res.stderr.splitlines() if ln.startswith("MODULES ")]
    assert modules and json.loads(modules[-1][len("MODULES "):]) == []


def test_scenario_equals_bench_py(scenarios):
    port, jax = scenarios
    assert len(port) == len(jax) == 2
    for pb, jb in zip(port, jax):
        assert pb.truths == jb.truths
        assert pb.drafts == jb.drafts
        assert pb.reads == jb.reads
        assert (pb.n_err, pb.read_bases, pb.bf_bytes) == (jb.n_err, jb.read_bases, jb.bf_bytes)


def _words(batch) -> list[bytes]:
    return [np.asarray(bf.array, np.uint8).tobytes() for bf in batch.bfs]


def test_fill_host_equals_bench_py(scenarios):
    for pb, jb in zip(*scenarios):
        pb.fill_host()
        jb.fill_host()
        assert _words(pb) == _words(jb)
        assert any(np.frombuffer(w, np.uint8).any() for w in _words(pb))


def test_fill_device_equals_bench_py(scenarios):
    pb, jb = scenarios[0][0], scenarios[1][0]
    pb.fill_device("cpu")
    jb.fill_device()
    assert _words(pb) == _words(jb)
    # the device fill's documented superset of the host fill
    host = type(pb)(pb.truths)
    host.fill_host()
    for hw, dw in zip(_words(host), _words(pb)):
        h, d = np.frombuffer(hw, np.uint8), np.frombuffer(dw, np.uint8)
        assert h.any() and not (h & ~d).any()


@pytest.mark.parametrize("backend", ["numpy", "hybrid"])
def test_chain_equals_bench_py(benches, scenarios, backend):
    port_mod, jax_mod = benches
    port, jax = scenarios
    for pb, jb in zip(port, jax):
        pb.fill_host()
        jb.fill_host()
    want = jax_mod._chain_fn(jax_mod.engines_for(jax, "numpy"), jax, procs=1)()
    got = port_mod._chain_fn(port_mod.engines_for(port, backend, "cpu"), port, procs=1,
                             force_device=backend == "hybrid")()
    assert got == want
    assert b"".join(got[0]).upper() == b"".join(t for b in port for t in b.truths)


def test_failed_device_fill_fails_the_overlap_stream(benches, monkeypatch):
    """The device claims the last batch; its fill fails: the stream
    raises, and that batch is never filled on the host."""
    bench = benches[0]
    batches = bench.build_scenario(40_000, 4, 4)
    claimed, host_filled = [], []
    fill_host = bench.Batch.fill_host

    def failing_fill(self, device="cuda"):
        claimed.append(batches.index(self))
        raise RuntimeError("device fill failed")

    def recorded_fill(self):
        host_filled.append(batches.index(self))
        return fill_host(self)

    monkeypatch.setattr(bench.Batch, "fill_device", failing_fill)
    monkeypatch.setattr(bench.Batch, "fill_host", recorded_fill)
    with pytest.raises(RuntimeError, match="device fill failed"):
        bench._pipeline_stream(batches, 1, "overlap", "hybrid", device="cpu")
    assert claimed == [3]
    assert 3 not in host_filled


def test_cuda_without_cuda_raises(benches):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the no-CUDA refusal cannot show")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        benches[0].main(["--device", "cuda"])


def test_device_profile_of_a_pass(benches, tmp_path):
    """GPTPU_PROFILE's pass: a traced chain pass gives its wall, the
    device's busy time and idle share, and writes its trace (on the CPU no
    CUDA event: busy 0, idle share 1)."""
    trace = str(tmp_path / "pass.json")
    prof = benches[0]._device_profile(lambda: sum(range(1000)), "cpu", trace)
    assert os.path.getsize(trace) > 0
    assert prof["wall_s"] > 0 and prof["events"] == 0
    assert prof["device_busy_ms"] == 0 and prof["idle_share"] == 1
    assert prof["device_ms_by_kernel"] == {}
