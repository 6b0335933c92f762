"""A small cell end to end on the CPU, through the benchmark's command: the
last line of standard output is the result object, the window holds whole
jobs, and the rate is all the draft bases over all the window's time."""

import json
import os
import re
import subprocess
import sys

from gpbench import generate, harness

from ._tiny import ROOT_DIR, TINY, run_cell


def run(*args, timeout=600):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, os.path.join(ROOT_DIR, "gpbench", "run.py"),
                           *args], capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=ROOT_DIR)


def test_cell_end_to_end_and_window(tmp_path):
    p = run("--workload", "ecoli_bulk.ont_draft", "--seed", str(2**31 + 99),
            "--seconds", "1.5", "--trace", "0", "--benchmark", TINY, "--device", "cpu")
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(res)[-1] == "check"
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"polished_bp_per_s", "setup_s"}
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}
    # the last lines of standard error: each compared number and its limit
    tail = p.stderr.strip().splitlines()[-len(res["check"]):]
    assert [ln.split()[1] for ln in tail] == list(res["check"])
    # whole jobs: the window closes after the first job that ends past 1.5 s,
    # and the rate is jobs x draft bases over the window's length
    m = re.search(r"window: (\d+) jobs in ([0-9.]+) s", p.stderr)
    jobs, window = int(m.group(1)), float(m.group(2))
    assert jobs == res["attempted"] and window >= 1.5
    cell = harness.load_cell(TINY, "ecoli_bulk.ont_draft")
    draft_bp = generate.generate(2**31 + 99, cell.config["genome_bp"], cell.traffic,
                                 str(tmp_path)).draft_bp
    rate = res["metrics"]["polished_bp_per_s"]["value"]
    assert abs(rate * window - jobs * draft_bp) <= 1e-3 * jobs * draft_bp


def test_no_cuda_no_result():
    p = run("--workload", "ecoli_bulk.ont_draft", "--seed", "1", "--seconds", "1",
            "--benchmark", TINY)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_unknown_cell():
    p = run("--workload", "nope", "--seed", "1", "--seconds", "1",
            "--benchmark", TINY, "--device", "cpu")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_moved_function_stops_the_run(monkeypatch):
    """A wrapped function of the port that is not where the harness looks
    stops the run before the window, by name, with no result line."""
    from goldpolish_tpu_torch.pipeline import bulk

    monkeypatch.delattr(bulk, "build_batch_bfs")
    rc, res, err = run_cell("ecoli_bulk.ont_draft", 2**31 + 42)
    assert rc == 4 and res is None
    assert "port internals moved: goldpolish_tpu_torch.pipeline.bulk.build_batch_bfs" in err


def test_a_missing_capture_stops_the_run(monkeypatch):
    """Where the port no longer calls a wrapped function through its module
    (so the probe catches no filters), the check says that the capture is
    missing, and does not report the filters as wrong."""
    inner = harness.Probe._patch

    def bound_at_import(self, owner, name, wrapper):
        if name != "build_batch_bfs":
            inner(self, owner, name, wrapper)

    monkeypatch.setattr(harness.Probe, "_patch", bound_at_import)
    rc, res, err = run_cell("ecoli_bulk.ont_draft", 2**31 + 43)
    assert rc == 4 and res is None
    assert "capture missing: port internals moved" in err
    assert "bulk.build_batch_bfs" in err
