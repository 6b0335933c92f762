"""The per-layer readers on a canned run record, the trace arithmetic on
canned events, and kernel 4's byte and operation count by hand."""

import pytest

from gpbench import harness
from gpbench.kernels import scan_eval
from gpbench.metrics import (device_idle_share, fill_s_per_mbp, fill_wait_s_per_mbp,
                             ntedit_s_per_mbp, scan_eval_roofline, sealer_s_per_mbp,
                             targeted_s_per_job)

PEAK = {"hbm_bytes_per_s": 3.35e12, "scalar_ops_per_s": 67e12}


def job(t0, t1, bulk, worker_start=None, polish=None, calls=()):
    j = harness.Job(t0=t0, t1=t1, bulk=bulk)
    j.worker_start = worker_start or {}
    j.polish = polish or {}
    j.scan_eval = list(calls)
    return j


def record(jobs, trace=None, mode="bulk"):
    cell = harness.Cell("c", 1, {"mode": mode}, {}, [])
    return harness.RunRecord(cell, jobs, 2_000_000, trace, {"card": PEAK}, "card")


TIMING = {"timing": {"bf_fill_bg_s": 3.0, "bf_build_s": 0.5, "ntedit_s": 1.0,
                     "sealer_s": 0.25}}


def test_timing_readers():
    jobs = [job(0, 10, [(1, 9, TIMING)]), job(10, 20, [(11, 19, TIMING)])]
    r = record(jobs)
    # per draft Mbp of each job: 2 jobs x 2 Mbp
    assert fill_s_per_mbp.read(r) == pytest.approx(7.0 / 4)
    assert ntedit_s_per_mbp.read(r) == pytest.approx(2.0 / 4)
    assert sealer_s_per_mbp.read(r) == pytest.approx(0.5 / 4)
    assert targeted_s_per_job.read(r) is None
    assert targeted_s_per_job.read(record(jobs, mode="target")) == pytest.approx(2.0)


def test_readers_without_their_layer():
    r = record([job(0, 1, [(0, 1, {"timing": {"ntedit_s": 1.0}})])])
    assert sealer_s_per_mbp.read(r) is None
    assert fill_wait_s_per_mbp.read(r) is None
    assert device_idle_share.read(r) is None
    assert scan_eval_roofline.read(r) is None


def test_fill_wait():
    a, b = ("ctg0",), ("ctg1",)
    j = job(0, 10, [(0, 10, TIMING)], worker_start={a: 1.0, b: 1.0},
            polish={a: (3.0, 5.0, 0.0), b: (6.5, 8.0, 0.25)})
    # 2 s + (5.5 s + 0.25 s inline) over 2 Mbp
    assert fill_wait_s_per_mbp.read(record([j])) == pytest.approx(7.75 / 2)


def test_trace_arithmetic():
    # two overlapping kernels and one apart: busy 3 + 1 ms in a 1 s window
    ev = [("se_tile", 0, 2_000_000), ("se_sites", 1_000_000, 2_000_000),
          ("memcpy", 10_000_000, 1_000_000)]
    assert harness.busy_intervals(ev) == [(0, 3_000_000), (10_000_000, 11_000_000)]
    s = harness.trace_summary(ev, [], 100.0, 101.0, 2_000_000, 100.002)
    assert s["busy_s"] == pytest.approx(0.004)
    assert s["window_s"] == pytest.approx(1.0)
    assert sum(v for _k, v in s["idle_gaps"]) == pytest.approx(0.996)
    assert s["device_ops"][0][0] == "se_tile" and s["device_ops"][0][1] == pytest.approx(0.002)
    r = record([job(100, 101, [])], trace=s)
    assert device_idle_share.read(r) == pytest.approx(99.6)


def test_scan_eval_work_by_hand():
    call = {"rows": 4, "cols": 1000 + 31, "k": 32, "h": 4, "bits": 1 << 25,
            "s_max": 4096, "max_del": 5, "combos": 341}
    # reads: 4 x 1031 code bytes + the 4 MiB filter; writes: 4 x 125 packed
    # bytes, the 4-byte head count, 4096 x (4+4+4+5+1+1+341) site slots
    assert scan_eval.work(call) == (4 * 1031 + 4 * 1024 * 1024
                                    + 4 * 125 + 4 + 4096 * 360, 4 * 4 * 1000)
    least = scan_eval.least_seconds(call, PEAK)
    assert least == pytest.approx(scan_eval.work(call)[0] / 3.35e12)
    trace = {"busy_s": 1, "window_s": 2,
             "events": [("void se_tile<4>(...)", 0, int(2 * least * 1e9)),
                        ("other", 0, 10**9)]}
    r = record([job(0, 1, [], calls=[call])], trace=trace)
    assert scan_eval_roofline.read(r) == pytest.approx(50.0, rel=1e-3)
