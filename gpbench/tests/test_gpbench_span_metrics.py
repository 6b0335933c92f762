"""The readers of the port's own spans (run_bulk's totals["trace"]) on
canned records, by hand, and on one tiny CPU job through harness.Runner."""

import pytest

from gpbench import harness
from gpbench.metrics import (_spans, fill_queue_s_per_mbp, fill_reads_s_per_mbp,
                             fill_stall_share, port_fill_wait_s_per_mbp,
                             scan_wait_s_per_mbp)

from ._tiny import TINY

HOST_ONLY = (fill_queue_s_per_mbp, fill_reads_s_per_mbp, port_fill_wait_s_per_mbp,
             scan_wait_s_per_mbp)
S = 1_000_000_000  # ns in a second
T = 1_700_000_000 * S  # a Unix time, as the port exports


def span(name, a, b, **attrs):
    return (name, T + int(a * S), T + int(b * S), attrs)


def totals(*spans):
    return {"timing": {}, "trace": {"clock": "unix_ns", "spans": list(spans)}}


def record(runs, events=None, draft_bp=2_000_000):
    """One job per run_bulk totals; `events` (name, start s, duration s)
    make the device trace."""
    jobs = [harness.Job(t0=0, t1=1, bulk=[(0, 1, t)]) for t in runs]
    trace = None
    if events is not None:
        trace = {"busy_s": 0, "window_s": 1,
                 "events": [(n, T + int(a * S), int(d * S)) for n, a, d in events]}
    cell = harness.Cell("c", 1, {"mode": "bulk"}, {}, [])
    return harness.RunRecord(cell, jobs, draft_bp, trace, {}, "card")


# two batches on one fill thread: batch 1 queues behind batch 0's fill, and
# its wait overlaps batch 0's edit and seal
TWO = totals(
    span("bulk.run", 0, 10), span("bulk.setup", 0, 1),
    span("fill.queued", 1, 1.5, batch=0), span("fill.queued", 1, 4, batch=1),
    span("fill.reads", 1.5, 2, batch=0), span("fill.reads", 4, 4.25, batch=1),
    span("fill.build", 1.5, 4, batch=0), span("fill.build", 4, 7, batch=1),
    span("fill.wait", 1, 4, batch=0), span("fill.wait", 1, 7, batch=1),
    span("edit", 4, 5, batch=0), span("seal", 5, 6, batch=0),
    span("edit", 7, 8, batch=1), span("seal", 8, 9, batch=1),
    span("edit.k", 4, 4.5, batch=0, k=32, placement="device", locked=False),
    span("scan.wait", 4.1, 4.2, batch=0), span("scan.wait", 4.3, 4.35, batch=0),
    span("batch.write", 6, 6.1, batch=0), span("batch.write", 9, 9.1, batch=1))


def test_span_sums_by_hand():
    # two jobs of 2 Mbp: 4 draft Mbp
    r = record([TWO, TWO])
    assert fill_queue_s_per_mbp.read(r) == pytest.approx(2 * 3.5 / 4)
    assert fill_reads_s_per_mbp.read(r) == pytest.approx(2 * 0.75 / 4)
    assert port_fill_wait_s_per_mbp.read(r) == pytest.approx(2 * 9 / 4)
    assert scan_wait_s_per_mbp.read(r) == pytest.approx(2 * 0.15 / 4)


def test_stall_share_by_hand():
    # waits cover [1, 7); edit and seal [4, 6): the stall is [1, 4) + [6, 7)
    # = 4 s of a 10 s run; a device event in [2, 2.5) takes 0.5 s off it, and
    # one inside the seal takes nothing
    r = record([TWO], events=[("k", 2, 0.5), ("k", 5.2, 0.1)])
    assert fill_stall_share.read(r) == pytest.approx(35.0)
    assert fill_stall_share.read(record([TWO], events=[])) == pytest.approx(40.0)


def test_stall_share_over_jobs_and_overlapping_events():
    # a second run with its waits all under edits reads 0 stall; the share
    # is over both runs' windows
    calm = totals(span("bulk.run", 20, 30), span("fill.wait", 21, 22, batch=0),
                  span("edit", 20.5, 23, batch=1))
    r = record([TWO, calm], events=[("a", 2, 0.5), ("b", 2.25, 0.5)])
    assert fill_stall_share.read(r) == pytest.approx(100 * (4 - 0.75) / 20)


def test_none_without_spans_or_trace():
    old = {"timing": {"bf_fill_bg_s": 1.0}}  # a program without the tracer
    for r in (record([old]), record([old], events=[("k", 0, 1)]),
              record([totals(span("bulk.run", 0, 1))], events=[])):
        for reader in (*HOST_ONLY, fill_stall_share):
            assert reader.read(r) is None, reader.__name__
    assert fill_stall_share.read(record([TWO])) is None  # no device trace
    assert fill_queue_s_per_mbp.read(record([TWO])) is not None


def test_interval_arithmetic():
    assert _spans.union([(5, 6), (0, 2), (1, 3), (3, 4), (7, 7)]) == [(0, 4), (5, 6)]
    xs, ys = [(0, 10), (20, 30)], [(2, 3), (5, 22), (25, 26), (29, 40)]
    assert _spans.intersect(xs, ys) == [(2, 3), (5, 10), (20, 22), (25, 26), (29, 30)]
    assert _spans.subtract(xs, ys) == [(0, 2), (3, 5), (22, 25), (26, 29)]
    assert _spans.length(_spans.subtract(xs, [])) == 20


def test_tiny_cpu_job_yields_the_host_metrics(tmp_path, monkeypatch):
    """One job of the tiny bulk cell through harness.Runner and its probe,
    the scans forced onto the device pipe (the plain torch scan on the
    CPU): every host-only reader finds its spans; the stall share needs a
    device trace."""
    monkeypatch.setenv("GPTPU_FORCE_DEVICE_SCAN", "1")
    cell = harness.load_cell(TINY, "ecoli_bulk.ont_draft")
    runner = harness.Runner(cell, 2**31 + 7, "cpu", str(tmp_path))
    runner.generate()
    probe = harness.Probe(runner.sample, shapes=False)
    probe.install()
    try:
        job = runner.run_job(probe)
    finally:
        probe.uninstall()
    assert not job.error, job.error
    r = harness.RunRecord(cell, [job], runner.draft_bp, None, {}, "cpu")
    values = {m.__name__.split(".")[-1]: m.read(r) for m in HOST_ONLY}
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert values["fill_queue_s_per_mbp"] > 0 and values["fill_reads_s_per_mbp"] > 0
    assert fill_stall_share.read(r) is None
