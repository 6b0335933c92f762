"""The port's tracer (goldpolish_tpu_torch/utils/trace.py) and the spans
run_bulk records: one of each per batch, in order, with the batch's
identity, and the stage timings equal to their durations.

The bulk cases run the 4-contig synthetic draft of
tests/test_torch_pipeline.py on the CPU (hybrid on device="cpu", the
default chain) and hold the output to the JAX package's bytes; the JAX
package is imported inside them, so the `cuda` case, which holds the
exported clock to torch.profiler's CUDA events, also runs where jax is not
installed (`pytest --noconftest -m cuda`)."""

import os
import threading
import time

import pytest
import torch

from goldpolish_tpu_torch.config import PipelineConfig
from goldpolish_tpu_torch.pipeline import bulk
from goldpolish_tpu_torch.utils import trace

PER_BATCH = ("fill.queued", "fill.reads", "fill.build", "fill.wait", "edit", "seal",
             "batch.write")


def _inputs(tmp_path):
    from test_pipeline import _write_synthetic

    draft, reads, paf, _truths = _write_synthetic(tmp_path, n_contigs=4)
    return dict(seqs_to_polish=draft, polishing_seqs=reads, k_values=[32, 28],
                batch_size=1, mappings_path=paf, workspace=str(tmp_path),
                max_concurrent_batches=4)


def _run(tmp_path, name, monkeypatch=None, **kw):
    """run_bulk with the port's config; each batch's stats by its first id."""
    stats = {}
    if monkeypatch is not None:
        inner, lock = bulk.polish_batch_records, threading.Lock()

        def kept(records, *a, **k):
            res = inner(records, *a, **k)
            with lock:
                stats[records[0][0].split()[0]] = res.stats
            return res

        monkeypatch.setattr(bulk, "polish_batch_records", kept)
    out = str(tmp_path / f"{name}.fa")
    totals = bulk.run_bulk(PipelineConfig(output_seqs=out, **kw))
    with open(out, "rb") as f:
        return totals, stats, f.read()


def _by(spans, name):
    return [s for s in spans if s[0] == name]


def _rounded(span) -> float:
    return round((span[2] - span[1]) / 1e9, 3)


def test_bulk_spans_per_batch_lookahead(tmp_path, monkeypatch):
    """Lookahead fill, 4 batches, 4 slots: every batch's spans once each
    and in order, fill.queued > 0, and every timing key the rounded
    duration of its span; the output is the JAX package's."""
    from goldpolish_tpu.config import PipelineConfig as JaxConfig
    from goldpolish_tpu.pipeline import bulk as jax_bulk

    common = _inputs(tmp_path)
    want = str(tmp_path / "jax.fa")
    jax_bulk.run_bulk(JaxConfig(output_seqs=want, backend="numpy", **common))
    totals, stats, got = _run(tmp_path, "port", monkeypatch, lookahead_fill=True,
                              device="cpu", **common)
    with open(want, "rb") as f:
        assert got == f.read()
    tr = totals["trace"]
    assert tr["clock"] == "unix_ns"
    spans = tr["spans"]
    for name in PER_BATCH:
        assert sorted(s[3]["batch"] for s in _by(spans, name)) == [0, 1, 2, 3], name
        assert all(s[3]["bases"] > 0 for s in _by(spans, name)), name
    placed = sorted((s[3]["batch"], s[3]["k"]) for s in _by(spans, "edit.k"))
    assert placed == [(b, k) for b in range(4) for k in (28, 32)]
    assert all(s[3]["placement"] in ("device", "host") for s in _by(spans, "edit.k"))
    assert {s[3]["where"] for s in _by(spans, "fill.build")} == {"host"}
    one = {name: {s[3]["batch"]: s for s in _by(spans, name)} for name in PER_BATCH}
    for b in range(4):
        assert one["fill.queued"][b][2] <= one["fill.build"][b][1]
        assert one["fill.build"][b][1] <= one["fill.reads"][b][1]
        assert one["fill.wait"][b][2] <= one["edit"][b][1]
        assert one["edit"][b][2] <= one["seal"][b][1] <= one["batch.write"][b][1]
    assert sum(s[2] - s[1] for s in _by(spans, "fill.queued")) > 0
    (run,) = _by(spans, "bulk.run")
    (setup,) = _by(spans, "bulk.setup")
    assert run[1] <= setup[1] and max(s[2] for s in spans) == run[2]
    # the timings are the spans' durations
    assert len(stats) == 4
    for b, key in enumerate(sorted(stats)):
        timing = stats[key]
        assert timing["timing"] == {
            "bf_build_s": 0.0, "ntedit_s": _rounded(one["edit"][b]),
            "sealer_s": _rounded(one["seal"][b]),
            "bf_fill_bg_s": _rounded(one["fill.build"][b])}
    t = totals["timing"]
    assert t["wall_s"] == _rounded(run) and t["setup_s"] == _rounded(setup)
    for key, name in (("ntedit_s", "edit"), ("sealer_s", "seal"),
                      ("bf_fill_bg_s", "fill.build")):
        assert t[key] == round(sum(_rounded(s) for s in _by(spans, name)), 3)


def test_bulk_spans_inline_fill(tmp_path, monkeypatch):
    """Without the lookahead each batch fills inside polish_batch_records:
    no fill.queued, a fill.wait from its slot to its filters in hand, and
    bf_build_s the inline fill.build's duration."""
    totals, stats, _out = _run(tmp_path, "inline", monkeypatch, lookahead_fill=False,
                               backend="numpy", **_inputs(tmp_path))
    spans = totals["trace"]["spans"]
    assert _by(spans, "fill.queued") == []
    builds = {s[3]["batch"]: s for s in _by(spans, "fill.build")}
    waits = {s[3]["batch"]: s for s in _by(spans, "fill.wait")}
    assert sorted(builds) == sorted(waits) == [0, 1, 2, 3]
    for b in range(4):
        assert waits[b][1] <= builds[b][1] and waits[b][2] == builds[b][2]
    assert {s[3]["placement"] for s in _by(spans, "edit.k")} == {"host"}
    by_batch = dict(zip(sorted(stats), range(4)))
    for key, b in by_batch.items():
        assert stats[key]["timing"]["bf_build_s"] == _rounded(builds[b])
        assert "bf_fill_bg_s" not in stats[key]["timing"]


@pytest.mark.parametrize("k_values", [[32, 28], [47]])
def test_seal_span_counts_native_searches(tmp_path, k_values):
    """The seal span's searches (every k round's pairs) and native (those
    the native round took): all of them at k <= 32, none at k = 47, and
    the spans line says so."""
    from goldpolish_tpu_torch.io import fasta

    common = {**_inputs(tmp_path), "k_values": k_values}
    # an n gap in each contig, so that every batch searches
    recs = list(fasta.read_seqs(common["seqs_to_polish"]))
    fasta.write_fasta(common["seqs_to_polish"], [
        fasta.SeqRecord(r.id, r.comment, r.seq[:1400] + "n" * 60 + r.seq[1460:])
        for r in recs])
    totals, _stats, _out = _run(tmp_path, "seal", backend="numpy", **common)
    seals = _by(totals["trace"]["spans"], "seal")
    assert len(seals) == 4
    searches = sum(s[3]["searches"] for s in seals)
    native = sum(s[3]["native"] for s in seals)
    assert searches >= 4 * len(k_values)
    assert native == (searches if max(k_values) <= 32 else 0)
    assert trace.summary(totals["trace"]["spans"]).endswith(
        f" | seal native={native} of {searches}")


def test_process_pool_workers_record_nothing(tmp_path):
    """Fork-pool workers time their stages but record no span: the parent's
    trace has the run's own spans and each batch's write."""
    totals, _stats, _out = _run(tmp_path, "pool", backend="numpy", process_pool=True,
                                **_inputs(tmp_path))
    names = {s[0] for s in totals["trace"]["spans"]}
    assert names == {"bulk.run", "bulk.setup", "batch.write"}
    assert totals["timing"]["ntedit_s"] > 0 and totals["timing"]["sealer_s"] > 0


def test_spans_outside_a_collector_record_nothing_and_time_themselves():
    with trace.span("alone") as sp:
        time.sleep(0.002)
    assert sp.seconds >= 0.002
    trace.record("alone", 0, 1)
    with trace.collect() as col:
        pass
    assert col.export()["spans"] == []


def test_export_is_on_the_unix_clock_and_tags_apply():
    before = time.time_ns()
    with trace.collect() as col:
        with trace.tags(batch=3, bases=10):
            with trace.span("a", k=32) as sp:
                sp.attrs["placement"] = "host"
            trace.record("b", sp.t0, sp.t1, extra=1)
        with trace.span("c"):
            pass
    after = time.time_ns()
    (a, b, c) = col.export()["spans"]
    assert a[0] == "a" and a[3] == {"batch": 3, "bases": 10, "k": 32, "placement": "host"}
    assert b[3] == {"batch": 3, "bases": 10, "extra": 1} and c[3] == {}
    assert before <= a[1] <= a[2] <= c[1] <= c[2] <= after
    assert (a[1], a[2]) == (b[1], b[2])


def test_a_span_lands_in_the_collectors_open_at_both_ends():
    """Nested collectors both get a span closed inside both; one that
    closed meanwhile gets nothing; a thread's span lands too."""
    with trace.collect() as outer:
        with trace.collect() as inner:
            with trace.span("both"):
                pass
            th = threading.Thread(target=lambda: trace.span("thread").__enter__().__exit__())
            th.start()
            th.join(timeout=10)
            assert not th.is_alive()
        late = trace.span("late").__enter__()
    with trace.collect() as after:
        late.__exit__()
    assert [s[0] for s in outer.export()["spans"]] == ["both", "thread"]
    assert [s[0] for s in inner.export()["spans"]] == ["both", "thread"]
    assert after.export()["spans"] == []


def test_a_forked_child_records_nothing(tmp_path):
    """The fork hook empties the child's collectors: a span the child closes
    is not in the parent's copy, nor in the child's."""
    if not hasattr(os, "fork"):
        pytest.skip("no fork here")
    out = tmp_path / "child"
    with trace.collect() as col:
        pid = os.fork()
        if pid == 0:
            with trace.span("child"):
                pass
            out.write_text(str(len(col.spans)))
            os._exit(0)
        os.waitpid(pid, 0)
    assert out.read_text() == "0"
    assert col.export()["spans"] == []


def test_summary_line():
    spans = [("edit.k", 0, 2_000_000, {"k": 32, "placement": "device"}),
             ("edit.k", 0, 1_000_000, {"k": 32, "placement": "host"}),
             ("edit.k", 0, 1_000_000, {"k": 28, "placement": "host"}),
             ("seal", 5, 5 + 3_000_000, {})]
    assert trace.summary(spans) == (
        "edit.k n=3 sum=0.004s max=0.002s; seal n=1 sum=0.003s max=0.003s"
        " | placement k=32 device=1 host=1; k=28 device=0 host=1")
    assert trace.summary([]) == ""


def test_summary_line_seal_counts():
    """The seals' searches and those the native round took, summed."""
    spans = [("seal", 0, 1_000_000, {"searches": 10, "native": 10}),
             ("seal", 0, 1_000_000, {"searches": 5, "native": 3})]
    assert trace.summary(spans) == (
        "seal n=2 sum=0.002s max=0.001s | seal native=13 of 15")


def test_summary_line_fill_workers():
    """Per run its fill workers; the fills that started beside another."""
    spans = [("bulk.run", 0, 1_000_000, {"fill_workers": 2}),
             ("fill.build", 0, 1_000_000, {"where": "host", "inflight": 1}),
             ("fill.build", 0, 1_000_000, {"where": "host", "inflight": 2})]
    assert trace.summary(spans) == (
        "bulk.run n=1 sum=0.001s max=0.001s; fill.build n=2 sum=0.002s max=0.001s"
        " | fill workers=2 overlapped=1 of 2")


@pytest.mark.cuda
def test_cuda_kernel_lies_inside_its_span():
    """A kernel launched inside a span lies inside the span's exported
    interval in torch.profiler's CUDA trace (CUDA activity alone, as
    gpbench/harness.py traces), and the exported clock agrees within 1 ms
    with the harness's own alignment (a marker kernel, then the host's
    monotonic clock after a synchronize)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 26, device="cuda")
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    marker = torch.ones(1, device="cuda")
    marker.add_(1)
    torch.cuda.synchronize()
    marker_host = time.monotonic()
    with trace.collect() as col:
        time.sleep(0.02)
        with trace.span("launch"):
            x.mul_(3)
            torch.cuda.synchronize()
        time.sleep(0.02)
    prof.stop()
    # the marker's fill and add, then the kernel
    events = sorted(((e.name(), e.start_ns(), e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA), key=lambda e: e[1])
    assert len(events) == 3, events
    (_m, m0, md), (_k, k0, kd) = events[1], events[2]
    (_n, s0, s1, _a), = col.export()["spans"]
    assert s0 <= k0 and k0 + kd <= s1, (events, s0, s1)
    # the harness's alignment: device ns -> host monotonic seconds
    to_host = marker_host + (k0 - (m0 + md)) / 1e9
    (_n, r0, _r1, _a), = col.spans
    assert abs((k0 - s0) / 1e9 - (to_host - r0 / 1e9)) < 1e-3, (events, s0, r0, marker_host)
