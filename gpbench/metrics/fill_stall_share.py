"""Share of run_bulk's time in which the job stalls on its fill: no CUDA
event runs, a batch waits for its filters (a fill.wait span is open), and
no batch edits or seals (no edit or seal span is open).  The port's spans
(pipeline.bulk) on the clock of the profiler's events; nothing to read
without a trace."""

from ._spans import intersect, intervals, length, runs, subtract, union


def read(record):
    if record.trace is None:
        return None
    busy = union((a, a + d) for _n, a, d in record.trace["events"])
    stall = window = 0
    for spans in runs(record):
        run = union(intervals(spans, "bulk.run"))
        waits = union(intervals(spans, "fill.wait"))
        if not run or not waits:
            continue
        working = union(intervals(spans, "edit", "seal"))
        stall += length(subtract(subtract(intersect(waits, run), working), busy))
        window += length(run)
    return 100.0 * stall / window if window else None
