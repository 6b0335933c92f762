"""Shared arithmetic of the readers of the port's own spans: run_bulk's
totals["trace"] (goldpolish_tpu_torch/utils/trace.py: (name, start, end,
attrs), Unix-epoch nanoseconds, the clock of the profiler's CUDA events),
summed per draft Mbp or laid against the device's busy intervals.  A
program without the spans (no "trace" in its totals) gives nothing to
read."""

from __future__ import annotations

from ._common import per_mbp


def runs(record):
    """The span list of every run_bulk call of every job that has one."""
    for job in record.jobs:
        for _t0, _t1, totals in job.bulk:
            trace = totals.get("trace") if isinstance(totals, dict) else None
            if trace and trace.get("clock") == "unix_ns":
                yield trace["spans"]


def intervals(spans, *names: str) -> list[tuple[int, int]]:
    return [(a, b) for n, a, b, _attrs in spans if n in names]


def span_sum_per_mbp(record, name: str) -> float | None:
    """The summed durations of every `name` span, in seconds per draft Mbp;
    None where no run recorded one."""
    total, seen = 0, False
    for spans in runs(record):
        for a, b in intervals(spans, name):
            total += b - a
            seen = True
    return per_mbp(record, total / 1e9) if seen else None


def union(ivs) -> list[tuple[int, int]]:
    """The union of intervals, in order."""
    out: list[list[int]] = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intersect(xs, ys) -> list[tuple[int, int]]:
    """The intersection of two unions (ordered, disjoint)."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs, ys) -> list[tuple[int, int]]:
    """xs less ys, both unions (ordered, disjoint)."""
    out = []
    for a, b in xs:
        for c, d in ys:
            if d <= a or c >= b:
                continue
            if c > a:
                out.append((a, c))
            a = max(a, d)
            if a >= b:
                break
        if a < b:
            out.append((a, b))
    return out


def length(ivs) -> int:
    return sum(b - a for a, b in ivs)
