"""Shared arithmetic of the per-layer readers: sums of the port's per-batch
timings (run_bulk's totals["timing"]) over the window's jobs, per draft Mbp."""

from __future__ import annotations


def timing_sum(record, *keys: str) -> float | None:
    """Sum of the given per-batch timing keys over every run_bulk call of
    every job, or None when no call recorded any of them."""
    total, seen = 0.0, False
    for job in record.jobs:
        for _t0, _t1, totals in job.bulk:
            timing = totals.get("timing", {})
            for k in keys:
                if k in timing:
                    total += timing[k]
                    seen = True
    return total if seen else None


def per_mbp(record, seconds: float | None) -> float | None:
    if seconds is None or not record.jobs:
        return None
    return seconds / (len(record.jobs) * record.draft_bp / 1e6)
