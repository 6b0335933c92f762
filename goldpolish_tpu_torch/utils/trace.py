"""Spans of a run at batch and stage grain, on the profiler's clock.

A run opens a Collector (pipeline.bulk.run_bulk opens one and returns its
spans as totals["trace"]).  While it is open, every span that closes in
this process, on any thread, lands in it as (name, start, end, attrs).  A
span records only into the collectors that were open when it started and
are still open when it ends.

Every span times itself with time.monotonic_ns(), whether or not a
collector is open: the pipeline's stats["timing"] are span durations.
Outside an open collector a span costs that one check and records
nothing.  There is no switch: spans sit at batch and stage grain only (a
job makes a few hundred), never inside a per-read, per-window, per-site or
per-k-mer loop.

A collector exports its spans in Unix-epoch nanoseconds, the clock on
which torch.profiler gives its CUDA events, through one anchor pair
(time.time_ns(), time.monotonic_ns()) taken when it opens.

tags(**attrs) gives every span that the calling thread closes meanwhile
those attributes (the batch's index and bases, on the threads that fill
and polish it).

A forked process (the --process-pool workers) starts with no open
collector: its spans record nothing.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

now = time.monotonic_ns

_lock = threading.Lock()
_open: list[Collector] = []
_local = threading.local()


def _forget() -> None:
    global _lock
    _lock = threading.Lock()
    _open.clear()


os.register_at_fork(after_in_child=_forget)


class Collector:
    """The spans of one run; export() gives them on the Unix clock."""

    def __init__(self):
        self.spans: list[tuple] = []
        self.closed = False
        self._offset = time.time_ns() - time.monotonic_ns()

    def export(self) -> dict:
        with _lock:
            spans = list(self.spans)
        off = self._offset
        return {"clock": "unix_ns",
                "spans": [(n, a + off, b + off, attrs) for n, a, b, attrs in spans]}


@contextlib.contextmanager
def collect():
    """Open a collector for the block: every span closed meanwhile lands in it."""
    col = Collector()
    with _lock:
        _open.append(col)
    try:
        yield col
    finally:
        with _lock:
            _open.remove(col)
            col.closed = True


@contextlib.contextmanager
def tags(**attrs):
    """Attributes of every span the calling thread closes within the block."""
    old = getattr(_local, "tags", {})
    _local.tags = {**old, **attrs}
    try:
        yield
    finally:
        _local.tags = old


def _add(cols, name: str, t0: int, t1: int, attrs: dict) -> None:
    rec = (name, t0, t1, {**getattr(_local, "tags", {}), **attrs})
    with _lock:
        for col in cols:
            if not col.closed:
                col.spans.append(rec)


def record(name: str, t0: int, t1: int, **attrs) -> None:
    """A span whose ends were taken apart (now() values), e.g. on two
    threads, recorded into the collectors open now."""
    if _open:
        _add(tuple(_open), name, t0, t1, attrs)


class span:
    """Times its block: `seconds` once it ends.  The block may add to
    `attrs` (a decision taken inside it)."""

    __slots__ = ("name", "attrs", "t0", "t1", "_cols")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> span:
        self._cols = tuple(_open) if _open else ()
        self.t0 = now()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = now()
        if self._cols:
            _add(self._cols, self.name, self.t0, self.t1, self.attrs)

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


def summary(spans) -> str:
    """Per span name its count, sum and max in seconds; per k the batches
    whose edit ran its scan on the device and on the host."""
    by_name: dict[str, list[float]] = {}
    placed: dict[int, dict[str, int]] = {}
    for name, t0, t1, attrs in spans:
        by_name.setdefault(name, []).append((t1 - t0) / 1e9)
        if name == "edit.k":
            per_k = placed.setdefault(attrs["k"], {"device": 0, "host": 0})
            per_k[attrs["placement"]] += 1
    parts = [f"{n} n={len(d)} sum={sum(d):.3f}s max={max(d):.3f}s"
             for n, d in sorted(by_name.items())]
    where = [f"k={k} device={p['device']} host={p['host']}"
             for k, p in sorted(placed.items(), reverse=True)]
    return "; ".join(parts) + (" | placement " + "; ".join(where) if where else "")
