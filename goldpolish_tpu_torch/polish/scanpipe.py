"""Chunked, lookahead-pipelined device presence scans.

Port counterpart: goldpolish_tpu/polish/scanpipe.py.  The planning is the
same (_plan, the 1, 2, 4 row ramp-up, ROW_WINDOWS = 1 << 19, DEPTH = 2);
the asynchrony is rebuilt for CUDA.

The dense detection scan (a Bloom probe of every draft window) runs on the
device as a short sequence of fixed-shape fused scans (ops/scan_conv),
dispatched ahead of the consumer: while the host walks the hot sites of the
sequences already scanned, the device is already scanning the next call, so
pipeline throughput is max(walk, device scan) instead of host scan + walk.

Packing: every device call has ONE shape [rows, ROW_BYTES].  Each row is a
dense byte stream of SEGMENTS — window ranges of the input jobs — placed
back to back; a segment covering windows [a, b) of a job contributes bytes
[a, b+k-1), so its presence bits are exact and stitch back byte-identically
to a whole-contig scan (window hashes read only their own k bytes; the k-1
windows spanning a segment boundary are sliced off by the segment map).

Asynchrony on CUDA: JAX hands back un-fetched arrays; in torch a pageable
copy or `.cpu()` blocks.  So each pipe owns one CUDA stream per scanner
shard and DEPTH + 2 pinned host staging slots (codes in, outputs back) —
one per call that can be live at once: DEPTH + 1 in flight plus the one
being consumed — each slot holding the whole call's codes and one set of
output buffers per shard.  A call fills its slot's codes (its rows padded
to a multiple of the shard count, as the scanner pads them), then, for
each shard, on that shard's stream copies the shard's rows to its device
(non_blocking), launches the scan, copies the outputs back (non_blocking)
and records an event; the consumer waits on every shard's event of that
call and on nothing else.  Pipes never share a slot, so batches polishing
on several threads (pipeline/bulk.py) cannot overwrite each other's
buffers.

Eval mode (the scanner's fused phase-A eval armed, ops/scan_eval): each
shard runs the fused eval (eval_shard) instead of the plain scan, its
slot holds one pinned buffer per output (nine), all nine copies run on the
shard's stream before its event, and the generator yields (job_id, present,
tables), the tables being the interior sites of the job's segments
(window-relative, the drop rule of the JAX pipe, scanpipe.py:259-291).
With several shards, merge_shards joins a call's outputs as the JAX
pipe's mesh merge does (:223-248).

The 2-bit packed transfer (the JAX pipe's :75-83, :136-153): when the
native packer loads, a call of the plain scan sends each row 2-bit packed
(native.pack2, about a quarter of the bytes) with up to EXC_BUCKET = 256
exceptions per row, and runs kernel 8 (scanner.scan2_shard) on it.  A call
with a row of more exceptions goes raw, as does every call in eval mode,
as in the JAX pipe.  The rows are packed from the call's raw slot into the
slot's pinned packed rows and exception arrays; a pad row (the rows that
only pad a call to the shard count) is packed as 'A' with no exception.

Replaces the reference's one-rolling-probe-per-position inner loop
(reference: subprojects/ntedit/ntedit.cpp:1414-1486) as the production
device scan.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

ROWS = 4
ROW_WINDOWS = 1 << 19  # 512 K windows per row -> 2 M windows per call
DEPTH = 2  # calls in flight beyond the one being consumed


@dataclass
class _Seg:
    job: int
    w0: int     # first window of the job this segment covers
    nw: int     # windows in this segment
    row: int    # row within the call
    off: int    # byte offset within the row


@dataclass
class _Call:
    segs: list[_Seg] = field(default_factory=list)


class _Pending:
    """One dispatched call: each shard's host outputs (numpy), ready once
    every one of `events` is."""

    def __init__(self, outs: list[tuple], events=(), keep=()):
        self._outs = outs
        self._events = events
        self._keep = keep  # device tensors (and scratch) the streams still use

    def result(self) -> list[tuple]:
        for event in self._events:
            event.synchronize()
        self._events = ()
        self._keep = ()
        return self._outs


def merge_shards(shard_outs: list[tuple], nw_row: int) -> tuple:
    """One call's outputs from its shards' (the JAX pipe's mesh merge,
    scanpipe.py:223-248): the packed rows in order and, in eval mode, the
    tables of each shard's valid sites (an ascending prefix of its `site`),
    concatenated, each site index moved from its shard's rows to the
    call's (shard s's row r is the call's row s * rows_per_shard + r)."""
    if len(shard_outs) == 1:
        return shard_outs[0]
    packed = np.concatenate([o[0] for o in shard_outs])
    if len(shard_outs[0]) == 1:
        return (packed,)
    rows_per = shard_outs[0][0].shape[0]
    cols: list[list] = [[] for _ in range(7)]
    for sh, o in enumerate(shard_outs):
        site = o[2]
        valid = site[site >= 0]
        cols[0].append(valid + sh * rows_per * nw_row)
        for col, table in zip(cols[1:], o[3:]):
            col.append(table[: len(valid)])
    n_sites = sum(int(o[1]) for o in shard_outs)
    return (packed, n_sites, *(np.concatenate(c) for c in cols))


class ScanPipe:
    """Runs fused device scans for a stream of byte-code jobs with lookahead.

    jobs: list of (job_id, codes uint8[n]).  `run()` yields
    (job_id, present bool[n-k+1]) in input order — (job_id, present,
    tables) in eval mode — while later calls scan on the device in the
    background.
    """

    EXC_BUCKET = 256  # per-row non-ACGT exception slots in the packed path

    def __init__(self, scanner, k: int, row_windows: int | None = None,
                 rows: int = ROWS, depth: int = DEPTH):
        self.scanner = scanner
        self.k = k
        # module-global default read at call time (tunable / patchable)
        self.row_windows = int(row_windows if row_windows is not None
                               else ROW_WINDOWS)
        self.rows = int(rows)
        self.depth = max(1, int(depth))
        self.row_bytes = self.row_windows + k - 1
        self.eval_mode = getattr(scanner, "eval_enabled", False)
        # rows of a call are padded to a multiple of the shard count, and
        # split over the shards, as the scanner does it
        self.n_shards = scanner.n_shards
        self.max_rows = scanner.padded_rows(self.rows)
        self._pad = scanner.pad_byte(self.eval_mode)
        self._cuda = scanner.device.type == "cuda"
        self._streams = ([torch.cuda.Stream(d) for d in scanner.devices]
                         if self._cuda else [])
        # 2-bit packed transfer when the native packer is available (calls
        # with exception-dense rows, and eval mode, send raw bytes)
        self._pack2 = None
        try:
            from .. import native

            native.lib()
            self._pack2 = native.pack2
        except (native.NativeUnavailable, OSError):
            pass
        # per slot: pinned codes, pinned packed rows and exceptions, then
        # each shard's pinned outputs (allocated at first use)
        self._codes: list = [None] * (self.depth + 2)
        self._packs: list = [None] * (self.depth + 2)
        self._outs: list = [[None] * self.n_shards for _ in range(self.depth + 2)]
        # observability for adaptive placement: how often the consumer had
        # to wait on the device vs found the result already materialized
        self.waits = 0
        self.calls = 0
        self.wait_s = 0.0
        # wait excluding the first call, which bears the kernel build and
        # device warmup — the number adaptive placement should reason about
        self.wait_steady_s = 0.0

    # -- planning ---------------------------------------------------------
    def _call_rows(self, call_idx: int) -> int:
        """Ramp-up: the first calls are small so the first walk can start
        after ~one row's scan latency instead of a full call's."""
        return min(self.rows, 1 << call_idx)

    def _plan(self, jobs) -> list[_Call]:
        k = self.k
        calls: list[_Call] = [_Call()]
        row, off = 0, 0
        for ji, (_job_id, codes) in enumerate(jobs):
            nw = len(codes) - k + 1
            a = 0
            while a < nw:
                if off + k > self.row_bytes:  # no room for even one window
                    row += 1
                    off = 0
                    if row == self._call_rows(len(calls) - 1):
                        calls.append(_Call())
                        row = 0
                take = min(nw - a, self.row_bytes - off - (k - 1))
                calls[-1].segs.append(_Seg(ji, a, take, row, off))
                off += take + k - 1
                a += take
        return [c for c in calls if c.segs]

    # -- dispatch ---------------------------------------------------------
    def _out_pins(self, i: int, shard: int, outs) -> tuple:
        """Pinned host buffers of slot i for one shard's device outputs (the
        first sized for a full call's rows; the ramp-up uses a prefix)."""
        if self._outs[i][shard] is None:
            first = outs[0]
            self._outs[i][shard] = (
                torch.empty((self.max_rows // self.n_shards, *first.shape[1:]),
                            dtype=first.dtype, pin_memory=True),
                *(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                  for o in outs[1:]),
            )
        pins = self._outs[i][shard]
        return (pins[0][: outs[0].shape[0]], *pins[1:])

    def _fill(self, buf: np.ndarray, jobs, call: _Call, rows: int) -> None:
        # pad with 'A': padding windows are sliced off by the segment map;
        # the rows past `rows` only pad the call to the shard count
        buf.fill(ord("A"))
        buf[rows:] = self._pad
        for s in call.segs:
            codes = jobs[s.job][1]
            buf[s.row, s.off : s.off + s.nw + self.k - 1] = codes[
                s.w0 : s.w0 + s.nw + self.k - 1
            ]

    def _pack_rows(self, buf: np.ndarray, rows: int, out: tuple) -> bool:
        """Pack the call's rows `buf` [total, row_bytes] into `out` (packed
        rows, exception positions and bytes, each [total, ...]); False when
        a row holds more than EXC_BUCKET exceptions (the call goes raw)."""
        packed, exc_idx, exc_byte = out
        for r in range(rows):
            res = self._pack2(buf[r], self.EXC_BUCKET,
                              out=(packed[r], exc_idx[r], exc_byte[r]))
            if res is None:
                return False
            exc_idx[r, len(res[1]):] = self.row_bytes  # padding entries
        packed[rows:] = 0  # pad rows: 'A', no exception
        exc_idx[rows:] = self.row_bytes
        return True

    def _pack_slot(self, i: int, total: int) -> tuple:
        """Slot i's pinned packed rows and exception arrays, `total` rows
        (the CPU path's are plain arrays of one call)."""
        shapes = (((-(-self.row_bytes // 4)), torch.uint8),
                  (self.EXC_BUCKET, torch.int64), (self.EXC_BUCKET, torch.uint8))
        if not self._cuda:
            return tuple(torch.empty((total, n), dtype=t) for n, t in shapes)
        if self._packs[i] is None:
            self._packs[i] = tuple(torch.empty((self.max_rows, n), dtype=t,
                                               pin_memory=True) for n, t in shapes)
        return tuple(t[:total] for t in self._packs[i])

    def _inputs(self, i: int, buf: torch.Tensor, rows: int) -> tuple:
        """The tensors a call sends: its packed rows and exceptions where
        the packed transfer applies, else its raw rows."""
        if self._pack2 is None or self.eval_mode:
            return (buf,)
        packs = self._pack_slot(i, buf.shape[0])
        if self._pack_rows(buf.numpy(), rows, tuple(t.numpy() for t in packs)):
            return packs
        return (buf,)

    def _launch(self, shard: int, inputs: tuple) -> tuple:
        if self.eval_mode:
            # fused scan + site eval (raw transfer; the tables' D2H dwarfs
            # what a packed transfer would save); the returned tuple also
            # carries the call's device scratch, which the pending call keeps
            return self.scanner.eval_shard(shard, inputs[0], self.k)
        if len(inputs) == 3:
            return (self.scanner.scan2_shard(shard, *inputs, self.k, self.row_bytes),)
        return (self.scanner.scan_shard(shard, inputs[0], self.k),)

    def _dispatch(self, jobs, call: _Call, call_idx: int) -> _Pending:
        rows = self._call_rows(call_idx)
        total = self.scanner.padded_rows(rows)
        self.calls += 1
        i = call_idx % len(self._codes)
        if not self._cuda:
            buf = torch.from_numpy(np.empty((total, self.row_bytes), np.uint8))
            self._fill(buf.numpy(), jobs, call, rows)
            parts = zip(*(self.scanner.split_rows(t) for t in self._inputs(i, buf, rows)))
            return _Pending([tuple(o.numpy() for o in self._launch(s, part))
                             for s, part in enumerate(parts)])
        if self._codes[i] is None:
            self._codes[i] = torch.empty((self.max_rows, self.row_bytes),
                                         dtype=torch.uint8, pin_memory=True)
        codes_pin = self._codes[i][:total]
        self._fill(codes_pin.numpy(), jobs, call, rows)
        inputs = self._inputs(i, codes_pin, rows)
        outs, events, keep = [], [], []
        for s, (dev, stream, *parts) in enumerate(zip(
                self.scanner.devices, self._streams,
                *(self.scanner.split_rows(t) for t in inputs))):
            # the filter words were uploaded on another stream
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                dev_in = tuple(p.to(dev, non_blocking=True) for p in parts)
                dev_outs = self._launch(s, dev_in)
                pins = self._out_pins(i, s, dev_outs)
                for pin, out in zip(pins, dev_outs):
                    pin.copy_(out, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
            outs.append(tuple(p.numpy() for p in pins))
            events.append(event)
            keep.append((dev_in, dev_outs))
        return _Pending(outs, events, keep)

    # -- execution --------------------------------------------------------
    def run(self, jobs):
        """Returns a generator of (job_id, present) in input order —
        (job_id, present, tables) in eval mode, tables None where the job
        has no interior site.

        The first `depth+1` device calls are dispatched EAGERLY (before the
        first next()), so a caller may start host work between run() and
        iteration with the device already scanning.
        """
        k = self.k
        jobs = list(jobs)
        calls = self._plan(jobs)
        inflight: deque = deque()
        state = {"pos": 0}

        def pump():
            while state["pos"] < len(calls) and len(inflight) < self.depth + 1:
                pos = state["pos"]
                inflight.append((calls[pos], self._dispatch(jobs, calls[pos], pos)))
                state["pos"] += 1

        pump()  # eager: the device is busy before the generator is consumed

        eval_mode = self.eval_mode
        nw_row = self.row_windows

        def gen():
            first_wait = True
            parts: dict[int, list[np.ndarray]] = {}
            tab_parts: dict[int, list[tuple]] = {}
            done: dict[int, np.ndarray] = {}
            done_tabs: dict[int, tuple] = {}
            need = {
                ji: max(0, len(c) - k + 1) for ji, (_j, c) in enumerate(jobs)
            }
            next_ji = 0

            def assemble_tabs(ji: int):
                ps = tab_parts.pop(ji, [])
                if not ps:
                    return None
                return tuple(np.concatenate(c) for c in zip(*ps))

            def emit_ready():
                nonlocal next_ji
                while next_ji < len(jobs):
                    if need[next_ji] == 0:
                        out = (jobs[next_ji][0], np.zeros(0, bool))
                    elif next_ji in done:
                        out = (jobs[next_ji][0], done.pop(next_ji))
                    else:
                        return
                    if eval_mode:
                        yield (*out, done_tabs.pop(next_ji, None))
                    else:
                        yield out
                    next_ji += 1

            while inflight:
                call, fut = inflight.popleft()
                pump()  # keep the device queue full before blocking
                t0 = time.perf_counter()
                # blocks for THIS call's shards only
                outs = merge_shards(fut.result(), nw_row)
                dt = time.perf_counter() - t0
                self.wait_s += dt
                if not first_wait:
                    self.wait_steady_s += dt
                first_wait = False
                if dt > 0.002:
                    self.waits += 1
                # copies only: the slot's pinned buffers are reused DEPTH+2
                # calls on
                bits = np.unpackbits(outs[0], axis=1, bitorder="little")
                if eval_mode:
                    (_packed, _n_sites, site, gate, sub_sup, del_sup, ins_lane,
                     ins_ok, ins_sup) = outs
                    valid = site[site >= 0]  # ascending prefix
                for s in call.segs:
                    parts.setdefault(s.job, []).append(
                        bits[s.row, s.off : s.off + s.nw].astype(bool)
                    )
                    if eval_mode:
                        # interior sites only (the drop rule: a device-
                        # evaluated site needs k+max_del suffix bytes inside
                        # its own segment; 2k covers every table consumer)
                        g0 = s.row * nw_row + s.off
                        lo = int(np.searchsorted(valid, g0))
                        hi = int(np.searchsorted(
                            valid, g0 + max(0, s.nw - 2 * k), side="right"
                        ))
                        if hi > lo:
                            wins = (valid[lo:hi] - g0 + s.w0).astype(np.int64)
                            # valid is the ascending PREFIX of site, so the
                            # table row of valid[j] is j itself
                            rows_i = np.arange(lo, hi)
                            tab_parts.setdefault(s.job, []).append((
                                wins, gate[rows_i], sub_sup[rows_i],
                                del_sup[rows_i], ins_lane[rows_i],
                                ins_ok[rows_i], ins_sup[rows_i],
                            ))
                    got = sum(len(p) for p in parts[s.job])
                    if got == need[s.job]:
                        ps = parts.pop(s.job)
                        done[s.job] = (
                            ps[0] if len(ps) == 1 else np.concatenate(ps)
                        )
                        if eval_mode:
                            done_tabs[s.job] = assemble_tabs(s.job)
                yield from emit_ready()
            yield from emit_ready()
            if next_ji != len(jobs):
                raise RuntimeError("scan pipe under-delivered")

        return gen()
