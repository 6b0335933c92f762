"""Kernel 4 (scan_eval, the fused phase-A eval) against its roofline: the
least time the chip needs for every call of the window (kernels/
scan_eval.py, from the call shapes) over the device time of kernel 4's
kernels in the trace.  Nothing to read where kernel 4 did not run."""

import re

from ..kernels import scan_eval

KERNELS = re.compile(r"\bse_(tile|compact|sites|ins)\b")


def read(record):
    if record.trace is None:
        return None
    calls = [c for j in record.jobs for c in j.scan_eval]
    device_s = sum(d for n, _a, d in record.trace["events"] if KERNELS.search(n)) / 1e9
    if not calls or device_s <= 0:
        return None
    peak = record.peaks[record.device_kind]
    least = sum(scan_eval.least_seconds(c, peak) for c in calls)
    return 100.0 * least / device_s
