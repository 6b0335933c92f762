"""Seconds the editor's host thread blocked on the device scan pipe, per
draft Mbp (polish: scanpipe): the scan.wait spans, one per scan call."""

from ._spans import span_sum_per_mbp


def read(record):
    return span_sum_per_mbp(record, "scan.wait")
