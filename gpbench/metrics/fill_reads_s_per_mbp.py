"""Seconds the fill spent choosing and gathering its reads, per draft Mbp
(bf_builder: read_stream, Python holding the interpreter lock): the
fill.reads spans."""

from ._spans import span_sum_per_mbp


def read(record):
    return span_sum_per_mbp(record, "fill.reads")
