"""Seconds batches waited at their head for their filters, per draft Mbp,
from the port's own spans (pipeline.bulk): fill.wait, from a batch's
worker holding its slot to its filters in hand, by whatever path.  The
in-port twin of fill_wait_s_per_mbp, which the harness's wrappers give."""

from ._spans import span_sum_per_mbp


def read(record):
    return span_sum_per_mbp(record, "fill.wait")
