"""Seconds batches' fills sat queued behind other batches' fills on the
one fill thread, per draft Mbp (pipeline.bulk: the lookahead fill): the
fill.queued spans, from a fill's submission to the thread starting it."""

from ._spans import span_sum_per_mbp


def read(record):
    return span_sum_per_mbp(record, "fill.queued")
