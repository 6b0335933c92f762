"""Seconds of the multi-k ntEdit chain per draft Mbp (polish: multik,
ntedit_gpu, scanpipe, the native walker): ntedit_s summed over batches."""

from ._common import per_mbp, timing_sum


def read(record):
    return per_mbp(record, timing_sum(record, "ntedit_s"))
