"""Seconds the host Bloom fill ran per draft Mbp (bf_builder -> native):
bf_fill_bg_s where the lookahead thread filled the batch, bf_build_s where
the batch filled inline; summed over batches and jobs."""

from ._common import per_mbp, timing_sum


def read(record):
    return per_mbp(record, timing_sum(record, "bf_fill_bg_s", "bf_build_s"))
