"""Seconds of the Sealer per draft Mbp (fill: sealer, konnector):
sealer_s summed over batches."""

from ._common import per_mbp, timing_sum


def read(record):
    return per_mbp(record, timing_sum(record, "sealer_s"))
