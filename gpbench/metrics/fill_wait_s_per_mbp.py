"""Seconds batches waited at their head for their filters, per draft Mbp
(pipeline.bulk: batching, the lookahead fill, the ordered writer).

A batch waits from the moment its worker holds a concurrency slot
(engine.run_pipeline calls it) until polish_batch_records starts, plus the
inline fill inside it (bf_build_s, 0 where the lookahead filled the
batch).  Both ends are the harness's own spans."""

from ._common import per_mbp


def read(record):
    total, seen = 0.0, False
    for job in record.jobs:
        for key, start in job.worker_start.items():
            if key in job.polish:
                t0, _t1, inline = job.polish[key]
                total += max(0.0, t0 - start) + inline
                seen = True
    return per_mbp(record, total) if seen else None
