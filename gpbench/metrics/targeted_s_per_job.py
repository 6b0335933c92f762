"""Seconds of a targeted job outside its inner bulk run (pipeline.targeted:
extraction, the PAF remap, the splice): the job's wall minus the inner
run_bulk's, both from the harness's spans, averaged over jobs."""


def read(record):
    if record.cell.config.get("mode") != "target" or not record.jobs:
        return None
    outside = [j.t1 - j.t0 - sum(b - a for a, b, _t in j.bulk) for j in record.jobs]
    return sum(outside) / len(outside)
