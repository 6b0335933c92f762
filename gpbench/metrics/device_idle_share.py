"""Share of the traced window in which no CUDA event ran: 1 minus the union
of the profiler's kernel, copy and memset intervals over the window."""


def read(record):
    if record.trace is None or record.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - record.trace["busy_s"] / record.trace["window_s"])
