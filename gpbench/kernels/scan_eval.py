"""Bytes and operations of one call of kernel 4 (scan_eval), from its shape.

The call reads its codes [rows, cols] (one byte each) and the filter
(bits / 8 bytes) once, and writes its nine outputs once: the packed
presence bits [rows, ceil(nw / 8)], the head count (4 bytes), and per
site slot (s_max of them) the site (4), gate (4), substitution supports
(4), deletion supports (max_del), the insertion lane (1), its flag (1)
and the insertion supports (combos), with nw = cols - k + 1 windows a row.
Its operations are the h hash probes of every window.  (The counting of
chip_smoke.py's kernel 4 row, from shapes instead of tensors.)"""


def work(call: dict) -> tuple[int, int]:
    nw = call["cols"] - call["k"] + 1
    rows, s = call["rows"], call["s_max"]
    read = rows * call["cols"] + call["bits"] // 8
    written = (rows * ((nw + 7) // 8) + 4
               + s * (4 + 4 + 4 + call["max_del"] + 1 + 1 + call["combos"]))
    return read + written, call["h"] * rows * nw


def least_seconds(call: dict, peak: dict) -> float:
    nbytes, ops = work(call)
    return max(nbytes / peak["hbm_bytes_per_s"], ops / peak["scalar_ops_per_s"])
