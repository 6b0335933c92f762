"""Runs of the small cells in tiny/ on the CPU, in this process."""

from __future__ import annotations

import contextlib
import io
import json
import os

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny", "BENCHMARK.json")


def run_cell(workload: str, seed: int, seconds: float = 0.5, trace: int = 0,
             *extra: str, bench: str | None = TINY) -> tuple[int, dict | None, str]:
    """(exit code, the result line's object or None, standard error) of a
    cell of tiny/ on the CPU, or with bench=None of BENCHMARK.json on the
    card."""
    from gpbench import run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace),
                       *(["--benchmark", bench, "--device", "cpu"] if bench else []),
                       *extra])
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    return rc, result, err.getvalue()
