"""Run one cell of the port's benchmark and print its result line.

    python3 gpbench/run.py --workload ecoli_bulk.ont_draft --seed 7 \
        --seconds 40 --trace 0

Exits non-zero, and prints no result, without the CUDA devices the cell
asks for.  See gpbench/README.md.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="gpbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the benchmark's own tests and the control runs
    p.add_argument("--benchmark", default=os.path.join(ROOT, "BENCHMARK.json"),
                   help=argparse.SUPPRESS)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help=argparse.SUPPRESS)
    p.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # every build and kernel cache inside the checkout, at fixed paths
    cache = os.path.join(ROOT, ".gpbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    sys.path.insert(0, ROOT)
    from gpbench import harness

    try:
        return harness.main(args, T_PROCESS)
    except harness.SetupError as e:
        print(f"gpbench: {e}", file=sys.stderr)
        return 2
    except harness.PortMoved as e:
        print(f"gpbench: {e}", file=sys.stderr)
        return 4


if __name__ == "__main__":
    sys.exit(main())
