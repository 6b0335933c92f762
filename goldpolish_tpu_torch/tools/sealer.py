"""Standalone gap filler (the sealer-gr equivalent,
reference subprojects/sealer/sealer.cpp:738-983 CLI surface):

    python -m goldpolish_tpu_torch.tools.sealer scaffolds.fa out.fa \
        --bf prefix-k32.bf [--bf prefix-k28.bf ...] \
        [-L flank] [-P max-paths] [-B max-branches] [-C max-cost] \
        [-G max-gap-length] [--lower] [--trace trace.tsv]

k values come from the Bloom-filter headers; gaps are Nn runs (or
all-lowercase runs with --lower), tried per k in the given order with
per-gap retirement.

Port counterpart: goldpolish_tpu/tools/sealer.py, copied.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from ..fill import sealer as sealer_mod
    from ..io import fasta
    from ..ops import bloom
    from ..polish import reports

    p = argparse.ArgumentParser(prog="goldpolish-tpu-torch-sealer", description=__doc__)
    p.add_argument("scaffolds")
    p.add_argument("out")
    p.add_argument("--bf", action="append", required=True,
                   help="per-k Bloom filter file (repeatable, k descending)")
    p.add_argument("-L", "--flank-length", type=int, default=0,
                   help="flank length (0 = first k)")
    p.add_argument("-P", "--max-paths", type=int, default=10)
    p.add_argument("-B", "--max-branches", type=int, default=1000)
    p.add_argument("-C", "--max-cost", type=int, default=100000)
    p.add_argument("-G", "--max-gap-length", type=int, default=800)
    p.add_argument("--lower", action="store_true",
                   help="treat all-lowercase runs as gaps (goldpolish mode)")
    p.add_argument("--trace", default="", help="per-gap search-stats TSV")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    bfs = [bloom.load_any(path) for path in args.bf]
    k_values = [bf.k for bf in bfs]
    bfs_by_k = dict(zip(k_values, bfs))
    cfg = sealer_mod.SealerConfig(
        k_values=k_values,
        flank_length=args.flank_length or k_values[0],
        max_paths=args.max_paths,
        max_branches=args.max_branches,
        max_cost=args.max_cost,
        max_gap_length=args.max_gap_length,
        lower=args.lower,
        verbose=args.verbose,
    )
    records = [(r.name, r.seq) for r in fasta.read_seqs(args.scaffolds)]
    trace: list = []
    sealed, stats = sealer_mod.seal_records(
        records, bfs_by_k, cfg, trace_out=trace if args.trace else None
    )
    fasta.write_fasta(args.out, [
        fasta.SeqRecord(h.split()[0], h.partition(" ")[2], s) for h, s in sealed
    ])
    if args.trace:
        reports.write_sealer_trace(args.trace, trace)
    print(
        f"{args.out}\tgaps={stats.get('gaps_found', 0)}"
        f"\tclosed={stats.get('gaps_closed', 0)}"
    )


if __name__ == "__main__":
    main()
