"""Standalone masker (the goldpolish-mask equivalent,
reference scripts/goldpolish-mask:44-81):

    python -m goldpolish_tpu_torch.tools.mask in.fa out.fa -k 32 [--hard]

Soft-masks (or hard-masks with --hard) ACTG runs shorter than k,
uppercases k-length sequence ends, and strips flanking Ns — the prep
step for the sealer's --lower gap detection.

Port counterpart: goldpolish_tpu/tools/mask.py, copied.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from ..io import fasta
    from ..polish import mask as mask_mod

    p = argparse.ArgumentParser(prog="goldpolish-tpu-torch-mask", description=__doc__)
    p.add_argument("infile")
    p.add_argument("outfile")
    p.add_argument("-k", type=int, default=32, help="minimum unmasked run")
    p.add_argument("--hard", action="store_true", help="hard-mask with N")
    args = p.parse_args(argv)
    recs = [
        fasta.SeqRecord(
            r.id, r.comment,
            mask_mod.mask_short_runs(r.seq, args.k, soft=not args.hard),
        )
        for r in fasta.read_seqs(args.infile)
    ]
    fasta.write_fasta(args.outfile, recs)
    print(f"{args.outfile}\tcontigs={len(recs)}")


if __name__ == "__main__":
    main()
