"""Standalone uppercaser (the goldpolish-to-upper equivalent,
reference scripts/goldpolish-to-upper:14-21):

    python -m goldpolish_tpu_torch.tools.to_upper in.fa out.fa

Port counterpart: goldpolish_tpu/tools/to_upper.py, copied.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from ..io import fasta
    from ..polish import mask as mask_mod

    p = argparse.ArgumentParser(prog="goldpolish-tpu-torch-to-upper",
                                description=__doc__)
    p.add_argument("infile")
    p.add_argument("outfile")
    args = p.parse_args(argv)
    recs = [
        fasta.SeqRecord(r.id, r.comment, mask_mod.to_upper(r.seq))
        for r in fasta.read_seqs(args.infile)
    ]
    fasta.write_fasta(args.outfile, recs)
    print(f"{args.outfile}\tcontigs={len(recs)}")


if __name__ == "__main__":
    main()
