"""Standalone k-mer polisher (the ntedit-gr equivalent,
reference subprojects/ntedit/ntedit.cpp:1774-1862 CLI surface):

    python -m goldpolish_tpu_torch.tools.ntedit draft.fa filter.bf out.fa \
        [-X 0.5 -Y 0.5 | -x N -y N] [-i 5] [-d 5] [-m 1] [-a 1] \
        [--snv] [--secbf other.bf] [--changes out.tsv] [--vcf out.vcf] \
        [--backend hybrid|jax|numpy] [--device cuda|cpu] [--processes N]

k and the hash count come from the Bloom-filter file header.

Port counterpart: goldpolish_tpu/tools/ntedit.py, copied with one
difference, as in the port's CLI: --backend defaults to hybrid (the dense
scan on the card) and --device picks where the hybrid and jax device work
runs (cuda, the default, raises at startup without CUDA unless --backend
numpy is given; cpu runs the plain torch versions, for tests).
--processes N walks the contigs in a pool of N worker processes, host work
only, on any backend.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from ..io import fasta
    from ..ops import bloom
    from ..polish import ntedit_oracle as ne
    from ..polish import reports
    from ..polish.ntedit_gpu import NtEditGPU

    p = argparse.ArgumentParser(prog="goldpolish-tpu-torch-ntedit", description=__doc__)
    p.add_argument("draft")
    p.add_argument("bf", help="Bloom filter (GPTPU_BF1, from tools.bf)")
    p.add_argument("out")
    p.add_argument("-X", type=float, default=None, help="missing-kmer ratio")
    p.add_argument("-Y", type=float, default=None, help="edit-support ratio")
    p.add_argument("-x", type=float, default=None, help="missing threshold")
    p.add_argument("-y", type=float, default=None, help="edit threshold")
    p.add_argument("-i", type=int, default=5, help="max insertion bases")
    p.add_argument("-d", type=int, default=5, help="max deletion bases")
    p.add_argument("-m", type=int, default=1, choices=[0, 1, 2], help="mode")
    p.add_argument("-a", type=int, default=1, choices=[0, 1],
                   help="soft-mask unfixable sites")
    p.add_argument("-j", "--jump", type=int, default=3)
    p.add_argument("--snv", action="store_true", help="SNV-only mode")
    p.add_argument("--secbf", default="", help="secondary (repeat) BF")
    p.add_argument("--changes", default="", help="write changes TSV")
    p.add_argument("--vcf", default="", help="write VCF")
    p.add_argument("--backend", default="hybrid",
                   choices=["numpy", "jax", "hybrid"])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Where the hybrid or jax device work runs (default "
                        "cuda, which raises without CUDA; cpu = the plain "
                        "torch versions, for tests)")
    p.add_argument("--processes", type=int, default=0,
                   help="contig walk workers (host work, any backend)")
    args = p.parse_args(argv)
    if args.backend != "numpy" and args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--backend {args.backend} runs on --device cuda, and CUDA is "
                "not available; --backend numpy is the host path (--device "
                "cpu runs the plain torch versions, for tests)"
            )

    bf = bloom.load_any(args.bf)
    secbf = bloom.load_any(args.secbf) if args.secbf else None
    use_ratio = args.x is None and args.y is None
    cfg = ne.Config(
        k=bf.k, h=bf.hash_num, use_ratio=use_ratio,
        missing_ratio=args.X if args.X is not None else 0.5,
        edit_ratio=args.Y if args.Y is not None else 0.5,
        missing_threshold=args.x if args.x is not None else 5.0,
        edit_threshold=args.y if args.y is not None else 9.0,
        mode=args.m, mask=args.a, jump=args.jump,
        max_insertions=args.i, max_deletions=args.d, snv=int(args.snv),
    )
    recs_in = list(fasta.read_seqs(args.draft))
    if args.snv or secbf is not None:
        # SNV stays on the oracle; the secondary-BF veto runs through the
        # native walk when available (byte-identical, differentially
        # tested) and falls back to the oracle otherwise.  Eligibility +
        # tables are loop-invariant; the oracle's min_contig_len guard
        # must be honored here too (the walker has no such guard).
        native_mod = None
        native_tables = None
        if not args.snv and cfg.k <= 64 and cfg.h <= 16 \
                and cfg.max_deletions <= 7 and cfg.max_insertions <= 5:
            try:
                from .. import native as native_mod  # noqa: F811

                native_mod.lib()
                from ..ops import siteeval

                native_tables = siteeval.make_tables(
                    cfg.k, cfg.jump, cfg.max_insertions, cfg.max_deletions
                )
            except Exception:  # noqa: BLE001 — no native lib
                native_mod = None

        def _polish_one(seq: bytes):
            if native_mod is not None and len(seq) >= cfg.min_contig_len:
                return native_mod.polish_contig(
                    seq, bf, cfg, native_tables, bloomrep=secbf
                )
            return ne.polish_contig(seq, bf, cfg, secbf)

        results = [_polish_one(r.seq.encode()) for r in recs_in]
        outs = [(out, recs) for out, recs, _ed in results]
    else:
        eng = NtEditGPU(cfg, bf, backend=args.backend, device=args.device)
        results = eng.polish_many(
            [r.seq.encode() for r in recs_in], processes=args.processes
        )
        outs = [(out, recs) for out, recs, _ed in results]
    fasta.write_fasta(args.out, [
        fasta.SeqRecord(r.id, r.comment, out.decode("latin-1"))
        for r, (out, _recs) in zip(recs_in, outs)
    ])
    per_contig = [
        (r.id, recs) for r, (_out, recs) in zip(recs_in, outs)
    ]
    n_edits = sum(len(recs) for _cid, recs in per_contig)
    if args.changes:
        reports.write_changes_tsv(args.changes, per_contig, cfg.k, cfg.jump)
    if args.vcf:
        reports.write_vcf(args.vcf, per_contig, args.draft, snv=bool(args.snv))
    print(f"{args.out}\tcontigs={len(recs_in)}\tedits={n_edits}")


if __name__ == "__main__":
    main()
