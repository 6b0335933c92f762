"""goldpolish CLI of the PyTorch + CUDA port — flag-compatible with the
reference driver.

Port counterpart: goldpolish_tpu/cli.py, copied with these changes:
--backend takes hybrid (the default: the card), jax (the device site eval
and the sealer's lockstep device DBG) or numpy (the host path),
and --device picks where the hybrid and jax device work and the
--fill-overlap device fill run (cuda, the default, raises without CUDA;
cpu is for tests).

Usage mirrors `goldpolish <draft.fa> <reads.fa|fq> <out.fa>` with the
reference's flags (reference: scripts/goldpolish:72-196) plus framework
additions (--backend, --device, --checkpoint, --no-sealer, --concurrency).

Run as:  python -m goldpolish_tpu_torch.cli draft.fa reads.fq polished.fa [...]
"""

from __future__ import annotations

import argparse
import sys

from .config import PipelineConfig
from .utils.log import get_logger

log = get_logger("cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="goldpolish-tpu-torch")
    p.add_argument("seqs_to_polish", help="Sequences to polish.")
    p.add_argument("polishing_seqs", help="Sequences to polish with.")
    p.add_argument("output_seqs", help="Filename to write polished sequences to.")
    p.add_argument("-k", action="append", default=[], type=int,
                   help="k-mer sizes (default: 32 28 24 20)")
    p.add_argument("-b", "--bsize", default=1, type=int,
                   help="Batch size: polished seqs per Bloom filter (default 1)")
    p.add_argument("-m", "--shared-mem", default="",
                   help="Workspace path (default /dev/shm)")
    p.add_argument("-t", "--threads", type=int, default=48)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-x", "--mx-max-reads-per-10kbp", type=float, default=150.0)
    p.add_argument("-s", "--subsample-max-reads-per-10kbp", type=float, default=-1)
    group = p.add_mutually_exclusive_group()
    group.add_argument("--ntlink", action="store_true",
                       help="Run ntLink for read mappings (default).")
    group.add_argument("--minimap2", action="store_true",
                       help="Run minimap2 for read mappings.")
    group.add_argument("--internal-map", action="store_true",
                       help="Use the built-in TPU-native minimizer mapper.")
    group.add_argument("--mappings", default="",
                       help="Pre-generated mappings (PAF, SAM, or ntLink TSV).")
    p.add_argument("--k-ntlink", type=int, default=88)
    p.add_argument("--w-ntlink", type=int, default=1000)
    p.add_argument("--target", action="store_true", help="Targeted mode.")
    p.add_argument("-l", "--length", type=int, default=64,
                   help="Targeted-mode flank length")
    tg = p.add_mutually_exclusive_group()
    tg.add_argument("--bed", default="", help="BED targets (with --target)")
    tg.add_argument("--softmask", action="store_true",
                    help="Targets from softmasked regions (with --target)")
    # framework additions
    p.add_argument("--backend", choices=["numpy", "hybrid", "jax"],
                   default="hybrid",
                   help="Editor compute backend (default hybrid = the "
                        "fused scan and eval on --device + host walk; "
                        "jax = the dense scan and batched site eval on "
                        "--device + Python walk, and the sealer's lockstep "
                        "extension probes on --device; "
                        "numpy = the host path)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Where the hybrid or jax device work and the "
                        "--fill-overlap fill run (default cuda, which raises "
                        "without CUDA; cpu = the plain torch versions, for "
                        "tests)")
    p.add_argument("--checkpoint", default="",
                   help="Checkpoint manifest path for preemption-safe resume")
    p.add_argument("--no-sealer", action="store_true",
                   help="Skip the Sealer gap-fill stage")
    p.add_argument("--concurrency", type=int, default=4,
                   help="Concurrent batches in flight")
    p.add_argument("--process-pool", action="store_true",
                   help="Fork-pool batch workers (host backend; scales "
                        "past the GIL like the reference's worker processes)")
    p.add_argument("--fill-overlap", action="store_true",
                   help="Fast mode (hybrid or jax backend): the device claims "
                        "Bloom-fill batches from the tail and fills them "
                        "with the sort-based fill on --device (a superset "
                        "of the host fill); a late device fill races a "
                        "host fill")
    # hidden reference flags (reference scripts/goldpolish:158-183)
    def _str2bool(v):
        if isinstance(v, bool):
            return v
        if v.lower() in ("true", "1", "yes"):
            return True
        if v.lower() in ("false", "0", "no"):
            return False
        raise argparse.ArgumentTypeError(f"boolean expected, got {v!r}")

    p.add_argument("--sensitive", type=_str2bool, default=True,
                   help=argparse.SUPPRESS)
    p.add_argument("--benchmark", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--target_dev", action="store_true", help=argparse.SUPPRESS)
    return p


def args_to_config(args) -> PipelineConfig:
    cfg = PipelineConfig(
        seqs_to_polish=args.seqs_to_polish,
        polishing_seqs=args.polishing_seqs,
        output_seqs=args.output_seqs,
        k_values=args.k or [32, 28, 24, 20],
        batch_size=args.bsize,
        workspace=args.shared_mem,
        threads=max(2, args.threads),
        verbose=args.verbose,
        mx_max_reads_per_10kbp=args.mx_max_reads_per_10kbp,
        subsample_max_reads_per_10kbp=args.subsample_max_reads_per_10kbp,
        mapper=(
            "minimap2" if args.minimap2
            else "internal" if args.internal_map
            else "ntlink"
        ),
        mappings_path=args.mappings,
        k_ntlink=args.k_ntlink,
        w_ntlink=args.w_ntlink,
        backend=args.backend,
        device=args.device,
        checkpoint=args.checkpoint,
        max_concurrent_batches=args.concurrency,
        run_sealer=not args.no_sealer,
        process_pool=args.process_pool,
        fill_overlap=args.fill_overlap,
        target=args.target,
        flank_length=args.length,
        bed=args.bed or "",
        softmask=args.softmask,
        sensitive=args.sensitive,
        benchmark=args.benchmark,
        target_dev=args.target_dev,
    )
    return cfg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = args_to_config(args)
    if cfg.target:
        from .pipeline import targeted

        targeted.run_targeted(cfg)
    else:
        from .pipeline import bulk

        bulk.run_bulk(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
