"""Unified typed configuration.

The reference scatters configuration across four layers — Python argparse
(reference: scripts/goldpolish:72-196), make variables
(reference: scripts/goldpolish-make:3-24), snakemake config
(goldpolish-target-run-pipeline.smk:10-27) and C++ getopt — plus hidden
flags and magic constants.  This dataclass is the single source of truth;
the CLI populates it.

Port counterpart: goldpolish_tpu/config.py, copied; the backend defaults
to "hybrid" (the card), and `device` says where the hybrid backend's scan
and the overlapped device fill run ("cuda", or "cpu" for the tests).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PipelineConfig:
    # positional (reference: scripts/goldpolish:74-78)
    seqs_to_polish: str = ""
    polishing_seqs: str = ""
    output_seqs: str = ""

    # -k (default 32 28 24 20, reference :189-190)
    k_values: list[int] = field(default_factory=lambda: [32, 28, 24, 20])
    # -b batch size: contigs per Bloom filter (reference :127-133)
    batch_size: int = 1
    # -m shared-mem workspace (reference :134-139)
    workspace: str = ""
    # -t threads (reference :96-102; floor of 2)
    threads: int = 48
    verbose: bool = False
    # -x ntLink minimizer filter cap (reference :104-110)
    mx_max_reads_per_10kbp: float = 150.0
    # -s random-subsample cap; -1 = per-mapper default (reference :111-117)
    subsample_max_reads_per_10kbp: float = -1.0
    # mapping source: "ntlink" | "minimap2" | path to mappings file
    mapper: str = "ntlink"
    mappings_path: str = ""
    k_ntlink: int = 88
    w_ntlink: int = 1000

    # ntEdit chain (reference goldpolish-make:15-16, goldpolish-ntedit)
    ntedit_x: float = 0.5
    ntedit_y: float = 0.5

    # Sealer (reference goldpolish-make:19-20 + sealer.cpp defaults)
    sealer_max_paths: int = 10
    sealer_max_branches: int = 1000
    sealer_max_cost: int = 100000
    sealer_max_gap_length: int = 800

    # Bloom sizing (reference goldpolish_targeted_bfs.cpp:270-272)
    hash_num: int = 4
    cbf_bytes: int = 10 * 1024 * 1024
    bf_bytes: int = 512 * 1024

    # new-framework knobs (no reference equivalent)
    # "hybrid" = the fused scan and eval on `device` + host walk (the
    # default: the card); "jax" = the packed scan and the batched site eval
    # on `device` + the Python walk, and the sealer's lockstep extension
    # probes on `device`; "numpy" = the host path
    backend: str = "hybrid"
    # device of the hybrid and jax device work and of the device fills:
    # "cuda" raises without CUDA (never a CPU fallback); "cpu" runs the
    # plain torch versions (tests)
    device: str = "cuda"
    # the device fill (kernel 5, a documented superset of the host fill) in
    # place of every host fill; jax backend only (run_bulk refuses it with
    # another backend, which the JAX package silently ignores)
    device_bf_build: bool = False
    # lookahead Bloom fill: batch N+1's filters build on a background
    # thread while batch N polishes (the reference BF-server's concurrency,
    # goldpolish_targeted_bfs.cpp:177-238); thread-pool path only — fork
    # pool workers fill in-process by construction
    lookahead_fill: bool = True
    # fast mode, hybrid or jax backend with the lookahead fill and without
    # device_bf_build (which fills every batch on the device): a thread claims
    # batches from the tail and fills them on `device` (ops/bloom_sort,
    # kernel 5: a documented superset of the host fill); a device fill still
    # running when its batch is due races a host fill (the hedge)
    fill_overlap: bool = False
    checkpoint: str = ""  # manifest path for preemption-safe resume
    max_concurrent_batches: int = 4
    run_sealer: bool = True
    # fork-pool batch workers (host backends only; scales past the GIL)
    process_pool: bool = False

    # targeted mode (reference :158-183)
    target: bool = False
    flank_length: int = 64  # -l
    bed: str = ""
    softmask: bool = False
    # hidden reference flags (reference :158-183, argparse.SUPPRESS)
    sensitive: bool = True  # --sensitive: ntLink sensitive mapping params
    benchmark: bool = False  # --benchmark: per-stage wall-time reporting
    target_dev: bool = False  # --target_dev: keep targeted-mode intermediates

    NTLINK_SUBSAMPLE_DEFAULT: float = 100.0  # reference :54
    MINIMAP2_SUBSAMPLE_DEFAULT: float = 40.0  # reference :55

    def resolved_subsample(self) -> float:
        if self.subsample_max_reads_per_10kbp != -1.0:
            return self.subsample_max_reads_per_10kbp
        if self.mapper == "minimap2" or self.mappings_path.endswith(
            (".paf", ".sam", ".bam")
        ):
            return self.MINIMAP2_SUBSAMPLE_DEFAULT
        return self.NTLINK_SUBSAMPLE_DEFAULT
