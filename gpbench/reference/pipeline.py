"""One batch through the polishing chain, in plain NumPy and torch: the
benchmark's reference of the port's pipeline/bulk.py per-batch chain.

    chosen reads -> per-k Bloom fill (fill.py)
                 -> multi-k ntEdit with the rollback guard (editor.py)
                 -> mask short runs -> Sealer (sealer.py) -> upper-case

It reads the draft, reads and mappings the benchmark wrote, and nothing
that the port made.  Parameters come from the benchmark's configuration
file (GoldPolish's defaults: scripts/goldpolish-make, ntEdit X=Y=0.5,
Sealer -P10 -B1000).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import fill, mask
from .bloom import BloomFilter
from .editor import HostEditor
from .ntedit_oracle import Config
from .sealer import SealerConfig, seal_records

# reference: src/goldpolish_targeted_bfs.cpp:45-53
KMER_THRESHOLD_A = 4.66943
KMER_THRESHOLD_B = 2.11391e-07
KMER_THRESHOLD_MAX = 13
ROLLBACK_RATIO = 0.75  # reference scripts/goldpolish-ntedit:31-40


@dataclass
class ChainParams:
    k_values: list[int] = field(default_factory=lambda: [32, 28, 24, 20])
    hash_num: int = 4
    cbf_bytes: int = 10 * 1024 * 1024
    bf_bytes: int = 512 * 1024  # grown to 16 bits per target base
    subsample_per_10kbp: float = 40.0
    ntedit_x: float = 0.5
    ntedit_y: float = 0.5
    sealer: bool = True
    sealer_max_paths: int = 10
    sealer_max_branches: int = 1000
    sealer_max_cost: int = 100000
    sealer_max_gap_length: int = 800


def load_paf(path: str, targets: set[str]) -> dict[str, list[str]]:
    """contig -> mapped read ids in file order, the first row of each
    (read, contig) pair kept, contigs outside `targets` dropped."""
    out: dict[str, list[str]] = {}
    seen: set[tuple[str, str]] = set()
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6 or parts[5] not in targets:
                continue
            key = (parts[0], parts[5])
            if key not in seen:
                seen.add(key)
                out.setdefault(parts[5], []).append(parts[0])
    return out


def kmer_threshold(mapped_bases: int) -> int:
    t = int(round(KMER_THRESHOLD_A + float(mapped_bases) * KMER_THRESHOLD_B))
    return min(t, KMER_THRESHOLD_MAX)


def chosen_reads(ids: list[str], lens: dict[str, int], mapped: dict[str, list[str]],
                 read_len: dict[str, int], per_10kbp: float):
    """[(read id, threshold)] of a batch in fill order: per target, its
    mapped reads by id (FASTA reads carry no quality), at most
    trunc(len * per_10kbp / 10 kbp) of them, with the target's adaptive
    threshold."""
    out = []
    for tid in ids:
        reads = mapped.get(tid, [])
        if not reads:
            continue
        num = min(len(reads), int(float(lens[tid]) * per_10kbp / 10_000.0))
        chosen = sorted(reads)[:num]
        thr = kmer_threshold(sum(read_len[r] for r in chosen))
        out += [(r, thr) for r in chosen]
    return out


def batch_bf_bytes(params: ChainParams, total_len: int) -> int:
    b = params.bf_bytes
    while b < total_len * 2:
        b *= 2
    return b


def ntedit_config(k: int, x: float, y: float, h: int) -> Config:
    return Config(k=k, h=h, max_insertions=5, max_deletions=5,
                  missing_ratio=x, edit_ratio=y, use_ratio=True, mode=1, mask=1)


def _fasta_bytes(records) -> int:
    return sum(len(h) + len(s) + 3 for h, s in records)


def polish_batch(records: list[tuple[str, str]], reads: dict[str, bytes],
                 mapped: dict[str, list[str]], params: ChainParams,
                 device="cpu", superset: bool = False) -> dict:
    """The chain's stages for one batch of (header, seq) records: "bf" (each
    k's BF bytes), "ntedit", "sealed" and "final" records; the fill and the
    site eval run on `device`.  superset fills by occurrence totals (the
    benchmark's control)."""
    ids = [h.split()[0] for h, _ in records]
    lens = {h.split()[0]: len(s) for h, s in records}
    pairs = chosen_reads(ids, lens, mapped, {r: len(s) for r, s in reads.items()},
                         params.subsample_per_10kbp)
    bf_bytes = batch_bf_bytes(params, sum(lens.values()))
    arrays = fill.fill_batch(
        [reads[r] for r, _t in pairs], [t for _r, t in pairs], params.k_values,
        params.hash_num, params.cbf_bytes, bf_bytes,
        device=device, superset=superset,
    ) if pairs else [np.zeros(bf_bytes, np.uint8) for _k in params.k_values]
    bfs = {}
    for k, arr in zip(params.k_values, arrays):
        bf = BloomFilter(bf_bytes, params.hash_num, k)
        bf.array[:] = arr
        bfs[k] = bf
    cur = records
    for k in params.k_values:
        ed = HostEditor(ntedit_config(k, params.ntedit_x, params.ntedit_y,
                                      params.hash_num), bfs[k], device)
        cur = [(h, ed.polish_contig(s.encode())[0].decode("ascii")) for h, s in cur]
    edited = records if _fasta_bytes(cur) / max(1, _fasta_bytes(records)) < ROLLBACK_RATIO \
        else cur
    sealed = edited
    if params.sealer:
        k0 = params.k_values[0]
        scfg = SealerConfig(
            k_values=params.k_values, flank_length=k0,
            max_gap_length=params.sealer_max_gap_length,
            max_paths=params.sealer_max_paths,
            max_branches=params.sealer_max_branches,
            max_cost=params.sealer_max_cost,
        )
        prepped = [(h, mask.mask_short_runs(s, k0, soft=True)) for h, s in edited]
        sealed, _stats = seal_records(prepped, bfs, scfg)
    final = [(h, mask.to_upper(s)) for h, s in sealed]
    return {"bf": arrays, "ntedit": edited, "sealed": sealed, "final": final}
