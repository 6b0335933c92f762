"""Targeted mode (GoldPolish-Target): polish only gap/target regions.

The in-process equivalent of the reference's snakemake DAG
(reference: scripts/goldpolish-target.py + goldpolish-target-run-pipeline.smk
rules run_ntLink_pair/run_minimap2 -> extract_seq -> update_mapping_paf ->
run_goldpolish -> run_post_processing):

 1. extract: softmasked runs (or BED intervals) + `-l` flanks become
    "contig.N" records with a "start-end" comment
    (reference: goldpolish-target-extract-seq.py — including the merge of
    uppercase separators shorter than 2*flank into the surrounding gaps and
    the strictly-greater-than-1 minimum gap length),
 2. remap: PAF rows whose target interval overlaps a gap are rewritten into
    gap-local coordinates via an interval lookup, with the 4 overlap cases;
    non-overlapping rows are dropped
    (reference: goldpolish-target-update-mapping.py:93-155),
 3. recurse: the extracted gaps run through the bulk pipeline with the
    remapped PAF (reference smk:97-103 — `goldpolish --mappings ... -s 100
    -x 150`),
 4. splice: polished gaps are re-inserted at their recorded coordinates
    (reference: goldpolish-target-post-processing.py — including its
    drop-last-base quirk when a gap ends exactly at len(seq)-1).

Port counterpart: goldpolish_tpu/pipeline/targeted.py, copied (host code;
step 3 runs the port's bulk pipeline, so the gaps polish on the config's
backend and device), with the port's startup check (bulk.check_ported)
run before step 1: a configuration the port refuses writes nothing.  On
many hosts, host 0 alone runs steps 1, 2 and 4 and deletes the
intermediates, and every host polishes its share of step 3 (run_targeted);
in the JAX package every host extracts, polishes into and deletes the same
files, and writes the output.
"""

from __future__ import annotations

import bisect
import csv
import os
import re
from dataclasses import replace

from ..config import PipelineConfig
from ..io import fasta
from ..utils.log import get_logger

log = get_logger("targeted")

MIN_GAP_LENGTH = 1
_CASE_RUNS = re.compile(r"([A-Z]+|[a-z]+)")


# --- 1. extraction -----------------------------------------------------------
def extract_masked_subsequences(seq: str, name: str, flank: int):
    """Softmask-driven extraction (reference extract-seq.py:60-108).

    Yields (gap_name, "start-end", uppercased_flanked_seq).
    """
    subseqs = _CASE_RUNS.findall(seq)
    if not subseqs:
        return
    filtered = [subseqs[0]]
    for sub in subseqs[1:]:
        if sub.isupper():
            if len(sub) >= 2 * flank:
                filtered.append(sub)
            elif filtered[-1].islower():
                filtered[-1] = filtered[-1] + sub.lower()
            else:
                raise ValueError("Unexpected order of softmasked subseqs")
        else:
            if filtered[-1].isupper():
                filtered.append(sub)
            else:
                filtered[-1] = filtered[-1] + sub
    idx = 0
    gap_count = 1
    for sub in filtered:
        if sub.islower() and len(sub) > MIN_GAP_LENGTH:
            start = max(0, idx - flank)
            end = min(len(seq), idx + len(sub) + flank)
            if end > start:
                yield (
                    f"{name}.{gap_count}",
                    f"{start}-{end}",
                    seq[start:end].upper(),
                )
                gap_count += 1
        idx += len(sub)


def extract_from_bed(seq: str, name: str, flank: int, coords: list[tuple[int, int]]):
    """BED-driven extraction with close-interval merging
    (reference extract-seq.py:111-143)."""
    if not coords:
        return
    filtered = [coords[0]]
    for c in coords[1:]:
        prev = filtered[-1]
        if int(c[0]) - int(prev[1]) < 2 * flank:
            filtered[-1] = (prev[0], c[1])
        else:
            filtered.append(c)
    count = 0
    for c in filtered:
        start = max(0, int(c[0]) - flank)
        end = min(len(seq), int(c[1]) + flank)
        count += 1
        yield (f"{name}.{count}", f"{start}-{end}", seq[start:end].upper())


def extract_gaps(fasta_path: str, out_path: str, flank: int, bed_path: str = ""):
    coords_by_contig: dict[str, list] = {}
    if bed_path:
        with open(bed_path, encoding="utf-8") as f:
            for row in csv.reader(f, delimiter="\t", quotechar='"'):
                coords_by_contig.setdefault(row[0], []).append((row[1], row[2]))
    n = 0
    with fasta.FastaWriter(out_path) as w:
        for rec in fasta.read_seqs(fasta_path):
            if bed_path:
                gaps = extract_from_bed(
                    rec.seq, rec.id, flank, coords_by_contig.get(rec.id, [])
                ) if rec.id in coords_by_contig else ()
            else:
                gaps = extract_masked_subsequences(rec.seq, rec.id, flank)
            for gid, desc, sub in gaps:
                w.write((f"{gid} {desc}", sub))
                n += 1
    log.info("extracted %d gap regions -> %s", n, out_path)
    return n


# --- 2. PAF remap ------------------------------------------------------------
class _IntervalIndex:
    """Sorted non-overlapping interval lookup (replaces the intervaltree
    dependency; extraction guarantees disjoint intervals)."""

    def __init__(self):
        self._items: list[tuple[int, int, str]] = []
        self._sorted = False

    def add(self, begin: int, end: int, data: str):
        self._items.append((begin, end, data))
        self._sorted = False

    def overlap(self, start: int, end: int):
        if not self._sorted:
            self._items.sort()
            self._starts = [it[0] for it in self._items]
            self._sorted = True
        out = []
        i = bisect.bisect_right(self._starts, end - 1) - 1
        # walk left while intervals may overlap [start, end)
        while i >= 0:
            b, e, d = self._items[i]
            if e <= start:
                break
            if b < end and e > start:
                out.append((b, e, d))
            i -= 1
        return out[::-1]


def build_gap_index(gaps_path: str) -> dict[str, _IntervalIndex]:
    """reference update-mapping.py:76-91: interval [start, end+1) keyed by
    the contig prefix of 'contig.N'."""
    trees: dict[str, _IntervalIndex] = {}
    for rec in fasta.read_seqs(gaps_path):
        contig = rec.id.rsplit(".", 1)[0]
        start_s, end_s = rec.comment.split("-")[0], rec.comment.split("-")[1]
        trees.setdefault(contig, _IntervalIndex()).add(
            int(start_s), int(end_s) + 1, rec.id
        )
    return trees


def update_paf(mapping_path: str, trees: dict[str, _IntervalIndex], out_path: str):
    """reference update-mapping.py:93-155 (4 overlap cases; drops rows with
    no overlap; rewrites to 12 columns)."""
    n = 0
    with open(mapping_path, encoding="utf-8") as f_in, open(
        out_path, "w", encoding="utf-8", newline=""
    ) as f_out:
        writer = csv.writer(f_out, delimiter="\t")
        for row in csv.reader(f_in, delimiter="\t", quotechar='"'):
            (qname, qlen, qstart, qend, strand, tname, tlen, tstart, tend,
             matches, alen, qual) = row[:12]
            tstart, tend = int(tstart), int(tend)
            qstart, qend = int(qstart), int(qend)
            tree = trees.get(tname)
            if tree is None:
                continue
            hits = tree.overlap(tstart, tend)
            if not hits:
                continue
            gb, ge_, gname = hits[0]
            if gb < tstart and ge_ > tend:
                nts, nte = tstart - gb, tend - gb
            elif gb < tstart and ge_ <= tend:
                nts, nte = tstart - gb, ge_ - gb
                qend = qend - (tend - ge_)
            elif gb >= tstart and ge_ > tend:
                nts, nte = 0, tend - gb
                qstart = qstart + (gb - tstart)
            else:
                nts, nte = 0, ge_ - gb
                qstart = qstart + (gb - tstart)
                qend = qend - (tend - ge_)
            writer.writerow([
                qname, qlen, qstart, qend, strand, gname, tlen, nts, nte,
                matches, nte - nts, qual,
            ])
            n += 1
    log.info("remapped %d PAF rows -> %s", n, out_path)
    return n


# --- 4. splice-back ----------------------------------------------------------
def insert_polished_gaps(fasta_path: str, gaps_path: str, out_path: str):
    """reference post-processing.py:28-94 (including the trailing-base quirk
    when a gap ends at len(seq)-1)."""
    gaps_by_contig: dict[str, list] = {}
    for rec in fasta.read_seqs(gaps_path):
        contig = rec.id.rsplit(".", 1)[0]
        start_s, end_s = rec.comment.split("-")[0], rec.comment.split("-")[1]
        gaps_by_contig.setdefault(contig, []).append(
            (rec.id, int(start_s), int(end_s), rec.seq)
        )
    with fasta.FastaWriter(out_path) as w:
        for rec in fasta.read_seqs(fasta_path):
            gaps = gaps_by_contig.get(rec.id)
            if not gaps:
                w.write((rec.id, rec.seq))
                continue
            parts = []
            start = 0
            for _gid, gs, ge_, gseq in gaps:
                parts.append(rec.seq[start:gs])
                parts.append(gseq)
                start = ge_
            if start < len(rec.seq) - 1:  # reference quirk: == len-1 drops it
                parts.append(rec.seq[start:])
            w.write((rec.id, "".join(parts)))


# --- driver ------------------------------------------------------------------
def run_targeted(cfg: PipelineConfig) -> dict:
    """Full targeted pipeline (reference smk target rule).

    Stage wall times are logged with cfg.benchmark (the reference wraps
    each snakemake rule in memusg/time -v, smk:29-37); intermediates are
    deleted unless cfg.target_dev (reference goldpolish-target.py cleanup
    of INTERMEDIATE_* files, kept with --target_dev).

    On many hosts (parallel/distributed.py) the run joins the group once,
    before extraction, and bulk polishes inside it: host 0 alone extracts,
    maps and remaps while the others wait; every host polishes its own
    batches of the gaps, which host 0's reaper merges; a barrier then holds
    host 0 until no host reads the gap files, and host 0 alone splices,
    writes the output and deletes the intermediates."""
    import time as _time

    from ..parallel import distributed as dist
    from . import bulk

    bulk.check_ported(cfg)
    t_start = _time.monotonic()
    marks: list[tuple[str, float]] = []

    def mark(stage: str):
        marks.append((stage, _time.monotonic()))
        if cfg.benchmark and len(marks) > 1:
            log.info(
                "benchmark: %s %.2fs", marks[-2][0],
                marks[-1][1] - marks[-2][1],
            )

    prefix = os.path.join(
        os.path.dirname(os.path.abspath(cfg.output_seqs)) or ".",
        "GoldPolish-Target_work",
    )
    gaps_fa = f"{prefix}.gaps.fa"
    remapped_paf = f"{prefix}.gaps.paf"
    polished_gaps = f"{prefix}.gaps.goldpolished.fa"
    own_group = not dist.in_group()
    host_id, n_hosts = dist.init_distributed()
    try:
        return _run_targeted_inner(
            cfg, gaps_fa, remapped_paf, polished_gaps, mark, marks, t_start,
            host_id, n_hosts,
        )
    finally:
        # intermediates go unless --target_dev (reference
        # goldpolish-target.py INTERMEDIATE_* cleanup), on every exit path
        # including the zero-gap early return and errors; host 0 wrote
        # them, and host 0 deletes them
        if host_id == 0 and not cfg.target_dev:
            for p in (
                gaps_fa, remapped_paf, polished_gaps,
                # derived caches of the intermediates (next-to-input
                # SeqIndex TSVs, internal mapper artifacts)
                gaps_fa + ".index",
                f"{os.path.basename(gaps_fa)}."
                f"{os.path.basename(cfg.polishing_seqs)}.internal.mapping.tsv",
            ):
                try:
                    os.remove(p)
                except OSError:
                    pass
        if own_group:
            dist.shutdown_distributed()


def _prepare(cfg: PipelineConfig, gaps_fa: str, remapped_paf: str, mark) -> int:
    """Steps 1 and 2: extract the gaps, map (or take --mappings) and remap
    the PAF into gap coordinates; returns the number of gaps (0 writes
    nothing but the empty gap file)."""
    mark("extract_seq")
    n_gaps = extract_gaps(
        cfg.seqs_to_polish, gaps_fa, cfg.flank_length, cfg.bed
    )
    if n_gaps == 0:
        return 0

    # mappings for the whole assembly (provided or external mapper)
    mark("map")
    if cfg.mappings_path:
        mapping = cfg.mappings_path
    elif _mapper_available(cfg):
        mapping = _run_external_mapper(cfg)
    else:
        raise RuntimeError(
            "targeted mode needs --mappings (PAF), or ntLink/minimap2 on PATH"
        )

    mark("update_mapping_paf")
    trees = build_gap_index(gaps_fa)
    update_paf(mapping, trees, remapped_paf)
    return n_gaps


def _run_targeted_inner(cfg: PipelineConfig, gaps_fa: str, remapped_paf: str,
                        polished_gaps: str, mark, marks, t_start,
                        host_id: int = 0, n_hosts: int = 1) -> dict:
    import time as _time

    from ..parallel import distributed as dist
    from . import bulk

    # host 0 alone writes the gap file and the remapped PAF; a failure
    # there reaches every host
    n_gaps = dist.on_host_0(lambda: _prepare(cfg, gaps_fa, remapped_paf, mark))
    if n_gaps == 0:
        if host_id == 0:
            log.info("no target regions found; copying input through")
            fasta.write_fasta(
                cfg.output_seqs,
                ((r.id, r.seq) for r in fasta.read_seqs(cfg.seqs_to_polish)),
            )
        return {"gaps": 0}

    # recurse into the bulk pipeline on the extracted gaps
    # (reference smk:97-103: -s 100 -x 150)
    sub_cfg = replace(
        cfg,
        seqs_to_polish=gaps_fa,
        output_seqs=polished_gaps,
        mappings_path=remapped_paf,
        target=False,
        subsample_max_reads_per_10kbp=100.0,
        mx_max_reads_per_10kbp=150.0,
    )
    mark("run_goldpolish")
    bulk.run_bulk(sub_cfg)
    if n_hosts > 1:
        # host 0's run_bulk returns once its reaper has merged every batch;
        # another host returns once its own are published, or at once when
        # it has none, and may still be reading the gap files then
        dist.barrier()
        if host_id != 0:
            return {"gaps": n_gaps}

    mark("post_processing")
    insert_polished_gaps(cfg.seqs_to_polish, polished_gaps, cfg.output_seqs)
    mark("done")
    if cfg.benchmark:
        log.info(
            "benchmark: targeted total %.2fs", _time.monotonic() - t_start
        )
    log.info("targeted polishing done -> %s", cfg.output_seqs)
    return {"gaps": n_gaps}


def _mapper_available(cfg) -> bool:
    import shutil

    tool = "minimap2" if cfg.mapper == "minimap2" else "ntLink"
    return shutil.which(tool) is not None


def _run_external_mapper(cfg) -> str:
    import shutil
    import subprocess

    if cfg.mapper == "minimap2":
        out = f"{os.path.basename(cfg.seqs_to_polish)}.targeted.paf"
        with open(out, "w") as f:
            subprocess.run(
                ["minimap2", f"-t{cfg.threads}", cfg.seqs_to_polish,
                 cfg.polishing_seqs],
                stdout=f, check=True,
            )
        return out
    subprocess.run(
        ["ntLink", "pair", f"target={cfg.seqs_to_polish}",
         f"reads={cfg.polishing_seqs}", f"sensitive={cfg.sensitive}",
         "dev=True",
         f"k={cfg.k_ntlink}", f"w={cfg.w_ntlink}", f"t={cfg.threads}",
         "paf=True"],
        check=True,
    )
    return f"{cfg.seqs_to_polish}.k{cfg.k_ntlink}.w{cfg.w_ntlink}.z1000.paf"
