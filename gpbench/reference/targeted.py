"""GoldPolish-Target's host steps, for the benchmark's plain reference:
extraction of the soft-masked targets with their flanks, the PAF remapped
into target coordinates, and the splice of the polished targets.

Frozen copy of goldpolish_tpu_torch/pipeline/targeted.py's steps 1, 2
and 4 (reference goldpolish-target-extract-seq.py,
goldpolish-target-update-mapping.py, goldpolish-target-post-processing.py).
"""

from __future__ import annotations

import bisect
import csv
import re

from . import fasta

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
