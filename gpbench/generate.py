"""The benchmark's input generator: a genome, a draft assembly of it, long
reads and their true mappings (PAF), all from one seed and a traffic file's
parameters.  Vectorised NumPy; the same seed gives the same bytes.

Traffic keys (see traffic/*.json):

    contigs            contigs the genome is cut into (equal lengths)
    draft.error_every_bp   one draft error per this many bases, at jittered
                           even spacing, kinds cycling sub / ins / del
    draft.gap_every_bp     one n gap per this many bases (0: none), of
    draft.gap_len          n bases, replacing genome bases
    targets            optional: one soft-masked target per every_bp bases,
                       min_bp..max_bp long (uniform), carrying the reads'
                       error model, lower-case (GoldPolish-Target's input)
    reads.coverage     read bases over genome bases
    reads.error_rate   per-base error rate, split sub / ins / del by
    reads.mix          [sub, ins, del]; deletions favour homopolymers
    reads.n50_bp, reads.sigma   log-normal lengths with this N50 and sigma,
    reads.min_bp, reads.max_bp  clipped to this range

(`check_batches`, read by the harness: how many contigs of a bulk draft
the check recomputes.)
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
_CODE = np.full(256, 255, np.uint8)
_CODE[ACGT] = np.arange(4, dtype=np.uint8)
_COMP = np.arange(256, dtype=np.uint8)
_COMP[ACGT] = np.frombuffer(b"TGCA", np.uint8)


@dataclass
class Inputs:
    draft_path: str
    reads_path: str
    paf_path: str
    truths: list[tuple[str, bytes]]
    drafts: list[tuple[str, bytes]]
    read_bases: int

    @property
    def draft_bp(self) -> int:
        return sum(len(s) for _n, s in self.drafts)


def _edit(seq: np.ndarray, rng, sub: np.ndarray, ins: np.ndarray,
          dele: np.ndarray, lower: np.ndarray | None = None,
          gap: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """seq with substitutions at `sub`, one random base inserted after each
    of `ins`, the bases at `dele` removed, `gap` positions turned to 'n' and
    `lower` positions lower-cased; returns (new seq, new length per input
    base)."""
    out = seq.copy()
    if len(sub):
        out[sub] = ACGT[(_CODE[seq[sub]] + rng.integers(1, 4, len(sub))) % 4]
    counts = np.ones(len(seq), np.int64)
    counts[dele] = 0
    counts[ins] = 2
    if gap is not None and len(gap):
        out[gap] = ord("n")
        counts[gap] = 1
    res = np.repeat(out, counts)
    ends = np.cumsum(counts)
    ins_live = ins[counts[ins] == 2]
    res[ends[ins_live] - 1] = ACGT[rng.integers(0, 4, len(ins_live))]
    if lower is not None and len(lower):
        flag = np.zeros(len(seq), bool)
        flag[lower] = True
        low = np.repeat(flag, counts)
        res[low] |= 0x20
    return res, counts


def _read_errors(seq: np.ndarray, rng, rate: float, mix) -> tuple:
    """(sub, ins, del) positions of the reads' error model on seq."""
    n = len(seq)
    pos = np.unique(rng.integers(0, n, rng.binomial(n, rate)))
    kind = rng.random(len(pos))
    sub = pos[kind < mix[0]]
    ins = pos[(kind >= mix[0]) & (kind < mix[0] + mix[1])]
    dele = pos[kind >= mix[0] + mix[1]]
    # ONT deletes mostly inside homopolymers: a deletion off a run moves to
    # the next base when that base starts one
    nxt = np.minimum(dele + 1, n - 1)
    nn = np.minimum(dele + 2, n - 1)
    off_run = (seq[dele] != seq[nxt]) & (seq[nxt] == seq[nn])
    dele = np.unique(np.where(off_run, nxt, dele))
    return sub, ins, dele


def make_genome(rng, genome_bp: int, contigs: int) -> list[tuple[str, bytes]]:
    sizes = [genome_bp // contigs] * contigs
    sizes[-1] += genome_bp - sum(sizes)
    g = ACGT[rng.integers(0, 4, genome_bp)]
    out, a = [], 0
    for i, n in enumerate(sizes):
        out.append((f"ctg{i}", g[a : a + n].tobytes()))
        a += n
    return out


def make_draft(rng, truth: bytes, traffic: dict) -> bytes:
    t = np.frombuffer(truth, np.uint8)
    n = len(t)
    d = traffic["draft"]
    every = int(d["error_every_bp"])
    pos = np.arange(300, n - 300, every)
    pos = np.clip(pos + rng.integers(-every // 4, every // 4 + 1, len(pos)), 0, n - 1)
    kinds = rng.permutation(np.arange(len(pos)) % 3)
    sub, ins, dele = pos[kinds == 0], pos[kinds == 1], pos[kinds == 2]
    gap = np.zeros(0, np.int64)
    lower = np.zeros(0, np.int64)
    if d.get("gap_every_bp"):
        g_every, g_len = int(d["gap_every_bp"]), int(d["gap_len"])
        starts = np.arange(g_every // 2, n - g_every // 2, g_every)
        gap = (starts[:, None] + np.arange(g_len)[None, :]).reshape(-1)
    tg = traffic.get("targets")
    if tg:
        r = traffic["reads"]
        starts = np.arange(int(tg["every_bp"]) // 2, n - int(tg["every_bp"]) // 2,
                           int(tg["every_bp"]))
        lens = rng.integers(int(tg["min_bp"]), int(tg["max_bp"]) + 1, len(starts))
        lower = np.concatenate([np.arange(s, min(n, s + ln))
                                for s, ln in zip(starts, lens)])
        inside = np.zeros(n, bool)
        inside[lower] = True
        keep = ~inside
        sub, ins, dele = sub[keep[sub]], ins[keep[ins]], dele[keep[dele]]
        ts, ti, td = _read_errors(t[lower], rng, float(r["error_rate"]), r["mix"])
        sub = np.union1d(sub, lower[ts])
        ins = np.union1d(ins, lower[ti])
        dele = np.union1d(dele, lower[td])
    if len(gap):
        hit = np.zeros(n, bool)
        hit[gap] = True
        sub, ins, dele = sub[~hit[sub]], ins[~hit[ins]], dele[~hit[dele]]
    out, _counts = _edit(t, rng, sub, ins, dele, lower=lower, gap=gap)
    return out.tobytes()


def make_reads(rng, truths: list[tuple[str, bytes]], traffic: dict):
    """Reads as (name, bytes) and their PAF lines, in read order."""
    r = traffic["reads"]
    genome_bp = sum(len(s) for _n, s in truths)
    sigma = float(r["sigma"])
    mu = np.log(float(r["n50_bp"])) - sigma * sigma
    want = float(r["coverage"]) * genome_bp
    mean = np.exp(mu + sigma * sigma / 2)
    lens = np.zeros(0, np.int64)
    while lens.sum() < want:
        more = np.exp(rng.normal(mu, sigma, int(want / mean * 0.2) + 16))
        lens = np.concatenate((lens, np.clip(more, r["min_bp"], r["max_bp"]).astype(np.int64)))
    lens = lens[: int(np.searchsorted(np.cumsum(lens), want)) + 1]
    clen = np.array([len(s) for _n, s in truths], np.int64)
    cum = np.concatenate(([0], np.cumsum(clen)))
    ctg = np.searchsorted(cum, rng.integers(0, genome_bp, len(lens)), side="right") - 1
    lens = np.minimum(lens, clen[ctg])
    starts = (rng.random(len(lens)) * (clen[ctg] - lens + 1)).astype(np.int64)
    minus = rng.random(len(lens)) < 0.5
    genome = np.frombuffer(b"".join(s for _n, s in truths), np.uint8)
    frags = [genome[cum[c] + s : cum[c] + s + ln] for c, s, ln in zip(ctg, starts, lens)]
    stream = np.concatenate(frags)
    sub, ins, dele = _read_errors(stream, rng, float(r["error_rate"]), r["mix"])
    edited, counts = _edit(stream, rng, sub, ins, dele)
    offs = np.concatenate(([0], np.cumsum(lens)))
    new_lens = np.add.reduceat(counts, offs[:-1])
    new_offs = np.concatenate(([0], np.cumsum(new_lens)))
    reads, paf = [], []
    for i in range(len(lens)):
        seq = edited[new_offs[i] : new_offs[i + 1]]
        if minus[i]:
            seq = _COMP[seq[::-1]]
        name = f"r{i}"
        q = len(seq)
        s, e = int(starts[i]), int(starts[i] + lens[i])
        c = int(ctg[i])
        reads.append((name, seq.tobytes()))
        paf.append(f"{name}\t{q}\t0\t{q}\t{'-' if minus[i] else '+'}\t{truths[c][0]}\t"
                   f"{clen[c]}\t{s}\t{e}\t{min(q, e - s)}\t{e - s}\t60\n")
    return reads, paf


def generate(seed: int, genome_bp: int, traffic: dict, work: str) -> Inputs:
    """Write draft.fa, reads.fa and map.paf for this seed into `work`."""
    rng = np.random.default_rng(seed)
    truths = make_genome(rng, genome_bp, int(traffic["contigs"]))
    drafts = [(n, make_draft(rng, t, traffic)) for n, t in truths]
    reads, paf = make_reads(rng, truths, traffic)
    paths = [os.path.join(work, f) for f in ("draft.fa", "reads.fa", "map.paf")]
    with open(paths[0], "wb") as f:
        f.write(b"".join(b">" + n.encode() + b"\n" + s + b"\n" for n, s in drafts))
    with open(paths[1], "wb") as f:
        f.write(b"".join(b">" + n.encode() + b"\n" + s + b"\n" for n, s in reads))
    with open(paths[2], "w") as f:
        f.write("".join(paf))
    return Inputs(*paths, truths=truths, drafts=drafts,
                  read_bases=sum(len(s) for _n, s in reads))
