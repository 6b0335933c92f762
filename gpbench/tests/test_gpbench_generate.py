"""The input generator: deterministic in the seed, and true to its traffic
file's parameters."""

import json
import os
import re

import numpy as np
import pytest

from gpbench import generate

TRAFFIC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "traffic")


def traffic(name):
    with open(os.path.join(TRAFFIC, name + ".json")) as f:
        return json.load(f)


def read_lengths(path):
    with open(path, "rb") as f:
        return np.array([len(s) for s in f.read().split(b"\n")[1::2]])


def test_same_seed_same_bytes(tmp_path):
    a, b, c = (tmp_path / d for d in "abc")
    for d in (a, b, c):
        d.mkdir()
    t = traffic("ont_draft")
    ia = generate.generate(2**31 + 7, 200_000, t, str(a))
    ib = generate.generate(2**31 + 7, 200_000, t, str(b))
    ic = generate.generate(2**31 + 8, 200_000, t, str(c))
    for pa, pb, pc in zip((ia.draft_path, ia.reads_path, ia.paf_path),
                          (ib.draft_path, ib.reads_path, ib.paf_path),
                          (ic.draft_path, ic.reads_path, ic.paf_path)):
        assert open(pa, "rb").read() == open(pb, "rb").read()
        assert open(pa, "rb").read() != open(pc, "rb").read()


@pytest.mark.parametrize("name", ["ont_draft", "rough_draft", "one_contig"])
def test_bulk_traffic_parameters(tmp_path, name):
    t = traffic(name)
    genome = 1_200_000
    inp = generate.generate(11, genome, t, str(tmp_path))
    assert len(inp.drafts) == t["contigs"]
    assert inp.read_bases / genome == pytest.approx(t["reads"]["coverage"], rel=0.01)
    lens = np.sort(read_lengths(inp.reads_path))[::-1]
    n50 = lens[np.searchsorted(np.cumsum(lens), lens.sum() / 2)]
    assert 0.85 * t["reads"]["n50_bp"] <= n50 <= 1.15 * t["reads"]["n50_bp"]
    assert lens.min() >= t["reads"]["min_bp"] * 0.9
    gaps = sum(len(re.findall(b"n+", s)) for _n, s in inp.drafts)
    every = t["draft"]["gap_every_bp"]
    per = genome // t["contigs"]
    want = t["contigs"] * len(range(every // 2, per - every // 2, every)) if every else 0
    assert gaps == want
    # one error per error_every_bp: each removes the truth's k-mers that
    # cover it (k of them for a substitution or deletion, k - 1 for an
    # insertion) from the draft, gaps aside
    k = 32
    for (_n, truth), (_m, draft) in zip(inp.truths, inp.drafts):
        n = len(truth)
        errors = len(range(300, n - 300, t["draft"]["error_every_bp"]))
        gap_kmers = gaps // t["contigs"] * (t["draft"]["gap_len"] + k - 1)
        missing = np.isin(kmers(truth, k), kmers(draft, k), invert=True).sum()
        assert 0.9 * errors * (k - 1) <= missing - gap_kmers * 0 <= 1.02 * errors * k + gap_kmers


def kmers(seq: bytes, k: int) -> np.ndarray:
    """The 2-bit packed k-mers (k <= 32) of seq's A/C/G/T windows."""
    code = np.full(256, 4, np.uint64)
    code[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint64)
    c = code[np.frombuffer(seq, np.uint8)]
    n = len(c) - k + 1
    v = np.zeros(n, np.uint64)
    bad = np.zeros(n, bool)
    for i in range(k):
        v = (v << np.uint64(2)) | (c[i : i + n] & np.uint64(3))
        bad |= c[i : i + n] == 4
    return v[~bad]


def test_read_error_rate(tmp_path):
    """Per-base read errors near the traffic file's rate: the share of
    plus-strand read k-mers absent from the genome is about
    1 - (1 - error_rate)^k."""
    t = traffic("ont_draft")
    inp = generate.generate(5, 400_000, t, str(tmp_path))
    lines = open(inp.reads_path, "rb").read().split(b"\n")
    reads = dict(zip((h[1:].decode() for h in lines[0::2]), lines[1::2]))
    k = 20
    genome = np.concatenate([kmers(s, k) for _n, s in inp.truths])
    plus = [f.split("\t")[0] for f in open(inp.paf_path) if f.split("\t")[4] == "+"]
    got = np.concatenate([kmers(reads[r], k) for r in plus[:300]])
    share = np.isin(got, genome, invert=True).mean()
    want = 1 - (1 - t["reads"]["error_rate"]) ** k
    assert 0.75 * want <= share <= 1.25 * want


def test_targets(tmp_path):
    t = traffic("gapfill")
    genome = 1_000_000
    inp = generate.generate(3, genome, t, str(tmp_path))
    runs = [m for _n, s in inp.drafts for m in re.findall(rb"[a-z]+", s)]
    per = genome // t["contigs"]
    every = t["targets"]["every_bp"]
    assert len(runs) == t["contigs"] * len(range(every // 2, per - every // 2, every))
    lens = [len(r) for r in runs]
    assert min(lens) >= t["targets"]["min_bp"] * 0.9
    assert max(lens) <= t["targets"]["max_bp"] * 1.1
