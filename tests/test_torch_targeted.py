"""The port's targeted mode (goldpolish_tpu_torch/pipeline/targeted.py)
against the JAX package's: every case of tests/test_targeted.py, each on
the same input through both packages (extraction records, remapped PAF
rows and bytes, spliced FASTA, the full recursion's polished bytes),
compared exactly.  The recursion runs the port's default backend, hybrid,
with device="cpu" (the plain torch versions of its kernels)."""

import glob
import os

import numpy as np

from goldpolish_tpu.config import PipelineConfig as JaxConfig
from goldpolish_tpu.pipeline import targeted as jtargeted
from goldpolish_tpu_torch.config import PipelineConfig
from goldpolish_tpu_torch.io import fasta
from goldpolish_tpu_torch.pipeline import targeted


def _both(name, *args):
    got = list(getattr(targeted, name)(*args))
    assert got == list(getattr(jtargeted, name)(*args))
    return got


# tests/test_targeted.py:11
def test_extract_masked_basic():
    seq = "A" * 200 + "acgt" * 10 + "G" * 200
    gaps = _both("extract_masked_subsequences", seq, "c1", 64)
    assert gaps == [("c1.1", f"{200 - 64}-{200 + 40 + 64}",
                     seq[200 - 64 : 200 + 40 + 64].upper())]


# tests/test_targeted.py:21
def test_extract_short_upper_merges_into_gap():
    seq = "A" * 200 + "acgt" * 5 + "GGGG" + "tttt" * 5 + "C" * 200
    gaps = _both("extract_masked_subsequences", seq, "c1", 64)
    assert len(gaps) == 1
    start, end = map(int, gaps[0][1].split("-"))
    assert start == 200 - 64 and end == 200 + 20 + 4 + 20 + 64


# tests/test_targeted.py:32
def test_extract_single_base_gap_skipped():
    assert _both("extract_masked_subsequences", "A" * 200 + "a" + "G" * 200, "c1", 64) == []


# tests/test_targeted.py:38
def test_extract_from_bed_merges_close_intervals():
    coords = [("100", "150"), ("200", "260"), ("700", "750")]
    gaps = _both("extract_from_bed", "ACGT" * 300, "c1", 64, coords)
    assert [g[0] for g in gaps] == ["c1.1", "c1.2"]
    s0, e0 = map(int, gaps[0][1].split("-"))
    assert s0 == 100 - 64 and e0 == 260 + 64


# tests/test_targeted.py:49
def test_update_paf_four_cases(tmp_path):
    gaps = tmp_path / "gaps.fa"
    gaps.write_text(">ctg.1 100-200\n" + "A" * 101 + "\n")
    paf = tmp_path / "in.paf"
    paf.write_text("\n".join([
        "r1\t500\t10\t110\t+\tctg\t1000\t120\t180\t50\t60\t60",
        "r2\t500\t0\t300\t+\tctg\t1000\t150\t400\t50\t250\t60",
        "r3\t500\t0\t300\t+\tctg\t1000\t50\t150\t50\t100\t60",
        "r4\t500\t0\t400\t+\tctg\t1000\t50\t400\t50\t350\t60",
        "r5\t500\t0\t100\t+\tctg\t1000\t500\t600\t50\t100\t60",
        "r6\t500\t0\t100\t+\tother\t1000\t120\t180\t50\t60\t60",
    ]) + "\n")
    out, jout = tmp_path / "out.paf", tmp_path / "jout.paf"
    n = targeted.update_paf(str(paf), targeted.build_gap_index(str(gaps)), str(out))
    assert n == jtargeted.update_paf(str(paf), jtargeted.build_gap_index(str(gaps)),
                                     str(jout)) == 4
    assert out.read_bytes() == jout.read_bytes()
    by_name = {g[0]: g for g in (ln.split("\t") for ln in out.read_text().splitlines())}
    assert by_name["r1"][5] == "ctg.1"
    assert (by_name["r1"][7], by_name["r1"][8]) == ("20", "80")
    assert (by_name["r2"][7], by_name["r2"][8]) == ("50", "101")
    assert by_name["r2"][3] == str(300 - (400 - 201))
    assert (by_name["r3"][7], by_name["r3"][8]) == ("0", "50")
    assert by_name["r3"][2] == str(0 + (100 - 50))
    assert (by_name["r4"][7], by_name["r4"][8]) == ("0", "101")


# tests/test_targeted.py:95
def test_insert_polished_gaps(tmp_path):
    orig = tmp_path / "orig.fa"
    orig.write_text(">c1\n" + "A" * 50 + "acgtacgt" + "G" * 50 + "\n>c2\nTTTT\n")
    gaps = tmp_path / "gaps.fa"
    gaps.write_text(">c1.1 40-76\n" + "X" * 36 + "\n")
    out, jout = tmp_path / "out.fa", tmp_path / "jout.fa"
    targeted.insert_polished_gaps(str(orig), str(gaps), str(out))
    jtargeted.insert_polished_gaps(str(orig), str(gaps), str(jout))
    assert out.read_bytes() == jout.read_bytes()
    recs = {r.id: r.seq for r in fasta.read_seqs(str(out))}
    assert recs == {"c1": "A" * 40 + "X" * 36 + "G" * 32, "c2": "TTTT"}


def _run_both(tmp_path, **kw) -> tuple[bytes, dict]:
    """run_targeted of both packages with the same fields, each writing in
    a directory of its own (the intermediates land beside the output);
    returns the port's bytes (asserted equal to the JAX package's) and its
    result."""
    outs, res = [], None
    for name, cls, mod, extra in (("jax", JaxConfig, jtargeted, {}),
                                  ("port", PipelineConfig, targeted, {"device": "cpu"})):
        (tmp_path / name).mkdir()
        outs.append(str(tmp_path / name / "polished.fa"))
        res = mod.run_targeted(cls(output_seqs=outs[-1],
                                   workspace=str(tmp_path / name), **kw, **extra))
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        got = b.read()
        assert got == a.read()
    return got, res


# tests/test_targeted.py:107
def test_targeted_end_to_end(tmp_path):
    rng = np.random.default_rng(0)
    truth = "".join(rng.choice(list("ACGT")) for _ in range(4000))
    d = list(truth)
    d[1900] = "A" if d[1900] != "A" else "C"
    d[1950] = ""
    draft = "".join(d)
    draft_path = str(tmp_path / "draft.fa")
    fasta.write_fasta(draft_path, [fasta.SeqRecord(
        "ctgA", "", draft[:1000] + draft[1000:3000].lower() + draft[3000:])])
    reads_path, paf_path = str(tmp_path / "reads.fq"), str(tmp_path / "map.paf")
    with open(reads_path, "w") as rf, open(paf_path, "w") as pf:
        rn = 0
        for _rep in range(8):
            for s in range(0, 4000, 600):
                e = min(4000, s + 1200)
                if e - s < 300:
                    continue
                rf.write(f"@r{rn}\n{truth[s:e]}\n+\n{'I' * (e - s)}\n")
                pf.write(f"r{rn}\t{e-s}\t0\t{e-s}\t+\tctgA\t4000\t{s}\t{e}\t{e-s}\t{e-s}\t60\n")
                rn += 1
    got, res = _run_both(tmp_path, seqs_to_polish=draft_path, polishing_seqs=reads_path,
                         k_values=[32, 28], mappings_path=paf_path, target=True,
                         flank_length=64, run_sealer=True)
    assert res["gaps"] == 1
    recs = list(fasta.read_seqs(str(tmp_path / "port" / "polished.fa")))
    assert recs[0].id == "ctgA" and recs[0].seq == truth


# tests/test_targeted.py:149
def test_targeted_no_gaps_passthrough(tmp_path):
    draft_path = str(tmp_path / "d.fa")
    fasta.write_fasta(draft_path, [fasta.SeqRecord("c1", "", "ACGT" * 100)])
    _got, res = _run_both(tmp_path, seqs_to_polish=draft_path, polishing_seqs=draft_path,
                          target=True)
    assert res["gaps"] == 0
    assert list(fasta.read_seqs(str(tmp_path / "port" / "polished.fa")))[0].seq == "ACGT" * 100


# tests/test_targeted.py:162
def test_target_dev_keeps_intermediates(tmp_path):
    rng = np.random.default_rng(5)
    truth = "".join(rng.choice(list("ACGT")) for _ in range(3000))
    d = list(truth)
    d[1500] = "A" if d[1500] != "A" else "C"
    draft = "".join(d)
    draft_path = str(tmp_path / "draft.fa")
    fasta.write_fasta(draft_path, [fasta.SeqRecord(
        "c1", "", draft[:1200] + draft[1200:1800].lower() + draft[1800:])])
    reads_path, paf_path = str(tmp_path / "reads.fq"), str(tmp_path / "map.paf")
    with open(reads_path, "w") as rf, open(paf_path, "w") as pf:
        rn = 0
        for _rep in range(8):
            for s in range(0, 3000, 500):
                e = min(3000, s + 1000)
                if e - s < 300:
                    continue
                rf.write(f"@r{rn}\n{truth[s:e]}\n+\n{'I' * (e - s)}\n")
                pf.write(f"r{rn}\t{e-s}\t0\t{e-s}\t+\tc1\t3000\t{s}\t{e}\t{e-s}\t{e-s}\t60\n")
                rn += 1
    for dev in (False, True):
        out = str(tmp_path / f"out{int(dev)}.fa")
        targeted.run_targeted(PipelineConfig(
            seqs_to_polish=draft_path, polishing_seqs=reads_path, output_seqs=out,
            k_values=[32, 28], mappings_path=paf_path, target=True, flank_length=64,
            workspace=str(tmp_path), target_dev=dev, benchmark=True, device="cpu"))
        work = glob.glob(str(tmp_path / "GoldPolish-Target_work*"))
        if not dev:
            assert work == [], work
        else:
            assert {
                "GoldPolish-Target_work.gaps.fa",
                "GoldPolish-Target_work.gaps.paf",
                "GoldPolish-Target_work.gaps.goldpolished.fa",
            } <= {os.path.basename(p) for p in work}, work
        for p in work:
            os.remove(p)
    with open(str(tmp_path / "out0.fa"), "rb") as a, open(str(tmp_path / "out1.fa"), "rb") as b:
        assert a.read() == b.read()
    assert list(fasta.read_seqs(str(tmp_path / "out1.fa")))[0].seq == truth


def test_targeted_stages_are_spans_and_keep_their_log_lines(tmp_path, caplog):
    """Each stage is a target.<stage> span; --benchmark logs each stage's
    seconds, as the span gives them, in the JAX package's words."""
    import logging
    import re

    from goldpolish_tpu_torch.utils import trace

    rng = np.random.default_rng(6)
    truth = "".join(rng.choice(list("ACGT")) for _ in range(3000))
    draft_path = str(tmp_path / "draft.fa")
    fasta.write_fasta(draft_path, [fasta.SeqRecord(
        "c1", "", truth[:1200] + truth[1200:1800].lower() + truth[1800:])])
    reads_path, paf_path = str(tmp_path / "reads.fq"), str(tmp_path / "map.paf")
    with open(reads_path, "w") as rf, open(paf_path, "w") as pf:
        for rn, s in enumerate(range(0, 2500, 250)):
            rf.write(f"@r{rn}\n{truth[s:s + 500]}\n+\n{'I' * 500}\n")
            pf.write(f"r{rn}\t500\t0\t500\t+\tc1\t3000\t{s}\t{s + 500}\t500\t500\t60\n")
    stages = ["extract_seq", "map", "update_mapping_paf", "run_goldpolish",
              "post_processing"]
    with caplog.at_level(logging.INFO, logger="goldpolish_tpu_torch"), \
            trace.collect() as col:
        targeted.run_targeted(PipelineConfig(
            seqs_to_polish=draft_path, polishing_seqs=reads_path,
            output_seqs=str(tmp_path / "out.fa"), k_values=[32], mappings_path=paf_path,
            target=True, flank_length=64, workspace=str(tmp_path), benchmark=True,
            device="cpu"))
    spans = {s[0]: s for s in col.export()["spans"] if s[0].startswith("target.")}
    assert list(spans) == [f"target.{st}" for st in stages]
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("benchmark:")]
    assert [ln.split()[1] for ln in lines] == stages + ["targeted"]
    for st, line in zip(stages, lines):
        _n, t0, t1, _a = spans[f"target.{st}"]
        assert line == f"benchmark: {st} {(t1 - t0) / 1e9:.2f}s"
    assert re.fullmatch(r"benchmark: targeted total \d+\.\d\ds", lines[-1])
    assert "bulk.run" in {s[0] for s in col.export()["spans"]}


def test_targeted_refuses_cuda_without_cuda_before_writing(tmp_path):
    """The port's startup check runs before extraction: the default device
    (cuda) without CUDA raises and leaves no intermediate behind."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the no-CUDA refusal cannot show")
    draft_path = str(tmp_path / "d.fa")
    fasta.write_fasta(draft_path, [fasta.SeqRecord("c1", "", "A" * 200 + "acgt" * 20
                                                   + "G" * 200)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        targeted.run_targeted(PipelineConfig(
            seqs_to_polish=draft_path, polishing_seqs=draft_path,
            output_seqs=str(tmp_path / "o.fa"), target=True, workspace=str(tmp_path)))
    assert glob.glob(str(tmp_path / "GoldPolish-Target_work*")) == []
    assert not os.path.exists(tmp_path / "o.fa")
