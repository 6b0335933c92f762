"""The port's internal minimizer mapper (goldpolish_tpu_torch/mapper.py)
against the JAX package's: the cases of tests/test_mapper.py (all but its
device sketch, minimizer_sketch_jax, which the port leaves out), each on
the same seeded input through both packages, compared exactly (positions,
hashes, mapping rows, TSV bytes, polished FASTA bytes)."""

import os

import numpy as np
import pytest

from goldpolish_tpu import cli as jax_cli
from goldpolish_tpu import mapper as jmapper
from goldpolish_tpu_torch import cli, mapper
from goldpolish_tpu_torch.io import fasta
from goldpolish_tpu_torch.mappings import AllMappings


def _genome(rng, n):
    return "".join(rng.choice(list("ACGT")) for _ in range(n))


def _same_sketch(seq, *args):
    pos, hashes = mapper.minimizer_sketch(seq, *args)
    jpos, jhashes = jmapper.minimizer_sketch(seq, *args)
    assert np.array_equal(pos, jpos) and np.array_equal(hashes, jhashes)
    return pos, hashes


# tests/test_mapper.py:13
def test_minimizer_sketch_density():
    rng = np.random.default_rng(0)
    seq = _genome(rng, 5000)
    pos, hashes = _same_sketch(seq, 24, 100)
    assert 40 < len(pos) < 250
    assert len(pos) == len(hashes)
    assert (np.diff(pos) > 0).all()


# tests/test_mapper.py:24
def test_sketch_shared_between_overlapping_seqs():
    rng = np.random.default_rng(1)
    seq = _genome(rng, 3000)
    _, h1 = _same_sketch(seq[:2000])
    _, h2 = _same_sketch(seq[1000:])
    assert len(np.intersect1d(h1, h2)) > 5


# tests/test_mapper.py:33
def test_map_reads_assigns_correct_contig():
    rng = np.random.default_rng(2)
    contigs = [("c%d" % i, _genome(rng, 4000)) for i in range(3)]
    reads, expected = [], {}
    for i, (cid, seq) in enumerate(contigs):
        for j in range(4):
            rid = f"r{i}_{j}"
            reads.append((rid, seq[500 * j : 500 * j + 1500]))
            expected[rid] = cid
    rows = list(mapper.map_reads(contigs, reads))
    assert rows == list(jmapper.map_reads(contigs, reads))
    by_read = {}
    for rid, cid, cnt in rows:
        if cnt > by_read.get(rid, ("", 0))[1]:
            by_read[rid] = (cid, cnt)
    for rid, cid in expected.items():
        assert by_read[rid][0] == cid, rid


# tests/test_mapper.py:52
def test_write_mapping_tsv_feeds_allmappings(tmp_path):
    rng = np.random.default_rng(3)
    truth = _genome(rng, 5000)
    target, reads = str(tmp_path / "t.fa"), str(tmp_path / "r.fa")
    fasta.write_fasta(target, [("ctg1", truth)])
    fasta.write_fasta(reads, [(f"r{i}", truth[i * 800 : i * 800 + 2000]) for i in range(5)])
    tsv, jtsv = str(tmp_path / "m.tsv"), str(tmp_path / "j.tsv")
    n = mapper.write_mapping_tsv(target, reads, tsv)
    assert n == jmapper.write_mapping_tsv(target, reads, jtsv) >= 5
    with open(tsv, "rb") as a, open(jtsv, "rb") as b:
        assert a.read() == b.read()

    class Idx:
        def seq_exists(self, rid):
            return rid == "ctg1"

        def get_seq_len(self, rid):
            return 5000

    assert len(AllMappings.load(tsv, Idx()).get_mappings("ctg1")) == 5


# tests/test_mapper.py:76, through both CLIs: no --mappings and no ntLink on
# PATH (the default mapper falls back to the internal one), and --internal-map
@pytest.mark.parametrize("flags", [[], ["--internal-map"]])
def test_bulk_pipeline_with_internal_mapper(tmp_path, monkeypatch, flags):
    import shutil

    assert shutil.which("ntLink") is None
    rng = np.random.default_rng(4)
    truth = _genome(rng, 6000)
    d = list(truth)
    d[3000] = "A" if d[3000] != "A" else "C"
    draft_path, reads_path = str(tmp_path / "draft.fa"), str(tmp_path / "reads.fq")
    fasta.write_fasta(draft_path, [("ctg1", "".join(d))])
    with open(reads_path, "w") as rf:
        for rep in range(8):
            for s in range(0, 6000, 1000):
                e = min(6000, s + 2000)
                if e - s >= 500:
                    rf.write(f"@q{rep}_{s}\n{truth[s:e]}\n+\n{'I' * (e - s)}\n")
    outs = []
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        outs.append(cwd / "out.fa")
        assert main([draft_path, reads_path, str(outs[-1]), "-k", "32", "--no-sealer",
                     "-m", str(cwd), *flags, *extra]) == 0
        # the mapping artifact lands in the CWD, as the JAX package's does
        assert (cwd / "draft.fa.reads.fq.internal.mapping.tsv").exists()
        assert not os.path.exists(cwd / "draft.fa.reads.fq.internal.mapping.tsv.tmp")
    assert outs[1].read_bytes() == outs[0].read_bytes()
    assert list(fasta.read_seqs(str(outs[1])))[0].seq == truth
    assert ((tmp_path / "port" / "draft.fa.reads.fq.internal.mapping.tsv").read_bytes()
            == (tmp_path / "jax" / "draft.fa.reads.fq.internal.mapping.tsv").read_bytes())
