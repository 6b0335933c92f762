"""The port's stage tools (goldpolish_tpu_torch/tools: bf, ntedit, sealer,
mask, to_upper) against the JAX package's: every case of
tests/test_tools.py, each tool run through both packages on the same input
with the same flags, the files they write compared byte for byte.  The
port's tools.ntedit runs its default backend, hybrid, with --device cpu
(the plain torch versions); its --processes 2 pool must write the bytes of
--processes 0."""

import numpy as np
import pytest

from goldpolish_tpu.tools import bf as jbf_tool
from goldpolish_tpu.tools import mask as jmask_tool
from goldpolish_tpu.tools import ntedit as jntedit_tool
from goldpolish_tpu.tools import sealer as jsealer_tool
from goldpolish_tpu.tools import to_upper as jupper_tool
from goldpolish_tpu_torch.io import fasta
from goldpolish_tpu_torch.ops import bloom
from goldpolish_tpu_torch.ops import nthash as nt
from goldpolish_tpu_torch.tools import bf as bf_tool
from goldpolish_tpu_torch.tools import mask as mask_tool
from goldpolish_tpu_torch.tools import ntedit as ntedit_tool
from goldpolish_tpu_torch.tools import sealer as sealer_tool
from goldpolish_tpu_torch.tools import to_upper as upper_tool
from test_tools import _fixture

CPU = ["--device", "cpu"]


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _both(tool, jtool, args_of, tmp_path, extra=()):
    """Run the port's tool and the JAX package's on args_of(prefix); the
    files each lists (a path per name) must hold the same bytes.  Returns
    the port's paths."""
    paths = {}
    for side, main, more in (("port", tool.main, list(extra)), ("jax", jtool.main, [])):
        args, outs = args_of(str(tmp_path / side))
        main([*args, *more])
        paths[side] = outs
    for got, want in zip(paths["port"], paths["jax"]):
        assert _read(got) == _read(want), got
    return paths["port"]


# tests/test_tools.py:32
def test_bf_ntedit_sealer_chain(tmp_path):
    truth, reads, draft, gapped = _fixture(tmp_path)
    _both(bf_tool, jbf_tool,
          lambda p: ([reads, "-k32", "-k28", "-o", p], [f"{p}-k32.bf", f"{p}-k28.bf"]),
          tmp_path)
    prefix = str(tmp_path / "port")
    polished, changes = _both(
        ntedit_tool, jntedit_tool,
        lambda p: ([draft, f"{prefix}-k32.bf", f"{p}.polished.fa", "--changes",
                    f"{p}.ch.tsv"], [f"{p}.polished.fa", f"{p}.ch.tsv"]),
        tmp_path, CPU)
    assert next(iter(fasta.read_seqs(polished))).seq.upper() == truth
    assert sum(1 for _ in open(changes)) == 12 + 1
    sealed, trace = _both(
        sealer_tool, jsealer_tool,
        lambda p: ([gapped, f"{p}.sealed.fa", "--bf", f"{prefix}-k32.bf", "--bf",
                    f"{prefix}-k28.bf", "--lower", "--trace", f"{p}.trace.tsv"],
                   [f"{p}.sealed.fa", f"{p}.trace.tsv"]),
        tmp_path)
    assert next(iter(fasta.read_seqs(sealed))).seq.upper() == truth
    assert sum(1 for _ in open(trace)) >= 2


# tests/test_tools.py:55
def test_ntedit_tool_threshold_mode(tmp_path):
    truth, reads, draft, _ = _fixture(tmp_path)
    prefix = str(tmp_path / "f")
    bf_tool.main([reads, "-k32", "-o", prefix])
    (out,) = _both(ntedit_tool, jntedit_tool,
                   lambda p: ([draft, f"{prefix}-k32.bf", f"{p}.fa", "-x", "5.0", "-y",
                               "9.0"], [f"{p}.fa"]),
                   tmp_path, CPU)
    assert next(iter(fasta.read_seqs(out))).seq.upper() == truth


# tests/test_tools.py:66
def test_mask_and_to_upper_tools(tmp_path):
    src = str(tmp_path / "in.fa")
    with open(src, "w") as f:
        f.write(">x\n" + "A" * 40 + "acgta" + "CGT" + "acgta" + "A" * 40 + "\n")
    (masked,) = _both(mask_tool, jmask_tool,
                      lambda p: ([src, f"{p}.m.fa", "-k", "32"], [f"{p}.m.fa"]), tmp_path)
    m = next(iter(fasta.read_seqs(masked))).seq
    assert "cgt" in m and "CGT" not in m
    (upped,) = _both(upper_tool, jupper_tool,
                     lambda p: ([masked, f"{p}.u.fa"], [f"{p}.u.fa"]), tmp_path)
    u = next(iter(fasta.read_seqs(upped))).seq
    assert u == u.upper()


def _secbf_inputs(tmp_path, seed, n, every, sec_len, sec_bytes, draft_of):
    rng = np.random.default_rng(seed)
    truth = "".join(rng.choice(list("ACGT")) for _ in range(n))
    bf = bloom.BloomFilter(1 << 17 if n > 3000 else 1 << 16, 4, 32)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(nt.encode(truth), 32), 32, 4))
    sec = bloom.BloomFilter(sec_bytes, 4, 32)
    if sec_len:
        sec.insert(nt.multi_hashes(nt.canonical_hashes(nt.encode(truth[:sec_len]), 32),
                                   32, 4))
    bf_path, sec_path = str(tmp_path / "p.bf"), str(tmp_path / "s.bf")
    bf.save(bf_path)
    sec.save(sec_path)
    draft = str(tmp_path / "d.fa")
    with open(draft, "w") as f:
        f.write(draft_of(truth, every))
    return truth, bf, sec, bf_path, sec_path, draft


# tests/test_tools.py:87
def test_ntedit_tool_secbf_walker_matches_oracle(tmp_path):
    from goldpolish_tpu_torch.polish import ntedit_oracle as ne

    def draft_of(truth, every):
        d = list(truth)
        for p in range(200, 4800, every):
            d[p] = "ACGT"[("ACGT".index(d[p]) + 1) % 4]
        return f">c1\n{''.join(d)}\n"

    _truth, bf, sec, bf_path, sec_path, draft = _secbf_inputs(
        tmp_path, 13, 5000, 401, 1500, 1 << 15, draft_of)
    (out,) = _both(ntedit_tool, jntedit_tool,
                   lambda p: ([draft, bf_path, f"{p}.fa", "--secbf", sec_path, "-m1",
                               "-a1"], [f"{p}.fa"]),
                   tmp_path, CPU)
    got = list(fasta.read_seqs(out))[0].seq
    draft_s = list(fasta.read_seqs(draft))[0].seq
    want, _recs, _ed = ne.polish_contig(draft_s.encode(), bf,
                                        ne.Config(k=32, h=4, use_ratio=True, mode=1, mask=1),
                                        sec)
    assert got.encode() == want


# tests/test_tools.py:117
def test_ntedit_tool_secbf_short_contig_untouched(tmp_path):
    def draft_of(truth, _every):
        short = truth[:80]
        mutated = "A" + short[1:] if short[0] != "A" else "C" + short[1:]
        return f">c1\n{mutated}\n>c2\n{truth}\n"

    truth, _bf, _sec, bf_path, sec_path, draft = _secbf_inputs(
        tmp_path, 19, 2000, 0, 0, 1 << 14, draft_of)
    (out,) = _both(ntedit_tool, jntedit_tool,
                   lambda p: ([draft, bf_path, f"{p}.fa", "--secbf", sec_path, "-m1",
                               "-a1"], [f"{p}.fa"]),
                   tmp_path, CPU)
    got = list(fasta.read_seqs(out))
    assert got[0].seq == list(fasta.read_seqs(draft))[0].seq  # below min_contig_len


# tests/test_tools.py:141
def test_bf_tool_btllib_format_chain(tmp_path):
    truth, reads, draft, _g = _fixture(tmp_path)
    (btl,) = _both(bf_tool, jbf_tool,
                   lambda p: ([reads, "-k32", "-o", p, "--format", "btllib"],
                              [f"{p}-k32.bf"]), tmp_path)
    bf_tool.main([reads, "-k32", "-o", str(tmp_path / "a")])
    a = bloom.load_any(str(tmp_path / "a-k32.bf"))
    b = bloom.load_any(btl)
    assert (b.hash_num, b.k) == (a.hash_num, a.k)
    assert bytes(b.array) == bytes(a.array)
    (polished,) = _both(ntedit_tool, jntedit_tool,
                        lambda p: ([draft, btl, f"{p}.pol.fa"], [f"{p}.pol.fa"]),
                        tmp_path, CPU)
    assert next(iter(fasta.read_seqs(polished))).seq.upper() == truth


@pytest.mark.parametrize("backend", ["hybrid", "jax", "numpy"])
def test_ntedit_tool_processes_match_inline(tmp_path, monkeypatch, backend):
    """--processes 2 walks the contigs in the fork-server pool: the bytes of
    --processes 0, on every backend (the hybrid scan forced onto the
    device, so its pipelined path feeds the pool)."""
    monkeypatch.setenv("GPTPU_FORCE_DEVICE_SCAN", "1")
    rng = np.random.default_rng(23)
    truths = ["".join(rng.choice(list("ACGT")) for _ in range(3000)) for _ in range(3)]
    bf = bloom.BloomFilter(1 << 16, 4, 32)
    with open(tmp_path / "d.fa", "w") as f:
        for i, t in enumerate(truths):
            bf.insert(nt.multi_hashes(nt.canonical_hashes(nt.encode(t), 32), 32, 4))
            d = list(t)
            for p in range(150 + 7 * i, 2900, 311):
                d[p] = "ACGT"[("ACGT".index(d[p]) + 1) % 4]
            f.write(f">c{i}\n{''.join(d)}\n")
    bf.save(str(tmp_path / "f.bf"))
    outs = []
    for procs in ("0", "2"):
        outs.append(str(tmp_path / f"o{procs}.fa"))
        ntedit_tool.main([str(tmp_path / "d.fa"), str(tmp_path / "f.bf"), outs[-1],
                          "--backend", backend, "--processes", procs, *CPU])
    assert _read(outs[0]) == _read(outs[1])
    assert [r.seq for r in fasta.read_seqs(outs[1])] == truths


def test_ntedit_tool_refuses_cuda_without_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the no-CUDA refusal cannot show")
    truth, reads, draft, _g = _fixture(tmp_path)
    bf_tool.main([reads, "-k32", "-o", str(tmp_path / "f")])
    for backend in ("hybrid", "jax"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ntedit_tool.main([draft, str(tmp_path / "f-k32.bf"), str(tmp_path / "o.fa"),
                              "--backend", backend])
    ntedit_tool.main([draft, str(tmp_path / "f-k32.bf"), str(tmp_path / "o.fa"),
                      "--backend", "numpy"])
    assert next(iter(fasta.read_seqs(str(tmp_path / "o.fa")))).seq.upper() == truth
