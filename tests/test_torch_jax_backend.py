"""The editor's `jax` backend of the port (NtEditGPU(backend="jax"): the
packed dense probe and the batched site eval on the device, the two-phase
Python walk) and bulk's device_bf_build against the JAX package's NtEditTPU
and run_bulk, on the CPU (the plain torch versions).  Output bytes and edit
records must be equal.

The JAX editor's site eval runs on at most 16 sites per call, in a site
bucket of 16: each site's supports depend on that site alone, and the
JAX program's padded rows are sliced off, so neither changes the result;
its default bucket of 256 takes GBs on the CPU at 341 combos."""

import os

import numpy as np
import pytest
from test_ntedit_tpu import _genome, _mutate
from test_torch_slice import _synthetic

from goldpolish_tpu.ops import bloom as jbloom
from goldpolish_tpu.ops import nthash as jnt
from goldpolish_tpu.ops import siteeval_jax
from goldpolish_tpu.ops.siteeval import SiteSupports
from goldpolish_tpu.polish import ntedit_oracle as jne
from goldpolish_tpu.polish.ntedit_tpu import NtEditTPU
from goldpolish_tpu_torch import cli
from goldpolish_tpu_torch.config import PipelineConfig
from goldpolish_tpu_torch.ops import bloom, dbg_extend
from goldpolish_tpu_torch.ops import siteeval_device as sd
from goldpolish_tpu_torch.pipeline import bulk
from goldpolish_tpu_torch.polish import ntedit_oracle as ne
from goldpolish_tpu_torch.polish.ntedit_gpu import NtEditGPU

K, H = 32, 4
CFG = dict(k=K, h=H, use_ratio=True)


@pytest.fixture(autouse=True)
def _small_jax_site_bucket(monkeypatch):
    orig = siteeval_jax.eval_sites_jax

    def eval_sites_jax(seq_codes, sites_w, *args, **kw):
        kw["s_bucket"] = 16
        parts = [orig(seq_codes, sites_w[i : i + 16], *args, **kw)
                 for i in range(0, len(sites_w), 16)]
        return SiteSupports(**{
            f: np.concatenate([getattr(p, f) for p in parts])
            for f in ("sub_cand", "gate", "sub_support", "ins_support", "del_support")
        }, n_combos=parts[0].n_combos)

    monkeypatch.setattr(siteeval_jax, "eval_sites_jax", eval_sites_jax)


def _filters(truth: str, nbytes=1 << 17):
    """The same filter of the truth's k-mers in both packages."""
    jbf = jbloom.BloomFilter(nbytes, H, K)
    jbf.insert(jnt.multi_hashes(jnt.canonical_hashes(jnt.encode(truth), K), K, H))
    bf = bloom.BloomFilter(nbytes, H, K)
    bf.array[:] = jbf.array
    return jbf, bf


def _both(cfg_kw, jbf, bf):
    return (NtEditTPU(jne.Config(**cfg_kw), jbf, backend="jax"),
            NtEditGPU(ne.Config(**cfg_kw), bf, backend="jax", device="cpu"))


@pytest.mark.parametrize("mode,mask,nbytes", [(0, 1, 1 << 17), (1, 1, 1 << 17),
                                              (2, 0, 1 << 17), (1, 0, 1 << 12)])
def test_jax_arm_matches_jax_package(mode, mask, nbytes):
    """Modes 0/1/2 (mode 0: 64-site batches of 21 combos; modes 1/2:
    256-site batches of 341), a draft with substitution, insertion and
    deletion errors, IUPAC codes, an N run and lowercase bytes; the last row
    on an undersized filter (many false positives: more hot sites)."""
    rng = np.random.default_rng(mode * 7 + nbytes)
    truth = _genome(rng, 2400)
    jbf, bf = _filters(truth, nbytes)
    d = bytearray(_mutate(rng, truth, 14).encode())
    d[600:604] = b"NNNN"
    d[900], d[1300] = ord("R"), ord("y")
    d[1700:1730] = bytes(d[1700:1730]).lower()
    draft = bytes(d)
    calls = sd.eval_sites_device_reference.calls.value
    want_eng, got_eng = _both(dict(CFG, mode=mode, mask=mask), jbf, bf)
    out_j, recs_j, ed_j = want_eng.polish_contig(draft)
    out_t, recs_t, ed_t = got_eng.polish_contig(draft)
    assert out_t == out_j and recs_t == recs_j
    assert (ed_t.n_subs, ed_t.n_ins, ed_t.n_dels, ed_t.n_masked) == (
        ed_j.n_subs, ed_j.n_ins, ed_j.n_dels, ed_j.n_masked)
    assert sd.eval_sites_device_reference.calls.value > calls  # the device eval ran


# tests/test_ntedit_tpu.py:200
def test_jax_backend_matches_numpy_backend():
    rng = np.random.default_rng(30)
    truth = _genome(rng, 3000)
    _jbf, bf = _filters(truth)
    draft = _mutate(rng, truth, 15, "sid").encode()
    cfg = ne.Config(**CFG)
    out_n, recs_n, _ = NtEditGPU(cfg, bf, backend="numpy").polish_contig(draft)
    out_j, recs_j, _ = NtEditGPU(cfg, bf, backend="jax", device="cpu").polish_contig(draft)
    assert out_j == out_n and recs_j == recs_n


# tests/test_ntedit_tpu.py:230, against the JAX package's jax arm as well
@pytest.mark.parametrize("mode", [0, 1])
def test_polish_many_matches_single_jax(mode):
    rng = np.random.default_rng(33)
    truth = _genome(rng, 2500)
    jbf, bf = _filters(truth)
    seqs = [_mutate(np.random.default_rng(40 + i), truth, 6, "sid").encode()
            for i in range(5)]
    seqs.append(seqs[0][:1500])  # another length bucket
    want_eng, eng = _both(dict(CFG, mode=mode), jbf, bf)
    many = eng.polish_many(seqs)
    want = want_eng.polish_many(seqs)
    for s, (out_m, recs_m, _), (out_w, recs_w, _) in zip(seqs, many, want):
        out_1, recs_1, _ = NtEditGPU(ne.Config(**CFG, mode=mode), bf,
                                     backend="numpy").polish_contig(s)
        assert out_m == out_1 == out_w and recs_m == recs_1 == recs_w
    pooled = eng.polish_many(seqs, processes=2)  # fork pool beside the CPU arm
    assert [o for o, _r, _s in pooled] == [o for o, _r, _e in many]


def test_jax_arm_refuses_cuda_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NtEditGPU(ne.Config(**CFG), bloom.BloomFilter(1 << 12, H, K), backend="jax")


# -- bulk: the jax backend with device_bf_build ------------------------------


def _cfg(cls, inputs, tmp_path, name, **kw):
    draft, reads, paf = inputs
    return cls(seqs_to_polish=draft, polishing_seqs=reads,
               output_seqs=str(tmp_path / name), mappings_path=paf,
               k_values=[32, 24], batch_size=1, workspace=str(tmp_path),
               max_concurrent_batches=2, **{"run_sealer": False, **kw})


def _cut_gaps(draft: str) -> None:
    """An N run and a lowercase span in every contig of a draft file, as
    tests/test_sealer.py:185 cuts them (the sealer's gaps)."""
    with open(draft) as f:
        blocks = [b.split("\n")[:2] for b in f.read().split(">")[1:]]
    with open(draft, "w") as f:
        for head, seq in blocks:
            seq = seq[:600] + "N" * 30 + seq[630:1300] + seq[1300:1340].lower() + seq[1340:]
            f.write(f">{head}\n{seq}\n")


@pytest.mark.parametrize("lookahead,sealer", [
    pytest.param(True, False, id="True"), pytest.param(False, False, id="False"),
    pytest.param(True, True, id="sealer"),
])
def test_run_bulk_device_bf_build_matches_jax_package(tmp_path, monkeypatch, lookahead,
                                                      sealer):
    """run_bulk(backend="jax", device_bf_build=True): the device fill of
    every batch (kernel 5's plain version) and the jax editor arm write the
    JAX package's bytes for the same config (the device fills are bit-equal
    by the port's contract); with the lookahead fill thread and without it,
    with the sealer off, and with it on (tests/test_pipeline.py:164 with
    the sealer) over drafts with gaps cut in: its lockstep searches probe
    through the extension probe's plain version."""
    from goldpolish_tpu.config import PipelineConfig as JaxConfig
    from goldpolish_tpu.pipeline import bulk as jbulk

    *inputs, truths = _synthetic(tmp_path, n_contigs=2, contig_len=2000)
    if sealer:
        _cut_gaps(inputs[0])
    common = dict(backend="jax", device_bf_build=True, lookahead_fill=lookahead,
                  run_sealer=sealer)
    jbulk.run_bulk(_cfg(JaxConfig, inputs, tmp_path, "want.fa", **common))
    calls = sd.eval_sites_device_reference.calls.value
    probes = dbg_extend.dbg_extend4_reference.calls.value
    seals = []
    polish = bulk.polish_batch_records

    def tallied(*args, **kw):
        res = polish(*args, **kw)
        seals.append(res.stats.get("sealer"))
        return res

    monkeypatch.setattr(bulk, "polish_batch_records", tallied)
    totals = bulk.run_bulk(_cfg(PipelineConfig, inputs, tmp_path, "got.fa",
                                device="cpu", **common))
    got = open(tmp_path / "got.fa").read()
    assert got == open(tmp_path / "want.fa").read()
    assert totals["device_filled_batches"] == totals["batches"] == 2
    assert sd.eval_sites_device_reference.calls.value > calls
    if sealer:
        assert sum(s["gaps_found"] for s in seals) >= 4  # two cut into each draft
        assert dbg_extend.dbg_extend4_reference.calls.value > probes
    else:
        assert seals == [None, None]
    recovered = [s.split("\n")[1] for s in got.split(">")[1:]]
    assert recovered == truths


def test_startup_refusals(tmp_path):
    """The jax backend with the sealer on runs (the CLI's jax arm, no
    --no-sealer); device_bf_build off the jax backend and a device backend
    on cuda without CUDA raise at startup."""
    import torch

    *inputs, truths = _synthetic(tmp_path, n_contigs=1)
    argv = [inputs[0], inputs[1], str(tmp_path / "jax.fa"),
            "--mappings", inputs[2], "--device", "cpu", "--backend", "jax"]
    assert cli.main(argv) == 0
    # the sealer writes ">id comment", the comment empty (the reference's quirk)
    assert open(tmp_path / "jax.fa").read() == f">ctg0 \n{truths[0]}\n"
    for backend in ("hybrid", "numpy"):
        with pytest.raises(ValueError, match="device_bf_build"):
            bulk.run_bulk(_cfg(PipelineConfig, inputs, tmp_path, "o.fa", backend=backend,
                               device="cpu", device_bf_build=True))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv[:2] + [str(tmp_path / "o.fa")] + argv[3:-4] + ["--backend", "jax"])
    assert not os.path.exists(tmp_path / "o.fa")
