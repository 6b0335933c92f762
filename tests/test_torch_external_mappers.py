"""Stub-executable coverage of the port's ntLink / minimap2 / internal
mapper paths (tests/test_external_mappers.py :56, :89, :121, :192, :217 on
goldpolish_tpu_torch): fake `minimap2` / `ntLink` executables on PATH emit
precomputed mappings; each case pins the argv the subprocess receives, the
artifact names, mtime reuse and the cross-filesystem workspace, and holds
the port's polished bytes equal to the JAX package's run of the same
config with --mappings.  The port runs its host backend here (numpy); the
mapping plumbing is the same for every backend."""

import os
import shutil

import pytest

from goldpolish_tpu.config import PipelineConfig as JaxConfig
from goldpolish_tpu.pipeline import bulk as jax_bulk
from goldpolish_tpu.pipeline import targeted as jax_targeted
from goldpolish_tpu_torch import mapper as internal_mapper
from goldpolish_tpu_torch.config import PipelineConfig
from goldpolish_tpu_torch.pipeline import bulk, targeted
from test_external_mappers import _install_stub, _targeted_inputs
from test_pipeline import _write_synthetic


def _bulk_cfg(cls, draft, reads, out, tmp_path, **kw):
    if cls is PipelineConfig:
        kw.setdefault("backend", "numpy")
    return cls(seqs_to_polish=draft, polishing_seqs=reads, output_seqs=out,
               k_values=[32, 28], batch_size=2, workspace=str(tmp_path),
               max_concurrent_batches=2, **kw)


def _jax_output(tmp_path, draft, reads, mappings) -> bytes:
    """The JAX package's bulk bytes with --mappings: the baseline."""
    out = str(tmp_path / "jax_polished.fa")
    jax_bulk.run_bulk(_bulk_cfg(JaxConfig, draft, reads, out, tmp_path,
                                mappings_path=mappings))
    with open(out, "rb") as f:
        return f.read()


# tests/test_external_mappers.py:56
def test_bulk_minimap2_stub(tmp_path, monkeypatch):
    draft, reads, paf, _ = _write_synthetic(tmp_path, n_contigs=2, contig_len=2000,
                                            coverage=10)
    expected = _jax_output(tmp_path, draft, reads, paf)
    argv_log = _install_stub(tmp_path, monkeypatch, "minimap2", f"cat {paf}")
    cwd = tmp_path / "m2_cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    out = str(tmp_path / "m2_polished.fa")
    bulk.run_bulk(_bulk_cfg(PipelineConfig, draft, reads, out, tmp_path,
                            mapper="minimap2", threads=2))
    with open(argv_log) as f:
        assert f.read().split() == ["-t2", draft, reads]
    assert (cwd / f"{os.path.basename(draft)}.{os.path.basename(reads)}.paf").exists()
    with open(out, "rb") as f:
        assert f.read() == expected
    # mtime reuse: a rerun does not invoke the mapper again
    os.unlink(argv_log)
    out2 = str(tmp_path / "m2_polished2.fa")
    bulk.run_bulk(_bulk_cfg(PipelineConfig, draft, reads, out2, tmp_path,
                            mapper="minimap2", threads=2))
    assert not os.path.exists(argv_log)
    with open(out2, "rb") as f:
        assert f.read() == expected


# tests/test_external_mappers.py:89
def test_bulk_ntlink_stub(tmp_path, monkeypatch):
    draft, reads, _paf, _ = _write_synthetic(tmp_path, n_contigs=2, contig_len=2000,
                                             coverage=10)
    tsv = str(tmp_path / "precomputed.mapping.tsv")
    internal_mapper.write_mapping_tsv(draft, reads, tsv)
    expected = _jax_output(tmp_path, draft, reads, tsv)
    artifact_name = f"{os.path.basename(draft)}.k88.w1000.z1000.mapping.tsv"
    argv_log = _install_stub(tmp_path, monkeypatch, "ntLink",
                             f"cp {tsv} {artifact_name}")
    cwd = tmp_path / "ntlink_cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    out = str(tmp_path / "ntlink_polished.fa")
    bulk.run_bulk(_bulk_cfg(PipelineConfig, draft, reads, out, tmp_path,
                            mapper="ntlink", threads=2))
    with open(argv_log) as f:
        assert f.read().split() == [
            "t=2", f"target={draft}", f"reads={reads}", "pair",
            "verbose=True", "k=88", "w=1000", "sensitive=True",
        ]
    assert (cwd / artifact_name).exists()
    with open(out, "rb") as f:
        assert f.read() == expected


# tests/test_external_mappers.py:121
@pytest.mark.skipif(not os.path.isdir("/dev/shm"), reason="no /dev/shm")
def test_bulk_internal_mapper_cross_filesystem_workspace(tmp_path, monkeypatch):
    """The mapping's tmp file is made next to its destination in the CWD,
    so os.replace never crosses from the tmpfs workspace; the bytes are the
    JAX package's internal-mapper run's."""
    assert shutil.which("ntLink") is None  # no stub: the internal fallback
    draft, reads, _paf, _ = _write_synthetic(tmp_path, n_contigs=2, contig_len=2000,
                                             coverage=10)
    outs = []
    for name, cls, run in (("jax", JaxConfig, jax_bulk.run_bulk),
                           ("port", PipelineConfig, bulk.run_bulk)):
        cwd = tmp_path / f"{name}_cwd"
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        shm_ws = f"/dev/shm/gp_torch_exdev_{name}_{os.getpid()}"
        os.makedirs(shm_ws, exist_ok=True)
        try:
            outs.append(str(tmp_path / f"{name}_polished.fa"))
            run(_bulk_cfg(cls, draft, reads, outs[-1], shm_ws))
            artifact = (cwd / f"{os.path.basename(draft)}."
                        f"{os.path.basename(reads)}.internal.mapping.tsv")
            assert artifact.exists()
        finally:
            shutil.rmtree(shm_ws, ignore_errors=True)
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        want = a.read()
        assert want and b.read() == want


def _targeted_cfg(cls, draft, reads, out, tmp_path, **kw):
    if cls is PipelineConfig:
        kw.setdefault("backend", "numpy")
    return cls(seqs_to_polish=draft, polishing_seqs=reads, output_seqs=out,
               k_values=[32, 28], target=True, flank_length=64,
               workspace=str(tmp_path), **kw)


def _jax_targeted_output(tmp_path, draft, reads, paf) -> bytes:
    (tmp_path / "jax_ref").mkdir()
    out = str(tmp_path / "jax_ref" / "out.fa")
    jax_targeted.run_targeted(_targeted_cfg(JaxConfig, draft, reads, out, tmp_path,
                                            mappings_path=paf))
    with open(out, "rb") as f:
        return f.read()


# tests/test_external_mappers.py:192
def test_targeted_minimap2_stub(tmp_path, monkeypatch):
    draft, reads, paf, _truth = _targeted_inputs(tmp_path)
    expected = _jax_targeted_output(tmp_path, draft, reads, paf)
    argv_log = _install_stub(tmp_path, monkeypatch, "minimap2", f"cat {paf}")
    cwd = tmp_path / "t_m2_cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    out = str(tmp_path / "t_m2_out.fa")
    targeted.run_targeted(_targeted_cfg(PipelineConfig, draft, reads, out, tmp_path,
                                        mapper="minimap2", threads=2))
    with open(argv_log) as f:
        assert f.read().split() == ["-t2", draft, reads]
    assert (cwd / f"{os.path.basename(draft)}.targeted.paf").exists()
    with open(out, "rb") as f:
        assert f.read() == expected


# tests/test_external_mappers.py:217
def test_targeted_ntlink_stub(tmp_path, monkeypatch):
    draft, reads, paf, _truth = _targeted_inputs(tmp_path)
    expected = _jax_targeted_output(tmp_path, draft, reads, paf)
    artifact = f"{draft}.k88.w1000.z1000.paf"  # next to the draft, not the CWD
    argv_log = _install_stub(tmp_path, monkeypatch, "ntLink", f"cp {paf} {artifact}")
    cwd = tmp_path / "t_nl_cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    out = str(tmp_path / "t_nl_out.fa")
    targeted.run_targeted(_targeted_cfg(PipelineConfig, draft, reads, out, tmp_path,
                                        mapper="ntlink", threads=2))
    with open(argv_log) as f:
        assert f.read().split() == [
            "pair", f"target={draft}", f"reads={reads}", "sensitive=True",
            "dev=True", "k=88", "w=1000", "t=2", "paf=True",
        ]
    assert os.path.exists(artifact)
    with open(out, "rb") as f:
        assert f.read() == expected
