"""The port's `--backend jax` end to end with the sealer on, against the
JAX package's run_bulk(backend="jax", run_sealer=True), on the CPU.

cli.main of goldpolish_tpu_torch with `--backend jax --device cpu` (the
packed scan, the site eval and the sealer's lockstep extension probe as
plain torch versions) on the golden inputs (k = 32, 28, -b 2) must write
the JAX package's bytes, which are tests/golden/expected_polished.fa.  The
golden draft has one N run (gold2) and 60 lowercase bases (gold1), so the
sealer finds gaps and the probe runs.  A file of its own: the JAX run
compiles its ntEdit programs for most of its ~17 s, and xdist's
`--dist loadfile` then runs it beside the other files."""

import os
import threading

from goldpolish_tpu.config import PipelineConfig as JaxConfig
from goldpolish_tpu.pipeline import bulk as jax_bulk
from goldpolish_tpu_torch import cli
from goldpolish_tpu_torch.ops import dbg_extend
from goldpolish_tpu_torch.pipeline import bulk

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def _sealer_stats(monkeypatch) -> list:
    """Collects each batch's sealer stats while the port's run_bulk runs
    (it looks polish_batch_records up per batch, on several threads)."""
    inner, got, lock = bulk.polish_batch_records, [], threading.Lock()

    def wrapped(*args, **kw):
        res = inner(*args, **kw)
        with lock:
            got.append(res.stats["sealer"])
        return res

    monkeypatch.setattr(bulk, "polish_batch_records", wrapped)
    return got


def test_cli_jax_backend_with_sealer_matches_jax_package(tmp_path, monkeypatch):
    common = dict(seqs_to_polish=os.path.join(GOLD, "draft.fa"),
                  polishing_seqs=os.path.join(GOLD, "reads.fq"),
                  mappings_path=os.path.join(GOLD, "map.paf"), k_values=[32, 28],
                  batch_size=2, backend="jax", run_sealer=True)
    want_cfg = JaxConfig(output_seqs=str(tmp_path / "want.fa"),
                         workspace=str(tmp_path / "ws_jax"), **common)
    jax_bulk.run_bulk(want_cfg)
    with open(want_cfg.output_seqs, "rb") as f:
        want = f.read()
    with open(os.path.join(GOLD, "expected_polished.fa"), "rb") as f:
        assert want == f.read()

    stats = _sealer_stats(monkeypatch)
    calls = dbg_extend.dbg_extend4_reference.calls.value
    out = tmp_path / "got.fa"
    rc = cli.main([common["seqs_to_polish"], common["polishing_seqs"], str(out),
                   "--mappings", common["mappings_path"], "-k", "32", "-k", "28",
                   "-b", "2", "--backend", "jax", "--device", "cpu",
                   "-m", str(tmp_path / "ws")])
    assert rc == 0
    assert out.read_bytes() == want
    assert sum(s["gaps_found"] for s in stats) >= 2
    assert sum(s["gaps_closed"] for s in stats) >= 1
    assert dbg_extend.dbg_extend4_reference.calls.value > calls
