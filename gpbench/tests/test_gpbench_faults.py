"""`correct` comes out false when the timed path is broken underneath: the
harness's whole run, its look for a chip skipped (--device cpu), with one
fault planted in the port for each that a cell can have; and for the
control, the plain reference with the fill's counting broken put in the
port's place (on the card, at the cells' own size).  (One chip: no exchange between chips to leave out.)"""

import pytest

from ._tiny import run_cell

CELLS = [("ecoli_bulk.ont_draft", 2**31 + 11), ("ecoli_target.gapfill", 2**31 + 12)]


def fault_unchanged(monkeypatch):
    """ntEdit returns its state unchanged."""
    from goldpolish_tpu_torch.polish import multik

    inner = multik.polish_multik
    monkeypatch.setattr(multik, "polish_multik",
                        lambda records, *a, **kw: (records, inner(records, *a, **kw)[1]))


def fault_half_the_batch(monkeypatch):
    """Half of each batch's reads left out of its filters."""
    from goldpolish_tpu_torch import bf_builder

    inner = bf_builder.BFBuilder.read_stream

    def half(self, ids):
        reads, thrs = inner(self, ids)
        return reads[: len(reads) // 2], thrs[: len(thrs) // 2]

    monkeypatch.setattr(bf_builder.BFBuilder, "read_stream", half)


def fault_altered_answer(monkeypatch):
    """One base of each polished batch altered where it is produced."""
    from goldpolish_tpu_torch.polish import mask

    inner = mask.to_upper

    def flip(seq):
        s = inner(seq)
        i = len(s) // 2
        return s[:i] + ("A" if s[i] != "A" else "C") + s[i + 1:]

    monkeypatch.setattr(mask, "to_upper", flip)


@pytest.mark.parametrize("workload,seed", CELLS)
@pytest.mark.parametrize("fault", [fault_unchanged, fault_half_the_batch,
                                   fault_altered_answer])
def test_fault_is_not_correct(monkeypatch, workload, seed, fault):
    fault(monkeypatch)
    rc, res, err = run_cell(workload, seed)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["check"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 21, 2**31 + 22, 2**31 + 23])
def test_control_is_not_correct(seed):
    """The control at the cell's own size, on the card: its filters differ
    from the plain reference's.  (At the small cells' size the counting
    filter is too empty for the occurrence totals to differ from the
    conservative counts; fill.py's own test shows them differing at load.)"""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size, on the card")
    rc, res, err = run_cell("ecoli_bulk.ont_draft", seed, 1, 0, "--control", bench=None)
    print(seed, res and res["check"])
    assert rc == 0, err[-3000:]
    assert res["correct"] is False
    assert res["check"]["filter_bits"]["value"] > 0
