"""The plain reference against the port on the CPU: the fill's level
schedule against the port's native fill, the torch site eval against the
NumPy one, and whole small cells (bulk and targeted) where every filter,
ntEdit output, sealer output and output byte must agree."""

import numpy as np
import pytest
import torch

from gpbench.reference import bloom, fill
from gpbench.reference import nthash as nt
from gpbench.reference import siteeval as se

from ._tiny import run_cell


def reads_of(rng, genome, n, err):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for _ in range(n):
        ln = int(rng.integers(400, 3000))
        s = int(rng.integers(0, len(genome) - ln))
        r = genome[s : s + ln].copy()
        m = rng.random(ln) < err
        r[m] = acgt[rng.integers(0, 4, int(m.sum()))]
        out.append(r.tobytes())
    return out


@pytest.mark.parametrize("cbf_bytes,part,chunks", [(1 << 17, 1 << 27, 64),
                                                   (3 << 16, 5000, 7)])
def test_fill_equals_the_ports_native_fill(monkeypatch, cbf_bytes, part, chunks):
    """Also with the level computation cut into many resource ranges and
    operation chunks, as the largest cells run it."""
    from goldpolish_tpu_torch import native
    from goldpolish_tpu_torch.ops import bloom as port_bloom

    monkeypatch.setattr(fill, "_PART_ENTRIES", part)
    monkeypatch.setattr(fill, "_CHUNKS", chunks)
    rng = np.random.default_rng(4)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 20_000)]
    reads = reads_of(rng, genome, 300, 0.01)
    thr = [int(t) for t in rng.integers(4, 9, len(reads))]
    ks, bf_bytes = [32, 28, 24, 20], 1 << 16
    want_bfs = [port_bloom.BloomFilter(bf_bytes, 4, k) for k in ks]
    native.fill_bfs_stream(reads, thr, 4, ks,
                           [port_bloom.CountingBloomFilter8(cbf_bytes, 4, k) for k in ks],
                           want_bfs)
    got = fill.fill_batch(reads, thr, ks, 4, cbf_bytes, bf_bytes, device="cpu")
    for g, w in zip(got, want_bfs):
        assert np.array_equal(g, w.array)
    # the control's superset contains every bit of the true fill
    sup = fill.fill_batch(reads, thr, ks, 4, cbf_bytes, bf_bytes, superset=True)
    assert all(not np.any(g & ~s) for g, s in zip(got, sup))
    assert any(np.any(s & ~g) for g, s in zip(got, sup))


def test_window_hashes_equal_the_numpy_hashes():
    rng = np.random.default_rng(2)
    codes = np.frombuffer(b"ACGTNacgt", np.uint8)[rng.integers(0, 9, 3000)].copy()
    for k in (20, 32, 33):
        base = nt.canonical_hashes(codes, k)
        want = nt.multi_hashes(base, k, 4).view(np.int64)
        starts = torch.arange(len(codes) - k + 1)
        got = fill.window_hashes(torch.from_numpy(codes), starts, k, 4).numpy()
        assert np.array_equal(got, want)
    x = torch.tensor([-1, -(2**63), 12345678901234, -987654321], dtype=torch.int64)
    for m in (10 * 1024 * 1024, 3 << 20, 1 << 20):
        want = [(int(v) & nt.MASK64) % m for v in x]
        assert fill.umod(x, m).tolist() == want


@pytest.mark.parametrize("k", [32, 20])
def test_torch_site_eval_equals_numpy(k):
    rng = np.random.default_rng(k)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 5000)].copy()
    seq[::97] = ord("N")
    seq[5::131] = ord("a")
    bf = bloom.BloomFilter(1 << 16, 4, k)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(seq[:3000], k), k, 4))
    tables = se.make_tables(k, 3, 5, 5)
    sites = np.sort(rng.choice(len(seq) - k - 10, 64, replace=False)).astype(np.int64)
    sites = np.concatenate([sites, [len(seq) - k, len(seq) - k - 1]])
    for combos in (21, 341):
        a = se.eval_sites_np(seq, sites, bf, tables, 4, combos)
        b = se.eval_sites(seq, sites, bf, tables, 4, combos,
                          dev_filter=se.DeviceFilter(bf, "cpu"))
        for f in ("sub_cand", "gate", "sub_support", "ins_support", "del_support"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("workload,seed", [("ecoli_bulk.ont_draft", 2**31 + 5),
                                           ("ecoli_target.gapfill", 2**31 + 6)])
def test_reference_agrees_with_the_port(workload, seed):
    rc, res, err = run_cell(workload, seed)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res["check"]
    assert all(v["value"] == 0 for v in res["check"].values())
