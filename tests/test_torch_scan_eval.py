"""ops/scan_eval (the fused phase-A eval, K2) of the port against the JAX
package's FusedEval, the host spec, the native table replay and the engine.

Every comparison is exact (tolerance 0: integer hashing and counts).  The
JAX program compiles once per (config, filter size, call shape), ~7 s
each on a CPU, so the parity cases share four programs: every input is
[3, 4000] rows cut with k-1 halos and padded with 'A', as the scan pipe
packs them (tests/test_scan_eval.py:69-90).  The JAX parity inputs avoid
bytes 1, 3, 4 and 7, whose seeds the JAX conv scan drops; a host-spec case
pins them.  The JAX package is imported only where it is compared with, so
the CUDA cases also run where jax is not installed
(`pytest --noconftest -m cuda`)."""

import numpy as np
import pytest
import torch

from goldpolish_tpu_torch import native
from goldpolish_tpu_torch.ops import bloom
from goldpolish_tpu_torch.ops import nthash as nt
from goldpolish_tpu_torch.ops import scan_eval as tse
from goldpolish_tpu_torch.ops import siteeval
from goldpolish_tpu_torch.polish.multik import ntedit_config_for_k
from goldpolish_tpu_torch.polish.ntedit_gpu import NtEditGPU

ROWS, ROW_BYTES = 3, 4000
NAMES = ("packed", "n_sites", "site", "gate", "sub_sup", "del_sup", "ins_lane",
         "ins_ok", "ins_sup")


def _scenario(n, k, h, seed, bf_bytes, spacing, extras=True, control=False):
    """Truth k-mers in a filter and a draft with sub/del/ins errors every
    `spacing` bp; extras add a lowercase run, an N run and IUPAC bytes;
    control adds bytes 1, 3, 4 and 7 near errors."""
    rng = np.random.default_rng(seed)
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes()
    bf = bloom.BloomFilter(bf_bytes, h, k)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(np.frombuffer(truth, np.uint8), k),
                              k, h))
    d = bytearray(truth)
    for i, p in enumerate(range(3 * k, n - 3 * k, spacing)):
        kind = i % 3
        if kind == 0:
            d[p] = ord("A") if d[p] != ord("A") else ord("G")
        elif kind == 1:
            q = p
            while d[q] == d[q - 1] or d[q] == d[q + 1]:
                q += 1
            del d[q]
        else:
            d.insert(p, next(c for c in b"TGCA" if c != d[p - 1] and c != d[p]))
        if control and i % 4 == 0:
            d[p + k + 3] = (1, 3, 4, 7)[(i // 4) % 4]
    if extras:
        a = len(d) // 3
        d[a : a + 40] = bytes(d[a : a + 40]).lower()
        d[a + 900 : a + 912] = b"N" * 12
        for j, c in enumerate(b"RYSWKMBDHVn"):
            d[2 * len(d) // 3 + 97 * j] = c
    return bytes(d), bf


def _rows(draft: bytes, k: int):
    """Segments of ROW_BYTES with k-1 halos, the last padded with 'A'."""
    codes = np.frombuffer(draft, np.uint8)
    nw_row = ROW_BYTES - k + 1
    total = len(codes) - k + 1
    rows, meta = [], []  # meta: (w0, nw) of each row
    w = 0
    while w < total:
        take = min(nw_row, total - w)
        row = np.full(ROW_BYTES, ord("A"), np.uint8)
        row[: take + k - 1] = codes[w : w + take + k - 1]
        rows.append(row)
        meta.append((w, take))
        w += take
    assert len(rows) == ROWS  # one call shape for every case: programs shared
    return np.stack(rows), meta


def _words(bf) -> torch.Tensor:
    return torch.from_numpy(np.asarray(bf.words_u32()).view(np.int32).copy())


def _ecfg_kw(k, h, **over):
    cfg = ntedit_config_for_k(k, hash_num=h)
    kw = dict(k=k, h=h, jump=cfg.jump, max_ins=cfg.max_insertions,
              max_del=cfg.max_deletions, thr_edit=cfg.thr_edit,
              thr_missing=cfg.thr_missing, s_max=256)
    kw.update(over)
    return kw


def _port(bf, kw, codes, device="cpu"):
    ecfg = tse.EvalConfig(**kw)
    tables = siteeval.make_tables(ecfg.k, ecfg.jump, ecfg.max_ins, ecfg.max_del)
    fused = tse.FusedEval(ecfg, int(bf.bits), tables, device)
    out = fused(_words(bf).to(device), torch.from_numpy(codes.copy()).to(device))
    return [t.cpu().numpy() for t in out]


def _jax(bf, kw, codes):
    import jax.numpy as jnp
    from goldpolish_tpu.ops import scan_eval as jse
    from goldpolish_tpu.ops import siteeval as jsite

    ecfg = jse.EvalConfig(**kw)
    fused = jse.FusedEval(ecfg, int(bf.bits), jsite.make_tables(
        ecfg.k, ecfg.jump, ecfg.max_ins, ecfg.max_del))
    return [np.asarray(x) for x in fused(jnp.asarray(bf.words_u32()),
                                         jnp.asarray(codes))]


@pytest.mark.parametrize("k", [20, 24, 28, 32])
def test_delta_tables_equal_jax(k):
    from goldpolish_tpu.ops import scan_eval as jse

    for got, want in zip(tse._sub_delta_tables(), jse._sub_delta_tables()):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    got, want = tse._ins_delta_tables(k, 3, 5), jse._ins_delta_tables(k, 3, 5)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[0].shape == (341, len(range(0, k - 1, 3)))


# case -> (k, h, eval config overrides, filter bytes, seed, error spacing);
# four JAX programs: bulk k=32 S=256; k=32 S=64 s_ins=8; k=32 thr_edit=0.5
# S=64 on a non-power-of-two filter; k=20 h=3 S=256
_NON_POW2 = 3 * (1 << 12) + 4
_PARITY = {
    "bulk": (32, 4, {}, 1 << 14, 1, 150),
    "n_sites_over_s": (32, 4, dict(s_max=64, s_ins=8), 1 << 14, 2, 120),
    "needing_over_s_ins": (32, 4, dict(s_max=64, s_ins=8), 1 << 14, 3, 170),
    "survivor_overflow": (32, 4, dict(thr_edit=0.5, s_max=64), _NON_POW2, 4, 200),
    "non_pow2_filter": (32, 4, dict(thr_edit=0.5, s_max=64), _NON_POW2, 5, 160),
    "k20_h3": (20, 3, {}, 1 << 14, 6, 150),
}


@pytest.mark.parametrize("case", list(_PARITY))
def test_plain_matches_jax_fused_eval(case):
    k, h, over, bf_bytes, seed, spacing = _PARITY[case]
    draft, bf = _scenario(11000, k, h, seed, bf_bytes, spacing)
    codes, _meta = _rows(draft, k)
    kw = _ecfg_kw(k, h, **over)
    got = _port(bf, kw, codes)
    want = _jax(bf, kw, codes)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and np.array_equal(g, w), name
    n_sites, site, ins_lane, ins_ok = int(got[1]), got[2], got[6], got[7]
    needing = int(((site >= 0) & (ins_lane >= 0)).sum())
    S, SI = kw["s_max"], tse.EvalConfig(**kw).resolved_s_ins()
    assert n_sites > 0 and needing > 0
    if case == "n_sites_over_s":
        assert n_sites > S
    elif case == "needing_over_s_ins":
        assert needing > SI and (ins_ok[(site >= 0) & (ins_lane >= 0)] == 0).any()
    elif case == "survivor_overflow":
        assert ((ins_lane >= 0) & (ins_ok == 0) & (got[8] != 0).any(axis=1)).any()
    elif case == "non_pow2_filter":
        assert int(bf.bits) & (int(bf.bits) - 1)
    else:
        assert n_sites <= S


def _heads_ref(hot: np.ndarray, k: int) -> np.ndarray:
    """First hot window with no hot in [w-k+1, w-1] (the device rule)."""
    return np.array([w for w in np.nonzero(hot)[0]
                     if not hot[max(0, w - k + 1) : w].any()], np.int64)


@pytest.mark.parametrize("control", [False, True], ids=["iupac", "bytes_1_3_4_7"])
def test_plain_matches_host_spec(control):
    """Presence, heads and interior-site tables against the port's host
    scan, host masks and siteeval.eval_sites_np (the walker's spec).  With
    bytes 1, 3, 4 and 7 the port follows the host, not the JAX conv scan."""
    k, h = 32, 4
    draft, bf = _scenario(11000, k, h, 7 + control, 1 << 14, 150, control=control)
    codes, meta = _rows(draft, k)
    kw = _ecfg_kw(k, h, s_max=512)
    (packed, n_sites, site, gate, sub_sup, del_sup, ins_lane, ins_ok,
     ins_sup) = _port(bf, kw, codes)
    cfg = ntedit_config_for_k(k, hash_num=h)
    eng = NtEditGPU(cfg, bf, backend="numpy", device="cpu")
    contig = np.frombuffer(draft, np.uint8)
    pres_host = eng._present_host(contig)
    bits = np.unpackbits(packed, axis=1, bitorder="little")
    nw_row = ROW_BYTES - k + 1
    heads = []
    for r, (w0, nw) in enumerate(meta):
        assert np.array_equal(bits[r, :nw].astype(bool), pres_host[w0 : w0 + nw])
        row_masks = eng._masks(codes[r], eng._present_host(codes[r]))
        heads += [r * nw_row + w for w in _heads_ref(row_masks.hot, k)]
    assert int(n_sites) == len(heads)
    got_sites = site[site >= 0]
    assert np.array_equal(got_sites, np.array(heads)[: len(got_sites)])
    tables = siteeval.make_tables(k, cfg.jump, cfg.max_insertions, cfg.max_deletions)
    thr = np.float32(cfg.thr_edit)
    checked = 0
    for gi, g in enumerate(got_sites):
        r, wl = divmod(int(g), nw_row)
        w0, nw = meta[r]
        if wl > nw - 2 * k:  # the pipe's drop rule: segment-tail sites
            continue
        sup = siteeval.eval_sites_np(contig, np.array([w0 + wl]), bf, tables, h,
                                     tables.n_combos)
        assert np.array_equal(gate[gi], sup.gate[0].astype(np.uint8))
        assert np.array_equal(sub_sup[gi], sup.sub_support[0])
        assert np.array_equal(del_sup[gi], sup.del_support[0])
        accepted = sup.gate[0] & (sup.sub_support[0].astype(np.float32) >= thr)
        need = next((c for c in range(4)
                     if not accepted[:c].any() and sup.gate[0][c]
                     and not accepted[c] and sup.sub_cand[0][c] != 0), -1)
        assert ins_lane[gi] == need
        if need >= 0 and ins_ok[gi]:
            host = sup.ins_support[0][need]
            dev = ins_sup[gi]
            passing = host.astype(np.float32) >= thr
            assert np.array_equal(dev[passing], host[passing])
            other = dev[~passing]
            assert ((other == host[~passing]) | (other == 0)).all()
            assert (other.astype(np.float32) < thr).all()
        checked += 1
    assert checked >= 20


def _walk_tables(draft: bytes, bf, cfg, thr_edit=None):
    """The port's plain fused eval over the whole contig as one row, mapped
    into walker site_tables with the interior drop rule."""
    k = cfg.k
    kw = _ecfg_kw(k, cfg.h, s_max=512, thr_edit=thr_edit or cfg.thr_edit)
    codes = np.frombuffer(draft, np.uint8)
    (packed, n_sites, site, gate, sub_sup, del_sup, ins_lane, ins_ok,
     ins_sup) = _port(bf, kw, codes[None])
    nw = len(codes) - k + 1
    present = np.unpackbits(packed[0], bitorder="little")[:nw].astype(bool)
    idx = np.nonzero((site >= 0) & (site <= nw - 2 * k))[0]
    assert int(n_sites) > 0 and len(idx) > 0
    return present, (site[idx].astype(np.int64), gate[idx], sub_sup[idx],
                     del_sup[idx], ins_lane[idx], ins_ok[idx], ins_sup[idx])


@pytest.mark.parametrize("case", ["mode1", "mode0", "giveup"])
def test_native_walk_replays_port_tables(case):
    """Tables from the port's plain fused eval, replayed by the port's
    native walk (gp_native.cpp run_trials_table_c): output, records and
    edit counters equal the probing walk's, with table hits; the output
    equals the JAX package's native walk."""
    from goldpolish_tpu import native as jnative
    from goldpolish_tpu.ops import bloom as jbloom
    from goldpolish_tpu.ops import siteeval as jsite
    from goldpolish_tpu.polish import multik as jmultik

    k, h = 32, 4
    n, seed = {"mode1": (40_000, 11), "mode0": (30_000, 23), "giveup": (30_000, 5)}[case]
    draft, bf = _scenario(n, k, h, seed, 1 << 16, 307, extras=False)
    cfg = ntedit_config_for_k(k)
    jcfg = jmultik.ntedit_config_for_k(k)
    if case == "mode0":
        cfg.mode = jcfg.mode = 0
    tables = siteeval.make_tables(k, cfg.jump, cfg.max_insertions, cfg.max_deletions)
    present, site_tables = _walk_tables(draft, bf, cfg,
                                        thr_edit=0.5 if case == "giveup" else None)
    if case == "giveup":
        assert (site_tables[5] == 0).any()
    out_ref, recs_ref, st_ref = native.polish_contig(draft, bf, cfg, tables,
                                                     present=present)
    out_tab, recs_tab, st_tab = native.polish_contig(
        draft, bf, cfg, tables, present=present, site_tables=site_tables)
    assert out_tab == out_ref and recs_tab == recs_ref
    assert (st_tab.n_subs, st_tab.n_ins, st_tab.n_dels, st_tab.n_masked) == (
        st_ref.n_subs, st_ref.n_ins, st_ref.n_dels, st_ref.n_masked)
    assert st_ref.n_table_hits == 0 and st_tab.n_table_hits > 0
    if case == "giveup":
        assert st_tab.n_table_giveups > 0
    jbf = jbloom.BloomFilter(1 << 16, h, k)
    jbf.array[:] = bf.array
    jtables = jsite.make_tables(k, jcfg.jump, jcfg.max_insertions,
                                jcfg.max_deletions)
    assert jnative.polish_contig(draft, jbf, jcfg, jtables)[0] == out_tab


def _engine_scenario():
    k, h = 32, 4
    rng = np.random.default_rng(7)
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 60_000)].tobytes()
    bf = bloom.BloomFilter(1 << 16, h, k)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(np.frombuffer(truth, np.uint8), k),
                              k, h))
    drafts = []
    for c in range(6):  # the pool path scans all but the first two
        d = bytearray(truth[c * 10_000 : (c + 1) * 10_000])
        for i, p in enumerate(range(2 * k + c, len(d) - 2 * k, 431)):
            kind = i % 3
            if kind == 0:
                d[p] = ord("A") if d[p] != ord("A") else ord("G")
            elif kind == 1:
                q = p
                while d[q] == d[q - 1] or d[q] == d[q + 1]:
                    q += 1
                del d[q]
            else:
                d.insert(p, next(x for x in b"TGCA" if x != d[p - 1] and x != d[p]))
        drafts.append(bytes(d))
    return bf, drafts


@pytest.mark.parametrize("pool", [False, True], ids=["serial", "pool"])
def test_hybrid_engine_with_eval_matches_jax_numpy(monkeypatch, pool):
    """The pipelined hybrid path with the eval armed by default (the plain
    eval on device="cpu"): byte-identical to the JAX package's numpy engine,
    with table hits (tests/test_scan_eval.py:201-245, smaller)."""
    from goldpolish_tpu.ops import bloom as jbloom
    from goldpolish_tpu.polish import multik as jmultik
    from goldpolish_tpu.polish.ntedit_tpu import NtEditTPU

    monkeypatch.delenv("GPTPU_DEVICE_EVAL", raising=False)
    monkeypatch.setenv("GPTPU_FORCE_DEVICE_SCAN", "1")
    bf, drafts = _engine_scenario()
    jbf = jbloom.BloomFilter(1 << 16, 4, 32)
    jbf.array[:] = bf.array
    want = [o for o, _r, _e in NtEditTPU(jmultik.ntedit_config_for_k(32), jbf,
                                         backend="numpy").polish_many(drafts)]
    eng = NtEditGPU(ntedit_config_for_k(32), bf, backend="hybrid", device="cpu")
    eng._ensure_scanner()
    assert eng._scanner.eval_enabled and eng._scanner.eval_shards == 1
    calls = tse.scan_eval_reference.calls.value
    if pool:
        got = eng.polish_many(drafts, processes=2, shard_bases=4_000)
    else:
        got = eng.polish_many(drafts)
    assert [o for o, _r, _e in got] == want
    assert tse.scan_eval_reference.calls.value > calls
    assert sum(e.n_table_hits for _o, _r, e in got) > 20


@pytest.mark.parametrize("why", ["env_off", "snv", "mode2"])
def test_eval_left_unarmed(monkeypatch, why):
    monkeypatch.setenv("GPTPU_DEVICE_EVAL", "0" if why == "env_off" else "1")
    cfg = ntedit_config_for_k(32)
    if why == "snv":
        cfg = type(cfg)(k=32, h=4, use_ratio=True, mode=1, snv=1)
    elif why == "mode2":
        cfg.mode = 2
    eng = NtEditGPU(cfg, bloom.BloomFilter(1 << 12, 4, 32), backend="hybrid",
                    device="cpu")
    eng._ensure_scanner()
    assert not eng._scanner.eval_enabled


def test_fused_eval_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the no-CUDA refusal cannot show")
    kw = _ecfg_kw(32, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tse.FusedEval(tse.EvalConfig(**kw), 1 << 15,
                      siteeval.make_tables(32, 3, 5, 5), "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 20])
def test_cuda_kernel_matches_plain(k):
    """The kernel chain against its plain version on the card at the pipe's
    eval call shape [4, 2^18 + k - 1]: on a truth filter (heads under S),
    and with an N every 100th byte on a p = 0.75 random filter (heads above
    S, needing sites above s_ins)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    rng = np.random.default_rng(k)
    row = 1 << 18
    draft, bf = _scenario(4 * row + 2 * k, k, 4, k, 1 << 22, 701, extras=False)
    codes = np.stack([np.frombuffer(draft, np.uint8)[i * row : (i + 1) * row + k - 1]
                      for i in range(4)])
    broken = codes.copy()
    broken[:, ::100] = ord("N")
    kw = _ecfg_kw(k, 4, s_max=4096)
    rand = bloom.BloomFilter(1 << 22, 4, k)
    rand.array[:] = (rng.integers(0, 256, rand.array.shape)
                     | rng.integers(0, 256, rand.array.shape)).astype(np.uint8)
    for filt, rows in ((bf, codes), (rand, broken)):
        launches = tse.scan_eval.launches.value
        got = _port(filt, kw, rows, device="cuda")
        torch.cuda.synchronize()
        assert tse.scan_eval.launches.value == launches + 1
        want = _port(filt, kw, rows, device="cpu")
        for name, g, w in zip(NAMES, got, want):
            assert g.shape == w.shape and np.array_equal(g, w), name
    # the scratch is the tile staging: no per-window array
    ecfg = tse.EvalConfig(**kw)
    outs = tse.scan_eval(_words(rand).cuda(), int(rand.bits), 4,
                         torch.from_numpy(broken).cuda(), ecfg,
                         siteeval.make_tables(k, ecfg.jump, ecfg.max_ins, ecfg.max_del))
    assert outs.scratch.numel() < broken.size // 4
    site, lane = want[2], want[6]
    assert int(want[1]) > kw["s_max"]
    assert int(((site >= 0) & (lane >= 0)).sum()) > tse.EvalConfig(**kw).resolved_s_ins()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*_PARITY, "bytes_1_3_4_7", "k40"])
def test_cuda_kernel_matches_plain_small(case):
    """The kernels against the plain version on the parity cases' [3, 4000]
    rows (one partial tile per row, S and s_ins overflow, a non-power-of-two
    filter, k = 20 with h = 3, lowercase, N, IUPAC and bytes 1, 3, 4, 7,
    and k = 40, past the pipeline's k values)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    extra = {"bytes_1_3_4_7": (32, 4, {}, 1 << 14, 8, 150),
             "k40": (40, 4, {}, 1 << 14, 9, 150)}
    k, h, over, bf_bytes, seed, spacing = _PARITY.get(case) or extra[case]
    draft, bf = _scenario(11000, k, h, seed, bf_bytes, spacing,
                          control=case == "bytes_1_3_4_7")
    codes, _meta = _rows(draft, k)
    kw = _ecfg_kw(k, h, **over)
    got = _port(bf, kw, codes, device="cuda")
    want = _port(bf, kw, codes, device="cpu")
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and np.array_equal(g, w), name
