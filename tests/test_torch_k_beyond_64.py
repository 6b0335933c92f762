"""k above 64 on the port's device paths, against the JAX package.

The JAX package's conv hash and gathers take any k, and so does its CLI
(`-k`).  The port's kernels 2 (the dense scan), 6 (the site eval) and 7
(the extension probe) size their tables from k at launch, so their plain
versions and the arms that run them take any k too.  Each case runs at
k = 65, 72 and 128, small sizes, the JAX side on the CPU as its own tests
run it, and compares exactly (tolerance 0: presence bits, supports, masks,
bytes).  The CUDA cases hold each kernel against its plain version on the
card at k = 72, 128 and 1100 (where kernels 2, 6 and 7 read their tables
from device memory, not shared memory); they need the card and skip here.
The JAX package is imported only by the tests that compare with it, so
the CUDA cases also run where jax is not installed (`pytest --noconftest
-m cuda`)."""

import os

import numpy as np
import pytest
import torch

from goldpolish_tpu_torch.config import PipelineConfig
from goldpolish_tpu_torch.fill import konnector
from goldpolish_tpu_torch.ops import bloom, dbg_extend, scan_conv, siteeval
from goldpolish_tpu_torch.ops import nthash as nt
from goldpolish_tpu_torch.ops import siteeval_device as sd
from goldpolish_tpu_torch.pipeline import bulk
from goldpolish_tpu_torch.polish import ntedit_oracle as ne
from goldpolish_tpu_torch.polish.ntedit_gpu import NtEditGPU
from test_torch_device_dbg import _frontier, _genome, _jax_ext_rows, _jax_filter
from test_torch_scan import _MIXED, _codes, _filter, _jax_scan, _port_scan
from test_torch_site_eval import JUMP, _assert_supports_equal, _inputs, _jax_outputs

KS = [65, 72, 128]
H = 4
GOLD = os.path.join(os.path.dirname(__file__), "golden")


def _words(bf, device="cpu"):
    return torch.from_numpy(bf.words_u32().view(np.int32).copy()).to(device)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions here run many small torch ops; one intra-op
    thread each keeps the suite's parallel workers from oversubscribing
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- kernel 2: the dense scan ---------------------------------------------------


@pytest.mark.parametrize("k", KS)
def test_scan_matches_jax_gather(k):
    codes = _codes(3 * 1024 + 37, k)
    bf, _truth = _filter(codes, k, H, 1 << 16)
    rows = np.stack([codes[:3000], codes[37:3037]])
    mixed = _codes(2000, k + 1, _MIXED)
    got, want = _port_scan(bf, k, rows), _jax_scan(bf, k, rows)
    assert np.array_equal(got, want)
    assert 0 < np.unpackbits(got).mean() < 1
    assert np.array_equal(_port_scan(bf, k, mixed[None]), _jax_scan(bf, k, mixed[None]))


def test_scan_k_above_1023_matches_host():
    """srol^k repeats with period lcm(31, 33) = 1023: the rolled scan holds
    past it, against the host filter's own probe of every window."""
    k = 1100
    codes = _codes(4000, k)
    bf, want = _filter(codes, k, H, 1 << 14)
    got = np.unpackbits(_port_scan(bf, k, codes[None])[0], bitorder="little")
    assert np.array_equal(got[: len(want)].astype(bool), want)
    assert 0 < want.mean() < 1


# -- kernel 6: the site eval ----------------------------------------------------


@pytest.mark.parametrize("k", KS)
def test_site_eval_matches_jax(k):
    C = 21
    draft, bf, sites = _inputs(k, H, 1 << 13)
    tables = siteeval.make_tables(k, JUMP)
    codes_dev = np.zeros(1024, np.uint8)
    codes_dev[: len(draft)] = draft
    raw = sd.site_eval(_words(bf), int(bf.bits), H, torch.from_numpy(codes_dev), len(draft),
                       torch.from_numpy(sites), tables, C)
    want_raw, want_jax = _jax_outputs(draft, bf, sites, tables, H, C, codes_dev)
    for g, w in zip(raw, want_raw):
        assert g.shape == w.shape and np.array_equal(g.numpy(), w)
    got = sd.eval_sites_device(draft, sites, _words(bf), int(bf.bits), tables, H, C,
                               codes_dev=torch.from_numpy(codes_dev))
    _assert_supports_equal(got, want_jax)
    _assert_supports_equal(got, siteeval.eval_sites_np(draft, sites, bf, tables, H, C))
    assert 0 < raw[0].float().mean() < 1


# -- kernel 7: the extension probe and the DeviceDBG ---------------------------


@pytest.mark.parametrize("k", KS)
def test_extension_probe_and_device_dbg_match_jax(k):
    import jax.numpy as jnp

    from goldpolish_tpu.fill import konnector as jkon
    from goldpolish_tpu.ops import bloom_jax

    rng = np.random.default_rng(k)
    truth = _genome(rng, 1500)
    bf = bloom.BloomFilter(1 << 15, H, k)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(nt.encode(truth), k), k, H))
    # 256 rows: 1,024 extensions, the JAX DeviceDBG's bucket for the
    # prefetch below, so the JAX probe compiles once per k
    verts, n_succ = _frontier(rng, truth, 256, k)
    pres = np.asarray(bloom_jax.probe_kmers_jit(
        jnp.asarray(bf.words_u32()), int(bf.bits), H, k,
        jnp.asarray(_jax_ext_rows(verts, n_succ).reshape(-1, k))))[:, 0]
    want = (pres.reshape(-1, 4) * np.array([1, 2, 4, 8])).sum(1).astype(np.uint8)
    got = dbg_extend.dbg_extend4(_words(bf), int(bf.bits), H, k, torch.from_numpy(verts),
                                 n_succ)
    assert np.array_equal(got.numpy(), want)
    assert (want == 0).any() and (want != 0).any()

    host = konnector.DBG(bf, k)
    jdbg = jkon.DeviceDBG(_jax_filter(bf), k)
    dev = konnector.DeviceDBG(bf, k, device="cpu")
    kmers = [truth[i : i + k] for i in range(0, 600, 9)]
    dev.prefetch(kmers[::2], kmers[1::2])
    jdbg.prefetch(kmers, kmers)  # every later query a cache hit
    for km in kmers:
        assert dev.successors(km) == host.successors(km) == jdbg.successors(km), km
        assert dev.predecessors(km) == host.predecessors(km) == jdbg.predecessors(km), km


# -- the editor's device arms ---------------------------------------------------


@pytest.mark.parametrize("k", KS)
def test_editor_device_arms_match_jax_package(k, monkeypatch):
    """NtEditGPU(device="cpu") on the jax backend (kernels 2 and 6's plain
    versions, the Python walk) and on the hybrid backend with the device
    scan forced (the eval is off past k = 64, so the scan pipe sends the
    draft 2-bit packed, as the JAX pipe does: kernel 8's plain version; the
    native walk stops at k = 64, so the two-phase engine walks) against
    NtEditTPU.  NtEditTPU runs its
    numpy backend, which walks the same two-phase engine there and equals
    its jax backend (whose site eval test_site_eval_matches_jax holds the
    port's against) without a compile per shape bucket."""
    from goldpolish_tpu.ops import bloom as jbloom
    from goldpolish_tpu.polish import ntedit_oracle as jne
    from goldpolish_tpu.polish.ntedit_tpu import NtEditTPU
    from test_ntedit_tpu import _genome as _acgt_genome
    from test_ntedit_tpu import _mutate

    rng = np.random.default_rng(k)
    truth = _acgt_genome(rng, 1000)
    draft = _mutate(rng, truth, 20, span=(k, 1000 - k)).encode()
    bf = bloom.BloomFilter(1 << 14, H, k)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(nt.encode(truth), k), k, H))
    jbf = jbloom.BloomFilter(bf.bytes, H, k)
    jbf.array[:] = bf.array
    kw = dict(k=k, h=H, use_ratio=True)
    want = NtEditTPU(jne.Config(**kw), jbf, backend="numpy").polish_many([draft])[0]
    evals = sd.eval_sites_device_reference.calls.value
    got = NtEditGPU(ne.Config(**kw), bf, backend="jax", device="cpu").polish_many([draft])[0]
    assert sd.eval_sites_device_reference.calls.value > evals  # > 16 hot sites
    assert got[:2] == want[:2]
    monkeypatch.setenv("GPTPU_FORCE_DEVICE_SCAN", "1")
    scans = scan_conv.scan_present_packed2_reference.calls.value
    got = NtEditGPU(ne.Config(**kw), bf, backend="hybrid",
                    device="cpu").polish_many([draft])[0]
    assert scan_conv.scan_present_packed2_reference.calls.value > scans
    assert got[:2] == want[:2]


# -- bulk at -k 72, the jax backend with the sealer -----------------------------


def test_bulk_k72_jax_backend_with_sealer_matches_jax_package(tmp_path):
    """The JAX package's jax backend (its DeviceDBG) is the reference here:
    its host DBG reads every extension as present at k > 64 (the settled
    gp_extend4 row of ROADMAP.md), so its numpy backend seals otherwise.
    The port's numpy backend, whose host DBG takes its Python path there,
    writes the same bytes as both jax backends."""
    from goldpolish_tpu.config import PipelineConfig as JaxConfig
    from goldpolish_tpu.pipeline import bulk as jax_bulk

    common = dict(seqs_to_polish=os.path.join(GOLD, "draft.fa"),
                  polishing_seqs=os.path.join(GOLD, "reads.fq"),
                  mappings_path=os.path.join(GOLD, "map.paf"), k_values=[72],
                  batch_size=2, run_sealer=True)
    want_cfg = JaxConfig(output_seqs=str(tmp_path / "want.fa"),
                         workspace=str(tmp_path / "ws_jax"), backend="jax", **common)
    jax_bulk.run_bulk(want_cfg)
    with open(want_cfg.output_seqs, "rb") as f:
        want = f.read()
    probes = dbg_extend.dbg_extend_chain_reference.calls.value
    evals = sd.eval_sites_device_reference.calls.value
    for backend in ("jax", "numpy"):
        cfg = PipelineConfig(output_seqs=str(tmp_path / f"{backend}.fa"),
                             workspace=str(tmp_path / f"ws_{backend}"), backend=backend,
                             device="cpu", **common)
        assert bulk.run_bulk(cfg)["contigs"] == 4
        with open(cfg.output_seqs, "rb") as f:
            assert f.read() == want, backend
    assert dbg_extend.dbg_extend_chain_reference.calls.value > probes
    assert sd.eval_sites_device_reference.calls.value > evals


def test_host_dbg_k_above_64_matches_device_dbg():
    """gp_extend4 refuses k > 64 (it returns -1); the port's native.extend4
    raises there, so the host DBG probes in Python, and its extensions are
    the DeviceDBG's."""
    from goldpolish_tpu_torch import native

    k = 72
    rng = np.random.default_rng(5)
    truth = _genome(rng, 800)
    bf = bloom.BloomFilter(1 << 14, H, k)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(nt.encode(truth), k), k, H))
    with pytest.raises(ValueError, match="k <= 64"):
        native.extend4(truth[:k].encode(), H, bf, True)
    host = konnector.DBG(bf, k)
    assert host._ext4 is None
    dev = konnector.DeviceDBG(bf, k, device="cpu")
    for i in range(0, 700, 13):
        km = truth[i : i + k]
        assert host.successors(km) == dev.successors(km) == [truth[i + 1 : i + k + 1]]
        if i:
            assert host.predecessors(km) == dev.predecessors(km) == [truth[i - 1 : i + k - 1]]


# -- the kernels on the card ------------------------------------------------------


def _dense_words(bits: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    n = -(-bits // 32)
    a, b = (rng.integers(0, 2**32, n, dtype=np.uint64) for _ in range(2))
    return torch.from_numpy((a | b).astype(np.uint32).view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("pow2", [True, False])
@pytest.mark.parametrize("k", [72, 128, 1100])
def test_cuda_scan_matches_plain(k, pow2):
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    codes = torch.from_numpy(np.stack([_codes(9000, k), _codes(9000, k + 1, _MIXED)]))
    bits = (1 << 20) if pow2 else 1_000_003
    words = _dense_words(bits, k)
    want = scan_conv.scan_present_packed(words, bits, H, k, codes)
    launches = scan_conv.scan_present_packed.launches.value
    got = scan_conv.scan_present_packed(words.cuda(), bits, H, k, codes.cuda())
    torch.cuda.synchronize()
    assert scan_conv.scan_present_packed.launches.value == launches + 1
    assert torch.equal(got.cpu(), want)
    assert 0 < want.float().mean() < 255


@pytest.mark.cuda
@pytest.mark.parametrize("mi,md", [(5, 5), (5, 0), (3, 0)])
@pytest.mark.parametrize("k", [72, 128, 1100])
def test_cuda_site_eval_matches_plain(k, mi, md):
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    draft, bf, sites = _inputs(k, H, 1 << 13, n=2 * k + 700)
    # the windows of the contig among _inputs' sites (those it places near
    # fixed errors start before 0 at k = 1100), and two at its start
    sites = np.unique(np.concatenate([sites[sites >= 0], [0, k // 2]]))
    tables = siteeval.make_tables(k, JUMP, mi, md)
    for words in (_words(bf), _dense_words(int(bf.bits), k)):
        args = (words, int(bf.bits), H, torch.from_numpy(draft), len(draft),
                torch.from_numpy(sites), tables, 21)
        want = sd.eval_sites_device_reference(*args)
        got = sd.site_eval(*(a.cuda() if isinstance(a, torch.Tensor) else a for a in args))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [72, 128, 1100])
def test_cuda_extension_chain_matches_plain(k):
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    rng = np.random.default_rng(k)
    truth = _genome(rng, 3000)
    bf = bloom.BloomFilter(1 << 15, H, k)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(nt.encode(truth), k), k, H))
    verts, n_succ = _frontier(rng, truth, 1000, k)
    args = (_words(bf), int(bf.bits), H, k, torch.from_numpy(verts), n_succ)
    for steps in (1, dbg_extend.CHAIN_STEPS):
        want = dbg_extend.dbg_extend_chain_reference(*args, steps)
        got = dbg_extend.dbg_extend_chain(args[0].cuda(), *args[1:4], args[4].cuda(),
                                          n_succ, steps)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
