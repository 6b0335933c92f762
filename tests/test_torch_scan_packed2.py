"""The 2-bit packed scan transfer of the port (kernel 8's plain version,
ops/scan_conv.scan_present_packed2; DeviceScanner.scan_packed2 on one and
several shards; the scan pipe's packing; native.pack2 into caller buffers)
against the JAX package's scan_present_packed2_gather and
scan_present_packed2_mxu (its Pallas probe in interpret mode), its
DeviceScanner and ScanPipe, and against the port's raw route and the host
filter.  Every comparison is exact.

The JAX 2-bit route classes every exception as seedless
(goldpolish_tpu/ops/scan_conv.py:130), which bytes 1, 3, 4 and 7 are not
(the settled fault row of tests/test_torch_scan.py), so the JAX
comparisons leave those bytes out and one test pins the difference.  The
edge sweep takes its inputs from chip_smoke.scan2_edge_case, as the smoke
run on the card does."""

import numpy as np
import pytest
import torch

import chip_smoke
from goldpolish_tpu_torch import native
from goldpolish_tpu_torch.ops import bloom
from goldpolish_tpu_torch.ops import nthash as nt
from goldpolish_tpu_torch.ops import scan_conv as tsc
from goldpolish_tpu_torch.polish import scanpipe
from goldpolish_tpu_torch.polish.multik import ntedit_config_for_k
from goldpolish_tpu_torch.polish.ntedit_gpu import NtEditGPU
from test_torch_scan_eval import _engine_scenario

_JAX_MISCLASSED = (1, 3, 4, 7)
# exception bytes the JAX route classes as the host does
_EXC = np.frombuffer(b"NnRYSWKMBDHVrykm" + bytes([0, 2, 5, 9, 127, 200, 255]), np.uint8)


def _codes(shape, seed):
    rng = np.random.default_rng(seed)
    codes = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, shape)].copy()
    codes[rng.random(shape) < 0.05] |= 32  # lowercase acgt packs as ACGT
    return codes


def _with_exceptions(codes, k, n, seed, alphabet=_EXC):
    """n exceptions a row, at seeded positions plus the row's ends, its
    last window's k - 1 halo and the middle."""
    rng = np.random.default_rng(seed)
    codes = codes.copy()
    length = codes.shape[1]
    for r in range(codes.shape[0]):
        fixed = [0, length - 1, length - k + 1, length - 2, length // 2]
        pos = np.unique(np.concatenate([fixed, rng.choice(length, n - len(fixed),
                                                          replace=False)]))
        codes[r, pos] = alphabet[rng.integers(0, len(alphabet), len(pos))]
    return codes


def _pack(codes, cap, seed=0):
    """(packed, exc_idx, exc_byte) of the rows, cap entries a row, padding
    at L and beyond, entries shuffled."""
    rng = np.random.default_rng(seed)
    b, length = codes.shape
    packed = np.zeros((b, -(-length // 4)), np.uint8)
    idx = np.full((b, cap), length, np.int64)
    byt = np.zeros((b, cap), np.uint8)
    for r in range(b):
        p, pos, by = native.pack2(codes[r], cap)
        packed[r], idx[r, : len(pos)], byt[r, : len(by)] = p, pos, by
        idx[r, len(pos):] += rng.choice([0, 3, 1 << 33], cap - len(pos))
        perm = rng.permutation(cap)
        idx[r], byt[r] = idx[r, perm], byt[r, perm]
    return packed, idx, byt


def _filter(rows, k, h, bf_bytes):
    bf = bloom.BloomFilter(bf_bytes, h, k)
    for row in rows:
        bf.insert(nt.multi_hashes(nt.canonical_hashes(row, k), k, h)[::2])
    return bf


def _host(bf, codes, k, h):
    """Packed presence of each row from the host filter."""
    return np.stack([np.packbits(bf.contains(nt.multi_hashes(
        nt.canonical_hashes(row, k), k, h)), bitorder="little") for row in codes])


def _plain(bf, k, length, call):
    words = torch.from_numpy(bf.words_u32().view(np.int32).copy())
    return tsc.scan_present_packed2(words, int(bf.bits), int(bf.hash_num), k, length,
                                    *(torch.from_numpy(a) for a in call)).numpy()


def _jax2(bf, k, length, call, mxu=False):
    import jax.numpy as jnp
    from goldpolish_tpu.ops import bloom_pallas
    from goldpolish_tpu.ops import scan_conv as jsc

    args = (int(bf.bits), int(bf.hash_num), k, length, *(jnp.asarray(a) for a in call))
    if mxu:
        planes = jnp.asarray(bloom_pallas.words_to_planes_i8(bf.words_u32()))
        return np.asarray(jsc.scan_present_packed2_mxu(planes, *args, interpret=True))
    return np.asarray(jsc.scan_present_packed2_gather(jnp.asarray(bf.words_u32()), *args))


@pytest.mark.parametrize("E", [64, 256])
@pytest.mark.parametrize("h", [1, 4])
@pytest.mark.parametrize("k", [20, 32, 72])
def test_plain_matches_jax_gather_and_mxu(k, h, E):
    """Rows with lowercase and E - 8 exceptions (the rows' ends, the halo,
    padding entries past L, shuffled): the plain version and the CPU
    scanner equal the JAX gather and MXU (interpret mode) routes."""
    codes = _with_exceptions(_codes((3, 1500), seed=k + h), k, E - 8, seed=E)
    length = codes.shape[1]
    bf = _filter(codes, k, h, 1 << 14)
    call = _pack(codes, E, seed=k)
    got = _plain(bf, k, length, call)
    assert np.array_equal(got, _jax2(bf, k, length, call))
    assert np.array_equal(got, _jax2(bf, k, length, call, mxu=True))
    assert np.array_equal(tsc.DeviceScanner(bf, "cpu").scan_packed2(*call, k, length).numpy(),
                          got)
    assert np.array_equal(got, _host(bf, codes, k, h))
    assert 0.1 < np.unpackbits(got).mean() < 0.9


@pytest.mark.parametrize("bf_bytes", [49160, 3 * (1 << 13) + 4])
@pytest.mark.parametrize("k", [20, 32, 72])
def test_non_pow2_filter_matches_host(k, bf_bytes):
    """A bit count that is no power of two: the full `hash % bits`, as the
    host (the JAX routes probe `lo32 % bits`, the settled fault row)."""
    codes = _with_exceptions(_codes((2, 2000), seed=k), k, 60, seed=bf_bytes)
    bf = _filter(codes, k, 4, bf_bytes)
    call = _pack(codes, 64)
    got = _plain(bf, k, codes.shape[1], call)
    assert np.array_equal(got, _host(bf, codes, k, 4))
    assert not np.array_equal(_jax2(bf, k, codes.shape[1], call), got)


def test_seeded_control_bytes_match_host_not_jax():
    """Bytes 1, 3, 4 and 7 carry forward seeds (goldpolish_tpu/ops/
    nthash.py:56-66); the JAX 2-bit route gives every exception forward
    class 4 (scan_conv.py:130), the port writes the raw byte back: its
    packed route equals its raw route and the host, the JAX one differs."""
    k, h = 20, 4
    codes = _with_exceptions(_codes((2, 2500), seed=3), k, 120, seed=4,
                             alphabet=np.array(_JAX_MISCLASSED, np.uint8))
    bf = _filter(codes, k, h, 1 << 14)
    call = _pack(codes, 256)
    got = _plain(bf, k, codes.shape[1], call)
    assert np.array_equal(got, _host(bf, codes, k, h))
    assert not np.array_equal(_jax2(bf, k, codes.shape[1], call), got)


@pytest.mark.parametrize("k", [20, 32, 128])
def test_packed_route_equals_raw_route_full_byte_alphabet(k):
    """Every byte value (the 248 non-ACGTacgt ones as exceptions, in
    rows of 256 entries): kernel 8's plain version equals the raw scan."""
    alphabet = np.arange(256, dtype=np.uint8)
    rows = []
    for r in range(4):
        row = _codes((1, 1200), seed=r)[0]
        row[np.random.default_rng(r).choice(1200, 64, replace=False)] = alphabet[
            64 * r : 64 * r + 64]
        rows.append(row)
    codes = np.stack(rows)
    assert len(np.unique(codes)) == 256
    bf = _filter(codes, k, 3, 1 << 13)
    call = _pack(codes, 256)
    got = _plain(bf, k, codes.shape[1], call)
    raw = tsc.DeviceScanner(bf, "cpu").scan_packed(codes, k).numpy()
    assert np.array_equal(got, raw)
    assert np.array_equal(got, _host(bf, codes, k, 3))


def test_unpack2_reference_writes_raw_bytes_back():
    codes = _with_exceptions(_codes((3, 999), seed=5), 20, 40, seed=6,
                             alphabet=np.arange(256, dtype=np.uint8))
    call = _pack(codes, 64)
    got = tsc.unpack2_reference(999, *(torch.from_numpy(a) for a in call)).numpy()
    upper = codes.copy()
    acgt = np.isin(codes, np.frombuffer(b"acgt", np.uint8))
    upper[acgt] -= 32
    assert np.array_equal(got, upper)


def test_wrapper_refuses_bad_shapes():
    bf = bloom.BloomFilter(1 << 10, 2, 20)
    words = torch.from_numpy(bf.words_u32().view(np.int32).copy())
    packed = torch.zeros(2, 25, dtype=torch.uint8)
    idx, byt = torch.zeros(2, 8, dtype=torch.int64), torch.zeros(2, 8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="fewer than L"):
        tsc.scan_present_packed2(words, int(bf.bits), 2, 20, 101, packed, idx, byt)
    with pytest.raises(ValueError, match="exc_idx"):
        tsc.scan_present_packed2(words, int(bf.bits), 2, 20, 100, packed, idx[:1], byt[:1])
    out = tsc.scan_present_packed2(words, int(bf.bits), 2, 20, 19, packed, idx, byt)
    assert tuple(out.shape) == (2, 0)


def test_pack2_into_caller_buffers_matches_jax_pack2():
    from goldpolish_tpu import native as jnative

    rng = np.random.default_rng(8)
    for n in (0, 1, 3, 4, 5, 999, 4096):
        codes = _codes((1, n), seed=n)[0]
        codes[rng.random(n) < 0.03] = ord("N")
        out = (np.full(1200, 7, np.uint8), np.full(300, -1, np.int64),
               np.full(300, 9, np.uint8))
        got = native.pack2(codes, 256, out=out)
        want = jnative.pack2(codes, 256)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        if len(got[1]):  # views of the caller's buffers
            assert np.shares_memory(got[0], out[0]) and np.shares_memory(got[1], out[1])
        assert all(np.array_equal(g, w) for g, w in zip(native.pack2(codes, 256), want))
    noisy = np.full(1000, ord("N"), np.uint8)
    assert native.pack2(noisy, 64) is None and jnative.pack2(noisy, 64) is None
    with pytest.raises(ValueError, match="writable contiguous"):
        native.pack2(noisy, 64, out=(np.zeros(10, np.uint8), np.zeros(64, np.int64),
                                     np.zeros(64, np.uint8)))
    with pytest.raises(ValueError, match="writable contiguous"):
        native.pack2(noisy, 64, out=(np.zeros(250, np.uint8), np.zeros(64, np.int32),
                                     np.zeros(64, np.uint8)))


def _jobs(k, dense_row=False):
    """Jobs with lowercase, N and IUPAC bytes; with dense_row, one job
    holds more than EXC_BUCKET exceptions in one call's row."""
    seq = _codes((1, 6000), seed=11)[0]
    seq[700] = ord("N")
    seq[1900:1910] = np.frombuffer(b"yRYKMnNNsw", np.uint8)
    jobs = [(0, seq), (1, seq[:10]), (2, seq[100:2100]), (3, seq[:k]),
            (4, seq[50:4000])]
    if dense_row:
        noisy = seq[:1500].copy()
        noisy[::3] = ord("N")  # ~310 exceptions in a row of 931 bytes
        jobs.append((5, noisy))
        jobs.append((6, seq[3000:5900]))
    return seq, jobs


def _counts():
    return (tsc.scan_present_packed2_reference.calls.value,
            tsc.scan_present_packed_reference.calls.value)


@pytest.mark.parametrize("dense_row", [False, True], ids=["packed", "dense_row"])
def test_scanpipe_packed_matches_raw_and_jax_pipe(dense_row):
    """The port's ScanPipe with the packed transfer on and off and the JAX
    ScanPipe (gather probe, packing on) yield the same presence, job by
    job; a call with a row past EXC_BUCKET goes raw."""
    from goldpolish_tpu.ops import scan_conv as jsc
    from goldpolish_tpu.polish.scanpipe import ScanPipe as JaxPipe

    k, h = 32, 3
    seq, jobs = _jobs(k, dense_row)
    bf = _filter([seq], k, h, 1 << 16)
    pipe = scanpipe.ScanPipe(tsc.DeviceScanner(bf, "cpu"), k, row_windows=900, rows=2)
    assert pipe._pack2 is native.pack2 and pipe.EXC_BUCKET == 256
    before = _counts()
    got = list(pipe.run(jobs))
    packed_calls, raw_calls = (a - b for a, b in zip(_counts(), before))
    assert packed_calls + raw_calls == pipe.calls > 3
    assert packed_calls > 0 and (raw_calls > 0) == dense_row
    raw_pipe = scanpipe.ScanPipe(tsc.DeviceScanner(bf, "cpu"), k, row_windows=900, rows=2)
    raw_pipe._pack2 = None
    before = _counts()
    want = list(raw_pipe.run(jobs))
    assert [a - b for a, b in zip(_counts(), before)] == [0, raw_pipe.calls]
    jax_got = list(JaxPipe(jsc.DeviceScanner(bf, force_probe="gather"), k,
                           row_windows=900, rows=2).run(jobs))
    assert [j for j, _p in got] == [j for j, _p in want] == [j for j, _p in jax_got]
    for (j, g), (_j, w), (_x, x) in zip(got, want, jax_got):
        assert np.array_equal(g, w) and np.array_equal(g, x), j
        codes = dict(jobs)[j]
        if len(codes) >= k:
            host = bf.contains(nt.multi_hashes(nt.canonical_hashes(codes, k), k, h))
            assert np.array_equal(g, host), j


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("rows", [3, 4])
def test_sharded_scan_packed2_matches_one_shard_and_jax_mesh(n, rows):
    """DeviceScanner(devices=n CPUs).scan_packed2: each shard runs the plain
    version on its rows, pad rows packed 'A' with padding entries; equal to
    one shard and to the JAX scanner's "scan2" shard_map on 8 devices."""
    from goldpolish_tpu.ops import scan_conv as jsc

    k = 28
    codes = _with_exceptions(_codes((4, 1800), seed=n), k, 100, seed=rows)[:rows]
    bf = _filter(codes[:1], k, 4, 1 << 14)
    call = _pack(codes, 128)
    length = codes.shape[1]
    jax_scanner = jsc.DeviceScanner(bf, force_probe="gather")
    assert jax_scanner.n_devices == 8
    want = np.asarray(jax_scanner.scan_packed2(*call, k, length))
    one = tsc.DeviceScanner(bf, "cpu").scan_packed2(*call, k, length).numpy()
    sharded = tsc.DeviceScanner(bf, "cpu", devices=("cpu",) * n)
    calls = tsc.scan_present_packed2_reference.calls.value
    got = sharded.scan_packed2(*call, k, length).numpy()
    assert tsc.scan_present_packed2_reference.calls.value - calls == n
    assert got.shape == want.shape == (rows, -(-(length - k + 1) // 8))
    assert np.array_equal(got, want) and np.array_equal(got, one)


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_scanpipe_packs_pad_rows_as_a(n):
    """A pipe over n CPU shards: its pad rows pack as 'A' with no exception
    (the raw route pads with byte 0), so every call goes packed and the
    presence equals the one-shard pipe's."""
    k, h = 32, 3
    seq, jobs = _jobs(k)
    bf = _filter([seq], k, h, 1 << 16)

    def run(devices):
        pipe = scanpipe.ScanPipe(tsc.DeviceScanner(bf, "cpu", devices=devices), k,
                                 row_windows=900, rows=3)
        before = _counts()
        out = list(pipe.run(jobs))
        return out, [a - b for a, b in zip(_counts(), before)], pipe

    want, _c, _p = run(None)
    got, (packed, raw), pipe = run(("cpu",) * n)
    assert raw == 0 and packed == n * pipe.calls
    for (j, g), (_j, w) in zip(got, want):
        assert np.array_equal(g, w), j


def test_polish_many_eval_off_matches_jax_hybrid(monkeypatch):
    """NtEditGPU.polish_many, hybrid on --device cpu with
    GPTPU_DEVICE_EVAL=0 (the packed transfer on the pipe's calls): the JAX
    package's hybrid engine's bytes, with its pack on."""
    from goldpolish_tpu.ops import bloom as jbloom
    from goldpolish_tpu.polish import multik as jmultik
    from goldpolish_tpu.polish import scanpipe as jscanpipe
    from goldpolish_tpu.polish.ntedit_tpu import NtEditTPU

    monkeypatch.setenv("GPTPU_FORCE_DEVICE_SCAN", "1")
    monkeypatch.setenv("GPTPU_DEVICE_EVAL", "0")
    monkeypatch.setattr(jscanpipe, "ROW_WINDOWS", 1 << 13)
    monkeypatch.setattr(scanpipe, "ROW_WINDOWS", 1 << 13)
    bf, drafts = _engine_scenario()
    drafts = [d[:300] + b"NRYN" + d[304:5000] + b"nnnn" + d[5004:] for d in drafts]
    jbf = jbloom.BloomFilter(1 << 16, 4, 32)
    jbf.array[:] = bf.array
    jeng = NtEditTPU(jmultik.ntedit_config_for_k(32), jbf, backend="hybrid")
    want = [o for o, _r, _e in jeng.polish_many(drafts)]
    eng = NtEditGPU(ntedit_config_for_k(32), bf, backend="hybrid", device="cpu")
    before = _counts()
    got = eng.polish_many(drafts)
    assert not eng._scanner.eval_enabled
    assert _counts()[0] > before[0]  # the packed route ran
    assert [o for o, _r, _e in got] == want


@pytest.mark.parametrize("nw,k,h,B,pow2", chip_smoke.scan2_edge_cases())
def test_scan2_edges_match_host(nw, k, h, B, pow2):
    """Rows of nw windows around every edge of kernel 8's tiling, with
    exceptions at the rows' ends, in the halo and on both sides of the
    2,048-window tiles (a row of exactly EXC_BUCKET where it fits),
    padding entries past L, shuffled: the plain version against the host
    filter window by window and against the raw scan."""
    bf, codes, call = chip_smoke.scan2_edge_case(nw, k, h, B, pow2)
    length = codes.shape[1]
    got = _plain(bf, k, length, call)
    assert got.shape == (B, (nw + 7) // 8)
    assert np.array_equal(got, _host(bf, codes, k, h))
    assert np.array_equal(got, tsc.DeviceScanner(bf, "cpu").scan_packed(codes, k).numpy())
    cap = chip_smoke.exc_bucket()
    n_exc = (call[1] < length).sum(axis=1)
    assert n_exc.max() <= cap and (call[1] >= length).any() == (n_exc.min() < cap)
    if B > 1 and length >= cap:
        assert n_exc[1] == cap


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [20, 32, 72, 400, 1100])
def test_cuda_kernel8_matches_plain_and_kernel2(k):
    _cuda()
    codes = _with_exceptions(_codes((4, 60_000 + k), seed=k), k, 250, seed=k,
                             alphabet=np.arange(256, dtype=np.uint8))
    length = codes.shape[1]
    for bf_bytes in (1 << 18, 49160):
        bf = _filter(codes[:2], k, 4, bf_bytes)
        call = _pack(codes, 256)
        words = torch.from_numpy(bf.words_u32().view(np.int32).copy())
        launches = tsc.scan_present_packed2.launches.value
        got = tsc.scan_present_packed2(words.cuda(), int(bf.bits), 4, k, length,
                                       *(torch.from_numpy(a).cuda() for a in call))
        torch.cuda.synchronize()
        assert tsc.scan_present_packed2.launches.value == launches + 1
        want = _plain(bf, k, length, call)
        raw = tsc.scan_present_packed(words.cuda(), int(bf.bits), 4, k,
                                      torch.from_numpy(codes).cuda())
        assert np.array_equal(got.cpu().numpy(), want)
        assert np.array_equal(raw.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("nw,k,h,B,pow2", chip_smoke.scan2_edge_cases())
def test_cuda_kernel8_edges(nw, k, h, B, pow2):
    """The twin of test_scan2_edges_match_host on the card: kernel 8
    against the plain raw scan, the packed rows also at an odd byte
    offset of their buffer."""
    _cuda()
    launches = tsc.scan_present_packed2.launches.value
    chip_smoke.scan2_edge_check((nw, k, h, B, pow2))
    assert tsc.scan_present_packed2.launches.value == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("devices", [None, ("cuda:0", "cuda:0")], ids=["one", "two"])
def test_cuda_scanpipe_packed_matches_raw(devices):
    """The CUDA pipe's packed route (pinned packed slots, each shard's
    copies and kernel 8 on its stream) yields the raw route's presence;
    the dense row's call goes raw."""
    _cuda()
    k, h = 32, 3
    seq, jobs = _jobs(k, dense_row=True)
    bf = _filter([seq], k, h, 1 << 16)
    jobs = jobs * 3  # every slot reused
    jobs = [(i, c) for i, (_j, c) in enumerate(jobs)]

    def run(pack):
        pipe = scanpipe.ScanPipe(tsc.DeviceScanner(bf, "cuda", devices=devices), k,
                                 row_windows=900, rows=2)
        if not pack:
            pipe._pack2 = None
        counts = (tsc.scan_present_packed2.launches.value,
                  tsc.scan_present_packed.launches.value)
        out = list(pipe.run(jobs))
        return out, (tsc.scan_present_packed2.launches.value - counts[0],
                     tsc.scan_present_packed.launches.value - counts[1])

    got, (packed, raw) = run(True)
    want, (packed_off, _raw_off) = run(False)
    assert packed > 0 and raw > 0 and packed_off == 0
    for (j, g), (_j, w) in zip(got, want):
        assert np.array_equal(g, w), j
