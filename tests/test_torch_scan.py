"""ops/scan_conv (kernel 2, DeviceScanner) and polish/scanpipe of the port
against the JAX package's dense scan and the host filter.

The JAX side calls the jitted scan_present_packed_gather directly: the
conftest mesh has 8 CPU devices and the JAX DeviceScanner would shard.
Every comparison is exact.  Two inputs are held against the host filter
(ops/bloom.py) instead of the JAX scan, each test saying why.  The JAX
package is imported only where it is compared with, so the CUDA cases also
run where jax is not installed (`pytest --noconftest -m cuda`).  The edge
sweep (row lengths around the kernel's 8-window runs and 2,048-window
tiles) takes its inputs from chip_smoke.scan_edge_case, as the smoke run on
the card does."""

import numpy as np
import pytest
import torch

import chip_smoke
from goldpolish_tpu_torch.ops import bloom
from goldpolish_tpu_torch.ops import nthash as nt
from goldpolish_tpu_torch.ops import scan_conv as tsc
from goldpolish_tpu_torch.polish.scanpipe import ScanPipe
from goldpolish_tpu_torch.utils import trace

# bytes whose ntHash forward seed the JAX one-hot drops (see
# test_seeded_control_bytes_match_host_not_jax)
_JAX_MISCLASSED = bytes([1, 3, 4, 7])


def _codes(n, seed, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    return np.frombuffer(alphabet, np.uint8)[rng.integers(0, len(alphabet), n)].copy()


def _filter(codes, k, h, bf_bytes, every=2):
    bf = bloom.BloomFilter(bf_bytes, h, k)
    hashes = nt.multi_hashes(nt.canonical_hashes(codes, k), k, h)
    bf.insert(hashes[::every])
    return bf, bf.contains(hashes)


def _jax_scan(bf, k, codes2d):
    import jax.numpy as jnp
    from goldpolish_tpu.ops import scan_conv as jsc

    return np.asarray(jsc.scan_present_packed_gather(
        jnp.asarray(bf.words_u32()), int(bf.bits), int(bf.hash_num), k,
        jnp.asarray(codes2d),
    ))


def _port_scan(bf, k, codes2d):
    return tsc.DeviceScanner(bf, "cpu").scan_packed(codes2d, k).numpy()


_MIXED = (b"ACGTacgtNnYyRrWwSsKkMmBbDdHhVv"
          + bytes(b for b in range(256) if bytes([b]) not in _JAX_MISCLASSED))


@pytest.mark.parametrize("k,h,log_bytes", [
    (20, 1, 16), (20, 4, 20), (24, 1, 17), (24, 4, 19),
    (28, 1, 18), (28, 4, 16), (32, 1, 20), (32, 4, 18),
])
def test_scan_matches_jax_gather_pow2(k, h, log_bytes):
    seq = _codes(3000, seed=k * 10 + h)
    bf, _ = _filter(seq, k, h, 1 << log_bytes)
    rows = np.stack([seq, _codes(3000, seed=k + 100 * h)])
    got = _port_scan(bf, k, rows)
    assert np.array_equal(got, _jax_scan(bf, k, rows))
    assert 0 < np.unpackbits(got[0]).mean() < 1


@pytest.mark.parametrize("k", [20, 32])
def test_scan_matches_jax_full_byte_alphabet(k):
    """Lowercase, IUPAC, N and arbitrary bytes (all but 1, 3, 4, 7)."""
    raw = _codes(4000, seed=k, alphabet=_MIXED)
    raw[::2] = _codes(2000, seed=k + 1)  # keep ACGT windows in the filter
    bf, _ = _filter(raw, k, 4, 1 << 16)
    got = _port_scan(bf, k, raw[None])
    assert np.array_equal(got, _jax_scan(bf, k, raw[None]))


def test_seeded_control_bytes_match_host_not_jax():
    """ntHash's seed table gives bytes 1, 3, 4 and 7 forward seeds
    (goldpolish_tpu/ops/nthash.py:56-66); the JAX scan's one-hot classes
    them as seedless (goldpolish_tpu/ops/scan_conv.py:90-97), so the JAX
    comparison does not apply to them.  The port follows the host spec."""
    k, h = 20, 4
    codes = np.frombuffer(bytes(range(256)) * 8, np.uint8).copy()
    bf, want = _filter(codes, k, h, 1 << 16, every=3)
    got = tsc.DeviceScanner.unpack_present(
        _port_scan(bf, k, codes[None])[0], len(codes) - k + 1
    )
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bf_bytes", [49160, 3 * (1 << 15) + 4])
def test_non_pow2_filter_matches_host(bf_bytes):
    """A filter whose bit count is not a power of two probes the full
    `hash % bits`, as the host does (goldpolish_tpu/ops/bloom.py:89).  The
    JAX comparison is skipped by construction: the JAX scan probes
    `lo32 % bits` (goldpolish_tpu/ops/scan_conv.py:199) and disagrees with
    its own host filter here."""
    k, h = 28, 4
    seq = _codes(5000, seed=bf_bytes)
    bf, want = _filter(seq, k, h, bf_bytes)
    got = tsc.DeviceScanner.unpack_present(
        _port_scan(bf, k, seq[None])[0], len(seq) - k + 1
    )
    assert np.array_equal(got, want)
    assert want.mean() > 0.4
    jax_got = tsc.DeviceScanner.unpack_present(
        _jax_scan(bf, k, seq[None])[0], len(seq) - k + 1
    )
    assert not np.array_equal(jax_got, want)  # the reference fault stands


@pytest.mark.parametrize("nw,k,h,B,pow2", chip_smoke.scan_edge_cases())
def test_scan_edges_match_host(nw, k, h, B, pow2):
    """Rows of nw windows around every edge of the kernel's tiling (a
    thread's run of 8 windows, a block's tile of 2,048), on the full byte
    alphabet, against the host filter window by window; the pad bits of
    the last byte are 0."""
    bf, codes = chip_smoke.scan_edge_case(nw, k, h, B, pow2)
    assert (int(bf.bits) & (int(bf.bits) - 1) == 0) == pow2
    got = _port_scan(bf, k, codes)
    assert got.shape == (B, (nw + 7) // 8)
    for row, packed in zip(codes, got):
        want = bf.contains(nt.multi_hashes(nt.canonical_hashes(row, k), k, h))
        bits = np.unpackbits(packed, bitorder="little")
        assert np.array_equal(bits[:nw].astype(bool), want)
        assert not bits[nw:].any()
    if nw >= 2047:
        assert len(set(codes.flatten().tolist())) > 30  # bytes beyond ACGT
        assert 0.3 < np.unpackbits(got).mean() < 0.9


def test_from_words_takes_the_jax_package_filter():
    from goldpolish_tpu.ops import bloom as jax_bloom

    k, h = 32, 4
    seq = _codes(2000, seed=9)
    bf = jax_bloom.BloomFilter(1 << 17, h, k)
    hashes = nt.multi_hashes(nt.canonical_hashes(seq, k), k, h)
    bf.insert(hashes[::2])
    want = bf.contains(hashes)
    sc = tsc.DeviceScanner.from_words(bf.words_u32(), int(bf.bits), h, "cpu")
    got = sc.unpack_present(sc.scan_packed(seq, k).numpy()[0], len(seq) - k + 1)
    assert np.array_equal(got, want)
    assert sc.preferred_rows == 4


def test_short_rows_give_empty_output():
    bf, _ = _filter(_codes(100, seed=1), 32, 4, 1 << 12)
    out = tsc.DeviceScanner(bf, "cpu").scan_packed(np.zeros((2, 20), np.uint8), 32)
    assert tuple(out.shape) == (2, 0)


def test_scanpipe_stitches_like_a_whole_contig_scan():
    """Chunked, ramped calls stitch byte-identically to whole scans."""
    k, h = 32, 3
    codes = _codes(5000, seed=11)
    codes[700] = ord("N")
    codes[1900] = ord("y")
    bf, want = _filter(codes, k, h, 1 << 16)
    scanner = tsc.DeviceScanner(bf, "cpu")
    pipe = ScanPipe(scanner, k, row_windows=700, rows=4, depth=2)
    jobs = [(0, codes), (1, codes[:10]), (2, codes[100:2100]),
            (3, codes[:k]), (4, codes[50:4000])]
    got = dict(pipe.run(jobs))
    assert len(pipe._plan(jobs)) > 3  # several calls, through the ramp-up
    assert np.array_equal(got[0], want)
    assert got[1].size == 0
    assert np.array_equal(got[2], want[100 : 2100 - k + 1])
    assert np.array_equal(got[3], want[:1])
    assert np.array_equal(got[4], want[50 : 4000 - k + 1])


def test_scanpipe_waits_are_spans():
    """The consumer's wait on each call is one scan.wait span
    (utils/trace.py); the pipe keeps no wait counters of its own."""
    k, h = 32, 3
    codes = _codes(5000, seed=12)
    bf, want = _filter(codes, k, h, 1 << 16)
    pipe = ScanPipe(tsc.DeviceScanner(bf, "cpu"), k, row_windows=700, rows=4, depth=2)
    jobs = [(0, codes), (1, codes[200:3000])]
    with trace.collect() as col:
        got = dict(pipe.run(jobs))
    waits = [s for s in col.export()["spans"] if s[0] == "scan.wait"]
    assert len(waits) == len(pipe._plan(jobs)) > 3
    assert all(t0 <= t1 for _n, t0, t1, _a in waits)
    assert np.array_equal(got[0], want)
    assert np.array_equal(got[1], want[200 : 3000 - k + 1])
    for gone in ("waits", "calls", "wait_s", "wait_steady_s"):
        assert not hasattr(pipe, gone)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the no-CUDA refusal cannot show")
    bf, _ = _filter(_codes(100, seed=2), 32, 4, 1 << 12)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsc.DeviceScanner(bf, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [20, 24, 28, 32])
def test_cuda_kernel_matches_plain(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    h = 4
    rng = np.random.default_rng(k)
    seq = _codes(200_000, seed=k)
    bf, _ = _filter(seq, k, h, 1 << 20)
    rows = np.stack([seq] * 3 + [rng.integers(0, 256, len(seq)).astype(np.uint8)])
    words = torch.from_numpy(bf.words_u32().view(np.int32).copy())
    codes = torch.from_numpy(rows)
    launches = tsc.scan_present_packed.launches.value
    got = tsc.scan_present_packed(words.cuda(), int(bf.bits), h, k, codes.cuda())
    torch.cuda.synchronize()
    assert tsc.scan_present_packed.launches.value == launches + 1
    want = tsc.scan_present_packed_reference(words, int(bf.bits), h, k, codes)
    assert torch.equal(got.cpu(), want)
    # a non-pow2 filter on the card: the full 64-bit modulo
    bf2, _ = _filter(seq, k, h, 49160)
    w2 = torch.from_numpy(bf2.words_u32().view(np.int32).copy())
    got2 = tsc.scan_present_packed(w2.cuda(), int(bf2.bits), h, k, codes.cuda())
    want2 = tsc.scan_present_packed_reference(w2, int(bf2.bits), h, k, codes)
    assert torch.equal(got2.cpu(), want2)


@pytest.mark.cuda
@pytest.mark.parametrize("nw,k,h,B,pow2", chip_smoke.scan_edge_cases())
def test_cuda_kernel_matches_plain_edges(nw, k, h, B, pow2):
    """The twin of test_scan_edges_match_host on the card: kernel against
    plain version, the codes also at an odd byte offset of their buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    launches = tsc.scan_present_packed.launches.value
    chip_smoke.scan_edge_check((nw, k, h, B, pow2))
    assert tsc.scan_present_packed.launches.value == launches + 2


@pytest.mark.cuda
def test_cuda_scanpipe_matches_plain_scans():
    """The CUDA pipe (own stream, pinned slots reused every DEPTH + 2 calls,
    one event per call) stitches like whole-contig plain scans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    k, h = 28, 4
    seq = _codes(60_000, seed=21)
    seq[1000:1010] = ord("N")
    bf, want = _filter(seq, k, h, 1 << 18)
    pipe = ScanPipe(tsc.DeviceScanner(bf, "cuda"), k, row_windows=1024,
                    rows=4, depth=2)
    jobs = [(i, seq[i * 7000 : i * 7000 + 9000 + i]) for i in range(7)]
    got = dict(pipe.run(jobs))
    assert len(pipe._plan(jobs)) > 2 * (pipe.depth + 2)  # every slot reused
    for i, codes in jobs:
        a = i * 7000
        assert np.array_equal(got[i], want[a : a + len(codes) - k + 1]), i
