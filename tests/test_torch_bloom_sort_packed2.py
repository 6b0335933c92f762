"""The port's device fill, which always uploads raw bytes, against the JAX
package's device_fill_bfs_sorted by both of its upload routes, on the CPU.

The JAX build sends a group of reads 2-bit packed, with up to _EXC_CAP =
8192 non-ACGT bytes beside it, whenever its native packer loads, and raw
bytes for a group of more (`_stream_arrays`).  The port has no packed
route: the same seeded reads (lowercase acgt, N runs and IUPAC bytes among
them; not bytes 1, 3, 4 and 7, which the JAX packed route classes as
seedless, ROADMAP.md queue 3) go through the JAX build by its packed route
as it is and by its raw route (goldpolish_tpu.native.pack2 returning None),
and the port's filters must equal both byte for byte (tolerance 0: integer
hashing, counting and bit sets).  Each JAX run's packer calls are tallied,
so a case that names the packed route is known to have taken it.  Streams
stay under one JAX row bucket (16 kbp) a group, so the JAX programs compile
once per k.  The `cuda` cases hold kernel 5's fill against its plain
version on the same reads, on the card, and skip here."""

import sys
import threading

import numpy as np
import pytest
import torch

import goldpolish_tpu.native as jax_native
from goldpolish_tpu.ops import bloom_sort as jbs
from goldpolish_tpu_torch import native
from goldpolish_tpu_torch.ops import bloom_sort as tbs
from goldpolish_tpu_torch.ops.scan_conv import unpack2_reference

H = 4
CBF_BYTES = 1 << 20
BF_BYTES = 1 << 17
KS = [32, 28]
SINGLE = 1 << 40
CHUNK = 4096
CAP = jbs._EXC_CAP
IUPAC = np.frombuffer(b"RYSWKMBDHVN", np.uint8)
ACGT = np.frombuffer(b"ACGTacgt", np.uint8)


def _n_exc(reads) -> int:
    """The non-ACGT bytes (either case) of the reads."""
    return int(np.isin(np.frombuffer(b"".join(reads), np.uint8), ACGT, invert=True).sum())


def _reads(seed: int, n_exc: int, genome: int = 2700, frag: int = 600,
           cov: int = 3, n_runs: int = 0):
    """Reads tiled over a seeded genome (cov passes of frag-base reads at a
    frag // 2 step), joined holding exactly n_exc non-ACGT bytes: N runs of
    25 (n_runs of them) and single IUPAC bytes; ~10% of the other bases
    lowercase.  Returns (reads, thresholds)."""
    rng = np.random.default_rng(seed)
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, genome)]
    parts = [truth[s : s + frag] for _ in range(cov)
             for s in range(0, genome - frag + 1, frag // 2)]
    lens = [len(p) for p in parts]
    stream = np.concatenate(parts).copy()
    assert n_exc <= len(stream)
    lower = rng.random(len(stream)) < 0.1
    stream[lower] += 32
    taken = np.zeros(len(stream), bool)
    for s in rng.choice(len(stream) - 25, n_runs, replace=False):
        room = min(25, n_exc - int(taken.sum()))
        stream[s : s + room] = ord("N")
        taken[s : s + room] = True
    rest = n_exc - int(taken.sum())
    pos = rng.choice(np.flatnonzero(~taken), rest, replace=False)
    stream[pos] = IUPAC[rng.integers(0, len(IUPAC), rest)]
    ends = np.cumsum(lens)
    reads = [stream[e - n : e].tobytes() for n, e in zip(lens, ends)]
    assert _n_exc(reads) == n_exc
    thrs = [int(t) for t in rng.integers(1, 4, len(reads))]
    return reads, thrs


def _jax(reads, thrs, chunk_bases, route, monkeypatch):
    """The JAX build by its packed route, or by its raw route (its packer
    made to return None, as when a stream passes its cap), and its groups
    (packed, raw) as its packer decided them."""
    routes = {"packed": 0, "raw": 0}
    pack2 = jax_native.pack2

    def tallied(*args, **kw):
        res = pack2(*args, **kw) if route == "packed" else None
        routes["raw" if res is None else "packed"] += 1
        return res

    with monkeypatch.context() as m:
        m.setattr(jax_native, "pack2", tallied)
        got = jbs.device_fill_bfs_sorted(reads, thrs, KS, H, CBF_BYTES, BF_BYTES,
                                         chunk_bases=chunk_bases)
    return got, (routes["packed"], routes["raw"])


def _port(reads, thrs, chunk_bases):
    return tbs.device_fill_bfs_sorted(reads, thrs, KS, H, CBF_BYTES, BF_BYTES,
                                      chunk_bases=chunk_bases, device="cpu")


def _assert_equal(got, want):
    for k, g, w in zip(KS, got, want):
        assert (g.bytes, g.hash_num, g.k) == (w.bytes, w.hash_num, w.k)
        assert bytes(g.array) == bytes(w.array), k


@pytest.mark.parametrize("jax_route", ["packed", "raw"])
@pytest.mark.parametrize("chunk_bases", [SINGLE, CHUNK])
@pytest.mark.parametrize("n_exc", [0, 1, CAP, CAP + 1])
def test_equals_jax_by_both_routes(n_exc, chunk_bases, jax_route, monkeypatch):
    """At 0, 1, 8192 and 8193 exceptions, single dispatch and chunked: the
    port's fill equals the JAX build by either of its routes; the JAX
    packed route sent a group of at most 8192 exceptions packed and one of
    more raw."""
    reads, thrs = _reads(40 + n_exc % 7, n_exc, n_runs=min(n_exc // 50, 100))
    want, routes = _jax(reads, thrs, chunk_bases, jax_route, monkeypatch)
    got = _port(reads, thrs, chunk_bases)
    _assert_equal(got, want)
    assert any(g.pop_count for g in got)
    groups = [(reads, thrs)] if chunk_bases == SINGLE else \
        tbs._groups(reads, thrs, chunk_bases)
    assert len(groups) == 1 if chunk_bases == SINGLE else len(groups) > 1
    packed = sum(_n_exc(g) <= CAP for g, _t in groups) if jax_route == "packed" else 0
    assert routes == (packed, len(groups) - packed)


@pytest.mark.parametrize("jax_route", ["packed", "raw"])
def test_chunked_groups_split_across_the_cap(jax_route, monkeypatch):
    """Three groups of 9,000 bases: 8192, 8193 and 100 exceptions.  The JAX
    packed route sends the second raw and the others packed; the port's
    chunked fill and its single dispatch equal the JAX build either way."""
    rng = np.random.default_rng(7)
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 4000)]
    reads, thrs = [], []
    for g, n_exc in enumerate((CAP, CAP + 1, 100)):
        stream = np.concatenate([truth[s : s + 1000] for s in range(0, 3000, 1000)] * 3)
        pos = rng.choice(len(stream), n_exc, replace=False)
        stream[pos] = IUPAC[rng.integers(0, len(IUPAC), n_exc)]
        reads += [stream[i : i + 1000].tobytes() for i in range(0, 9000, 1000)]
        thrs += [1 + g] * 9
    assert len(tbs._groups(reads, thrs, 9000)) == 3
    want, routes = _jax(reads, thrs, 9000, jax_route, monkeypatch)
    assert routes == ((2, 1) if jax_route == "packed" else (0, 3))
    _assert_equal(_port(reads, thrs, 9000), want)
    _assert_equal(_port(reads, thrs, SINGLE), want)


def _fill_threads(device: str, n_threads: int = 6, rounds: int = 3):
    """n_threads threads, each filling `rounds` times on reads of its own,
    with a short switch interval: (each thread's filters of each round, the
    plain fill of each thread's reads)."""
    inputs = [_reads(60 + t, 40 * t, n_runs=t) for t in range(n_threads)]
    out = [[None] * rounds for _ in range(n_threads)]

    def work(t):
        for r in range(rounds):
            out[t][r] = tbs.device_fill_bfs_sorted(*inputs[t], KS, H, CBF_BYTES, BF_BYTES,
                                                   chunk_bases=CHUNK, device=device)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    want = [tbs.device_fill_bfs_sorted_reference(*i, KS, H, CBF_BYTES, BF_BYTES,
                                                 chunk_bases=CHUNK) for i in inputs]
    return out, want


def test_fills_on_many_threads():
    """Fills on six threads at once (the overlap arm fills beside other
    batches): every fill equals the plain fill of its reads."""
    out, want = _fill_threads("cpu")
    for fills, w in zip(out, want):
        for got in fills:
            _assert_equal(got, w)


def _decode_case(n: int, seed: int) -> bytes:
    """n seeded bytes: ACGT and acgt, with IUPAC bytes and N at the first
    and the last position and a few between."""
    rng = np.random.default_rng(seed)
    a = np.frombuffer(b"ACGTacgt", np.uint8)[rng.integers(0, 8, n)].copy()
    a[0], a[-1] = ord("N"), ord("Y")
    if n > 8:
        pos = rng.choice(n, n // 8, replace=False)
        a[pos] = IUPAC[rng.integers(0, len(IUPAC), len(pos))]
    return a.tobytes()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 4093, 4094, 4095, 4096])
def test_plain_decode_gives_back_the_stream(n):
    """A stream packed as the JAX packed route packs it (native.pack2), then
    decoded (scan_conv's plain decode, one row): the raw upload's bytes up
    to case (kernel 5 hashes acgt as ACGT), for n % 4 of 0-3, n < 4 and
    exceptions at the first and the last position."""
    raw = _decode_case(n, n)
    packed, exc_idx, exc_byte = native.pack2(np.frombuffer(raw, np.uint8), CAP)
    assert exc_idx[0] == 0 and exc_idx[-1] == n - 1
    codes = unpack2_reference(n, *(torch.from_numpy(a)[None] for a in (packed, exc_idx,
                                                                        exc_byte)))[0]
    assert codes.dtype == torch.uint8 and codes.shape == (n,)
    want = bytes(c - 32 if c in b"acgt" else c for c in raw)
    assert codes.numpy().tobytes() == want
    up, offsets, _thrs = tbs.upload_stream([raw], [3], torch.device("cpu"))
    assert up.numpy().tobytes() == raw
    assert offsets.tolist() == [0, n]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_bases", [SINGLE, CHUNK])
@pytest.mark.parametrize("n_exc", [0, 1, CAP, CAP + 1])
def test_cuda_fill_equals_plain(n_exc, chunk_bases):
    """Kernel 5's fill on the card equals its plain fill on these
    exception-laden reads."""
    _cuda()
    reads, thrs = _reads(40 + n_exc % 7, n_exc, n_runs=min(n_exc // 50, 100))
    args = (reads, thrs, KS, H, CBF_BYTES, BF_BYTES)
    got = tbs.device_fill_bfs_sorted(*args, chunk_bases=chunk_bases, device="cuda")
    _assert_equal(got, tbs.device_fill_bfs_sorted_reference(*args, chunk_bases=chunk_bases))


@pytest.mark.cuda
def test_cuda_fills_on_many_threads():
    """Six threads filling on the card at once, each on its own side
    stream: every fill equals the plain fill of its reads."""
    _cuda()
    out, want = _fill_threads("cuda")
    for fills, w in zip(out, want):
        for got in fills:
            _assert_equal(got, w)
