"""The port's BFBuilder.build_batch_device against the JAX package's, on
the CPU (the plain fill: device="cpu").

The device filters must equal the JAX build's byte for byte (tolerance 0)
and contain the port's own host fill with under 5% extra bits, at 0%, 0.25%
and 1% read error and with per-target thresholds (the cases of
tests/test_bf_builder_device.py, at a ~100 kbp read stream)."""

import numpy as np
import pytest
import torch

from goldpolish_tpu.bf_builder import BFBuilder as JaxBuilder
from goldpolish_tpu_torch.bf_builder import BFBuilder

CBF_BYTES = 1 << 20


class FakeIndex:
    def __init__(self, seqs):
        self.seqs = seqs

    def get_seq_len(self, i):
        return len(self.seqs[i])

    def get_seq(self, i):
        return self.seqs[i]

    def get_phred_avg(self, i):
        return 40.0


class FakeMappings:
    def __init__(self, m):
        self.m = m

    def get_mappings(self, t):
        return self.m.get(t, [])


def _genome(rng, n):
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes()


def _tiled_reads(rng, targets, err_rate=0.0, passes=6, frag=2500, step=1250):
    """Tiled fragments of each target with `err_rate` substitutions."""
    reads, mappings = {}, {t: [] for t in targets}
    for rep in range(passes):
        off = rep * step // passes
        for tname, t in targets.items():
            for s in range(-off, len(t), step):
                a, e = max(0, s), min(len(t), s + frag)
                if e - a < 300:
                    continue
                r = bytearray(t[a:e])
                for p in rng.integers(0, len(r), rng.poisson(err_rate * len(r))):
                    r[p] = b"ACGT"[(b"ACGT".index(r[p]) + 1 + int(rng.integers(0, 3))) % 4]
                name = f"r{len(reads)}"
                reads[name] = bytes(r)
                mappings[tname].append(name)
    return reads, mappings


def _builders(targets, reads, mappings, ks):
    args = (FakeIndex(targets), FakeIndex(reads), FakeMappings(mappings), ks)
    kw = dict(cbf_bytes=CBF_BYTES, subsample_max_mapped_seqs_per_target_10kbp=1000.0)
    return BFBuilder(*args, **kw), JaxBuilder(*args, **kw)


def _check(port, jax_b, ids):
    """Device = JAX device build; superset of the host fill.  Returns the
    worst extra-bit share over the k values."""
    dev = port.build_batch_device(ids, device="cpu")
    want = jax_b.build_batch_device(ids)
    host = port.build_batch(ids)
    assert dev.cbfs == [] and dev.k_values == want.k_values
    worst = 0.0
    for k in port.k_values:
        d, w, hb = dev.bf_for_k(k), want.bf_for_k(k), host.bf_for_k(k)
        assert bytes(d.array) == bytes(w.array), k
        assert d.bytes == hb.bytes
        assert np.all((hb.array & ~d.array) == 0), k
        extra = int(np.unpackbits(d.array & ~hb.array).sum())
        worst = max(worst, extra / max(1, int(np.unpackbits(hb.array).sum())))
    return dev, worst


@pytest.mark.parametrize("err_rate", [0.0, 0.0025, 0.01])
def test_device_build_equals_jax_and_contains_host(err_rate):
    rng = np.random.default_rng(11)
    targets = {"c0": _genome(rng, 8000)}
    reads, mappings = _tiled_reads(rng, targets, err_rate)
    port, jax_b = _builders(targets, reads, mappings, [32, 28])
    _dev, worst = _check(port, jax_b, ["c0"])
    assert worst < 0.05, worst


def test_device_build_per_target_thresholds():
    """Targets promote with their own thresholds (5 and 7, forced at the
    chooser as the JAX test does), not the batch minimum: at ~4x coverage
    c1's k-mers miss its k = 32 threshold (7 - 2 = 5) and pass the batch
    minimum's (5 - 2 = 3)."""
    rng = np.random.default_rng(5)
    targets = {"c0": _genome(rng, 4000), "c1": _genome(rng, 4000)}
    reads, mappings = _tiled_reads(rng, targets, passes=2, frag=2000, step=1000)
    port, jax_b = _builders(targets, reads, mappings, [32])

    def forced(builder, thr_of):
        orig = builder._choose_reads
        builder._choose_reads = lambda ids: [(t, c, thr_of(t)) for t, c, _ in orig(ids)]

    forced(port, lambda t: 5 if t == "c0" else 7)
    forced(jax_b, lambda t: 5 if t == "c0" else 7)
    dev, _worst = _check(port, jax_b, ["c0", "c1"])
    port_min, jax_min = _builders(targets, reads, mappings, [32])
    forced(port_min, lambda t: 5)
    forced(jax_min, lambda t: 5)
    dmin, _worst = _check(port_min, jax_min, ["c0", "c1"])
    bits = np.unpackbits(dev.bf_for_k(32).array).sum()
    assert bits < np.unpackbits(dmin.bf_for_k(32).array).sum()


def test_device_build_refusals(monkeypatch):
    rng = np.random.default_rng(3)
    targets = {"c0": _genome(rng, 2000)}
    reads, mappings = _tiled_reads(rng, targets, passes=2)
    port, _jax_b = _builders(targets, reads, mappings, [32])
    monkeypatch.setenv("GPTPU_SCATTER_FILL", "1")
    with pytest.raises(NotImplementedError, match="GPTPU_SCATTER_FILL"):
        port.build_batch_device(["c0"], device="cpu")
    monkeypatch.delenv("GPTPU_SCATTER_FILL")
    big_k, _ = _builders(targets, reads, mappings, [34])
    with pytest.raises(ValueError, match="k <= 33"):
        big_k.build_batch_device(["c0"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port.build_batch_device(["c0"], device="cuda")


@pytest.mark.cuda
def test_cuda_device_build_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    rng = np.random.default_rng(11)
    targets = {"c0": _genome(rng, 8000)}
    reads, mappings = _tiled_reads(rng, targets, 0.01)
    port = BFBuilder(FakeIndex(targets), FakeIndex(reads), FakeMappings(mappings),
                     [32, 28, 24, 20], cbf_bytes=CBF_BYTES,
                     subsample_max_mapped_seqs_per_target_10kbp=1000.0)
    got = port.build_batch_device(["c0"], device="cuda")
    want = port.build_batch_device(["c0"], device="cpu")
    for k in port.k_values:
        assert bytes(got.bf_for_k(k).array) == bytes(want.bf_for_k(k).array)
