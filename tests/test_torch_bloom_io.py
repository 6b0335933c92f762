"""The port's Bloom-filter file formats (ops/bloom.py) against the JAX
package's, on the CPU: every format the two read alike loads to the same
filter (tolerance 0: bytes), and the two inputs where the JAX loader is at
fault (ROADMAP.md queue 3) raise in the port instead."""

import numpy as np
import pytest

from goldpolish_tpu.ops import bloom as jbloom
from goldpolish_tpu_torch.ops import bloom

_JAX_FAULT = {
    "btllib_counting": "the JAX load_any reads a btllib counting container as a "
                       "plain filter (reference fault, repaired in the port)",
    "btllib_seed": "the JAX load_any reads a btllib seed container as a plain "
                   "filter (reference fault, repaired in the port)",
    "btllib_no_k": "the JAX load_btllib_bf takes k = 0 for a header without k "
                   "(reference fault, repaired in the port)",
}


def _filter() -> bloom.BloomFilter:
    rng = np.random.default_rng(5)
    bf = bloom.BloomFilter(1 << 12, 3, 25)
    bf.array[:] = rng.integers(0, 256, bf.array.shape, dtype=np.uint8)
    return bf


def _btllib_file(path, signature: str, fields: dict, payload: bytes) -> str:
    head = [signature] + [f"    {key} = {val}" for key, val in fields.items()]
    with open(path, "wb") as f:
        f.write(("\n".join(head + ["[HeaderEnd]"]) + "\n").encode() + payload)
    return str(path)


def _write(fmt: str, tmp_path) -> str:
    bf = _filter()
    path = tmp_path / f"filter.{fmt}"
    fields = {"bytes": bf.bytes, "hash_num": bf.hash_num, "k": bf.k}
    if fmt == "gptpu":
        bf.save(str(path))
    elif fmt == "ntedit":
        bloom.save_ntedit_bf(bf, str(path))
    elif fmt == "btllib":
        bloom.save_btllib_bf(bf, str(path))
    elif fmt == "btllib_v5":
        _btllib_file(path, "[BTLBloomFilter_v5]", fields, bf.array.tobytes())
    elif fmt == "btllib_counting":
        _btllib_file(path, "[BTLCountingBloomFilter_v6]", fields, bf.array.tobytes())
    elif fmt == "btllib_seed":
        _btllib_file(path, "[BTLSeedBloomFilter_v6]", fields, bf.array.tobytes())
    elif fmt == "btllib_no_k":
        del fields["k"]
        _btllib_file(path, "[BTLKmerBloomFilter_v6]", fields, bf.array.tobytes())
    return str(path)


@pytest.mark.parametrize("fmt", ["gptpu", "ntedit", "btllib", "btllib_v5",
                                 *_JAX_FAULT])
def test_load_any_matches_jax(fmt, tmp_path):
    if fmt in _JAX_FAULT:
        pytest.skip(_JAX_FAULT[fmt])
    path = _write(fmt, tmp_path)
    got, want = bloom.load_any(path), jbloom.load_any(path)
    assert (got.bytes, got.hash_num, got.k) == (want.bytes, want.hash_num, want.k)
    assert bytes(got.array) == bytes(want.array)
    assert bytes(got.array) == bytes(_filter().array)


@pytest.mark.parametrize("fmt", ["btllib_counting", "btllib_seed"])
def test_load_any_refuses_counting_and_seed(fmt, tmp_path):
    path = _write(fmt, tmp_path)
    name = "Counting" if fmt == "btllib_counting" else "Seed"
    with pytest.raises(ValueError, match=f"BTL{name}BloomFilter_v6"):
        bloom.load_any(path)


def test_load_btllib_bf_needs_k(tmp_path):
    path = _write("btllib_no_k", tmp_path)
    with pytest.raises(ValueError, match="no k field"):
        bloom.load_btllib_bf(path)
    with pytest.raises(ValueError, match="no k field"):
        bloom.load_any(path)
    bf = bloom.load_btllib_bf(path, k=25)
    assert bf.k == 25 and bytes(bf.array) == bytes(_filter().array)
    # a header's own k wins over the caller's
    assert bloom.load_btllib_bf(_write("btllib", tmp_path), k=31).k == 25
