// The Bloom-filter probe that every device probe in this package uses:
// kernel 1 (bloom_probe.cu) includes it, and so does nthash_roll.cuh,
// through which kernels 2-8 probe, so the bit layout exists once.
//
// Replaces: the word select + bit test of every Pallas probe kernel in
// goldpolish_tpu/ops/bloom_pallas.py (_probe_kernel :36, _probe_mxu_kernel
// :129, _select_word :224 used by _probe_mxu_i8_kernel :255 and
// _probe_mxu_i8_chunked_kernel :274).  On the TPU the select is a one-hot
// matmul over byte planes, because Mosaic cannot gather across vector
// registers; on Hopper it is one 4-byte load.
//
// Layout: bit b of the filter is bit (b & 31) of little-endian word b >> 5
// (goldpolish_tpu/ops/bloom.py:112-114, BloomFilter.words_u32).
//
// Beside the bit test, the probe rounds that kernels 1, 2 and 8 share
// (gp_probe_rounds): round i computes the bit of hash i of every key of a
// thread's run still alive, starts all those loads, and only then tests
// them (a thread's instructions go in order, so a test right after its load
// would hold the next load back).
#pragma once

#include <cstdint>

// The word that holds bit `bit`, and the bit of a loaded word: apart, so a
// caller can start several loads before it tests the first.
__device__ __forceinline__ uint32_t gp_bloom_word(const uint32_t* __restrict__ words,
                                                  uint64_t bit) {
  return __ldg(words + (bit >> 5));
}

__device__ __forceinline__ bool gp_bloom_bit(uint32_t word, uint64_t bit) {
  return (word >> (uint32_t)(bit & 31u)) & 1u;
}

__device__ __forceinline__ bool gp_bloom_test(const uint32_t* __restrict__ words,
                                              uint64_t bit) {
  return gp_bloom_bit(gp_bloom_word(words, bit), bit);
}

// The h probe rounds of kRun (<= 32) keys against `words`: bit q of
// `alive` marks key q live; bit_of(q, i) is the filter bit of key q's hash
// i, computed for every key (a dead one's is never loaded, so it must only
// be safe to compute).  Returns the keys whose h bits are all set.  A key
// leaves at its first clear bit and sends no further request.
template <int kRun, class BitOf>
__device__ __forceinline__ unsigned gp_probe_rounds(const uint32_t* __restrict__ words,
                                                    int h, unsigned alive, BitOf bit_of) {
  for (int i = 0; i < h; ++i) {
    uint64_t bit[kRun];
    uint32_t word[kRun];
#pragma unroll
    for (int q = 0; q < kRun; ++q) bit[q] = bit_of(q, i);
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      word[q] = ~0u;
      if ((alive >> q) & 1u) word[q] = gp_bloom_word(words, bit[q]);
    }
#pragma unroll
    for (int q = 0; q < kRun; ++q)
      if (!gp_bloom_bit(word[q], bit[q])) alive &= ~(1u << q);
    if (!alive) break;
  }
  return alive;
}
