// The one Bloom-filter bit test that every device probe in this package
// uses: kernel 1 (bloom_probe.cu) includes it, and so does nthash_roll.cuh,
// through which kernels 2-5 probe, so the bit layout exists once.
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
