// Kernel 2: the fused dense scan — canonical ntHash of every k-window,
// h derived hashes, Bloom probe, and presence packed 8 windows per byte.
//
//   fh(w) = XOR_j TF[j][class(s[w+j])]     TF[j][c] = srol^(k-1-j)(seed_c)
//   rh(w) = XOR_j TR[j][s[w+j] & 7]        TR[j][c] = srol^j(seedTab[c])
//   hash_0 = fh + rh (wrapping), hash_i = t ^ (t >> 27), t = hash_0 * (i ^ k*MULTI_SEED)
//   present(w) = AND_i bit(words, hash_i mod bits)
//   out[b, w >> 3] bit (w & 7) = present(w)          (little-endian packing)
//
// The tables come from goldpolish_tpu_torch/ops/scan_conv.py:_xor_tables,
// which the plain torch version (scan_present_packed_reference) shares.
// class(c) is the forward-seed class of byte c (A, C, G, T or none) read
// from ntHash's 256-entry seed table, so every byte value hashes exactly
// as ops/nthash.py does.
//
// Replaces: goldpolish_tpu/ops/scan_conv.py K1 — scan_present_packed_gather
// (:190) and scan_present_packed_mxu (:228), whose probe is the Pallas
// kernel P3 (bloom_pallas.py:322).  The TPU computes the hash as a
// bit-sliced bf16 convolution on the MXU and probes with a one-hot int8
// matmul; both exist to feed the MXU.  Here the hash is u64 integer
// arithmetic on shared-memory tables and the probe is the word load of
// bloom_probe.cuh.  Unlike the JAX scan, a filter whose bit count is not a
// power of two is probed at the full 64-bit `hash % bits`, as the host
// filter does (ops/bloom.py:89), not at `lo32 % bits`.
//
// What bounds it on the H100: the input is L bytes and the output L/8 bytes
// per row, so HBM traffic is negligible (the byte bound of a [4, 2^19]
// call is ~2 us).  The work is, per window, the hash and up to h random
// 4-byte loads from a filter that lives in L2.  The first form of this
// kernel hashed every window directly (2k table loads from shared memory,
// so its time followed k); with the hash rolled, what is left is the rate
// at which the card serves random L2 requests (kernels 4 and 5 meet the
// same limit): measured, ~120 G requests/s, which sets a floor of the
// call's probe count over that rate, far above the byte bound.
//
// What the design does about it:
//  * a thread owns a run of kRun = 8 consecutive windows, which is one
//    output byte (no ballot: a warp writes 32 neighbouring bytes).  It
//    hashes the first window directly (gp_window_hash, 2k table loads) and
//    rolls the other seven in O(1) each (gp_roll of nthash_roll.cuh, the
//    ntHash device code kernels 4 and 5 use): about (2k + 7 * 6) / 8 table
//    and byte loads per window instead of 4k;
//  * a block covers a tile of 2,048 windows and stages the direct and the
//    roll tables once for it; the tile's 2,048 + k - 1 bytes arrive as
//    16-byte loads of the aligned chunks that cover them (rows start at
//    any byte offset, so the tile sits at offset `a` < 16 in its buffer),
//    with byte loads only for a chunk that crosses an end of the tensor;
//  * all eight hashes of a run are computed before the first probe; the
//    probes then go in h rounds: round i computes the bit index of hash i
//    for every window still alive, starts those loads together (up to 8
//    independent requests in flight per thread, none tested before all
//    have started: a thread's instructions go in order) and drops the
//    windows whose bit is clear.  Starting all h loads of a window at once
//    was measured too: it sends 4 requests per window where the rounds
//    send ~2.7 on a p = 0.75 filter, and the request rate is the limit, so
//    it lost there and tied on a filter that holds most windows;
//  * the kernel is instantiated for power-of-two filters apart, so that
//    path is straight-line code (the 64-bit modulo is a routine with
//    branches, across which no load is scheduled);
//  * shared-memory banks: the roll tables are indexed by byte value, and
//    A, C, G, T (65, 67, 71, 84) fall on different banks, as do the 5
//    classes of TF and the 8 of TR at one j; neighbouring threads read
//    code bytes 8 apart (a 2-way conflict on those byte loads, the
//    cheapest loads of the hash).
#include <cuda_runtime.h>

#include <cstdint>

#include "nthash_roll.cuh"

namespace {

constexpr int kScanThreads = 256;
constexpr int kRun = 8;  // windows per thread: a multiple of 8, kRun / 8 output bytes
constexpr int kScanTile = kScanThreads * kRun;  // windows per block
constexpr int kChunk = 16;                      // bytes per staging load

template <bool kPow2>
__global__ void __launch_bounds__(kScanThreads)
gp_scan_kernel(const uint32_t* __restrict__ words, uint64_t bits, int h, int k,
               const uint8_t* __restrict__ codes, int64_t B, int64_t L, int64_t nw,
               int64_t nbytes, const uint64_t* __restrict__ tf,
               const uint64_t* __restrict__ tr, const uint8_t* __restrict__ fclass,
               uint64_t kmul, uint8_t* __restrict__ out) {
  __shared__ GpWindowTables s_t;
  __shared__ GpRollTables s_r;
  // the tile's bytes from offset a on; every chunk is loaded whole
  __shared__ __align__(kChunk) uint8_t s_raw[kScanTile + kGpMaxK + 2 * kChunk];

  const int64_t row = blockIdx.y;
  const int64_t w0 = (int64_t)blockIdx.x * kScanTile;
  gp_load_window_tables(s_t, k, tf, tr, fclass);
  // bytes [w0, w0 + kScanTile + k - 1) of the row.  Bytes past the row's
  // end are read only by windows >= nw, which are never probed, so
  // whatever the chunk holds there (the next row, or 0 past the tensor)
  // is never seen.
  const uint8_t* src = codes + row * L + w0;
  const int a = (int)((uintptr_t)src & (kChunk - 1));
  const uint8_t* lo = codes;
  const uint8_t* hi = codes + B * L;
  const int nchunks = (a + kScanTile + k - 1 + kChunk - 1) / kChunk;
  for (int c = threadIdx.x; c < nchunks; c += kScanThreads) {
    const uint8_t* g = src - a + (int64_t)c * kChunk;
    if (g >= lo && g + kChunk <= hi) {
      *(uint4*)(s_raw + c * kChunk) = __ldg((const uint4*)g);
    } else {
      for (int i = 0; i < kChunk; ++i)
        s_raw[c * kChunk + i] = (g + i >= lo && g + i < hi) ? g[i] : 0;
    }
  }
  __syncthreads();
  gp_load_roll_tables(s_r, s_t, k);
  __syncthreads();

  const int64_t w = w0 + (int64_t)threadIdx.x * kRun;  // the run's first window
  if (w >= nw) return;
  const uint8_t* s = s_raw + a + threadIdx.x * kRun;
  uint64_t base[kRun], fh, rh;
  gp_window_hash(s_t, k, [s](int j) { return s[j]; }, fh, rh);
  base[0] = fh + rh;
#pragma unroll
  for (int q = 1; q < kRun; ++q) {
    gp_roll(s_r, fh, rh, s[q - 1], s[q - 1 + k]);
    base[q] = fh + rh;
  }
  // window 8j + r of the run is bit r of its byte j; a window past the
  // row's last starts out absent (its bit stays 0 and it is never probed)
  const int64_t m = nw - w;  // windows of the run inside the row (>= 1)
  unsigned present[kRun / 8];
#pragma unroll
  for (int j = 0; j < kRun / 8; ++j)
    present[j] = m >= 8 * (j + 1) ? 0xffu : m > 8 * j ? (1u << (m - 8 * j)) - 1u : 0u;
  // round i tests hash i of every window of the run that is still alive:
  // the indices, then the loads (up to kRun in flight), then the tests; a
  // window leaves at its first clear bit and sends no further request
  for (int i = 0; i < h; ++i) {
    uint64_t bit[kRun];
    uint32_t word[kRun];
#pragma unroll
    for (int q = 0; q < kRun; ++q)
      bit[q] = gp_bit_index<kPow2>(gp_nth_hash(base[q], i, kmul), bits);
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      word[q] = ~0u;
      if ((present[q >> 3] >> (q & 7)) & 1u) word[q] = gp_bloom_word(words, bit[q]);
    }
    unsigned any = 0;
#pragma unroll
    for (int q = 0; q < kRun; ++q)
      if (!gp_bloom_bit(word[q], bit[q])) present[q >> 3] &= ~(1u << (q & 7));
#pragma unroll
    for (int j = 0; j < kRun / 8; ++j) any |= present[j];
    if (!any) break;
  }
  uint8_t* dst = out + row * nbytes + (w >> 3);
#pragma unroll
  for (int j = 0; j < kRun / 8; ++j)
    if (m > 8 * j) dst[j] = (uint8_t)present[j];
}

}  // namespace

// codes: uint8[B, L] row-major (device); words: uint32[ceil(bits/32)];
// tf: uint64[k, 4]; tr: uint64[k, 8]; fclass: uint8[256]; kmul = k *
// MULTI_SEED (mod 2^64); out: uint8[B, ceil((L-k+1)/8)].  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int gp_scan_present_packed(const void* words, uint64_t bits, int h,
                                      int k, const void* codes, int64_t B,
                                      int64_t L, const void* tf, const void* tr,
                                      const void* fclass, uint64_t kmul,
                                      void* out, void* stream) {
  if (k < 1 || k > kGpMaxK || h < 1 || bits == 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t nw = L - k + 1;
  if (nw <= 0 || B <= 0) return 0;
  const int64_t nbytes = (nw + 7) / 8;
  dim3 grid((unsigned)((nw + kScanTile - 1) / kScanTile), (unsigned)B);
  auto kernel = (bits & (bits - 1)) == 0 ? gp_scan_kernel<true> : gp_scan_kernel<false>;
  kernel<<<grid, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, bits, h, k, (const uint8_t*)codes, B, L, nw, nbytes,
      (const uint64_t*)tf, (const uint64_t*)tr, (const uint8_t*)fclass, kmul,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}
