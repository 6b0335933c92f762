// Kernel 1: Bloom probe of low-32-bit hash tuples.
//
//   present[i] = AND_j bit(words, lo32[i, j] & (bits - 1)),  bits a power of two
//
// Replaces: goldpolish_tpu/ops/bloom_pallas.py — all four Pallas kernels
// compute this one function: _probe_lo32_pallas_32 (:78, take-along-axis
// gather), _probe_lo32_mxu_32 (:178, bf16 one-hot matmul),
// _probe_lo32_mxu_i8 single-chunk (:331) and chunked (:360) (int8 one-hot
// matmul, OR-accumulated over 2048-row chunks).  Their oracle is
// probe_lo32_reference (:102); the plain torch version of this kernel is
// goldpolish_tpu_torch/ops/bloom_probe.py:probe_lo32_reference.
//
// What bounds it on the H100: the hash tuples are streamed once (16 bytes a
// row at h = 4, 33.5 MB for 2^21 rows: ~10 us of HBM), but the probes are
// random 4-byte requests to a filter that lives in L2, up to h a row, and
// the rate at which L2 serves those (~120 G/s, the rate kernels 2 and 8
// reach on an NVIDIA H100 80GB HBM3 at 700.00 W) sets a floor far above
// the byte bound.  The tuples pass through the same L2 (1.05 M sectors at
// [2^21, 4]).
//
// What the design does about it:
//  * a warp takes 128 rows and each lane probes 4 of them, rows 32q + lane
//    (q < 4), so each load instruction of the warp reads 32 neighbouring
//    rows: at h = 4 with 16-byte aligned tuples one 16-byte load a row
//    (`__ldcs`, streaming: the tuples, read once, are evicted first and
//    leave the filter in L2), else one 4-byte load a hash;
//  * the probes go in h rounds over the 4 rows (gp_probe_rounds of
//    bloom_probe.cuh, kernels 2 and 8's loop): every live row's load starts
//    before any test, and a row stops at its first clear bit;
//  * four warp ballots then hand each lane the results of 4 consecutive
//    rows, stored as one 4-byte write;
//  * four rows a lane, not kernel 2's 8: at 8 the tuples held in registers
//    (8 x 16 bytes) took the kernel to 64 registers and 4 blocks a SM,
//    and it measured slower than at 4.
// A second form that held filters of at most 2 MiB in the shared memory of
// a thread-block cluster, read over distributed shared memory, was built
// and measured 1.65-1.9x slower than this one at 512 KiB - 2 MiB on an
// NVIDIA H100 80GB HBM3 at 700.00 W (it served 61-75 G requests/s, L2
// 116-124 G/s), and was removed (PERF.md §6).
#include <cuda_runtime.h>

#include <cstdint>

#include "bloom_probe.cuh"

namespace {

constexpr int kRun = 4;                // rows a lane probes, and stores
constexpr int kWarpRows = 32 * kRun;   // rows a warp takes
constexpr int kPerBallot = 32 / kRun;  // lanes whose rows one ballot holds
constexpr int kProbeThreads = 256;

// Bytes 0/1 of the 4 low bits of x, little-endian: bit j to byte j.
__device__ __forceinline__ uint32_t gp_spread4(uint32_t x) {
  return (x * 0x204081u) & 0x01010101u;
}

// kVec4: h = 4 and the tuples 16-byte aligned.  Warp w takes rows
// [128 w, 128 w + 128) ∩ [0, n): lane probes rows 128 w + 32q + lane
// (q < 4) and writes rows 128 w + 4 lane .. + 3.  No thread returns early
// (the ballots need all 32 lanes).
template <bool kVec4>
__global__ void __launch_bounds__(kProbeThreads)
gp_probe_lo32_kernel(const uint32_t* __restrict__ words, uint32_t mask,
                     const uint32_t* __restrict__ lo32, int64_t n, int h,
                     uint8_t* __restrict__ out) {
  const int64_t seg = ((int64_t)blockIdx.x * kProbeThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r0 = seg * kWarpRows + lane;
  unsigned live = 0;
#pragma unroll
  for (int q = 0; q < kRun; ++q)
    if (r0 + 32 * q < n) live |= 1u << q;
  unsigned found;
  if constexpr (kVec4) {
    uint4 v[kRun];
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      v[q] = make_uint4(0u, 0u, 0u, 0u);
      if ((live >> q) & 1u) v[q] = __ldcs((const uint4*)lo32 + (r0 + 32 * q));
    }
    found = gp_probe_rounds<kRun>(words, 4, live, [&](int q, int i) -> uint64_t {
      return (i == 0 ? v[q].x : i == 1 ? v[q].y : i == 2 ? v[q].z : v[q].w) & mask;
    });
  } else {
    found = gp_probe_rounds<kRun>(words, h, live, [&](int q, int i) -> uint64_t {
      return r0 + 32 * q < n ? __ldcs(lo32 + (r0 + 32 * q) * h + i) & mask : 0u;
    });
  }
  // ballot q: bit l = row 128 w + 32q + l; lane takes bits 4 (lane % 8) ..
  // + 3 of ballot lane / 8, rows 128 w + 4 lane .. + 3
  uint32_t mine = 0;
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    const uint32_t b = __ballot_sync(0xffffffffu, (found >> q) & 1u);
    if (lane / kPerBallot == q) mine = b;
  }
  const uint32_t bits = (mine >> (kRun * (lane % kPerBallot))) & ((1u << kRun) - 1u);
  const int64_t first = seg * kWarpRows + kRun * lane;
  if (first + kRun <= n) {
    *(uint32_t*)(out + first) = gp_spread4(bits);
  } else {
    for (int j = 0; first + j < n; ++j) out[first + j] = (bits >> j) & 1u;
  }
}

}  // namespace

// words: uint32[bits/32] (device); lo32: uint32[n, h] row-major (device);
// out: bool/uint8[n] (device, 4-byte aligned).  bits must be a power of two
// <= 2^32 (the wrapper checks).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int gp_probe_lo32(const void* words, uint64_t bits, const void* lo32,
                             int64_t n, int h, void* out, void* stream) {
  if (n <= 0) return 0;
  if (h < 1 || bits == 0 || (bits & (bits - 1)) || bits > (1ull << 32) ||
      ((uintptr_t)out & 3))
    return (int)cudaErrorInvalidValue;
  // the 16-byte loads need an aligned row 0; a view's data_ptr() may not be
  const bool vec4 = h == 4 && ((uintptr_t)lo32 & 15) == 0;
  const int64_t blocks = (n + kProbeThreads * kRun - 1) / (kProbeThreads * kRun);
  auto kernel = vec4 ? gp_probe_lo32_kernel<true> : gp_probe_lo32_kernel<false>;
  kernel<<<(unsigned)blocks, kProbeThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (uint32_t)(bits - 1), (const uint32_t*)lo32, n, h,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}
