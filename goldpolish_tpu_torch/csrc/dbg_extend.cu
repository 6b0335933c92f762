// Kernel 7: the sealer's 4-way extension probe (K8) — for every vertex of a
// lockstep round's frontier, which of its four one-base extensions are in
// the Bloom filter:
//
//   row r < n_succ (a successor row):    ext_b = v[1:] + "ACGT"[b]
//   row r >= n_succ (a predecessor row): ext_b = "ACGT"[b] + v[:-1]
//   bit b of out[r] = all h bits of ext_b's canonical ntHash (forward +
//                     reverse, then the extra hashes) set in the filter
//
// The vertices are k bytes each, any byte value (the sealer's string
// vertices may carry N, IUPAC codes or lowercase).  The plain torch version
// is goldpolish_tpu_torch/ops/dbg_extend.py:dbg_extend4_reference.
//
// Replaces: goldpolish_tpu/fill/konnector.py, DeviceDBG.prefetch (:265-299):
// the host writes every vertex's four [k]-byte extensions into a [rows, 4, k]
// array, pads it to a power-of-two bucket (one XLA compile per bucket) and
// calls bloom_jax.probe_kmers_jit (:45), which hashes every extension from
// scratch.  Here the extensions never exist in memory: a thread reads its
// vertex's k bytes once.  Unlike bloom_jax.probe_words, which casts
// `hash % bits` to uint32, the bit index is 64-bit.
//
// What bounds it on the H100: the bytes are small (R * k in, R out, at most
// 4 * R * h filter words), so at the sealer's frontiers (tens to a few
// thousand vertices per round) one launch is launch-bound, a few us.  At
// 2^16 vertices the 4 * R * h random 4-byte loads from a filter in L2 set
// the floor, as for kernels 2, 4, 5 and 6 (~124 G requests/s measured for
// kernel 2).  The cost of the lockstep design is outside the kernel: one
// upload, one launch and one copy back per BFS level.
//
// The design, simple first:
//  * one thread per vertex: the (k-1) bytes its four extensions share are
//    hashed once from kernel 2's XOR tables (nthash_roll.cuh), since the
//    direct window hash is an XOR over positions; each base then adds the
//    one table entry of its position (k - 1 for a successor, 0 for a
//    predecessor), so the four canonical hashes cost k table reads, not 4k;
//  * all four extensions' first four hashes are loaded together
//    (gp_probe4_load for each, 16 loads in flight), then tested
//    (gp_probe4_all); further hashes only for the extensions still present;
//  * the tables are staged in shared memory once per block; a grid-stride
//    loop over a few blocks per SM keeps that staging small beside the work.
#include <cuda_runtime.h>

#include <cstdint>

#include "nthash_roll.cuh"

namespace {

constexpr int kExtThreads = 128;
constexpr int kExtBlocksPerSm = 8;
constexpr int kExtMaxH = 16;  // as the device fill (bloom_sort.cu: kMaxH)

struct ExtendArgs {
  const uint32_t* words;
  uint64_t bits;
  int h, k;
  uint64_t kmul;
  const uint8_t* verts;  // [R, k]
  int64_t R, n_succ;
  uint8_t* out;  // [R]
};

template <bool kPow2>
__global__ void __launch_bounds__(kExtThreads)
gp_dbg_extend4_kernel(ExtendArgs a, const uint64_t* __restrict__ tf,
                      const uint64_t* __restrict__ tr, const uint8_t* __restrict__ fclass) {
  __shared__ GpWindowTables s_t;
  gp_load_window_tables(s_t, a.k, tf, tr, fclass);
  __syncthreads();

  const int k = a.k;
  const uint8_t acgt[4] = {'A', 'C', 'G', 'T'};
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < a.R;
       r += (int64_t)gridDim.x * blockDim.x) {
    const bool succ = r < a.n_succ;
    // window position j of an extension holds vertex byte j + shift; the
    // base sits at position bpos
    const int shift = succ ? 1 : -1, bpos = succ ? k - 1 : 0;
    const uint8_t* v = a.verts + r * k;
    uint64_t fh = 0, rh = 0;
    for (int j = succ ? 0 : 1; j < (succ ? k - 1 : k); ++j) {
      const uint8_t c = __ldg(v + j + shift);
      fh ^= s_t.tf[j * 5 + s_t.cls[c]];
      rh ^= s_t.tr[j * 8 + (c & 7)];
    }
    uint64_t base[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      base[b] = (fh ^ s_t.tf[bpos * 5 + s_t.cls[acgt[b]]]) +
                (rh ^ s_t.tr[bpos * 8 + (acgt[b] & 7)]);
    unsigned mask = 0xFu;
    for (int i0 = 0; i0 < a.h && mask; i0 += 4) {
      GpProbe4 p[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (mask >> b & 1u)
          p[b] = gp_probe4_load<kPow2>(a.words, a.bits, a.h, a.kmul, base[b], i0);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if ((mask >> b & 1u) && !gp_probe4_all(p[b])) mask &= ~(1u << b);
    }
    a.out[r] = (uint8_t)mask;
  }
}

}  // namespace

// words: uint32[ceil(bits/32)]; verts: uint8[R, k], successor rows first
// (n_succ of them), then predecessor rows; tf, tr, fclass: kernel 2's tables
// (ops/scan_conv.py:_xor_tables); kmul = k * MULTI_SEED (mod 2^64); out:
// uint8[R], bit b for base "ACGT"[b].  Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments out of range.
extern "C" int gp_dbg_extend4(const void* words, uint64_t bits, int h, int k, const void* verts,
                              int64_t R, int64_t n_succ, void* out, const void* tf,
                              const void* tr, const void* fclass, uint64_t kmul,
                              void* stream) {
  if (k < 1 || k > kGpMaxK || h < 1 || h > kExtMaxH || bits == 0 || R < 0 || n_succ < 0 ||
      n_succ > R)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = (R + kExtThreads - 1) / kExtThreads;
  if (blocks > (int64_t)sms * kExtBlocksPerSm) blocks = (int64_t)sms * kExtBlocksPerSm;
  const ExtendArgs a{(const uint32_t*)words, bits, h, k, kmul, (const uint8_t*)verts,
                     R, n_succ, (uint8_t*)out};
  auto kernel = (bits & (bits - 1)) == 0 ? gp_dbg_extend4_kernel<true>
                                         : gp_dbg_extend4_kernel<false>;
  kernel<<<(unsigned)blocks, kExtThreads, 0, (cudaStream_t)stream>>>(
      a, (const uint64_t*)tf, (const uint64_t*)tr, (const uint8_t*)fclass);
  return (int)cudaGetLastError();
}
