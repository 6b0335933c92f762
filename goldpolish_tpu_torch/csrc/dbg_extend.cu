// Kernel 7: the sealer's extension probe (K8), walking unbranched chains —
// for every vertex of a lockstep round's frontier, which of its four
// one-base extensions are in the Bloom filter, and then the same for each
// further vertex of the unbranched chain that starts there:
//
//   row r < n_succ (a successor row):    ext_b(v) = v[1:] + "ACGT"[b]
//   row r >= n_succ (a predecessor row): ext_b(v) = "ACGT"[b] + v[:-1]
//   bit b of mask_j = all h bits of ext_b(v_j)'s canonical ntHash (forward
//                     + reverse, then the extra hashes) set in the filter
//   v_0 = the row's vertex; while mask_j has exactly one bit b set and
//   j + 1 < D: v_{j+1} = ext_b(v_j)
//
// out[r * ld + j] = mask_j for j < len_r (the chain's length, 1..D), 0 for
// len_r <= j < D, and out[r * ld + D] = len_r when ld > D.  D = 1, ld = 1 is
// the one-level probe of a BFS round (dbg_extend4).  The vertices are k bytes
// each, any byte value (the sealer's string vertices may carry N, IUPAC
// codes or lowercase); the walk appends only A, C, G, T.  The plain torch
// version is goldpolish_tpu_torch/ops/dbg_extend.py:dbg_extend_chain_reference
// (dbg_extend4_reference for D = 1).
//
// Replaces: goldpolish_tpu/fill/konnector.py, DeviceDBG.prefetch (:265-299):
// the host writes every vertex's four [k]-byte extensions into a [rows, 4, k]
// array, pads it to a power-of-two bucket (one XLA compile per bucket) and
// calls bloom_jax.probe_kmers_jit (:45), which hashes every extension from
// scratch, once per BFS level.  Here the extensions never exist in memory,
// and one launch answers up to D levels of every unbranched search.  Unlike
// bloom_jax.probe_words, which casts `hash % bits` to uint32, the bit index
// is 64-bit.
//
// What bounds it on the H100: the sealer's searches are unbranched paths,
// 1-2 vertices a direction a level, so a one-level launch answered a few
// rows for ~4 us of device time and ~0.24 ms of host round trip (upload,
// launch, copy back, the Python search), once per BFS level.  A chain
// launch answers D levels for one round trip; its floor is no longer bytes
// (R * k in, R * (D + 1) out) but D dependent L2 round trips, the probes of
// step j + 1 waiting for the mask of step j: ~0.7 us a level, as kernel 3
// measured.  At 2^16 rows the 16 random 4-byte loads of each step bound it,
// as for kernels 2, 4, 5 and 6.
//
// The design:
//  * one thread per row: the (k-1) bytes the four extensions share are
//    hashed once from kernel 2's XOR tables (nthash_roll.cuh), since the
//    direct window hash is an XOR over positions; each base then adds the
//    one table entry of its position (k - 1 for a successor, 0 for a
//    predecessor), so the four canonical hashes cost k table reads, not 4k;
//  * all four extensions' first four hashes are loaded together
//    (gp_probe4_load for each, 16 loads in flight), then tested
//    (gp_probe4_all); further hashes only for the extensions still present;
//  * a step moves the shared hash to the chosen extension in O(1)
//    (gp_chain_step): two table reads and a split rotation, whatever k;
//    the byte that leaves is the vertex's own (read again, L1) or a base
//    the walk appended, kept as 2 bits in a 128-bit register history;
//  * the tables are staged in shared memory once per block; a grid-stride
//    loop over a few blocks per SM keeps that staging small beside the work.
//    They take dynamic shared memory sized from k at launch (at k <= 64 the
//    bytes of static arrays of that capacity); past ~470, where they would pass
//    48 KB, the kernel reads them through the read-only cache instead
//    (kSmem false), so any k runs.
#include <cuda_runtime.h>

#include <cstdint>

#include "nthash_roll.cuh"

namespace {

constexpr int kExtThreads = 128;
constexpr int kExtBlocksPerSm = 8;
constexpr int kExtMaxH = 16;  // as the device fill (bloom_sort.cu: kMaxH)
constexpr int kExtMaxD = 64;  // the walk's 2-bit history holds 64 bases

struct ExtendArgs {
  const uint32_t* words;
  uint64_t bits;
  int h, k;
  uint64_t kmul;
  const uint8_t* verts;  // [R, k]
  int64_t R, n_succ;
  int D;         // levels a row may walk (1 = the one-level probe)
  int64_t ld;    // bytes of a row of out: D, or D + 1 with the length
  uint8_t* out;  // [R, ld]
};

template <bool kPow2, class T>
__device__ __forceinline__ void extend_rows(const ExtendArgs& a, const T& s_t) {
  const int k = a.k;
  const uint8_t acgt[4] = {'A', 'C', 'G', 'T'};
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < a.R;
       r += (int64_t)gridDim.x * blockDim.x) {
    const bool succ = r < a.n_succ;
    // window position j of an extension holds vertex byte j + shift; the
    // base sits at position bpos
    const int shift = succ ? 1 : -1, bpos = succ ? k - 1 : 0;
    const uint8_t* v = a.verts + r * k;
    uint8_t* out = a.out + r * a.ld;
    uint64_t fh = 0, rh = 0;
    for (int j = succ ? 0 : 1; j < (succ ? k - 1 : k); ++j) {
      const uint8_t c = __ldg(v + j + shift);
      fh ^= s_t.f(j, c);
      rh ^= s_t.r(j, c);
    }
    uint64_t hist0 = 0, hist1 = 0;  // base (0-3) chosen at step s: 2 bits at s
    int step = 0;
    for (;; ++step) {
      uint64_t base[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        base[b] = (fh ^ s_t.f(bpos, acgt[b])) + (rh ^ s_t.r(bpos, acgt[b]));
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
      out[step] = (uint8_t)mask;
      if (step + 1 == a.D || __popc(mask) != 1) break;
      const int b = __ffs(mask) - 1;
      if (step < 32) hist0 |= (uint64_t)b << (2 * step);
      else hist1 |= (uint64_t)b << (2 * (step - 32));
      // byte i of the walk, i = step + 1, is the byte the chosen extension
      // drops on the far side at the next step: vertex byte i (a successor
      // walk) or k-1-i (a predecessor walk) while i < k, else the base
      // appended at step i - k
      const int i = step + 1, s = i - k;
      const uint8_t drop =
          i < k ? __ldg(v + (succ ? i : k - 1 - i))
                : acgt[((s < 32 ? hist0 : hist1) >> (2 * (s & 31))) & 3];
      gp_chain_step(s_t, k, succ, fh, rh, acgt[b], drop);
    }
    for (int j = step + 1; j < a.D; ++j) out[j] = 0;
    if (a.ld > a.D) out[a.D] = (uint8_t)(step + 1);
  }
}

// kSmem: the direct tables staged in dynamic shared memory
// (gp_table_bytes(k)); else read from device memory.
template <bool kPow2, bool kSmem>
__global__ void __launch_bounds__(kExtThreads)
gp_dbg_extend_kernel(ExtendArgs a, const uint64_t* __restrict__ tf,
                     const uint64_t* __restrict__ tr, const uint8_t* __restrict__ fclass) {
  if constexpr (kSmem) {
    extern __shared__ __align__(16) uint8_t s_dyn[];
    const GpTableRef t = gp_table_ref(s_dyn, a.k);
    gp_load_window_tables(t, a.k, tf, tr, fclass);
    __syncthreads();
    extend_rows<kPow2>(a, t);
  } else {
    extend_rows<kPow2>(a, GpGlobalTables{tf, tr, fclass});
  }
}

}  // namespace

// words: uint32[ceil(bits/32)]; verts: uint8[R, k], successor rows first
// (n_succ of them), then predecessor rows; D: levels a row may walk, 1..64;
// out: uint8[R, ld], ld = D (masks only) or D + 1 (masks, then the chain's
// length); bit b of a mask for base "ACGT"[b]; tf, tr, fclass: kernel 2's
// tables (ops/scan_conv.py:_xor_tables); kmul = k * MULTI_SEED (mod 2^64).
// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments out of range.
extern "C" int gp_dbg_extend(const void* words, uint64_t bits, int h, int k, const void* verts,
                             int64_t R, int64_t n_succ, int D, int64_t ld, void* out,
                             const void* tf, const void* tr, const void* fclass, uint64_t kmul,
                             void* stream) {
  if (k < 1 || h < 1 || h > kExtMaxH || bits == 0 || R < 0 || n_succ < 0 ||
      n_succ > R || D < 1 || D > kExtMaxD || (ld != D && ld != D + 1))
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
                     R, n_succ, D, ld, (uint8_t*)out};
  const bool pow2 = (bits & (bits - 1)) == 0;
  const int64_t smem = gp_table_bytes(k);
  const bool in_smem = smem <= kGpSmemBytes;
  auto kernel = in_smem ? (pow2 ? gp_dbg_extend_kernel<true, true> : gp_dbg_extend_kernel<false, true>)
                        : (pow2 ? gp_dbg_extend_kernel<true, false> : gp_dbg_extend_kernel<false, false>);
  kernel<<<(unsigned)blocks, kExtThreads, in_smem ? (size_t)smem : 0, (cudaStream_t)stream>>>(
      a, (const uint64_t*)tf, (const uint64_t*)tr, (const uint8_t*)fclass);
  return (int)cudaGetLastError();
}
