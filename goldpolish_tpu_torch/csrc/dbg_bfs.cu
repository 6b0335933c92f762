// Kernel 3: the sealer's whole-search de Bruijn BFS.
//
// For every (search g, direction d) — d = 0 expands successors of the start
// k-mer, d = 1 predecessors of the goal k-mer — a level-synchronous BFS to
// depth max_d[g][d] over the Bloom-filter de Bruijn graph:
//
//   level 0 frontier = {seed}; at each level <= max_d, every frontier vertex
//   is logged with its 4-bit extension mask (bit b set when the child with
//   base b passes the h-hash Bloom test of its canonical hash fh + rh); below
//   the cap, children not seen before form the next frontier.
//
// k-mers are 2-bit packed (first base in the high bits, A=0 C=1 G=2 T=3,
// k <= 32) and their (fh, rh) ntHash state rolls from parent to child in
// O(1): forward `fh' = srol(fh) ^ F[b] ^ FK[out]`, `rh' = sror(rh ^ RK[b] ^
// R[out])`, and the mirror image for predecessors, with F/R the forward and
// reverse-complement seeds of A, C, G, T and FK/RK those seeds rotated k
// times (the table comes from goldpolish_tpu_torch/ops/dbg_bfs.py).  A
// search overflows when one level yields more than W new children or more
// than V vertices are logged; the host then searches it natively.
//
// Replaces: goldpolish_tpu/ops/dbg_bfs.py:86-290 (_build_kernel -> run /
// expand, K6), an XLA while_loop over levels that dedups children by a
// per-level argsort and a 3-bit shadow byte set (:134-173, :210-230) because
// XLA has no hash table.  The shadow set's false positives drop vertices
// from the log (the host then re-runs the gap).  Here each (search,
// direction) is one CTA with an exact visited set in shared memory: open
// addressing over T = 2 * (V + 4W) u64 slots, inserted with atomicCAS, so
// the first inserter of a k-mer wins and dedup within and across levels is
// exact.  At most V + 4W keys ever enter (the log is capped at V before a
// level's children are inserted), so the load stays at or below one half.
// The all-T 32-mer equals the empty-slot value and is tracked by a flag.
// The plain torch version is goldpolish_tpu_torch/ops/dbg_bfs.py:
// dbg_bfs_reference.
//
// What bounds it on the H100: each level is a chain of dependent steps —
// roll, h random 4-byte Bloom loads from a filter that lives in L2 (4-16
// MiB), a shared-memory insert, then a block barrier before the next level
// can start.  Konnector searches are thin (1-2 vertices wide over hundreds
// of levels), so most of a CTA's threads idle and the time is L2 latency
// times depth, not bandwidth or arithmetic.
//
// What the design does about it: the whole search runs in one launch (no
// host round trip per level, the cost that made the lockstep device DBG
// slow), every search and direction of the batch runs in parallel as its
// own CTA (2G CTAs of 128 threads), a thread owns one (vertex, base) child
// so the 4 children of a vertex are 4 neighbouring lanes whose presence
// bits one warp ballot gathers into the mask, and the probe stops at the
// first clear bit.  Packing several thin searches into one CTA, and
// warp-synchronous levels without block barriers, are left for later.
#include <cuda_runtime.h>

#include <cstdint>

#include "bloom_probe.cuh"

namespace {

constexpr int kBfsThreads = 128;  // a multiple of 32: a child's 4 lanes share a warp
constexpr unsigned long long kEmpty = ~0ull;
constexpr uint64_t kMask31 = (1ull << 31) - 1;
constexpr uint64_t kMask33 = (1ull << 33) - 1;

// ntHash's split rotation (31-bit high field, 33-bit low field) by one.
__device__ __forceinline__ uint64_t srol1(uint64_t x) {
  const uint64_t hi = x >> 33, lo = x & kMask33;
  return ((((hi << 1) | (hi >> 30)) & kMask31) << 33) |
         (((lo << 1) | (lo >> 32)) & kMask33);
}

__device__ __forceinline__ uint64_t sror1(uint64_t x) {
  const uint64_t hi = x >> 33, lo = x & kMask33;
  return ((((hi >> 1) | (hi << 30)) & kMask31) << 33) |
         (((lo >> 1) | (lo << 32)) & kMask33);
}

// The h-hash Bloom test of a canonical hash: hash 0 is `base`, hash i the
// ntHash extra hash t ^ (t >> 27), t = base * (i ^ k * MULTI_SEED).
__device__ __forceinline__ bool bloom_has(const uint32_t* __restrict__ words,
                                          uint64_t bits, bool pow2, int h,
                                          uint64_t kmul, uint64_t base) {
  for (int i = 0; i < h; ++i) {
    uint64_t hv = base;
    if (i) {
      const uint64_t t = base * ((uint64_t)i ^ kmul);
      hv = t ^ (t >> 27);
    }
    if (!gp_bloom_test(words, pow2 ? (hv & (bits - 1)) : (hv % bits))) return false;
  }
  return true;
}

// Insert `key` into the visited set; true when this thread inserted it.
__device__ __forceinline__ bool visit(unsigned long long* table, uint32_t T,
                                      int* all_ones, uint64_t key) {
  if (key == kEmpty) return atomicExch(all_ones, 1) == 0;
  uint64_t x = key;
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33;
  uint32_t p = (uint32_t)((x >> 32) % T);
  while (true) {
    const unsigned long long old = atomicCAS(table + p, kEmpty, key);
    if (old == kEmpty) return true;
    if (old == key) return false;
    p = p + 1 == T ? 0 : p + 1;
  }
}

__global__ void __launch_bounds__(kBfsThreads)
gp_dbg_bfs_kernel(const uint32_t* __restrict__ words, uint64_t bits, int pow2,
                  int h, int k, uint64_t kmul,
                  const uint64_t* __restrict__ roll_tab,
                  const uint64_t* __restrict__ seed_k,
                  const uint64_t* __restrict__ seed_fh,
                  const uint64_t* __restrict__ seed_rh,
                  const int32_t* __restrict__ max_d, int W, int V, uint32_t T,
                  uint64_t* __restrict__ vis_k, uint8_t* __restrict__ vis_m,
                  int32_t* __restrict__ n_vis_out, uint8_t* __restrict__ over_out) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* table = smem;               // [T]
  uint64_t* cur = (uint64_t*)(smem + T);          // [3W]: k-mer, fh, rh
  uint64_t* nxt = cur + 3 * W;                    // [3W]
  __shared__ uint64_t s_roll[16];                 // F[4] R[4] FK[4] RK[4]
  __shared__ int s_nf, s_new, s_all_ones;

  const int lane = blockIdx.x;  // g * 2 + d
  const int dirn = lane & 1;
  const int md = max_d[lane];
  const int tid = threadIdx.x;
  for (uint32_t i = tid; i < T; i += blockDim.x) table[i] = kEmpty;
  if (tid < 16) s_roll[tid] = roll_tab[tid];
  if (tid == 0) {
    s_nf = md >= 0 ? 1 : 0;
    s_new = 0;
    s_all_ones = 0;
    cur[0] = seed_k[lane];
    cur[W] = seed_fh[lane];
    cur[2 * W] = seed_rh[lane];
  }
  __syncthreads();
  if (tid == 0) visit(table, T, &s_all_ones, seed_k[lane]);
  __syncthreads();

  const uint64_t* F = s_roll;
  const uint64_t* R = s_roll + 4;
  const uint64_t* FK = s_roll + 8;
  const uint64_t* RK = s_roll + 12;
  const uint64_t kmask = k < 32 ? (1ull << (2 * k)) - 1 : ~0ull;
  const int top = 2 * (k - 1);
  const bool is_pow2 = pow2 != 0;
  uint64_t* log_k = vis_k + (int64_t)lane * V;
  uint8_t* log_m = vis_m + (int64_t)lane * V;
  int n_vis = 0;
  bool over = false;

  for (int level = 0; level <= md; ++level) {
    const int nf = s_nf;
    if (nf == 0) break;
    const bool grow = level < md && n_vis + nf <= V;
    for (int base = 0; base < 4 * nf; base += blockDim.x) {
      const int c = base + tid;
      const bool live = c < 4 * nf;
      const int i = c >> 2;
      const uint64_t b = (uint64_t)(c & 3);
      uint64_t ck = 0, cfh = 0, crh = 0;
      bool pres = false;
      if (live) {
        const uint64_t u = cur[i], fh = cur[W + i], rh = cur[2 * W + i];
        if (dirn == 0) {
          const int out = (int)((u >> top) & 3);
          ck = ((u << 2) & kmask) | b;
          cfh = srol1(fh) ^ F[b] ^ FK[out];
          crh = sror1(rh ^ RK[b] ^ R[out]);
        } else {
          const int in = (int)(u & 3);
          ck = (u >> 2) | (b << top);
          cfh = sror1(fh ^ F[in] ^ FK[b]);
          crh = srol1(rh) ^ RK[in] ^ R[b];
        }
        pres = bloom_has(words, bits, is_pow2, h, kmul, cfh + crh);
      }
      // the 4 children of vertex i are lanes 4i..4i+3 of one warp
      const unsigned ballot = __ballot_sync(0xffffffffu, pres);
      if (live && b == 0 && n_vis + i < V) {
        log_k[n_vis + i] = cur[i];
        log_m[n_vis + i] = (uint8_t)((ballot >> (tid & 28)) & 0xFu);
      }
      if (pres && grow && visit(table, T, &s_all_ones, ck)) {
        const int slot = atomicAdd(&s_new, 1);
        if (slot < W) {
          nxt[slot] = ck;
          nxt[W + slot] = cfh;
          nxt[2 * W + slot] = crh;
        }
      }
    }
    __syncthreads();  // every child of this level is inserted and counted
    const int n_new = s_new;
    n_vis += nf;
    if (n_vis > V || n_new > W) {
      over = true;
      break;
    }
    if (level == md) break;
    uint64_t* t = cur;
    cur = nxt;
    nxt = t;
    __syncthreads();  // every thread has read s_new and s_nf
    if (tid == 0) {
      s_nf = n_new;
      s_new = 0;
    }
    __syncthreads();
  }
  if (tid == 0) {
    n_vis_out[lane] = n_vis;
    over_out[lane] = over ? 1 : 0;
  }
}

}  // namespace

// Dynamic shared memory of one CTA for frontier cap W and log cap V.
extern "C" int64_t gp_dbg_bfs_smem_bytes(int W, int V) {
  const int64_t T = 2 * ((int64_t)V + 4 * (int64_t)W);
  return 8 * (T + 6 * (int64_t)W);
}

// words: uint32[ceil(bits/32)]; roll_tab: uint64[16] (F, R, FK, RK of A, C,
// G, T); seed_k / seed_fh / seed_rh: uint64[G, 2] (start, goal); max_d:
// int32[G, 2] (-1 = inactive); kmul = k * MULTI_SEED (mod 2^64).  Outputs:
// vis_k uint64[G, 2, V], vis_m uint8[G, 2, V] (entries past n_vis are left
// unwritten), n_vis int32[G, 2], over uint8[G, 2].  All device pointers.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int gp_dbg_bfs(const void* words, uint64_t bits, int h, int k,
                          uint64_t kmul, const void* roll_tab, const void* seed_k,
                          const void* seed_fh, const void* seed_rh,
                          const void* max_d, int64_t G, int W, int V, void* vis_k,
                          void* vis_m, void* n_vis, void* over, void* stream) {
  if (G <= 0) return 0;
  if (k < 1 || k > 32 || h < 1 || bits == 0 || W < 1 || V < 1 || 2 * G > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = gp_dbg_bfs_smem_bytes(W, V);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem + 1024 > optin) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gp_dbg_bfs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const uint32_t T = (uint32_t)(2 * ((int64_t)V + 4 * (int64_t)W));
  gp_dbg_bfs_kernel<<<(unsigned)(2 * G), kBfsThreads, (size_t)smem,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)words, bits, (bits & (bits - 1)) == 0, h, k, kmul,
      (const uint64_t*)roll_tab, (const uint64_t*)seed_k, (const uint64_t*)seed_fh,
      (const uint64_t*)seed_rh, (const int32_t*)max_d, W, V, T, (uint64_t*)vis_k,
      (uint8_t*)vis_m, (int32_t*)n_vis, (uint8_t*)over);
  return (int)cudaGetLastError();
}
