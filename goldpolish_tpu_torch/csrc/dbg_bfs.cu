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
// direction) is one warp with an exact visited set in shared memory: open
// addressing over T = 2 * (V + 4W) u64 slots, inserted with atomicCAS, so
// the first inserter of a k-mer wins and dedup within and across levels is
// exact.  At most V + 4W keys ever enter (the log is capped at V before a
// level's children are inserted), so the load stays at or below one half.
// The all-T 32-mer equals the empty-slot value and is tracked by a flag.
// The plain torch version is goldpolish_tpu_torch/ops/dbg_bfs.py:
// dbg_bfs_reference.
//
// What bounds it on the H100: latency.  Konnector searches are thin (1-2
// vertices wide over a hundred or more levels), and one level is a chain of
// dependent steps — read the frontier, roll, probe the filter (random
// 4-byte loads from L2, 4-16 MiB), insert into the visited set, publish the
// next frontier.  The floor is depth x one L2 latency; bandwidth does not
// enter (the byte bound of 256 searches is ~5 us).  The first form of this
// kernel paid up to h L2 latencies in turn (the probe stopped at the first
// clear bit) and three block barriers of 128 threads per level, with 120
// or more of the threads idle.  In this form a level takes ~0.7 us on the
// H100, and the wait for the filter words is the smaller part of it: the
// rest is the warp's own chain of dependent instructions (64-bit rotations
// and multiplies on 32-bit units, the shared-memory CAS).
//
// What the design does about it:
//  * one warp per (search, direction), kept for the whole search; a CTA is
//    just up to 3 such warps that share nothing, so the level loop has no
//    __syncthreads() at all: `__ballot_sync` gathers the masks and compacts
//    the new children (no shared counter), `__syncwarp()` publishes the
//    next frontier, and the frontier is double-buffered in the warp's own
//    slice of dynamic shared memory;
//  * a lane owns one (vertex, base) child, so a pass covers 8 frontier
//    vertices; a frontier wider than 8 (up to the cap W) is walked in
//    passes of 8 by the same warp.  That keeps the result exact up to W in
//    one launch with one code path, instead of a second block-wide kernel
//    for flagged searches: a wide level costs ceil(nf / 8) passes, each one
//    L2 latency, and wide levels are rare on Konnector's graphs;
//  * the h probe loads of a child are in flight at once (gp_probe4_load),
//    so a level waits for one L2 latency, not up to h; the kernel is
//    instantiated for power-of-two filters apart, so that path is
//    straight-line code (no load is scheduled across the branches of the
//    64-bit modulo);
//  * whatever does not need the probe's answer runs while the loads are in
//    flight: the child's k-mer, its slot in the visited set, and its half
//    of the next level's roll.  A frontier vertex is kept as (k-mer, A, B)
//    with A and B its ntHash state already rotated and XORed with the
//    terms of its own first or last base, so a child's hash is one XOR per
//    strand with a constant of its lane (rotation distributes over XOR):
//      successors    A = srol(fh) ^ FK[first base], B = sror(rh ^ R[first base])
//                    child b: fh' = A ^ F[b],        rh' = B ^ sror(RK[b])
//      predecessors  A = sror(fh ^ F[last base]),   B = srol(rh) ^ RK[last base]
//                    child b: fh' = A ^ sror(FK[b]), rh' = B ^ R[b]
//  * the visited set is sized to the search: at most min(V + 4W, 1 + 4W *
//    max_d) keys can enter, so a shallow search clears (16-byte stores, by
//    its own warp) and hashes into a few slots, a deep one into T = 2 *
//    (V + 4W); clearing all 34 KB at W = 32 is 68 stores per lane, well
//    under one level's latency x the >= 100 levels of a search that needs
//    them.  The load stays at or below one half and the first inserter of
//    a k-mer still wins (atomicCAS).
#include <cuda_runtime.h>

#include <cstdint>

#include "nthash_roll.cuh"

namespace {

// (search, direction) pairs per CTA, at most: 3 fills an SM's shared memory
// at both of DeviceBFS's tiers (2 CTAs of 3 at W = 32, 1 CTA of 3 at W = 256)
constexpr int kMaxWarps = 3;
constexpr int kGroup = 8;     // frontier vertices per pass: 32 children, one per lane
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;

// The slot of the visited set (T slots) where the probing for `key` starts.
__device__ __forceinline__ uint32_t visit_slot(uint64_t key, uint32_t T) {
  uint64_t x = key;
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33;
  return (uint32_t)(((x >> 32) * T) >> 32);
}

// Insert `key` into the visited set from slot p = visit_slot(key, T) on;
// true when this thread inserted it.  The all-T 32-mer equals the
// empty-slot value: a flag.
__device__ __forceinline__ bool visit(unsigned long long* table, uint32_t T,
                                      int* all_ones, uint64_t key, uint32_t p) {
  if (key == kEmpty) return atomicExch(all_ones, 1) == 0;
  while (true) {
    const unsigned long long old = atomicCAS(table + p, kEmpty, key);
    if (old == kEmpty) return true;
    if (old == key) return false;
    p = p + 1 == T ? 0 : p + 1;
  }
}

// A vertex's half of its children's roll (see the header): (fh, rh) of
// k-mer u -> (A, B).  tab = F[4] R[4] FK[4] RK[4].
__device__ __forceinline__ void half_roll(const uint64_t* tab, int dirn, int top, uint64_t u,
                                          uint64_t fh, uint64_t rh, uint64_t& A,
                                          uint64_t& B) {
  if (dirn == 0) {
    const int out = (int)((u >> top) & 3);
    A = gp_srol_n(fh, 1) ^ tab[8 + out];
    B = gp_sror1(rh ^ tab[4 + out]);
  } else {
    const int in = (int)(u & 3);
    A = gp_sror1(fh ^ tab[in]);
    B = gp_srol_n(rh, 1) ^ tab[12 + in];
  }
}

template <bool kPow2>
__global__ void __launch_bounds__(32 * kMaxWarps)
gp_dbg_bfs_kernel(const uint32_t* __restrict__ words, uint64_t bits,
                  int h, int k, uint64_t kmul,
                  const uint64_t* __restrict__ roll_tab,
                  const uint64_t* __restrict__ seed_k,
                  const uint64_t* __restrict__ seed_fh,
                  const uint64_t* __restrict__ seed_rh,
                  const int32_t* __restrict__ max_d, int n_pairs, int W, int V,
                  uint32_t T, uint64_t* __restrict__ vis_k,
                  uint8_t* __restrict__ vis_m, int32_t* __restrict__ n_vis_out,
                  uint8_t* __restrict__ over_out) {
  extern __shared__ __align__(16) unsigned long long smem[];
  __shared__ uint64_t s_roll[kMaxWarps][16];  // F[4] R[4] FK[4] RK[4], per warp
  __shared__ int s_all_ones[kMaxWarps];

  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int pair = blockIdx.x * (blockDim.x >> 5) + warp;  // g * 2 + d
  if (pair >= n_pairs) return;  // the whole warp leaves together
  const int dirn = pair & 1;
  const int md = max_d[pair];
  if (md < 0) {  // inactive: nothing to clear, log or search
    if (ln == 0) {
      n_vis_out[pair] = 0;
      over_out[pair] = 0;
    }
    return;
  }
  // this warp's slice: the visited table, then two frontiers of (k-mer, A, B)
  unsigned long long* table = smem + (size_t)warp * (T + 6 * (size_t)W);
  uint64_t* cur = (uint64_t*)(table + T);  // [3W]: k-mer, A, B
  uint64_t* nxt = cur + 3 * W;             // [3W]
  int* all_ones = &s_all_ones[warp];
  uint64_t* tab = s_roll[warp];
  const int top = 2 * (k - 1);

  // no more than 1 + 4W * md keys can enter (4 children of at most W
  // vertices at each of md growing levels), nor more than V + 4W
  uint32_t Tn = T;
  if (2 * (1 + 4 * (int64_t)W * md) < (int64_t)T)
    Tn = (uint32_t)(2 * (1 + 4 * (int64_t)W * md));
  const uint4 empty4 = make_uint4(~0u, ~0u, ~0u, ~0u);
  for (uint32_t i = ln; i < Tn / 2; i += 32) ((uint4*)table)[i] = empty4;
  if (ln < 16) tab[ln] = roll_tab[ln];
  __syncwarp();
  if (ln == 0) {
    *all_ones = 0;
    const uint64_t u = seed_k[pair];
    cur[0] = u;
    half_roll(tab, dirn, top, u, seed_fh[pair], seed_rh[pair], cur[W], cur[2 * W]);
    visit(table, Tn, all_ones, u, visit_slot(u, Tn));
  }
  __syncwarp();

  const uint64_t kmask = k < 32 ? (1ull << (2 * k)) - 1 : ~0ull;
  const uint64_t b = (uint64_t)(ln & 3);  // this lane's base
  // this lane's constants of a child's hash: fh' = A ^ X, rh' = B ^ Y
  const uint64_t X = dirn == 0 ? tab[b] : gp_sror1(tab[8 + b]);
  const uint64_t Y = dirn == 0 ? gp_sror1(tab[12 + b]) : tab[4 + b];
  uint64_t* log_k = vis_k + (int64_t)pair * V;
  uint8_t* log_m = vis_m + (int64_t)pair * V;
  int n_vis = 0, nf = 1;
  bool over = false;

  for (int level = 0; level <= md && nf > 0; ++level) {
    const bool grow = level < md && n_vis + nf <= V;
    int n_new = 0;
    for (int v0 = 0; v0 < nf; v0 += kGroup) {
      const int i = v0 + (ln >> 2);
      const bool live = i < nf;
      uint64_t u = 0, ck = 0, cA = 0, cB = 0;
      uint32_t slot = 0;
      bool pres = false;
      if (live) {
        u = cur[i];
        const uint64_t cfh = cur[W + i] ^ X, crh = cur[2 * W + i] ^ Y;
        const GpProbe4 probe = gp_probe4_load<kPow2>(words, bits, h, kmul, cfh + crh, 0);
        // while the loads are in flight: the child's k-mer, its slot in
        // the visited set and its half of the next level's roll
        ck = dirn == 0 ? (((u << 2) & kmask) | b) : ((u >> 2) | (b << top));
        slot = visit_slot(ck, Tn);
        half_roll(tab, dirn, top, ck, cfh, crh, cA, cB);
        pres = gp_probe4_all(probe);
        for (int i0 = 4; i0 < h && pres; i0 += 4)
          pres = gp_probe4_all(gp_probe4_load<kPow2>(words, bits, h, kmul, cfh + crh, i0));
      }
      // the 4 children of vertex i are lanes 4(i - v0) .. + 3
      const unsigned ballot = __ballot_sync(kFull, pres);
      if (live && b == 0 && n_vis + i < V) {
        log_k[n_vis + i] = u;
        log_m[n_vis + i] = (uint8_t)((ballot >> (ln & 28)) & 0xFu);
      }
      const bool fresh = pres && grow && visit(table, Tn, all_ones, ck, slot);
      const unsigned fm = __ballot_sync(kFull, fresh);
      if (fresh) {
        const int at = n_new + __popc(fm & ((1u << ln) - 1u));
        if (at < W) {
          nxt[at] = ck;
          nxt[W + at] = cA;
          nxt[2 * W + at] = cB;
        }
      }
      n_new += __popc(fm);
    }
    n_vis += nf;
    if (n_vis > V || n_new > W) {
      over = true;
      break;
    }
    uint64_t* t = cur;
    cur = nxt;
    nxt = t;
    nf = n_new;
    __syncwarp();  // the next frontier is written; this one is read
  }
  if (ln == 0) {
    n_vis_out[pair] = n_vis;
    over_out[pair] = over ? 1 : 0;
  }
}

}  // namespace

// Dynamic shared memory one (search, direction) warp needs for frontier cap
// W and log cap V (the visited table and the two frontiers); a CTA holds up
// to kMaxWarps such warps.
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
  const int64_t per_pair = gp_dbg_bfs_smem_bytes(W, V);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (per_pair + 1024 > optin) return (int)cudaErrorInvalidValue;
  // as many warps per CTA as the shared memory holds (no warp waits for
  // another, so the CTA's size changes nothing but the packing)
  int warps = (int)((optin - 1024) / per_pair);
  warps = warps < kMaxWarps ? warps : kMaxWarps;
  const int64_t smem = warps * per_pair;
  auto kernel = (bits & (bits - 1)) == 0 ? gp_dbg_bfs_kernel<true> : gp_dbg_bfs_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const uint32_t T = (uint32_t)(2 * ((int64_t)V + 4 * (int64_t)W));
  const int n_pairs = (int)(2 * G);
  kernel<<<(unsigned)((n_pairs + warps - 1) / warps), 32 * warps, (size_t)smem,
           (cudaStream_t)stream>>>(
      (const uint32_t*)words, bits, h, k, kmul, (const uint64_t*)roll_tab,
      (const uint64_t*)seed_k, (const uint64_t*)seed_fh, (const uint64_t*)seed_rh,
      (const int32_t*)max_d, n_pairs, W, V, T, (uint64_t*)vis_k, (uint8_t*)vis_m,
      (int32_t*)n_vis, (uint8_t*)over);
  return (int)cudaGetLastError();
}
