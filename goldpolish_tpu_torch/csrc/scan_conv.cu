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
//  * any k: the direct tables (104k + 256 bytes) and the tile (2,048 + k
//    + 31 bytes) take dynamic shared memory sized from k at launch (at k
//    <= 64 the same bytes as static arrays of that capacity).  Past
//    ~360, where that and the roll tables would pass 48 KB, the kernel's
//    second form reads the direct tables through the read-only cache and
//    the bytes straight from the row (gp_scan_kernel<kPow2, false>): each
//    thread's first window still costs 2k table loads, now from L1, and
//    nothing else changes.  The roll holds at every k: srol^k is taken
//    mod 31 and mod 33, not bounded by 64;
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
//
// Kernel 8, gp_scan_present_packed2: the same scan over the 2-bit packed
// transfer.  Base i of a row sits in bits 2 * (i & 3) of byte i >> 2 (A =
// 0, C = 1, G = 2, T = 3, lowercase packed as uppercase), and a list of E
// exceptions per row carries the raw byte of every other position (an
// entry whose index is not below L is padding).  Replaces:
// goldpolish_tpu/ops/scan_conv.py scan_present_packed2_mxu (:247, whose
// probe is the Pallas kernel P3), its XLA twin scan_present_packed2_gather
// (:206) and _classes_from_packed (:104).  The TPU decodes to one-hot
// classes; here the tile of bytes that kernel 2 stages is filled from the
// packed words instead of the raw row: one 4-byte load carries 16 bases,
// decoded to 'A', 'C', 'G', 'T', then each block walks its row's E
// entries (in any order) and writes the raw byte of those inside its tile.
// Everything after the tile is kernel 2's code, so the two give the same
// bits on every byte value ('a' hashes as 'A': the forward class comes
// from the seed table, the reverse from c & 7).  The JAX route classes an
// exception as "no forward seed" (scan_conv.py:130), which bytes 1, 3, 4
// and 7 are not; the raw byte avoids that.  What bounds it is kernel 2's
// bound, the random L2 requests of the probes: the decode and the E
// entries per block add ~1% to them.  Where kernel 2 takes its second form
// (k past ~360), kernel 8 decodes the rows into device scratch [B, L]
// (gp_scan_packed2_scratch_bytes), writes the exceptions there and runs
// that second form on it.  A form of kernel 8 that held filters of at most
// 2 MiB in the shared memory of a thread-block cluster (read over
// distributed shared memory, the tile fill and hashing unchanged) was
// built and measured 2.0-3.3x slower than this one at 512 KiB - 2 MiB on
// an NVIDIA H100 80GB HBM3 at 700.00 W, and was removed (PERF.md §6):
// kernels 2 and 8 share this code path at every filter size.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "nthash_roll.cuh"

namespace {

constexpr int kScanThreads = 256;
constexpr int kRun = 8;  // windows per thread: one output byte
constexpr int kScanTile = kScanThreads * kRun;  // windows per block
constexpr int kChunk = 16;                      // bytes per staging load

// The dynamic shared memory of gp_scan_kernel<kPow2, true> at k: the
// direct tables, then the tile's bytes from offset a on (every chunk is
// loaded whole).
int64_t scan_smem_bytes(int k) {
  return gp_table_bytes(k) + kScanTile + k + 2 * kChunk;
}

// Window hashes from the direct tables `t` and the run's bytes byte(j).
template <bool kPow2, class T, class Byte>
__device__ __forceinline__ void scan_run(const uint32_t* __restrict__ words, uint64_t bits,
                                         int h, int k, int64_t w, int64_t nw,
                                         int64_t nbytes, int64_t row, uint64_t kmul,
                                         const T& t, const GpRollTables& s_r, Byte byte,
                                         uint8_t* __restrict__ out) {
  uint64_t base[kRun], fh, rh;
  gp_window_hash(t, k, byte, fh, rh);
  base[0] = fh + rh;
#pragma unroll
  for (int q = 1; q < kRun; ++q) {
    gp_roll(s_r, fh, rh, byte(q - 1), byte(q - 1 + k));
    base[q] = fh + rh;
  }
  // window r of the run is bit r of its output byte; a window past the
  // row's last starts out absent (its bit stays 0 and it is never probed)
  const int64_t m = nw - w;  // windows of the run inside the row (>= 1)
  const unsigned live = m >= kRun ? 0xffu : (1u << m) - 1u;
  // the h rounds of bloom_probe.cuh (kernel 1's loop): round i tests hash
  // i of every window still alive, its loads all started before any test
  const unsigned present = gp_probe_rounds<kRun>(words, h, live, [&](int q, int i) {
    return gp_bit_index<kPow2>(gp_nth_hash(base[q], i, kmul), bits);
  });
  out[row * nbytes + (w >> 3)] = (uint8_t)present;
}

// kSmem: the direct tables and the tile in dynamic shared memory
// (scan_smem_bytes); else the tables from device memory and the bytes
// from the row.
template <bool kPow2, bool kSmem>
__global__ void __launch_bounds__(kScanThreads)
gp_scan_kernel(const uint32_t* __restrict__ words, uint64_t bits, int h, int k,
               const uint8_t* __restrict__ codes, int64_t B, int64_t L, int64_t nw,
               int64_t nbytes, const uint64_t* __restrict__ tf,
               const uint64_t* __restrict__ tr, const uint8_t* __restrict__ fclass,
               uint64_t kmul, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t s_dyn[];
  __shared__ GpRollTables s_r;

  const int64_t row = blockIdx.y;
  const int64_t w0 = (int64_t)blockIdx.x * kScanTile;
  const int64_t w = w0 + (int64_t)threadIdx.x * kRun;  // the run's first window
  if constexpr (kSmem) {
    const GpTableRef t = gp_table_ref(s_dyn, k);
    uint8_t* s_raw = s_dyn + gp_table_bytes(k);
    gp_load_window_tables(t, k, tf, tr, fclass);
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
    gp_load_roll_tables(s_r, t, k);
    __syncthreads();
    if (w >= nw) return;
    const uint8_t* s = s_raw + a + threadIdx.x * kRun;
    scan_run<kPow2>(words, bits, h, k, w, nw, nbytes, row, kmul, t, s_r,
                    [s](int j) { return s[j]; }, out);
  } else {
    const GpGlobalTables t{tf, tr, fclass};
    gp_load_roll_tables(s_r, t, k);
    __syncthreads();
    if (w >= nw) return;
    // bytes past the row's end are read only by windows >= nw: 0 here
    const uint8_t* s = codes + row * L + w;
    const int64_t left = L - w;
    scan_run<kPow2>(words, bits, h, k, w, nw, nbytes, row, kmul, t, s_r,
                    [s, left](int j) { return j < left ? __ldg(s + j) : (uint8_t)0; }, out);
  }
}

// The four bases of a packed byte as four code bytes (little-endian).
__device__ __forceinline__ uint32_t gp_decode4(uint32_t packed) {
  uint32_t out = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t c = (packed >> (2 * q)) & 3u;
    out |= ((0x54474341u >> (8 * c)) & 0xffu) << (8 * q);  // "ACGT"[c]
  }
  return out;
}

// Kernel 8 (smem form): kernel 2 with its tile filled from the packed row.
template <bool kPow2>
__global__ void __launch_bounds__(kScanThreads)
gp_scan2_kernel(const uint32_t* __restrict__ words, uint64_t bits, int h, int k,
                const uint8_t* __restrict__ packed, int64_t B, int64_t L, int64_t P,
                const int64_t* __restrict__ exc_idx, const uint8_t* __restrict__ exc_byte,
                int64_t E, int64_t nw, int64_t nbytes, const uint64_t* __restrict__ tf,
                const uint64_t* __restrict__ tr, const uint8_t* __restrict__ fclass,
                uint64_t kmul, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t s_dyn[];
  __shared__ GpRollTables s_r;

  const int64_t row = blockIdx.y;
  const int64_t w0 = (int64_t)blockIdx.x * kScanTile;
  const int64_t w = w0 + (int64_t)threadIdx.x * kRun;
  const GpTableRef t = gp_table_ref(s_dyn, k);
  uint8_t* s_raw = s_dyn + gp_table_bytes(k);
  gp_load_window_tables(t, k, tf, tr, fclass);
  // bytes [w0, w0 + tile) of the row from its packed bytes [w0 / 4, ...):
  // whole 4-byte words, the first at offset `a` < 4 before them (a packed
  // row starts at any byte), so the tile's byte 0 lands at s_raw[4a].  As
  // in kernel 2, what lies past the row's end is read only by windows >=
  // nw, never probed.
  const int64_t tile = kScanTile + k - 1;
  const uint8_t* src = packed + row * P + (w0 >> 2);
  const int a = (int)((uintptr_t)src & 3);
  const uint8_t* lo = packed;
  const uint8_t* hi = packed + B * P;
  const int nwords = (int)((a + (tile + 3) / 4 + 3) / 4);
  for (int c = threadIdx.x; c < nwords; c += kScanThreads) {
    const uint8_t* g = src - a + 4 * (int64_t)c;
    uint32_t v = 0;
    if (g >= lo && g + 4 <= hi) {
      v = __ldg((const uint32_t*)g);
    } else {
      for (int i = 0; i < 4; ++i)
        if (g + i >= lo && g + i < hi) v |= (uint32_t)g[i] << (8 * i);
    }
    uint4 bases;
    bases.x = gp_decode4(v & 0xffu);
    bases.y = gp_decode4((v >> 8) & 0xffu);
    bases.z = gp_decode4((v >> 16) & 0xffu);
    bases.w = gp_decode4(v >> 24);
    *(uint4*)(s_raw + 16 * c) = bases;
  }
  __syncthreads();
  // the row's exceptions inside the tile, as raw bytes (padding: idx >= L)
  uint8_t* s_tile = s_raw + 4 * a;
  const int64_t* ei = exc_idx + row * E;
  const uint8_t* eb = exc_byte + row * E;
  for (int64_t e = threadIdx.x; e < E; e += kScanThreads) {
    const uint64_t p = (uint64_t)__ldg((const long long*)ei + e);
    if (p < (uint64_t)L && p >= (uint64_t)w0 && p - (uint64_t)w0 < (uint64_t)tile)
      s_tile[p - (uint64_t)w0] = __ldg(eb + e);
  }
  gp_load_roll_tables(s_r, t, k);
  __syncthreads();
  if (w >= nw) return;
  const uint8_t* s = s_tile + threadIdx.x * kRun;
  scan_run<kPow2>(words, bits, h, k, w, nw, nbytes, row, kmul, t, s_r,
                  [s](int j) { return s[j]; }, out);
}

// Kernel 8's second form, step 1: every packed byte of [B, P] to its (up
// to) four code bytes of scratch [B, L].
__global__ void gp_unpack2_kernel(const uint8_t* __restrict__ packed, int64_t B, int64_t L,
                                  int64_t P, uint8_t* __restrict__ codes) {
  const int64_t n = B * P;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = i / P, j = 4 * (i % P);
    const uint32_t v = gp_decode4(packed[i]);
    for (int q = 0; q < 4 && j + q < L; ++q) codes[row * L + j + q] = (uint8_t)(v >> (8 * q));
  }
}

// Step 2: the exceptions' raw bytes over the decoded rows.
__global__ void gp_exceptions_kernel(const int64_t* __restrict__ exc_idx,
                                     const uint8_t* __restrict__ exc_byte, int64_t B,
                                     int64_t E, int64_t L, uint8_t* __restrict__ codes) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * E) return;
  const uint64_t p = (uint64_t)exc_idx[i];
  if (p < (uint64_t)L) codes[(i / E) * L + (int64_t)p] = exc_byte[i];
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
  if (k < 1 || h < 1 || bits == 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const int64_t nw = L - k + 1;
  if (nw <= 0 || B <= 0) return 0;
  const int64_t nbytes = (nw + 7) / 8;
  dim3 grid((unsigned)((nw + kScanTile - 1) / kScanTile), (unsigned)B);
  const bool pow2 = (bits & (bits - 1)) == 0;
  const int64_t smem = scan_smem_bytes(k);
  const bool in_smem = smem + (int64_t)sizeof(GpRollTables) <= kGpSmemBytes;
  auto kernel = in_smem ? (pow2 ? gp_scan_kernel<true, true> : gp_scan_kernel<false, true>)
                        : (pow2 ? gp_scan_kernel<true, false> : gp_scan_kernel<false, false>);
  kernel<<<grid, kScanThreads, in_smem ? (size_t)smem : 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, bits, h, k, (const uint8_t*)codes, B, L, nw, nbytes,
      (const uint64_t*)tf, (const uint64_t*)tr, (const uint8_t*)fclass, kmul,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

// Kernel 8's device scratch at (k, B, L): 0 where its smem form runs, else
// the decoded rows, B * L bytes.
extern "C" int64_t gp_scan_packed2_scratch_bytes(int k, int64_t B, int64_t L) {
  const bool in_smem = scan_smem_bytes(k) + (int64_t)sizeof(GpRollTables) <= kGpSmemBytes;
  return in_smem ? 0 : B * L;
}

// packed: uint8[B, P] row-major (device), P >= ceil(L/4); exc_idx: int64[B,
// E]; exc_byte: uint8[B, E]; scratch: gp_scan_packed2_scratch_bytes bytes
// (may be null where that is 0); the rest as gp_scan_present_packed.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int gp_scan_present_packed2(const void* words, uint64_t bits, int h, int k,
                                       const void* packed, int64_t B, int64_t L,
                                       int64_t P, const void* exc_idx,
                                       const void* exc_byte, int64_t E, const void* tf,
                                       const void* tr, const void* fclass, uint64_t kmul,
                                       void* scratch, void* out, void* stream) {
  if (k < 1 || h < 1 || bits == 0 || B > 65535 || E < 0 || P * 4 < L)
    return (int)cudaErrorInvalidValue;
  const int64_t nw = L - k + 1;
  if (nw <= 0 || B <= 0) return 0;
  const int64_t nbytes = (nw + 7) / 8;
  const bool pow2 = (bits & (bits - 1)) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (gp_scan_packed2_scratch_bytes(k, B, L) == 0) {
    dim3 grid((unsigned)((nw + kScanTile - 1) / kScanTile), (unsigned)B);
    auto kernel = pow2 ? gp_scan2_kernel<true> : gp_scan2_kernel<false>;
    kernel<<<grid, kScanThreads, (size_t)scan_smem_bytes(k), s>>>(
        (const uint32_t*)words, bits, h, k, (const uint8_t*)packed, B, L, P,
        (const int64_t*)exc_idx, (const uint8_t*)exc_byte, E, nw, nbytes,
        (const uint64_t*)tf, (const uint64_t*)tr, (const uint8_t*)fclass, kmul,
        (uint8_t*)out);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  uint8_t* codes = (uint8_t*)scratch;
  const int64_t n = B * P;
  gp_unpack2_kernel<<<(unsigned)std::min<int64_t>((n + 255) / 256, 4096), 256, 0, s>>>(
      (const uint8_t*)packed, B, L, P, codes);
  if (B * E > 0)
    gp_exceptions_kernel<<<(unsigned)((B * E + 255) / 256), 256, 0, s>>>(
        (const int64_t*)exc_idx, (const uint8_t*)exc_byte, B, E, L, codes);
  dim3 grid((unsigned)((nw + kScanTile - 1) / kScanTile), (unsigned)B);
  auto kernel = pow2 ? gp_scan_kernel<true, false> : gp_scan_kernel<false, false>;
  kernel<<<grid, kScanThreads, 0, s>>>((const uint32_t*)words, bits, h, k, codes, B, L,
                                       nw, nbytes, (const uint64_t*)tf,
                                       (const uint64_t*)tr, (const uint8_t*)fclass, kmul,
                                       (uint8_t*)out);
  return (int)cudaGetLastError();
}
