// ntHash v1 on the device: the split rotation, the direct window hash from
// kernel 2's XOR tables, the O(1) roll and the extra hashes.  Kernels 2-7
// include it.
//
//   fh(w)   = XOR_j TF[j][class(s[w+j])]    TF[j][c] = srol^(k-1-j)(seed_c)
//   rh(w)   = XOR_j TR[j][s[w+j] & 7]       TR[j][c] = srol^j(seedTab[c])
//   fh(w+1) = srol(fh(w)) ^ F[s[w+k]] ^ srol^k(F[s[w]])
//   rh(w+1) = sror(rh(w) ^ srol^k(R[s[w+k]]) ^ R[s[w]])
//
// with F[c] = TF[k-1][class(c)] (ntHash's seedTab[c]) and R[c] = TR[0][c & 7]
// (seedTab[c & 7]).  Rotation distributes over XOR, so the rolled and the
// direct forms agree for every byte, whatever seed it carries (the tables
// come from goldpolish_tpu_torch/ops/scan_conv.py:_xor_tables).
//
// The tables of one k, TF [k][5] (class 4, no seed, contributes 0), TR
// [k][8] and the classes [256], take 104k + 256 bytes.  Three holders give
// them the same interface, t.f(j, byte) = TF[j][class(byte)] and t.r(j,
// byte) = TR[j][byte & 7]:
//  * GpWindowTables<kMaxK>: static shared memory of a fixed capacity
//    (kernels 4 and 5, whose k stays gated as in the JAX package);
//  * GpTableRef: dynamic shared memory sized from k at launch (kernels 2,
//    6 and 7, at any k whose tables fit beside the kernel's other shared
//    memory within kGpSmemBytes);
//  * GpGlobalTables: the wrapper's TF [k][4] and TR [k][8] in device memory
//    read through the read-only cache, for a k too large for that.
#pragma once

#include <cstdint>

#include "bloom_probe.cuh"

constexpr int kGpNoClass = 4;  // forward class of bytes without a seed
// The shared memory a block takes without the opt-in attribute; a kernel
// whose k-sized shared memory would pass it reads its tables from device
// memory instead (GpGlobalTables), so no k is refused.
constexpr int64_t kGpSmemBytes = 48 * 1024;

__device__ __forceinline__ uint64_t gp_srol_n(uint64_t v, int n) {
  const uint64_t m31 = (1ull << 31) - 1, m33 = (1ull << 33) - 1;
  const int s31 = n % 31, s33 = n % 33;
  uint64_t hi = v >> 33, lo = v & m33;
  hi = ((hi << s31) | (hi >> (31 - s31))) & m31;
  lo = ((lo << s33) | (lo >> (33 - s33))) & m33;
  return (hi << 33) | lo;
}

__device__ __forceinline__ uint64_t gp_sror1(uint64_t v) {
  const uint64_t m31 = (1ull << 31) - 1, m33 = (1ull << 33) - 1;
  uint64_t hi = v >> 33, lo = v & m33;
  hi = ((hi >> 1) | (hi << 30)) & m31;
  lo = ((lo >> 1) | (lo << 32)) & m33;
  return (hi << 33) | lo;
}

// hash i of a canonical base hash (nte64; kmul = k * MULTI_SEED)
__device__ __forceinline__ uint64_t gp_nth_hash(uint64_t base, int i, uint64_t kmul) {
  if (!i) return base;
  const uint64_t t = base * ((uint64_t)i ^ kmul);
  return t ^ (t >> 27);
}

// The bit index of a hash value.  kPow2 is a template argument so that the
// power-of-two path is straight-line code: the 64-bit modulo is a routine
// with branches, and a load cannot be scheduled across them.
template <bool kPow2>
__device__ __forceinline__ uint64_t gp_bit_index(uint64_t hv, uint64_t bits) {
  return kPow2 ? (hv & (bits - 1)) : (hv % bits);
}

// Four hashes of the h-hash Bloom test, latency first: gp_probe4_load
// computes the bit indices of hashes i0 .. i0 + 3 of a canonical base hash
// and starts their four word loads; gp_probe4_all tests them.  The loads
// are in flight together, so a present key waits for one L2 latency, not
// four in turn, and whatever the caller computes between the two calls
// runs while it waits (a thread's instructions go in order: a test right
// after its load would stall the thread there).  Past h the slots repeat
// hash i0, whose word is then in L1.
struct GpProbe4 {
  uint64_t bit[4];
  uint32_t word[4];
};

template <bool kPow2>
__device__ __forceinline__ GpProbe4 gp_probe4_load(const uint32_t* __restrict__ words,
                                                    uint64_t bits, int h, uint64_t kmul,
                                                    uint64_t base, int i0) {
  GpProbe4 p;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    p.bit[j] = gp_bit_index<kPow2>(gp_nth_hash(base, i0 + j < h ? i0 + j : i0, kmul), bits);
#pragma unroll
  for (int j = 0; j < 4; ++j) p.word[j] = gp_bloom_word(words, p.bit[j]);
  return p;
}

__device__ __forceinline__ bool gp_probe4_all(const GpProbe4& p) {
  bool all = true;
#pragma unroll
  for (int j = 0; j < 4; ++j) all &= gp_bloom_bit(p.word[j], p.bit[j]);
  return all;
}

// The direct-hash tables, staged in static shared memory, k <= kMaxK.
template <int kMaxK>
struct GpWindowTables {
  uint64_t tf[kMaxK * 5];  // class 4 (no seed) contributes 0
  uint64_t tr[kMaxK * 8];
  uint8_t cls[256];
  __device__ __forceinline__ uint64_t f(int j, uint8_t c) const { return tf[j * 5 + cls[c]]; }
  __device__ __forceinline__ uint64_t r(int j, uint8_t c) const { return tr[j * 8 + (c & 7)]; }
};

// The same tables in dynamic shared memory (gp_table_ref carves them).
struct GpTableRef {
  uint64_t* tf;
  uint64_t* tr;
  uint8_t* cls;
  __device__ __forceinline__ uint64_t f(int j, uint8_t c) const { return tf[j * 5 + cls[c]]; }
  __device__ __forceinline__ uint64_t r(int j, uint8_t c) const { return tr[j * 8 + (c & 7)]; }
};

// Bytes of a GpTableRef's tables at k, rounded up to 16.
__host__ __device__ constexpr int64_t gp_table_bytes(int k) {
  return (104ll * k + 256 + 15) / 16 * 16;
}

// The tables at the start of `smem` (8-byte aligned, gp_table_bytes(k)).
__device__ __forceinline__ GpTableRef gp_table_ref(void* smem, int k) {
  uint64_t* p = (uint64_t*)smem;
  return {p, p + 5 * k, (uint8_t*)(p + 13 * k)};
}

// The wrapper's tables in device memory: tf [k][4], tr [k][8], cls [256].
struct GpGlobalTables {
  const uint64_t* tf;
  const uint64_t* tr;
  const uint8_t* cls;
  __device__ __forceinline__ uint64_t f(int j, uint8_t c) const {
    const uint8_t q = __ldg(cls + c);
    return q == kGpNoClass ? 0ull : __ldg(tf + j * 4 + q);
  }
  __device__ __forceinline__ uint64_t r(int j, uint8_t c) const {
    return __ldg(tr + j * 8 + (c & 7));
  }
};

// The per-byte roll seeds for one k, staged in shared memory.
struct GpRollTables {
  uint64_t f[256], r[256], fk[256], rk[256];  // F, R, srol^k(F), srol^k(R)
};

// Stages GpWindowTables or GpTableRef.  Every thread of the block calls
// it; __syncthreads() before reading.
template <class T>
__device__ __forceinline__ void gp_load_window_tables(T& t, int k,
                                                      const uint64_t* __restrict__ tf,
                                                      const uint64_t* __restrict__ tr,
                                                      const uint8_t* __restrict__ fclass) {
  for (int i = threadIdx.x; i < k * 5; i += blockDim.x) {
    const int j = i / 5, c = i % 5;
    t.tf[i] = c == kGpNoClass ? 0ull : tf[j * 4 + c];
  }
  for (int i = threadIdx.x; i < k * 8; i += blockDim.x) t.tr[i] = tr[i];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) t.cls[i] = fclass[i];
}

// After the window tables are staged and synchronised; every thread of the
// block calls it; __syncthreads() before reading.
template <class T>
__device__ __forceinline__ void gp_load_roll_tables(GpRollTables& r, const T& t, int k) {
  for (int c = threadIdx.x; c < 256; c += blockDim.x) {
    const uint64_t f = t.f(k - 1, (uint8_t)c), rv = t.r(0, (uint8_t)c);
    r.f[c] = f;
    r.r[c] = rv;
    r.fk[c] = gp_srol_n(f, k);
    r.rk[c] = gp_srol_n(rv, k);
  }
}

// (fh, rh) of the window whose byte j is byte(j), j < k.
template <class T, class Byte>
__device__ __forceinline__ void gp_window_hash(const T& t, int k, Byte byte, uint64_t& fh,
                                               uint64_t& rh) {
  fh = 0;
  rh = 0;
  for (int j = 0; j < k; ++j) {
    const uint8_t c = byte(j);
    fh ^= t.f(j, c);
    rh ^= t.r(j, c);
  }
}

// One step of a walk on the de Bruijn graph (kernel 7).  (fh, rh) hold the
// direct-hash XOR of the k - 1 bytes that a vertex's four extensions share,
// at their window positions: 0 .. k-2 for a successor walk (the base at
// k - 1), 1 .. k-1 for a predecessor walk (the base at 0).  The walk moves
// to the extension with `base`; `drop` is that extension's byte on the far
// side (position 0, or k - 1), which the next vertex's extensions do not
// share.  TF[j] = srol(TF[j+1]) and TR[j+1] = srol(TR[j]), so moving every
// byte one position over is one split rotation, whatever k.
template <class T>
__device__ __forceinline__ void gp_chain_step(const T& t, int k, bool succ, uint64_t& fh,
                                              uint64_t& rh, uint8_t base, uint8_t drop) {
  const int last = k - 1;
  if (succ) {
    fh = gp_srol_n(fh ^ t.f(last, base) ^ t.f(0, drop), 1);
    rh = gp_sror1(rh ^ t.r(last, base) ^ t.r(0, drop));
  } else {
    fh = gp_sror1(fh ^ t.f(0, base) ^ t.f(last, drop));
    rh = gp_srol_n(rh ^ t.r(0, base) ^ t.r(last, drop), 1);
  }
}

// One window to the right: c_out leaves at the left, c_in enters at the right.
__device__ __forceinline__ void gp_roll(const GpRollTables& r, uint64_t& fh, uint64_t& rh,
                                        uint8_t c_out, uint8_t c_in) {
  fh = gp_srol_n(fh, 1) ^ r.f[c_in] ^ r.fk[c_out];
  rh = gp_sror1(rh ^ r.rk[c_in] ^ r.r[c_out]);
}
