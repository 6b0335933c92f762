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
#pragma once

#include <cstdint>

#include "bloom_probe.cuh"

constexpr int kGpMaxK = 64;
constexpr int kGpNoClass = 4;  // forward class of bytes without a seed

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

// The direct-hash tables, staged in shared memory.
struct GpWindowTables {
  uint64_t tf[kGpMaxK * 5];  // class 4 (no seed) contributes 0
  uint64_t tr[kGpMaxK * 8];
  uint8_t cls[256];
};

// The per-byte roll seeds for one k, staged in shared memory.
struct GpRollTables {
  uint64_t f[256], r[256], fk[256], rk[256];  // F, R, srol^k(F), srol^k(R)
};

// Every thread of the block calls it; __syncthreads() before reading.
__device__ __forceinline__ void gp_load_window_tables(GpWindowTables& t, int k,
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
__device__ __forceinline__ void gp_load_roll_tables(GpRollTables& r, const GpWindowTables& t,
                                                    int k) {
  for (int c = threadIdx.x; c < 256; c += blockDim.x) {
    const uint64_t f = t.tf[(k - 1) * 5 + t.cls[c]], rv = t.tr[c & 7];
    r.f[c] = f;
    r.r[c] = rv;
    r.fk[c] = gp_srol_n(f, k);
    r.rk[c] = gp_srol_n(rv, k);
  }
}

// (fh, rh) of the window whose byte j is byte(j), j < k.
template <class Byte>
__device__ __forceinline__ void gp_window_hash(const GpWindowTables& t, int k, Byte byte,
                                               uint64_t& fh, uint64_t& rh) {
  fh = 0;
  rh = 0;
  for (int j = 0; j < k; ++j) {
    const uint8_t c = byte(j);
    fh ^= t.tf[j * 5 + t.cls[c]];
    rh ^= t.tr[j * 8 + (c & 7)];
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
__device__ __forceinline__ void gp_chain_step(const GpWindowTables& t, int k, bool succ,
                                              uint64_t& fh, uint64_t& rh, uint8_t base,
                                              uint8_t drop) {
  const int last = k - 1;
  if (succ) {
    fh = gp_srol_n(fh ^ t.tf[last * 5 + t.cls[base]] ^ t.tf[t.cls[drop]], 1);
    rh = gp_sror1(rh ^ t.tr[last * 8 + (base & 7)] ^ t.tr[drop & 7]);
  } else {
    fh = gp_sror1(fh ^ t.tf[t.cls[base]] ^ t.tf[last * 5 + t.cls[drop]]);
    rh = gp_srol_n(rh ^ t.tr[base & 7] ^ t.tr[last * 8 + (drop & 7)], 1);
  }
}

// One window to the right: c_out leaves at the left, c_in enters at the right.
__device__ __forceinline__ void gp_roll(const GpRollTables& r, uint64_t& fh, uint64_t& rh,
                                        uint8_t c_out, uint8_t c_in) {
  fh = gp_srol_n(fh, 1) ^ r.f[c_in] ^ r.fk[c_out];
  rh = gp_sror1(rh ^ r.rk[c_in] ^ r.r[c_out]);
}
