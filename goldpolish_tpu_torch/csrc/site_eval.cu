// Kernel 6: the batched site eval (K7) — for every hot site of a contig,
// every candidate edit's patched sequence, the canonical ntHash of its
// checked windows and the h-hash Bloom test of each:
//
//   sub  c     prefix(k-1) + cand[c] + suffix[:k]          windows 0, j_sub
//   ins  c, m  prefix(k-1) + combo m (cand[c]'s row) + draft + suffix
//                                                          windows j_ins
//   del  d     prefix(k-1) + suffix[d : d+k]               windows j_del
//
//   gate[s, c] = window 0 present, sub_sup[s, c] = #j_sub present,
//   ins_sup[s, c, m] = #j_ins present, del_pr[s, d, i] = window j_del[i]
//
// prefix = codes[w : w+k-1], draft = upper(codes[w+k-1]), suffix[j] =
// codes[w+k+j] or 0 at or past the contig's length n; cand = sub_cand[draft]
// (zero-padded: padded lanes hash byte 0).  The plain torch version is
// goldpolish_tpu_torch/ops/siteeval_device.py:eval_sites_device_reference.
//
// Replaces: goldpolish_tpu/ops/siteeval_jax.py, the jitted program `run` of
// _kernel (:44-143) with _window_probes / _probe (:27-40).  The JAX program
// materialises every patch ([S, 4, C, 2k + max_ins] bytes for the
// insertions), hashes every window of it with the prefix-XOR form and then
// gathers the checked windows.  Here no patch exists in memory: a thread
// owns one patch and reads its bytes through the site's context.  Unlike
// `_probe`, which casts `hash % bits` to uint32, the bit index is 64-bit.
//
// What bounds it on the H100: the bytes are small (the filter, each site's
// 2k + max_del bytes, one byte out per candidate), so the byte bound of the
// main path's call is ~1 us.  The work is per checked window its hash and
// random 4-byte loads from a filter that sits in L2: at k = 32, 256 sites
// and 341 combos, ~3.87 M checked windows.  As for kernels 2, 4 and 5, the
// rate of random L2 requests (~124 G/s measured for kernel 2) sets a floor
// far above the byte bound.  The first design sent all h loads of every
// window (15.47 M requests at h = 4, 0.120-0.125 ms, at that floor), though
// most patched windows miss on their first hash.
//
// The design, first hash first, each hash part once:
//  * one thread per (site, candidate[, combo]) patch, over a flat index
//    (subs, then insertions, then deletions), so a warp's threads share a
//    site and a candidate and differ in the combo;
//  * insertion patches, 98% of the windows: the window hash is an XOR over
//    positions, so window j of prefix(k-1) + combo + draft + suffix is the
//    XOR of three parts: the prefix bytes (the same for every patch of the
//    site), the draft and suffix bytes (the same for every combo of one
//    length) and the combo's bytes (the same for every site).  A first
//    launch (gp_site_parts_kernel) computes each part once, into a scratch
//    of S x n_ins x (1 + max_ins) + 4 x n_ins x C entries of 16 bytes (~0.5
//    MB on the main path); a window then costs the eval three 16-byte loads
//    (two broadcast within a warp, one coalesced) and no hashing.  The
//    first design hashed every patch's first window directly (k table
//    reads) and rolled to each further window (~k rolls a patch); with the
//    requests cut below, that hashing had set the pace;
//  * substitution and deletion patches (2%) keep that form: the first
//    checked window hashed directly from kernel 2's XOR tables (gp_window_hash
//    of nthash_roll.cuh) and rolled to each further one (gp_roll), the tables
//    staged in shared memory once per block;
//  * a thread takes its windows kRing at a time and starts the load of
//    each one's FIRST hash's word, all kRing loads in flight together; only
//    the windows whose first bit is set load their further hashes, kRest
//    hashes of every such window together (a window counts only when all h
//    bits are set, so the results cannot change).  At h = 4 that is one
//    request per window plus three per window whose first bit is set: ~3x
//    fewer than all h on the main path's sites;
//  * a ring of 4 in blocks of 128 threads keeps a thread's registers low
//    enough for 7-8 blocks an SM: a ring of 8 or 16 in blocks of 256 (more
//    registers a thread, fewer warps an SM) ran slower on the H100;
//  * the bit index through gp_bit_index<kPow2> (the power-of-two filter is
//    instantiated apart: straight-line code; 64-bit modulo otherwise);
//  * any k and any (max_ins, max_del): the direct tables take dynamic
//    shared memory sized from k at launch (at k <= 64 the bytes of static
//    arrays of that capacity), or, past ~390 where they would pass 48 KB beside
//    the roll tables, are read through the read-only cache (kSmem false);
//    a patch reads its bytes through the site's context, the contig's own
//    bytes or 0 past its end, so no suffix bound limits max_ins.
#include <cuda_runtime.h>

#include <cstdint>

#include "nthash_roll.cuh"

namespace {

constexpr int kSiteThreads = 128;
constexpr int kSiteBlocksPerSm = 8;
constexpr int kRing = 4;  // windows whose first-hash loads are in flight together
constexpr int kRest = 3;  // further hashes per window loaded together

struct SiteEvalArgs {
  const uint32_t* words;
  uint64_t bits;
  int h, k;
  uint64_t kmul;
  const uint8_t* codes;
  int64_t n;  // the contig's length (the buffer may be longer)
  const int64_t* sites;
  int64_t S;
  const uint8_t* sub_cand;     // [256, 4]
  const uint8_t* combo_codes;  // [4, n_tab, max_ins]
  int n_tab;
  const int32_t* combo_len;  // [n_tab]
  int C, max_ins, max_del;
  const int32_t* js;  // [0] + j_sub, then j_ins, then j_del (each ascending)
  int n_sub, n_ins, n_del;
  uint8_t* gate;
  int8_t* sub_sup;
  int8_t* ins_sup;
  uint8_t* del_pr;
  uint64_t* parts;  // the insertion windows' hash parts (PartsLayout)
};

// The hash parts of the insertion windows, (forward, reverse) XORs over
// the window positions each covers (the direct hash is an XOR over
// positions, so a window's hash is the XOR of its parts'):
//   site(s, i, 0)        the prefix bytes of window i of site s
//   site(s, i, cl)       the draft and suffix bytes, for a combo of length
//                        cl (1 .. max_ins): they start at position k-1+cl
//   combo(row, i, m)     combo m of candidate row `row` (its cl bytes)
struct PartsLayout {
  int64_t n_site, n_combo;  // entries (2 x uint64 each)
  __host__ __device__ PartsLayout(int64_t S, int n_ins, int max_ins, int C)
      : n_site(S * n_ins * (1 + max_ins)), n_combo(4ll * n_ins * C) {}
  __device__ int64_t site(int64_t s, int i, int part, int n_ins, int max_ins) const {
    return (s * n_ins + i) * (1 + max_ins) + part;
  }
  __device__ int64_t combo(int row, int i, int m, int n_ins, int C) const {
    return n_site + ((int64_t)row * n_ins + i) * C + m;
  }
};

// Byte q of a site's context: the prefix for q < k - 1 and the suffix for
// q >= k (0 at or past the contig's end).  q = k - 1, the draft, is never
// read through it.
struct SiteCtx {
  const uint8_t* codes;
  int64_t n, w;
  __device__ __forceinline__ uint8_t at(int q) const {
    return w + q < n ? __ldg(codes + w + q) : (uint8_t)0;
  }
};

// The Bloom test of nj windows whose canonical hashes hash(0), hash(1),
// ... gives in turn; emit(i, present) each.  kRing windows at a time:
// their first hashes' loads together, then the further hashes of those
// whose first bit is set, kRest at a time.
template <bool kPow2, class Hash, class Emit>
__device__ __forceinline__ void window_probes(const SiteEvalArgs& a, int nj, Hash hash,
                                              Emit emit) {
  for (int i0 = 0; i0 < nj; i0 += kRing) {
    uint64_t base[kRing];
    uint32_t word[kRing], shift[kRing];
#pragma unroll
    for (int g = 0; g < kRing; ++g)
      if (i0 + g < nj) base[g] = hash(i0 + g);
#pragma unroll
    for (int g = 0; g < kRing; ++g)
      if (i0 + g < nj) {
        const uint64_t bit = gp_bit_index<kPow2>(base[g], a.bits);
        word[g] = gp_bloom_word(a.words, bit);
        shift[g] = (uint32_t)(bit & 31u);
      }
    unsigned alive = 0;
#pragma unroll
    for (int g = 0; g < kRing; ++g)
      if (i0 + g < nj && (word[g] >> shift[g] & 1u)) alive |= 1u << g;
    for (int i1 = 1; i1 < a.h && alive; i1 += kRest) {
      uint32_t w2[kRing][kRest], s2[kRing];  // s2: kRest 5-bit shifts a window
#pragma unroll
      for (int g = 0; g < kRing; ++g) {
        s2[g] = 0;
#pragma unroll
        for (int q = 0; q < kRest; ++q)
          if ((alive >> g & 1u) && i1 + q < a.h) {
            const uint64_t bit =
                gp_bit_index<kPow2>(gp_nth_hash(base[g], i1 + q, a.kmul), a.bits);
            w2[g][q] = gp_bloom_word(a.words, bit);
            s2[g] |= (uint32_t)(bit & 31u) << (5 * q);
          }
      }
#pragma unroll
      for (int g = 0; g < kRing; ++g)
#pragma unroll
        for (int q = 0; q < kRest; ++q)
          if ((alive >> g & 1u) && i1 + q < a.h &&
              !(w2[g][q] >> (s2[g] >> (5 * q) & 31u) & 1u))
            alive &= ~(1u << g);
    }
#pragma unroll
    for (int g = 0; g < kRing; ++g)
      if (i0 + g < nj) emit(i0 + g, (bool)(alive >> g & 1u));
  }
}

// The checked windows js[0 .. nj) of the patch whose byte q is byte(q):
// the first hashed directly, the rest rolled to.
template <bool kPow2, class T, class Byte, class Emit>
__device__ __forceinline__ void patch_probes(const SiteEvalArgs& a, const T& t,
                                             const GpRollTables& r, Byte byte,
                                             const int32_t* __restrict__ js, int nj,
                                             Emit emit) {
  if (nj <= 0) return;
  int at = __ldg(js);
  uint64_t fh, rh;
  gp_window_hash(t, a.k, [&](int j) { return byte(at + j); }, fh, rh);
  window_probes<kPow2>(
      a, nj,
      [&](int i) {
        for (const int j = __ldg(js + i); at < j; ++at)
          gp_roll(r, fh, rh, byte(at), byte(at + a.k));
        return fh + rh;
      },
      emit);
}

// The XOR of positions q0 .. q1 of window j (its byte q is byte(q)) into
// (f, r); an empty range adds nothing.
template <class T, class Byte>
__device__ __forceinline__ void xor_positions(const T& t, int j, int q0, int q1, Byte byte,
                                              uint64_t& f, uint64_t& r) {
  for (int q = q0; q <= q1; ++q) {
    const uint8_t c = byte(q);
    f ^= t.f(q - j, c);
    r ^= t.r(q - j, c);
  }
}

// The direct tables of a block: staged in dynamic shared memory
// (gp_table_bytes(k)) when kSmem, else read from device memory.
template <bool kSmem>
struct SiteTablesOf {
  using type = GpTableRef;
};
template <>
struct SiteTablesOf<false> {
  using type = GpGlobalTables;
};

// Every thread of the block calls it; __syncthreads() before reading.
template <bool kSmem>
__device__ __forceinline__ typename SiteTablesOf<kSmem>::type site_tables(
    void* smem, int k, const uint64_t* __restrict__ tf, const uint64_t* __restrict__ tr,
    const uint8_t* __restrict__ fclass) {
  if constexpr (kSmem) {
    const GpTableRef t = gp_table_ref(smem, k);
    gp_load_window_tables(t, k, tf, tr, fclass);
    return t;
  } else {
    return GpGlobalTables{tf, tr, fclass};
  }
}

// Site s's context, and its draft byte upper-cased into `draft`.
__device__ __forceinline__ SiteCtx site_ctx(const SiteEvalArgs& a, int64_t s, uint8_t& draft) {
  const SiteCtx ctx{a.codes, a.n, (int64_t)__ldg((const long long*)a.sites + s)};
  draft = __ldg(a.codes + ctx.w + a.k - 1);
  if (draft >= 97 && draft <= 122) draft -= 32;
  return ctx;
}

// The first launch: every entry of PartsLayout, one thread each.  An
// insertion patch is prefix(k-1) + combo (cl bytes) + draft + suffix; its
// window j covers positions j .. j+k-1.
template <bool kSmem>
__global__ void __launch_bounds__(kSiteThreads)
gp_site_parts_kernel(SiteEvalArgs a, const uint64_t* __restrict__ tf,
                     const uint64_t* __restrict__ tr, const uint8_t* __restrict__ fclass) {
  extern __shared__ __align__(16) uint8_t s_dyn[];
  const auto s_t = site_tables<kSmem>(s_dyn, a.k, tf, tr, fclass);
  __syncthreads();

  const int k = a.k, MI = a.max_ins;
  const PartsLayout lay(a.S, a.n_ins, MI, a.C);
  const int32_t* js_ins = a.js + 1 + a.n_sub;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < lay.n_site + lay.n_combo;
       t += (int64_t)gridDim.x * blockDim.x) {
    uint64_t f = 0, r = 0;
    if (t < lay.n_site) {
      const int part = (int)(t % (1 + MI));
      const int64_t si = t / (1 + MI), s = si / a.n_ins;
      const int j = __ldg(js_ins + (int)(si - s * a.n_ins));
      uint8_t draft;
      const SiteCtx ctx = site_ctx(a, s, draft);
      if (part == 0) {
        xor_positions(s_t, j, j, min(k - 2, j + k - 1), [&](int q) { return ctx.at(q); }, f,
                      r);
      } else {
        const int cl = part;
        xor_positions(s_t, j, max(j, k - 1 + cl), j + k - 1,
                      [&](int q) { return q == k - 1 + cl ? draft : ctx.at(q - cl); }, f, r);
      }
    } else {
      const int64_t u = t - lay.n_site;
      const int m = (int)(u % a.C), ri = (int)(u / a.C), row = ri / a.n_ins;
      const int j = __ldg(js_ins + (ri - row * a.n_ins));
      const uint8_t* combo = a.combo_codes + ((int64_t)row * a.n_tab + m) * MI;
      const int cl = __ldg(a.combo_len + m);
      xor_positions(s_t, j, max(j, k - 1), min(k - 2 + cl, j + k - 1),
                    [&](int q) { return __ldg(combo + q - (k - 1)); }, f, r);
    }
    a.parts[2 * t] = f;
    a.parts[2 * t + 1] = r;
  }
}

template <bool kPow2, bool kSmem>
__global__ void __launch_bounds__(kSiteThreads)
gp_site_eval_kernel(SiteEvalArgs a, const uint64_t* __restrict__ tf,
                    const uint64_t* __restrict__ tr, const uint8_t* __restrict__ fclass) {
  extern __shared__ __align__(16) uint8_t s_dyn[];
  __shared__ GpRollTables s_r;
  const auto s_t = site_tables<kSmem>(s_dyn, a.k, tf, tr, fclass);
  __syncthreads();
  gp_load_roll_tables(s_r, s_t, a.k);
  __syncthreads();

  const int k = a.k;
  const PartsLayout lay(a.S, a.n_ins, a.max_ins, a.C);
  const int64_t n_subs = a.S * 4, n_inss = n_subs * a.C;
  const int64_t total = n_subs + n_inss + a.S * a.max_del;
  const int32_t* js_sub = a.js;
  const int32_t* js_del = js_sub + 1 + a.n_sub + a.n_ins;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    int64_t s, u = t;
    int kind, c = 0, m = 0, d = 0;
    if (u < n_subs) {
      kind = 0;
      s = u >> 2;
      c = (int)(u & 3);
    } else if ((u -= n_subs) < n_inss) {
      kind = 1;
      s = u / (4 * a.C);
      const int rem = (int)(u - s * 4 * a.C);
      c = rem / a.C;
      m = rem - c * a.C;
    } else {
      kind = 2;
      u -= n_inss;
      s = u / a.max_del;
      d = (int)(u - s * a.max_del);
    }
    uint8_t draft;
    const SiteCtx ctx = site_ctx(a, s, draft);
    const uint8_t cand = __ldg(a.sub_cand + draft * 4 + c);

    if (kind == 0) {
      bool gate = false;
      int sup = 0;
      patch_probes<kPow2>(
          a, s_t, s_r, [&](int q) { return q == k - 1 ? cand : ctx.at(q); }, js_sub,
          1 + a.n_sub, [&](int i, bool present) {
            if (i == 0) gate = present;
            else sup += present;
          });
      a.gate[s * 4 + c] = gate;
      a.sub_sup[s * 4 + c] = (int8_t)sup;
    } else if (kind == 1) {
      // window i's hash from its three parts (gp_site_parts_kernel)
      const int row = cand == 'C' ? 1 : cand == 'G' ? 2 : cand == 'T' ? 3 : 0;
      const int cl = __ldg(a.combo_len + m);
      const ulonglong2* parts = (const ulonglong2*)a.parts;
      int sup = 0;
      window_probes<kPow2>(
          a, a.n_ins,
          [&](int i) {
            const ulonglong2 p = __ldg(parts + lay.site(s, i, 0, a.n_ins, a.max_ins));
            const ulonglong2 q = __ldg(parts + lay.site(s, i, cl, a.n_ins, a.max_ins));
            const ulonglong2 x = __ldg(parts + lay.combo(row, i, m, a.n_ins, a.C));
            return (p.x ^ q.x ^ x.x) + (p.y ^ q.y ^ x.y);
          },
          [&](int, bool present) { sup += present; });
      a.ins_sup[(s * 4 + c) * a.C + m] = (int8_t)sup;
    } else {
      uint8_t* out = a.del_pr + (s * a.max_del + d) * a.n_del;
      patch_probes<kPow2>(
          a, s_t, s_r, [&](int q) { return ctx.at(q < k - 1 ? q : q + d + 1); }, js_del,
          a.n_del, [&](int i, bool present) { out[i] = present; });
    }
  }
}

}  // namespace

// The bytes of gp_site_eval's `parts` scratch for S sites.
extern "C" int64_t gp_site_eval_parts_bytes(int64_t S, int n_ins, int max_ins, int C) {
  const PartsLayout lay(S, n_ins, max_ins, C);
  return 16 * (lay.n_site + lay.n_combo);
}

// codes: uint8[>= n] (device), the contig's bytes first; sites: int64[S],
// window starts with sites + k - 1 < n; words: uint32[ceil(bits/32)]; tf,
// tr, fclass: kernel 2's tables (ops/scan_conv.py:_xor_tables); kmul =
// k * MULTI_SEED (mod 2^64); sub_cand uint8[256, 4]; combo_codes
// uint8[4, n_tab, max_ins]; combo_len int32[n_tab]; js int32[1 + n_sub +
// n_ins + n_del]; outputs gate uint8[S, 4], sub_sup int8[S, 4], ins_sup
// int8[S, 4, C], del_pr uint8[S, max_del, n_del]; parts: scratch of
// gp_site_eval_parts_bytes, 16-byte aligned.  Two launches on `stream` (the
// insertion windows' hash parts, then the eval); returns cudaGetLastError().
extern "C" int gp_site_eval(const void* words, uint64_t bits, int h, int k, const void* codes,
                            int64_t n, const void* sites, int64_t S, const void* tf,
                            const void* tr, const void* fclass, uint64_t kmul,
                            const void* sub_cand, const void* combo_codes, int n_tab,
                            const void* combo_len, int C, int max_ins, int max_del,
                            const void* js, int n_sub, int n_ins, int n_del, void* gate,
                            void* sub_sup, void* ins_sup, void* del_pr, void* parts,
                            void* stream) {
  if (k < 1 || h < 1 || bits == 0 || C < 1 || C > n_tab || max_ins < 1 ||
      max_del < 0 || n_sub < 0 || n_ins < 0 || n_del < 0 || n < k ||
      ((uintptr_t)parts & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (S <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const SiteEvalArgs a{(const uint32_t*)words, bits, h, k, kmul, (const uint8_t*)codes, n,
                       (const int64_t*)sites, S, (const uint8_t*)sub_cand,
                       (const uint8_t*)combo_codes, n_tab, (const int32_t*)combo_len, C,
                       max_ins, max_del, (const int32_t*)js, n_sub, n_ins, n_del,
                       (uint8_t*)gate, (int8_t*)sub_sup, (int8_t*)ins_sup, (uint8_t*)del_pr,
                       (uint64_t*)parts};
  const int64_t cap = (int64_t)sms * kSiteBlocksPerSm;
  const PartsLayout lay(S, n_ins, max_ins, C);
  const int64_t n_parts = lay.n_site + lay.n_combo;
  // the direct tables in shared memory while they fit beside the roll tables
  const int64_t smem = gp_table_bytes(k);
  const bool in_smem = smem + (int64_t)sizeof(GpRollTables) <= kGpSmemBytes;
  const size_t dyn = in_smem ? (size_t)smem : 0;
  if (n_parts > 0) {
    const int64_t blocks = (n_parts + kSiteThreads - 1) / kSiteThreads;
    auto parts_kernel = in_smem ? gp_site_parts_kernel<true> : gp_site_parts_kernel<false>;
    parts_kernel<<<(unsigned)(blocks < cap ? blocks : cap), kSiteThreads, dyn,
                   (cudaStream_t)stream>>>(a, (const uint64_t*)tf, (const uint64_t*)tr,
                                           (const uint8_t*)fclass);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int64_t total = S * (4 + 4 * (int64_t)C + max_del);
  const int64_t blocks = (total + kSiteThreads - 1) / kSiteThreads;
  const bool pow2 = (bits & (bits - 1)) == 0;
  auto kernel = in_smem ? (pow2 ? gp_site_eval_kernel<true, true> : gp_site_eval_kernel<false, true>)
                        : (pow2 ? gp_site_eval_kernel<true, false> : gp_site_eval_kernel<false, false>);
  kernel<<<(unsigned)(blocks < cap ? blocks : cap), kSiteThreads, dyn, (cudaStream_t)stream>>>(
      a, (const uint64_t*)tf, (const uint64_t*)tr, (const uint8_t*)fclass);
  return (int)cudaGetLastError();
}
