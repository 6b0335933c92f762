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
// main path's call is ~1 us.  The work is per checked window an O(1) roll
// and up to h random 4-byte loads from a filter that sits in L2: at k = 32,
// 256 sites and 341 combos, ~3.8 M insertion windows of up to 4 loads each.
// As for kernels 2, 4 and 5, the rate of random L2 requests (~124 G/s
// measured for kernel 2) sets the floor, far above the byte bound.
//
// The design, simple first:
//  * one thread per (site, candidate[, combo]) patch, over a flat index
//    (subs, then insertions, then deletions), so a warp's threads share a
//    site and a candidate and differ in the combo: the same prefix bytes
//    (L1), the same control flow but for combos of other lengths;
//  * the first checked window is hashed directly from kernel 2's XOR tables
//    (gp_window_hash of nthash_roll.cuh, 2k shared-memory loads) and rolled
//    to each further checked window (gp_roll); the tables are staged in
//    shared memory once per block, and a grid-stride loop over a few blocks
//    per SM keeps that staging small beside the work;
//  * all h loads of a window are in flight together (gp_probe4_load /
//    gp_probe4_all, groups of 4), the bit index through gp_bit_index<kPow2>
//    (the power-of-two filter is instantiated apart: straight-line code).
// Not done yet (later work): sharing a site's prefix hash between its
// candidates, and keeping several windows' probes in flight per thread.
#include <cuda_runtime.h>

#include <cstdint>

#include "nthash_roll.cuh"

namespace {

constexpr int kSiteThreads = 256;
constexpr int kSiteBlocksPerSm = 4;

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

template <bool kPow2>
__device__ __forceinline__ bool probe_all(const SiteEvalArgs& a, uint64_t base) {
  bool present = true;
  for (int i0 = 0; i0 < a.h && present; i0 += 4)
    present = gp_probe4_all(gp_probe4_load<kPow2>(a.words, a.bits, a.h, a.kmul, base, i0));
  return present;
}

// The checked windows js[0 .. nj) of the patch whose byte q is byte(q):
// the first hashed directly, the rest rolled to; emit(i, present) each.
template <bool kPow2, class Byte, class Emit>
__device__ __forceinline__ void patch_probes(const SiteEvalArgs& a, const GpWindowTables& t,
                                             const GpRollTables& r, Byte byte,
                                             const int32_t* __restrict__ js, int nj,
                                             Emit emit) {
  if (nj <= 0) return;
  int at = __ldg(js);
  uint64_t fh, rh;
  gp_window_hash(t, a.k, [&](int j) { return byte(at + j); }, fh, rh);
  for (int i = 0; i < nj; ++i) {
    for (const int j = __ldg(js + i); at < j; ++at)
      gp_roll(r, fh, rh, byte(at), byte(at + a.k));
    emit(i, probe_all<kPow2>(a, fh + rh));
  }
}

template <bool kPow2>
__global__ void __launch_bounds__(kSiteThreads)
gp_site_eval_kernel(SiteEvalArgs a, const uint64_t* __restrict__ tf,
                    const uint64_t* __restrict__ tr, const uint8_t* __restrict__ fclass) {
  __shared__ GpWindowTables s_t;
  __shared__ GpRollTables s_r;
  gp_load_window_tables(s_t, a.k, tf, tr, fclass);
  __syncthreads();
  gp_load_roll_tables(s_r, s_t, a.k);
  __syncthreads();

  const int k = a.k;
  const int64_t n_subs = a.S * 4, n_inss = n_subs * a.C;
  const int64_t total = n_subs + n_inss + a.S * a.max_del;
  const int32_t* js_sub = a.js;
  const int32_t* js_ins = js_sub + 1 + a.n_sub;
  const int32_t* js_del = js_ins + a.n_ins;
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
    const SiteCtx ctx{a.codes, a.n, (int64_t)__ldg((const long long*)a.sites + s)};
    uint8_t draft = __ldg(a.codes + ctx.w + k - 1);
    if (draft >= 97 && draft <= 122) draft -= 32;
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
      const int row = cand == 'C' ? 1 : cand == 'G' ? 2 : cand == 'T' ? 3 : 0;
      const uint8_t* combo = a.combo_codes + ((int64_t)row * a.n_tab + m) * a.max_ins;
      const int cl = __ldg(a.combo_len + m);
      int sup = 0;
      patch_probes<kPow2>(
          a, s_t, s_r,
          [&](int q) {
            const int rel = q - (k - 1);
            if (rel < 0) return ctx.at(q);
            if (rel < cl) return __ldg(combo + rel);
            return rel == cl ? draft : ctx.at(q - cl);
          },
          js_ins, a.n_ins, [&](int, bool present) { sup += present; });
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

// codes: uint8[>= n] (device), the contig's bytes first; sites: int64[S],
// window starts with sites + k - 1 < n; words: uint32[ceil(bits/32)]; tf,
// tr, fclass: kernel 2's tables (ops/scan_conv.py:_xor_tables); kmul =
// k * MULTI_SEED (mod 2^64); sub_cand uint8[256, 4]; combo_codes
// uint8[4, n_tab, max_ins]; combo_len int32[n_tab]; js int32[1 + n_sub +
// n_ins + n_del]; outputs gate uint8[S, 4], sub_sup int8[S, 4], ins_sup
// int8[S, 4, C], del_pr uint8[S, max_del, n_del].  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int gp_site_eval(const void* words, uint64_t bits, int h, int k, const void* codes,
                            int64_t n, const void* sites, int64_t S, const void* tf,
                            const void* tr, const void* fclass, uint64_t kmul,
                            const void* sub_cand, const void* combo_codes, int n_tab,
                            const void* combo_len, int C, int max_ins, int max_del,
                            const void* js, int n_sub, int n_ins, int n_del, void* gate,
                            void* sub_sup, void* ins_sup, void* del_pr, void* stream) {
  if (k < 1 || k > kGpMaxK || h < 1 || bits == 0 || C < 1 || C > n_tab || max_ins < 1 ||
      max_del < 0 || n_sub < 0 || n_ins < 0 || n_del < 0 || n < k)
    return (int)cudaErrorInvalidValue;
  if (S <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = S * (4 + 4 * (int64_t)C + max_del);
  int64_t blocks = (total + kSiteThreads - 1) / kSiteThreads;
  if (blocks > (int64_t)sms * kSiteBlocksPerSm) blocks = (int64_t)sms * kSiteBlocksPerSm;
  const SiteEvalArgs a{(const uint32_t*)words, bits, h, k, kmul, (const uint8_t*)codes, n,
                       (const int64_t*)sites, S, (const uint8_t*)sub_cand,
                       (const uint8_t*)combo_codes, n_tab, (const int32_t*)combo_len, C,
                       max_ins, max_del, (const int32_t*)js, n_sub, n_ins, n_del,
                       (uint8_t*)gate, (int8_t*)sub_sup, (int8_t*)ins_sup, (uint8_t*)del_pr};
  auto kernel = (bits & (bits - 1)) == 0 ? gp_site_eval_kernel<true> : gp_site_eval_kernel<false>;
  kernel<<<(unsigned)blocks, kSiteThreads, 0, (cudaStream_t)stream>>>(
      a, (const uint64_t*)tf, (const uint64_t*)tr, (const uint8_t*)fclass);
  return (int)cudaGetLastError();
}
