// Kernel 5 (K3): the device Bloom fill without a sort — per k, two passes
// over the windows of a batch's read stream (the reads concatenated):
//
//   bf_count    (pass A) every valid window adds 1 to each of its h slots
//               (hash_i mod cbf_size, full unsigned 64 bits) of the int32
//               totals; a slot that two of its hashes share gets 2
//   bf_promote  (pass B, after pass A has seen every window of every chunk)
//               a valid window whose smallest slot total is >= its
//               threshold max(thr[read] + delta, 1) sets its h bits
//               (hash_i & (bits-1) for a power-of-two bit count, else
//               hash_i mod bits, in 64 bits)
//
// A window is valid iff it lies inside its read.  Each thread walks a run
// of kRun consecutive windows: one binary search of the read offsets, then
// the read index advances with the walk; the hash starts from the direct
// form and rolls (nthash_roll.cuh), so a window costs O(1) hash work.
// Pass B first loads the window's h filter bits: when all are set (its
// k-mer was promoted through an earlier window) it skips the slot loads.
//
// Replaces: goldpolish_tpu/ops/bloom_sort.py, the XLA programs `_fill_k`
// (:245, single dispatch), `_count_k` (:268) and `_promote_k` (:292) of the
// chunked build, with `_stream_meta` (:114; the binary search of the read
// offsets below takes its place), the raw route's `_stream_onehot_raw`
// (:167) and `_distinct_runs` (:177) inside them.  The packed route's
// `_stream_onehot_packed` (:145) has no counterpart: the upload is always
// the raw bytes (ops/bloom_sort.py says why).  The plain torch versions
// are count_reference and promote_reference in
// goldpolish_tpu_torch/ops/bloom_sort.py.
//
// Why the bits are the JAX program's: it sorts the window hashes so that a
// distinct k-mer x becomes one run with cnt(x) valid windows and its
// smallest threshold, then computes totals[s] = sum_x cnt(x) * #{i : slot_i(x)
// = s} (the repeat(cnt, h) scatter) and promotes x iff min_i
// totals[slot_i(x)] >= min over x's windows of thr_w.  Pass A adds the same
// sum one window at a time; pass B promotes x as soon as any of its windows
// passes, and "min_i totals >= thr_w for some window" is exactly "min_i
// totals >= the smallest thr_w".  So the sort and its runs are not needed,
// the bits equal single dispatch at any chunking, and no pad is ever hashed
// (the JAX pad-run fault of ROADMAP.md queue 3 has no counterpart).  The
// TPU sorts because it has no scatter atomics; Hopper's L2 does them.
//
// What bounds it on the H100: per k the bound counts the stream's bytes
// read once and the filter written once (~15.8 MB for a smoke batch of
// ~11.6 M bases and a 4 MiB filter: ~4.7 us at 3.35 TB/s).  The real limit
// is the rate of random 4-byte L2 requests: h atomics per valid window in
// pass A (they return nothing: RED) into 40 MiB of totals (cbf_size = 10 Mi
// slots), and in pass B h bit loads per window from the 4 MiB filter plus
// h slot loads and the atomicOr only for windows not yet promoted; totals
// and filter together fit in the 50 MB L2.  A smoke batch issues ~46 M
// requests per pass (PERF.md gives the rate measured on the card).
#include <cuda_runtime.h>

#include <cstdint>

#include "nthash_roll.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;                 // consecutive windows per thread
constexpr int kSpan = kThreads * kRun;  // windows per block
constexpr int kMaxH = 16;
// the largest k the kernel takes; it sizes the static shared memory (the
// wrapper takes k <= bloom_sort.KHALO + 1, the JAX build's row halo)
constexpr int kFillMaxK = 64;

struct Stream {
  const uint8_t* codes;
  int64_t n;
  const int64_t* offsets;  // [n_reads + 1], strictly rising
  int64_t n_reads;
  const uint8_t* thrs;     // [n_reads]
};

struct Fill {
  int k, delta, h;
  uint64_t kmul, cbf_size, bits;
  int32_t* totals;
  uint32_t* words;
};

template <bool kPromote>
__device__ __forceinline__ void visit(const Fill& f, uint64_t base, int thr) {
  if (!kPromote) {
    for (int i = 0; i < f.h; ++i)
      atomicAdd(f.totals + gp_nth_hash(base, i, f.kmul) % f.cbf_size, 1);
    return;
  }
  // a window whose h bits are all set already (its k-mer was promoted
  // through another window) changes nothing: skip its slot loads
  const bool pow2 = (f.bits & (f.bits - 1)) == 0;
  uint64_t bit[kMaxH];
  bool all = true;
  for (int i = 0; i < f.h; ++i) {
    const uint64_t hv = gp_nth_hash(base, i, f.kmul);
    bit[i] = pow2 ? (hv & (f.bits - 1)) : (hv % f.bits);
    all &= (((volatile uint32_t*)f.words)[bit[i] >> 5] >> (uint32_t)(bit[i] & 31)) & 1;
  }
  if (all) return;
  bool ok = true;
  for (int i = 0; i < f.h; ++i)
    ok &= __ldg(f.totals + gp_nth_hash(base, i, f.kmul) % f.cbf_size) >= thr;
  if (!ok) return;
  for (int i = 0; i < f.h; ++i)
    atomicOr(f.words + (bit[i] >> 5), 1u << (uint32_t)(bit[i] & 31));
}

template <bool kPromote>
__global__ void __launch_bounds__(kThreads) bf_pass(Stream st, Fill f,
                                                    const uint64_t* __restrict__ tf,
                                                    const uint64_t* __restrict__ tr,
                                                    const uint8_t* __restrict__ fclass) {
  __shared__ GpWindowTables<kFillMaxK> s_t;
  __shared__ GpRollTables s_r;
  __shared__ uint8_t s_codes[kSpan + kFillMaxK - 1];

  const int k = f.k;
  const int64_t p0 = (int64_t)blockIdx.x * kSpan;
  gp_load_window_tables(s_t, k, tf, tr, fclass);
  for (int i = threadIdx.x; i < kSpan + k - 1; i += kThreads) {
    const int64_t p = p0 + i;
    s_codes[i] = p < st.n ? st.codes[p] : 0;
  }
  __syncthreads();
  gp_load_roll_tables(s_r, s_t, k);
  __syncthreads();

  const int i0 = threadIdx.x * kRun;
  const int64_t p = p0 + i0, nw = st.n - k + 1;
  if (p >= nw) return;
  // the read holding p: the last r with offsets[r] <= p
  int64_t r = 0, hi = st.n_reads - 1;
  while (r < hi) {
    const int64_t mid = (r + hi + 1) >> 1;
    if (st.offsets[mid] <= p) r = mid; else hi = mid - 1;
  }
  int64_t end = st.offsets[r + 1];
  int thr = kPromote ? max((int)st.thrs[r] + f.delta, 1) : 0;
  uint64_t fh, rh;
  const uint8_t* s = s_codes + i0;
  gp_window_hash(s_t, k, [s](int j) { return s[j]; }, fh, rh);
  const int m = nw - p < kRun ? (int)(nw - p) : kRun;
  for (int i = 0;;) {
    const int64_t q = p + i;
    while (end <= q) {  // q < nw <= offsets[n_reads]: r stays in range
      end = st.offsets[++r + 1];
      if (kPromote) thr = max((int)st.thrs[r] + f.delta, 1);
    }
    if (q + k <= end) visit<kPromote>(f, fh + rh, thr);
    if (++i == m) break;
    gp_roll(s_r, fh, rh, s[i - 1], s[i - 1 + k]);
  }
}

template <bool kPromote>
int launch(const void* codes, int64_t n, const void* offsets, int64_t n_reads,
           const void* thrs, int k, int delta, const void* tf, const void* tr,
           const void* fclass, int h, uint64_t kmul, uint64_t cbf_size, void* totals,
           uint64_t bits, void* words, void* stream) {
  if (k < 1 || k > kFillMaxK || n_reads < 1 || n < k || h < 1 || h > kMaxH || cbf_size == 0 ||
      (kPromote && bits == 0))
    return (int)cudaErrorInvalidValue;
  const int64_t nw = n - k + 1;
  const Stream st{(const uint8_t*)codes, n, (const int64_t*)offsets, n_reads,
                  (const uint8_t*)thrs};
  const Fill f{k, delta, h, kmul, cbf_size, bits, (int32_t*)totals, (uint32_t*)words};
  bf_pass<kPromote><<<(unsigned)((nw + kSpan - 1) / kSpan), kThreads, 0,
                      (cudaStream_t)stream>>>(st, f, (const uint64_t*)tf,
                                              (const uint64_t*)tr, (const uint8_t*)fclass);
  return (int)cudaGetLastError();
}

}  // namespace

// Pass A.  codes: uint8[n] (the reads concatenated), n >= k; offsets:
// int64[n_reads + 1], strictly rising, offsets[0] = 0, offsets[n_reads] = n;
// tf, tr, fclass: kernel 2's scan tables for k; kmul = k * MULTI_SEED (mod
// 2^64).  totals int32[cbf_size] += 1 at each of the h slots of every valid
// window.
extern "C" int gp_bf_count(const void* codes, int64_t n, const void* offsets,
                           int64_t n_reads, int k, const void* tf, const void* tr,
                           const void* fclass, int h, uint64_t kmul, uint64_t cbf_size,
                           void* totals, void* stream) {
  return launch<false>(codes, n, offsets, n_reads, nullptr, k, 0, tf, tr, fclass, h, kmul,
                       cbf_size, totals, 0, nullptr, stream);
}

// Pass B, after pass A over every window of the batch.  thrs: uint8[n_reads];
// words uint32[bits / 32] |= the h bits of every valid window whose smallest
// slot total is >= max(thrs[read] + delta, 1).
extern "C" int gp_bf_promote(const void* codes, int64_t n, const void* offsets,
                             int64_t n_reads, const void* thrs, int k, int delta,
                             const void* tf, const void* tr, const void* fclass, int h,
                             uint64_t kmul, uint64_t cbf_size, const void* totals,
                             uint64_t bits, void* words, void* stream) {
  return launch<true>(codes, n, offsets, n_reads, thrs, k, delta, tf, tr, fclass, h, kmul,
                      cbf_size, (void*)totals, bits, words, stream);
}
