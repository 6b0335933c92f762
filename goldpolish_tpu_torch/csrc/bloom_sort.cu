// Kernel 5 (K3): the sort-based device Bloom fill — per k, the canonical
// ntHash of every window of a batch's read stream, one representative per
// distinct k-mer with its occurrence count and smallest threshold, the
// h-fold counting-filter slot totals, and the promotion of every k-mer whose
// smallest slot total reaches its threshold into the plain filter's bits.
//
// Replaces: goldpolish_tpu/ops/bloom_sort.py, the XLA programs `_fill_k`
// (:245, single dispatch), `_count_k` (:268) and `_promote_k` (:292) of the
// chunked build, with `_stream_meta` (:114), `_stream_onehot_*` (:145,
// :167) and `_distinct_runs` (:177) inside them.  The plain torch versions
// are the `*_reference` functions of goldpolish_tpu_torch/ops/bloom_sort.py.
//
// The chain per k (one stream; the only host synchronisation is the run
// count, read back to size the representative arrays):
//   bs_keys        one thread per stream window p: valid iff the window
//                  lies inside its read (binary search of the read
//                  offsets); key = (fh + rh) with the sign bit flipped, so a
//                  signed sort is the unsigned hash order; threshold =
//                  max(thr[read] + delta, 1); an invalid window gets the pad
//                  key INT64_MAX and threshold 255
//   (torch.sort of the keys, then the thresholds gathered by its indices,
//    in the wrapper: the JAX program sorts with the compiler's sort too)
//   bs_run_flags   per block of the sorted keys: the count of run starts
//   bs_block_scan  one block: exclusive scan of the block counts, n_runs
//   bs_rep_init    rep count 0, rep threshold 255
//   bs_run_write   per element: its run id (block scan + block offset); a
//                  run start writes the run's key; a valid element adds 1
//                  to its run's count and takes the minimum threshold
//   bs_slot_add    one thread per live run: the h hashes, slot = hash mod
//                  cbf_size (full unsigned 64-bit), atomicAdd(count)
//   bs_promote     one thread per live run: the minimum total over its h
//                  slots; if >= the threshold, atomicOr its h bits (bit =
//                  hash & (bits-1) for a power-of-two bit count, else
//                  hash mod bits, in 64 bits)
// The chunked build runs bs_keys .. bs_slot_add per chunk and keeps each
// chunk's (key, threshold) representatives; the representatives of all
// chunks are then sorted and run through bs_run_flags .. bs_run_write
// again (dedupe, smallest threshold) and promoted against the global totals.
//
// Counting differs from the JAX program in one place: a run counts only
// valid windows.  In the JAX program a valid window whose hash is exactly
// 2^64 - 1 sorts into the pads' run and its count includes every pad of the
// halo'd row grid (bloom_sort.py:219-221); the port does not copy that.
//
// What bounds it on the H100: the sort.  Per k at the smoke's batch size
// (~11.6 M windows) the keys are 93 MB; torch.sort's radix passes move
// several times that through HBM, while bs_keys reads 11.6 MB of bases and
// writes 104 MB, and the run kernels read the sorted keys once more.  The
// slot and bit updates are random 4-byte atomics into a 40 MiB totals
// array and a 4 MiB filter, per distinct k-mer (D ~ N / coverage).
//
// What the simple design leaves for later: the rolling O(1) hash per window
// (the direct form costs 2k shared-memory loads), a hand radix sort of the
// keys with the thresholds packed beside them, and one exact open-addressing
// table (as kernel 3's visited set) in place of sort + runs.
#include <cuda_runtime.h>

#include <cstdint>

#include "block_scan.cuh"

namespace {

constexpr int kKeyThreads = 256;  // windows per block in bs_keys
constexpr int kRunThreads = 1024;  // sorted elements per block in the run kernels
constexpr int kThreads = 256;
constexpr int kMaxK = 64;
constexpr int kNoClass = 4;  // forward class of bytes without a seed
constexpr int64_t kPadKey = INT64_MAX;
constexpr uint64_t kSign = 1ull << 63;

__device__ __forceinline__ uint64_t nth_hash(uint64_t base, int i, uint64_t kmul) {
  if (!i) return base;
  const uint64_t t = base * ((uint64_t)i ^ kmul);
  return t ^ (t >> 27);
}

__global__ void bs_keys(const uint8_t* __restrict__ codes, int64_t n,
                        const int64_t* __restrict__ offsets, int64_t n_reads,
                        const uint8_t* __restrict__ thrs, int k, int delta,
                        const uint64_t* __restrict__ tf,
                        const uint64_t* __restrict__ tr,
                        const uint8_t* __restrict__ fclass,
                        int64_t* __restrict__ keys, uint8_t* __restrict__ thr_out) {
  __shared__ uint64_t s_tf[kMaxK * 5];
  __shared__ uint64_t s_tr[kMaxK * 8];
  __shared__ uint8_t s_cls[256];
  __shared__ uint8_t s_codes[kKeyThreads + kMaxK - 1];

  const int64_t p0 = (int64_t)blockIdx.x * kKeyThreads;
  for (int i = threadIdx.x; i < k * 5; i += blockDim.x) {
    const int j = i / 5, c = i % 5;
    s_tf[i] = c == kNoClass ? 0ull : tf[j * 4 + c];
  }
  for (int i = threadIdx.x; i < k * 8; i += blockDim.x) s_tr[i] = tr[i];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_cls[i] = fclass[i];
  for (int i = threadIdx.x; i < kKeyThreads + k - 1; i += blockDim.x) {
    const int64_t p = p0 + i;
    s_codes[i] = p < n ? codes[p] : 0;
  }
  __syncthreads();

  const int64_t p = p0 + threadIdx.x;
  if (p >= n) return;
  // the read holding p: the last r with offsets[r] <= p (offsets rise
  // strictly: empty reads were dropped on the host)
  int64_t lo = 0, hi = n_reads - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    if (offsets[mid] <= p) lo = mid; else hi = mid - 1;
  }
  int64_t key = kPadKey;
  int thr = 255;
  if (p + k <= offsets[lo + 1]) {
    uint64_t fh = 0, rh = 0;
    for (int j = 0; j < k; ++j) {
      const uint8_t c = s_codes[threadIdx.x + j];
      fh ^= s_tf[j * 5 + s_cls[c]];
      rh ^= s_tr[j * 8 + (c & 7)];
    }
    key = (int64_t)((fh + rh) ^ kSign);
    thr = (int)thrs[lo] + delta;
    thr = thr < 1 ? 1 : thr;
  }
  keys[p] = key;
  thr_out[p] = (uint8_t)thr;
}

__device__ __forceinline__ bool run_start(const int64_t* keys, int64_t n, int64_t i) {
  return i < n && (i == 0 || keys[i] != keys[i - 1]);
}

__global__ void bs_run_flags(const int64_t* __restrict__ keys, int64_t n,
                             int32_t* __restrict__ blk_cnt) {
  const int64_t i = (int64_t)blockIdx.x * kRunThreads + threadIdx.x;
  const int c = __syncthreads_count(run_start(keys, n, i));
  if (threadIdx.x == 0) blk_cnt[blockIdx.x] = c;
}

__global__ void bs_block_scan(int64_t nblk, const int32_t* __restrict__ blk_cnt,
                              int32_t* __restrict__ blk_off,
                              int32_t* __restrict__ n_runs) {
  int carry = 0;
  for (int64_t base = 0; base < nblk; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    int total;
    const int e = gp_block_exclusive_scan(i < nblk ? blk_cnt[i] : 0, &total);
    if (i < nblk) blk_off[i] = carry + e;
    carry += total;
  }
  if (threadIdx.x == 0) *n_runs = carry;
}

__global__ void bs_rep_init(int64_t m, int32_t* __restrict__ cnt,
                            int32_t* __restrict__ thr) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m) return;
  cnt[r] = 0;
  thr[r] = 255;
}

__global__ void bs_run_write(const int64_t* __restrict__ keys,
                             const uint8_t* __restrict__ thr, int64_t n,
                             const int32_t* __restrict__ blk_off,
                             int64_t* __restrict__ rep_key,
                             int32_t* __restrict__ rep_cnt,
                             int32_t* __restrict__ rep_thr) {
  const int64_t i = (int64_t)blockIdx.x * kRunThreads + threadIdx.x;
  const int s = run_start(keys, n, i);
  int total;
  const int excl = gp_block_exclusive_scan(s, &total);
  if (i >= n) return;
  const int64_t rid = (int64_t)blk_off[blockIdx.x] + excl + s - 1;
  if (s) rep_key[rid] = keys[i];
  const int t = thr[i];
  if (t < 255) {
    atomicAdd(rep_cnt + rid, 1);
    atomicMin(rep_thr + rid, t);
  }
}

__global__ void bs_slot_add(const int64_t* __restrict__ rep_key,
                            const int32_t* __restrict__ rep_cnt, int64_t m, int h,
                            uint64_t kmul, uint64_t cbf_size,
                            int32_t* __restrict__ totals) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m) return;
  const int c = rep_cnt[r];
  if (c <= 0) return;
  const uint64_t base = (uint64_t)rep_key[r] ^ kSign;
  for (int i = 0; i < h; ++i) atomicAdd(totals + nth_hash(base, i, kmul) % cbf_size, c);
}

__global__ void bs_promote(const int64_t* __restrict__ rep_key,
                           const int32_t* __restrict__ rep_cnt,
                           const int32_t* __restrict__ rep_thr, int64_t m, int h,
                           uint64_t kmul, uint64_t cbf_size,
                           const int32_t* __restrict__ totals, uint64_t bits,
                           unsigned int* __restrict__ words) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m || rep_cnt[r] <= 0) return;
  const uint64_t base = (uint64_t)rep_key[r] ^ kSign;
  int mn = INT32_MAX;
  for (int i = 0; i < h; ++i) {
    const int t = totals[nth_hash(base, i, kmul) % cbf_size];
    mn = t < mn ? t : mn;
  }
  if (mn < rep_thr[r]) return;
  const bool pow2 = (bits & (bits - 1)) == 0;
  for (int i = 0; i < h; ++i) {
    const uint64_t hv = nth_hash(base, i, kmul);
    const uint64_t b = pow2 ? (hv & (bits - 1)) : (hv % bits);
    atomicOr(words + (b >> 5), 1u << (unsigned)(b & 31));
  }
}

int64_t blocks(int64_t n, int per) { return (n + per - 1) / per; }

}  // namespace

// codes: uint8[n] (the reads concatenated); offsets: int64[n_reads + 1],
// strictly rising, offsets[0] = 0, offsets[n_reads] = n; thrs: uint8[n_reads];
// tf, tr, fclass: kernel 2's scan tables for k.  Writes keys int64[n] and
// thr uint8[n].
extern "C" int gp_bs_keys(const void* codes, int64_t n, const void* offsets,
                          int64_t n_reads, const void* thrs, int k, int delta,
                          const void* tf, const void* tr, const void* fclass,
                          void* keys, void* thr, void* stream) {
  if (k < 1 || k > kMaxK || n_reads < 1 || n < 1) return (int)cudaErrorInvalidValue;
  bs_keys<<<(unsigned)blocks(n, kKeyThreads), kKeyThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, n, (const int64_t*)offsets, n_reads, (const uint8_t*)thrs,
      k, delta, (const uint64_t*)tf, (const uint64_t*)tr, (const uint8_t*)fclass,
      (int64_t*)keys, (uint8_t*)thr);
  return (int)cudaGetLastError();
}

// Sorted keys int64[n] -> blk_off int32[ceil(n / 1024)] (exclusive run
// counts per block; blk_cnt is scratch of the same size) and n_runs int32[1].
extern "C" int gp_bs_run_count(const void* keys, int64_t n, void* blk_cnt,
                               void* blk_off, void* n_runs, void* stream) {
  if (n < 1 || n >= (int64_t)INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t nblk = blocks(n, kRunThreads);
  bs_run_flags<<<(unsigned)nblk, kRunThreads, 0, st>>>((const int64_t*)keys, n,
                                                      (int32_t*)blk_cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bs_block_scan<<<1, kRunThreads, 0, st>>>(nblk, (const int32_t*)blk_cnt,
                                          (int32_t*)blk_off, (int32_t*)n_runs);
  return (int)cudaGetLastError();
}

// One representative per run of the sorted keys: rep_key int64[m], rep_cnt
// int32[m] (valid elements: thr < 255), rep_thr int32[m] (their smallest
// threshold, 255 if none); m = n_runs from gp_bs_run_count.
extern "C" int gp_bs_run_write(const void* keys, const void* thr, int64_t n,
                               const void* blk_off, int64_t m, void* rep_key,
                               void* rep_cnt, void* rep_thr, void* stream) {
  if (n < 1 || m < 1 || m > n) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  bs_rep_init<<<(unsigned)blocks(m, kThreads), kThreads, 0, st>>>(
      m, (int32_t*)rep_cnt, (int32_t*)rep_thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bs_run_write<<<(unsigned)blocks(n, kRunThreads), kRunThreads, 0, st>>>(
      (const int64_t*)keys, (const uint8_t*)thr, n, (const int32_t*)blk_off,
      (int64_t*)rep_key, (int32_t*)rep_cnt, (int32_t*)rep_thr);
  return (int)cudaGetLastError();
}

// totals int32[cbf_size] += rep_cnt at the h slots of every live
// representative; kmul = k * MULTI_SEED (mod 2^64).
extern "C" int gp_bs_slot_add(const void* rep_key, const void* rep_cnt, int64_t m,
                              int h, uint64_t kmul, uint64_t cbf_size, void* totals,
                              void* stream) {
  if (m < 1 || h < 1 || cbf_size == 0) return (int)cudaErrorInvalidValue;
  bs_slot_add<<<(unsigned)blocks(m, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)rep_key, (const int32_t*)rep_cnt, m, h, kmul, cbf_size,
      (int32_t*)totals);
  return (int)cudaGetLastError();
}

// words uint32[bits / 32] |= the h bits of every live representative whose
// smallest slot total is >= its threshold.
extern "C" int gp_bs_promote(const void* rep_key, const void* rep_cnt,
                             const void* rep_thr, int64_t m, int h, uint64_t kmul,
                             uint64_t cbf_size, const void* totals, uint64_t bits,
                             void* words, void* stream) {
  if (m < 1 || h < 1 || cbf_size == 0 || bits == 0) return (int)cudaErrorInvalidValue;
  bs_promote<<<(unsigned)blocks(m, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)rep_key, (const int32_t*)rep_cnt, (const int32_t*)rep_thr, m, h,
      kmul, cbf_size, (const int32_t*)totals, bits, (unsigned int*)words);
  return (int)cudaGetLastError();
}
