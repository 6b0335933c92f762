// Port counterpart: goldpolish_tpu/native/gp_native.cpp, copied unchanged
// but for gp_pack2, which writes whole packed bytes (no zeroed output), and
// gp_konnect_pairs (the sealer's host search for one k round), which the
// JAX package lacks.
// gp_native — native host kernels for goldpolish_tpu_torch.
//
// The reference keeps its data-plane hot loops native (SeqIndex scan:
// src/seqindex.cpp; Bloom fill: src/utils.cpp:96-123 with btllib ntHash);
// this library provides the TPU framework's equivalents, exposed through a
// plain C ABI consumed via ctypes (no pybind11 in the build environment).
//
// Everything here is a from-scratch implementation:
//  * ntHash v1 recurrences re-derived from the published scheme
//    (reference: subprojects/ntedit/lib/nthash.hpp) — same constants, our
//    own code,
//  * conservative-update 8-bit counting Bloom + plain Bloom fill with the
//    reference's per-k escalating threshold,
//  * FASTA/FASTQ linear-scan indexer with byte offsets + mean phred
//    (2-line FASTA / 4-line FASTQ framing, like the reference indexer).
//
// Build: see build.py (g++ -O3 -shared -fPIC -fopenmp).

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <deque>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr uint64_t SEED_A = 0x3c8bfbb395c60474ULL;
constexpr uint64_t SEED_C = 0x3193c18562a02b4cULL;
constexpr uint64_t SEED_G = 0x20323ed082572324ULL;
constexpr uint64_t SEED_T = 0x295549f54be24456ULL;
constexpr uint64_t MULTI_SEED = 0x90b45d39fb6da1faULL;
constexpr int MULTI_SHIFT = 27;
constexpr uint64_t M33 = 0x1FFFFFFFFULL;
constexpr uint64_t M31 = 0x7FFFFFFFULL;

struct SeedTabs {
  uint64_t fwd[256];
  uint64_t rc[256];
  SeedTabs() {
    std::memset(fwd, 0, sizeof(fwd));
    fwd[1] = SEED_T;
    fwd[3] = SEED_G;
    fwd[4] = SEED_A;
    fwd[7] = SEED_C;
    fwd['A'] = fwd['a'] = SEED_A;
    fwd['C'] = fwd['c'] = SEED_C;
    fwd['G'] = fwd['g'] = SEED_G;
    fwd['T'] = fwd['t'] = SEED_T;
    for (int c = 0; c < 256; c++) rc[c] = fwd[c & 0x07];
  }
};
const SeedTabs kSeeds;

// split-rotate left by 1: independent rotations of the 31-bit high field
// and the 33-bit low field.
inline uint64_t srol(uint64_t v) {
  uint64_t hi = v >> 33, lo = v & M33;
  hi = ((hi << 1) | (hi >> 30)) & M31;
  lo = ((lo << 1) | (lo >> 32)) & M33;
  return (hi << 33) | lo;
}

inline uint64_t srol_n(uint64_t v, unsigned n) {
  unsigned s31 = n % 31, s33 = n % 33;
  uint64_t hi = v >> 33, lo = v & M33;
  hi = ((hi << s31) | (hi >> (31 - s31))) & M31;
  lo = ((lo << s33) | (lo >> (33 - s33))) & M33;
  return (hi << 33) | lo;
}

// split-rotate right by n (inverse of srol_n; the reverse-strand hash's
// per-roll transform is one right-rotation, so its n-step power is this)
inline uint64_t sror_n(uint64_t v, unsigned n) {
  unsigned s31 = n % 31, s33 = n % 33;
  uint64_t hi = v >> 33, lo = v & M33;
  hi = ((hi >> s31) | (hi << (31 - s31))) & M31;
  lo = ((lo >> s33) | (lo << (33 - s33))) & M33;
  return (hi << 33) | lo;
}

inline void multi_hash(uint64_t base, unsigned k, unsigned m, uint64_t* out) {
  out[0] = base;
  for (unsigned i = 1; i < m; i++) {
    uint64_t t = base * ((uint64_t)i ^ ((uint64_t)k * MULTI_SEED));
    t ^= t >> MULTI_SHIFT;
    out[i] = t;
  }
}

// h mod bits, with the power-of-two case (the autoscaled production
// filters) reduced to a mask: the generic 64-bit div costs ~20+ cycles and
// shows up in every fill/probe inner loop.
inline uint64_t bf_reduce(uint64_t h, uint64_t bits) {
  return (bits & (bits - 1)) == 0 ? (h & (bits - 1)) : (h % bits);
}

inline bool bf_contains(const uint8_t* arr, uint64_t bits, const uint64_t* hashes,
                        unsigned m) {
  for (unsigned i = 0; i < m; i++) {
    uint64_t b = bf_reduce(hashes[i], bits);
    if (!((arr[b >> 3] >> (b & 7)) & 1)) return false;
  }
  return true;
}

inline void bf_insert(uint8_t* arr, uint64_t bits, const uint64_t* hashes,
                      unsigned m) {
  for (unsigned i = 0; i < m; i++) {
    uint64_t b = bf_reduce(hashes[i], bits);
    arr[b >> 3] |= (uint8_t)(1u << (b & 7));
  }
}

// conservative-update insert capped at threshold; returns resulting count.
inline unsigned cbf_insert_thresh(uint8_t* counters, uint64_t size,
                                  const uint64_t* hashes, unsigned m,
                                  unsigned threshold) {
  uint64_t idx[16];
  uint8_t mn = 255;
  for (unsigned i = 0; i < m; i++) {
    idx[i] = bf_reduce(hashes[i], size);
    if (counters[idx[i]] < mn) mn = counters[idx[i]];
  }
  if (mn >= threshold) return mn;
  for (unsigned i = 0; i < m; i++)
    if (counters[idx[i]] == mn) counters[idx[i]] = (uint8_t)(mn + 1);
  return mn + 1;
}

// One read's fill for ONE k: the prefetch-pipelined CBF->BF insert loop
// (reference src/utils.cpp:108-121 for a single k of the sweep).  Shared by
// gp_fill_bfs (per-k omp branch) and gp_fill_bfs_stream.
inline void fill_read_one_k(const uint8_t* seq, int64_t seq_len, uint32_t k,
                            unsigned thresh, uint32_t hash_num, uint8_t* cbf,
                            uint64_t cbf_bytes, uint8_t* bf, uint64_t bf_bits,
                            int32_t skip_promoted) {
  if (seq_len < (int64_t)k) return;
  uint64_t fh = 0, rh = 0;
  for (uint32_t i = 0; i < k; i++) fh = srol(fh) ^ kSeeds.fwd[seq[i]];
  for (uint32_t i = 0; i < k; i++) rh = srol(rh) ^ kSeeds.rc[seq[k - 1 - i]];
  // The fill is random-access bound: every k-mer touches hash_num CBF
  // and/or BF cache lines that are almost never resident.  Pipeline the
  // loop with a lookahead ring — hash position w+D and prefetch its slots
  // while the filter work for position w-D runs on lines already in flight.
  constexpr int64_t D = 8;
  uint64_t ring[D][16];
  const int64_t n_win = seq_len - (int64_t)k + 1;
  for (int64_t w = 0; w < n_win + D; w++) {
    const int64_t p = w - D;
    if (p >= 0) {
      const uint64_t* hs = ring[p % D];
      // skip_promoted: once a k-mer's bits all read set, further CBF
      // counting cannot change the final BF array (see gp_fill_bfs).
      if (!skip_promoted || !bf_contains(bf, bf_bits, hs, hash_num)) {
        if (cbf_insert_thresh(cbf, cbf_bytes, hs, hash_num, thresh) >= thresh)
          bf_insert(bf, bf_bits, hs, hash_num);
      }
    }
    if (w < n_win) {
      uint64_t* slot = ring[w % D];
      multi_hash(fh + rh, k, hash_num, slot);
      for (uint32_t i = 0; i < hash_num; i++) {
        __builtin_prefetch(&bf[bf_reduce(slot[i], bf_bits) >> 3], 0, 1);
        __builtin_prefetch(&cbf[bf_reduce(slot[i], cbf_bytes)], 1, 1);
      }
      if (w + 1 < n_win) {
        uint8_t out_c = seq[w], in_c = seq[w + k];
        fh = srol(fh) ^ kSeeds.fwd[in_c] ^ srol_n(kSeeds.fwd[out_c], k);
        uint64_t v = rh ^ srol_n(kSeeds.rc[in_c], k) ^ kSeeds.rc[out_c];
        uint64_t hi = v >> 33, lo = v & M33;
        hi = ((hi >> 1) | (hi << 30)) & M31;
        lo = ((lo >> 1) | (lo << 32)) & M33;
        rh = (hi << 33) | lo;
      }
    }
  }
}

}  // namespace

extern "C" {

// Canonical multi-hash of every k-window of seq -> out[n_windows * hash_num].
// Rolling recurrence, sequential — used for oracle checks and host builds.
void gp_nthash_all(const uint8_t* seq, int64_t n, uint32_t k, uint32_t hash_num,
                   uint64_t* out) {
  if (n < (int64_t)k) return;
  uint64_t fh = 0, rh = 0;
  for (uint32_t i = 0; i < k; i++) fh = srol(fh) ^ kSeeds.fwd[seq[i]];
  for (uint32_t i = 0; i < k; i++) rh = srol(rh) ^ kSeeds.rc[seq[k - 1 - i]];
  multi_hash(fh + rh, k, hash_num, out);
  const uint64_t m33 = M33, m31 = M31;
  (void)m33;
  (void)m31;
  for (int64_t w = 1; w <= n - (int64_t)k; w++) {
    uint8_t out_c = seq[w - 1], in_c = seq[w + k - 1];
    fh = srol(fh) ^ kSeeds.fwd[in_c] ^ srol_n(kSeeds.fwd[out_c], k);
    // reverse: rh' = sror(rh ^ srol_k(rc[in]) ^ rc[out])
    uint64_t v = rh ^ srol_n(kSeeds.rc[in_c], k) ^ kSeeds.rc[out_c];
    {  // sror
      uint64_t hi = v >> 33, lo = v & M33;
      hi = ((hi >> 1) | (hi << 30)) & M31;
      lo = ((lo >> 1) | (lo << 32)) & M33;
      rh = (hi << 33) | lo;
    }
    multi_hash(fh + rh, k, hash_num, out + (uint64_t)w * hash_num);
  }
}

// The reference fill loop (src/utils.cpp:96-123): per k (escalating
// threshold), insert every k-mer of the read into the counting BF and
// promote to the plain BF at the threshold.
// cbf_arrays[i] has cbf_bytes counters; bf_arrays[i] has bf_bytes bytes.
// Returns 0 on success, -1 on bad args.
int gp_fill_bfs(const uint8_t* seq, int64_t seq_len, uint32_t hash_num,
                const uint32_t* k_values, uint32_t num_k,
                uint32_t kmer_threshold, uint8_t** cbf_arrays,
                uint64_t cbf_bytes, uint8_t** bf_arrays, uint64_t bf_bytes,
                int32_t skip_promoted) {
  if (kmer_threshold < 4 || hash_num > 16) return -1;
  const uint64_t bf_bits = bf_bytes * 8;
  // Single-thread case (fork-pool workers pin OpenMP to 1 thread): fuse
  // the k sweep into ONE pass with per-k interleaved rolling states.  The
  // k streams touch disjoint filters, so each k's conservative-update
  // order is untouched (bit-identical to the serial sweep), while the
  // independent dependency chains overlap their cache misses.
#ifdef _OPENMP
  bool fuse = num_k > 1 && num_k <= 8 && omp_get_max_threads() <= 1;
#else
  bool fuse = num_k > 1 && num_k <= 8;
#endif
  if (fuse && std::getenv("GPTPU_NO_FUSED_FILL")) fuse = false;
  if (fuse) {
    constexpr int64_t D = 4;
    struct KState {
      uint64_t fh = 0, rh = 0;
      uint64_t ring[D][16];
      int64_t n_win = 0;
      unsigned thresh = 0;
      uint8_t* cbf = nullptr;
      uint8_t* bf = nullptr;
      uint32_t k = 0;
    };
    KState ks[8];
    int64_t max_win = 0;
    for (uint32_t ki = 0; ki < num_k; ki++) {
      KState& s = ks[ki];
      s.k = k_values[ki];
      s.thresh = kmer_threshold - 2 + ki;
      s.cbf = cbf_arrays[ki];
      s.bf = bf_arrays[ki];
      s.n_win = seq_len - (int64_t)s.k + 1;
      if (s.n_win < 0) s.n_win = 0;
      if (s.n_win > max_win) max_win = s.n_win;
      if (s.n_win) {
        for (uint32_t i = 0; i < s.k; i++) {
          s.fh = srol(s.fh) ^ kSeeds.fwd[seq[i]];
          s.rh = srol(s.rh) ^ kSeeds.rc[seq[s.k - 1 - i]];
        }
      }
    }
    for (int64_t w = 0; w < max_win + D; w++) {
      const int64_t p = w - D;
      for (uint32_t ki = 0; ki < num_k; ki++) {
        KState& s = ks[ki];
        if (p >= 0 && p < s.n_win) {
          const uint64_t* hs = s.ring[p % D];
          if (!skip_promoted || !bf_contains(s.bf, bf_bits, hs, hash_num)) {
            if (cbf_insert_thresh(s.cbf, cbf_bytes, hs, hash_num, s.thresh) >=
                s.thresh)
              bf_insert(s.bf, bf_bits, hs, hash_num);
          }
        }
        if (w < s.n_win) {
          uint64_t* slot = s.ring[w % D];
          multi_hash(s.fh + s.rh, s.k, hash_num, slot);
          for (uint32_t i = 0; i < hash_num; i++) {
            __builtin_prefetch(&s.bf[bf_reduce(slot[i], bf_bits) >> 3], 0, 1);
            __builtin_prefetch(&s.cbf[bf_reduce(slot[i], cbf_bytes)], 1, 1);
          }
          if (w + 1 < s.n_win) {
            const uint8_t out_c = seq[w], in_c = seq[w + s.k];
            s.fh = srol(s.fh) ^ kSeeds.fwd[in_c] ^
                   srol_n(kSeeds.fwd[out_c], s.k);
            uint64_t v = s.rh ^ srol_n(kSeeds.rc[in_c], s.k) ^
                         kSeeds.rc[out_c];
            uint64_t hi = v >> 33, lo = v & M33;
            hi = ((hi >> 1) | (hi << 30)) & M31;
            lo = ((lo >> 1) | (lo << 32)) & M33;
            s.rh = (hi << 33) | lo;
          }
        }
      }
    }
    return 0;
  }
  // per-k filters are independent: parallelize the k sweep (each thread
  // owns its own CBF/BF pair, so the conservative-update order within a
  // read stays sequential per k -> bit-identical to the serial loop)
#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1)
#endif
  for (uint32_t ki = 0; ki < num_k; ki++) {
    fill_read_one_k(seq, seq_len, k_values[ki], kmer_threshold - 2 + ki,
                    hash_num, cbf_arrays[ki], cbf_bytes, bf_arrays[ki],
                    bf_bits, skip_promoted);
  }
  return 0;
}

// Batch fill: a whole read set in one call.  seqs = concatenated read bytes;
// offsets[i]..offsets[i+1] delimit read i (offsets has n_reads+1 entries);
// thresholds[i] is read i's adaptive k-mer threshold (per-target regression,
// reference goldpolish_targeted_bfs.cpp:45-53 — reads arrive in target
// order, each carrying its target's threshold).  Parallelism is ACROSS k
// (one thread per k owns its CBF/BF pair and replays every read in order,
// so the per-filter conservative-update order is byte-identical to the
// serial sweep), with threads living for the whole batch instead of one
// omp region per read (reference does one omp task per batch,
// goldpolish_targeted_bfs.cpp:177-192).
int gp_fill_bfs_stream(const uint8_t* seqs, const int64_t* offsets,
                       int64_t n_reads, const uint32_t* thresholds,
                       uint32_t hash_num, const uint32_t* k_values,
                       uint32_t num_k, uint8_t** cbf_arrays,
                       uint64_t cbf_bytes, uint8_t** bf_arrays,
                       uint64_t bf_bytes, int32_t skip_promoted) {
  if (hash_num > 16) return -1;
  for (int64_t r = 0; r < n_reads; r++)
    if (thresholds[r] < 4) return -1;
  const uint64_t bf_bits = bf_bytes * 8;
#ifdef _OPENMP
  // Single-thread case (fork-pool workers pin OpenMP to 1 thread and must
  // not enter a parallel region post-fork): delegate per read to
  // gp_fill_bfs, whose region-free fused multi-k path interleaves the k
  // streams' cache misses.
  if (omp_get_max_threads() <= 1) {
#else
  if (true) {
#endif
    for (int64_t r = 0; r < n_reads; r++) {
      int rc = gp_fill_bfs(seqs + offsets[r], offsets[r + 1] - offsets[r],
                           hash_num, k_values, num_k, thresholds[r],
                           cbf_arrays, cbf_bytes, bf_arrays, bf_bytes,
                           skip_promoted);
      if (rc != 0) return rc;
    }
    return 0;
  }
#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1)
#endif
  for (uint32_t ki = 0; ki < num_k; ki++) {
    const uint32_t k = k_values[ki];
    uint8_t* cbf = cbf_arrays[ki];
    uint8_t* bf = bf_arrays[ki];
    for (int64_t r = 0; r < n_reads; r++) {
      fill_read_one_k(seqs + offsets[r], offsets[r + 1] - offsets[r], k,
                      thresholds[r] - 2 + ki, hash_num, cbf, cbf_bytes, bf,
                      bf_bits, skip_promoted);
    }
  }
  return 0;
}

// Minimizer selection over all-window hashes (mapper.minimizer_sketch's
// identity): out[i] = 1 iff max over windows covering i of the per-window
// min equals h[i].  Two O(n) van Herk passes (block prefix/suffix scans).
void gp_minimizer_select(const uint64_t* h, int64_t n, int32_t w,
                         uint8_t* out) {
  if (n <= 0) return;
  if (n <= w) {
    // single window: first argmin
    int64_t best = 0;
    for (int64_t i = 1; i < n; i++)
      if (h[i] < h[best]) best = i;
    std::memset(out, 0, n);
    out[best] = 1;
    return;
  }
  const int64_t nw = n - w + 1;  // windows
  std::vector<uint64_t> wmin(nw);
  {
    std::vector<uint64_t> pre(n), suf(n);
    for (int64_t b = 0; b < n; b += w) {
      const int64_t e = std::min(b + w, n);
      pre[b] = h[b];
      for (int64_t i = b + 1; i < e; i++)
        pre[i] = std::min(pre[i - 1], h[i]);
      suf[e - 1] = h[e - 1];
      for (int64_t i = e - 2; i >= b; i--)
        suf[i] = std::min(suf[i + 1], h[i]);
    }
    for (int64_t i = 0; i < nw; i++)
      wmin[i] = std::min(suf[i], pre[i + w - 1]);
  }
  // cover_max[i] = max of wmin[j], j in [i-w+1, i] ∩ [0, nw)
  const int64_t np_ = nw + 2 * (w - 1);
  std::vector<uint64_t> pad(np_, 0), pre(np_), suf(np_);
  std::copy(wmin.begin(), wmin.end(), pad.begin() + (w - 1));
  for (int64_t b = 0; b < np_; b += w) {
    const int64_t e = std::min(b + w, np_);
    pre[b] = pad[b];
    for (int64_t i = b + 1; i < e; i++)
      pre[i] = std::max(pre[i - 1], pad[i]);
    suf[e - 1] = pad[e - 1];
    for (int64_t i = e - 2; i >= b; i--)
      suf[i] = std::max(suf[i + 1], pad[i]);
  }
  for (int64_t i = 0; i < n; i++) {
    const uint64_t cm = std::max(suf[i], pre[i + w - 1]);
    out[i] = (cm == h[i]) ? 1 : 0;
  }
}

// Batched membership probe: hashes[n * hash_num] against a plain BF.
void gp_bf_contains(const uint8_t* bf, uint64_t bf_bytes, uint32_t hash_num,
                    const uint64_t* hashes, int64_t n, uint8_t* out) {
  const uint64_t bits = bf_bytes * 8;
  for (int64_t i = 0; i < n; i++)
    out[i] = bf_contains(bf, bits, hashes + (uint64_t)i * hash_num, hash_num)
                 ? 1
                 : 0;
}

// FASTA/FASTQ linear-scan indexer (reference: src/seqindex.cpp:12-66).
// Writes a TSV: id \t seq_start_byte \t seq_len \t phred_avg.
// FASTA is assumed 2-line-per-record, FASTQ 4-line (like the reference).
// phred_avg averages quals[0 .. len-2] (reference passes line.size()-1 as
// the length argument, seqindex.cpp:45).
int gp_seqindex_build(const char* seqs_path, const char* out_tsv) {
  FILE* in = std::fopen(seqs_path, "rb");
  if (!in) return -1;
  FILE* out = std::fopen(out_tsv, "w");
  if (!out) {
    std::fclose(in);
    return -2;
  }
  int first = std::fgetc(in);
  bool fastq = (first == '@');
  std::fseek(in, 0, SEEK_SET);
  std::string line;
  line.reserve(1 << 20);
  char buf[1 << 20];
  int64_t byte = 0, i = 0, id_endbyte = 0, seq_start = 0, seq_len = 0;
  std::string id;
  while (std::fgets(buf, sizeof(buf), in)) {
    size_t got = std::strlen(buf);
    line.assign(buf, got);
    while (got == sizeof(buf) - 1 && buf[got - 1] != '\n' &&
           std::fgets(buf, sizeof(buf), in)) {
      got = std::strlen(buf);
      line.append(buf, got);
    }
    bool had_nl = !line.empty() && line.back() == '\n';
    if (had_nl) line.pop_back();
    const int64_t endbyte = byte + (int64_t)line.size();
    if (fastq) {
      if (i % 4 == 0) {
        id_endbyte = endbyte;
        size_t sp = line.find_first_of(" \t");
        id = line.substr(1, sp == std::string::npos ? std::string::npos : sp - 1);
      } else if (i % 4 == 1) {
        seq_start = id_endbyte + 1;
        seq_len = endbyte - id_endbyte - 1;
      } else if (i % 4 == 3) {
        double phred = 0.0;
        const size_t qlen = line.size() > 0 ? line.size() - 1 : 0;
        for (size_t q = 0; q < qlen; q++) phred += (double)(line[q] - 33);
        if (qlen) phred /= (double)qlen;
        std::fprintf(out, "%s\t%lld\t%lld\t%g\n", id.c_str(),
                     (long long)seq_start, (long long)seq_len, phred);
      }
    } else {
      if (i % 2 == 0) {
        id_endbyte = endbyte;
        size_t sp = line.find(' ');
        id = line.substr(1, sp == std::string::npos ? std::string::npos : sp - 1);
      } else {
        std::fprintf(out, "%s\t%lld\t%lld\t%g\n", id.c_str(),
                     (long long)(id_endbyte + 1),
                     (long long)(endbyte - id_endbyte - 1), 0.0);
      }
    }
    byte = endbyte + (had_nl ? 1 : 0);
    i++;
  }
  std::fclose(in);
  std::fclose(out);
  return 0;
}

}  // extern "C"

namespace {

// canonical multi-hash of the first k bases of `buf`, then helpers to roll.
struct RollState {
  uint64_t fh = 0, rh = 0;
  void seed(const uint8_t* buf, uint32_t k) {
    fh = rh = 0;
    for (uint32_t i = 0; i < k; i++) {
      fh = srol(fh) ^ kSeeds.fwd[buf[i]];
      rh = srol(rh) ^ kSeeds.rc[buf[k - 1 - i]];
    }
  }
  void roll(uint8_t out_c, uint8_t in_c, uint32_t k) {
    fh = srol(fh) ^ kSeeds.fwd[in_c] ^ srol_n(kSeeds.fwd[out_c], k);
    uint64_t v = rh ^ srol_n(kSeeds.rc[in_c], k) ^ kSeeds.rc[out_c];
    uint64_t hi = v >> 33, lo = v & M33;
    hi = ((hi >> 1) | (hi << 30)) & M31;
    lo = ((lo >> 1) | (lo << 32)) & M33;
    rh = (hi << 33) | lo;
  }
  bool probe(const uint8_t* bf, uint64_t bits, uint32_t k, uint32_t m) const {
    uint64_t hs[16];
    multi_hash(fh + rh, k, m, hs);
    // prefetch all slots before the first dependent read (an all-present
    // tuple otherwise pays m chained miss latencies)
    uint64_t b[16];
    for (uint32_t i = 0; i < m; i++) {
      b[i] = bf_reduce(hs[i], bits);
      __builtin_prefetch(&bf[b[i] >> 3], 0, 3);
    }
    for (uint32_t i = 0; i < m; i++)
      if (!((bf[b[i] >> 3] >> (b[i] & 7)) & 1)) return false;
    return true;
  }
};

// count probes of patch windows listed in j[] (ascending); patch has plen
// bytes; jmax_valid bounds the usable window index (-1 = no bound).
// bail_needed: the smallest count that can still pass the accept rule; once
// cnt + remaining checks < bail_needed the candidate is rejected whatever
// the remaining probes say, and any value below the threshold is
// decision-equivalent (accepted-first comparison logic), so we stop early.
inline int count_patch_probes(const uint8_t* patch, int plen, uint32_t k,
                              uint32_t m, const uint8_t* bf, uint64_t bits,
                              const int32_t* j, int nj, int64_t max_j,
                              int bail_needed = 0) {
  RollState st;
  st.seed(patch, k);
  int cnt = 0, ji = 0, w = 0;
  while (ji < nj && j[ji] < 0) ji++;
  for (;;) {
    if (ji >= nj) break;
    if (bail_needed > 0 && cnt + (nj - ji) < bail_needed) break;
    if (w == j[ji]) {
      if ((max_j < 0 || w <= max_j) && st.probe(bf, bits, k, m)) cnt++;
      ji++;
      if (ji >= nj) break;
    }
    if (w + (int)k >= plen) break;
    st.roll(patch[w], patch[w + k], k);
    w++;
  }
  return cnt;
}

inline uint8_t upper_c(uint8_t c) { return (c >= 'a' && c <= 'z') ? c - 32 : c; }

}  // namespace

extern "C" {

// Batched candidate-support evaluation (semantics of ops/siteeval.py):
// for each site w: gate + sub supports (4 lanes), insertion supports
// (4 x n_combos), deletion supports (max_del).  Tables are passed in so the
// layouts stay single-sourced in Python.
int gp_eval_sites(
    const uint8_t* seq, int64_t n, uint32_t k, uint32_t hash_num,
    const int64_t* sites, int64_t n_sites,
    const uint8_t* bf, uint64_t bf_bytes,
    const uint8_t* sub_cand,        // [256*4]
    const int32_t* sub_cand_n,      // [256]
    const uint8_t* combo_codes,     // [4 * n_combos * max_ins]
    const int32_t* combo_len,       // [n_combos]
    int32_t n_combos, int32_t max_ins, int32_t max_del,
    const int32_t* j_sub, int32_t nj_sub,
    const int32_t* j_ins, int32_t nj_ins,
    const int32_t* j_del, int32_t nj_del,
    int32_t bail_edit, int32_t bail_del,
    int32_t skip_unused,            // skip ins lanes the decision never reads
    uint8_t* gate_out,              // [n_sites*4]
    int32_t* sub_out,               // [n_sites*4]
    int32_t* ins_out,               // [n_sites*4*n_combos] (caller-zeroed)
    int32_t* del_out) {             // [n_sites*max_del]
  if (hash_num > 16 || k > 64) return -1;
  const uint64_t bits = bf_bytes * 8;
  const int L_sub = 2 * k, L_ins = 2 * k + max_ins, L_del = 2 * k - 1;

  int base_row[256];
  std::memset(base_row, 0, sizeof(base_row));
  base_row['A'] = 0; base_row['C'] = 1; base_row['G'] = 2; base_row['T'] = 3;

  // sites are independent (read-only inputs, disjoint output rows):
  // parallelize across them.  Inside fork-pool workers OpenMP is pinned
  // to one thread (utils/procs.py) and this compiles to the serial loop.
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 8)
#endif
  for (int64_t si = 0; si < n_sites; si++) {
    std::vector<uint8_t> patch(L_ins + 8, 0);
    std::vector<uint8_t> suffix(k + max_del, 0);
    const int64_t w = sites[si];
    const int64_t p = w + k - 1;
    const uint8_t draft = upper_c(seq[p]);
    // suffix s[p+1 : p+1+k+max_del], zero-padded past the end
    for (int i = 0; i < (int)k + max_del; i++) {
      const int64_t q = p + 1 + i;
      suffix[i] = (q < n) ? seq[q] : 0;
    }
    RollState win;
    win.seed(seq + w, k);
    const uint64_t fh0 = win.fh, rh0 = win.rh;
    const int nc = sub_cand_n[draft];
    // --- substitutions + gate
    bool sub_accepted_any = false;
    // dels are read only by the indel scan, which runs only for a gated,
    // not-yet-accepted candidate (same conditions as the ins skip)
    bool indels_reachable = false;
    for (int ci = 0; ci < 4; ci++) {
      gate_out[si * 4 + ci] = 0;
      sub_out[si * 4 + ci] = 0;
      if (ci >= nc) continue;
      const uint8_t sub = sub_cand[draft * 4 + ci];
      RollState g{fh0, rh0};
      // changelast draft -> sub
      g.fh = fh0 ^ kSeeds.fwd[draft] ^ kSeeds.fwd[sub];
      {
        uint64_t v = srol(rh0) ^ srol_n(kSeeds.rc[draft], k) ^ srol_n(kSeeds.rc[sub], k);
        uint64_t hi = v >> 33, lo = v & M33;
        hi = ((hi >> 1) | (hi << 30)) & M31;
        lo = ((lo >> 1) | (lo << 32)) & M33;
        g.rh = (hi << 33) | lo;
      }
      gate_out[si * 4 + ci] = g.probe(bf, bits, k, hash_num) ? 1 : 0;
      // patch = prefix(k-1) + sub + suffix[:k]  (L = 2k)
      std::memcpy(patch.data(), seq + w, k - 1);
      patch[k - 1] = sub;
      std::memcpy(patch.data() + k, suffix.data(), k);
      sub_out[si * 4 + ci] =
          count_patch_probes(patch.data(), L_sub, k, hash_num, bf, bits,
                             j_sub, nj_sub, -1, bail_edit);
      // The decision loop reads a candidate's insertion supports only when
      // its gate passed, its substitution was NOT accepted, and no earlier
      // gated candidate's substitution was accepted (run_trials /
      // _engine_run_trials both `continue` past the indel scan otherwise).
      // bail_edit is the smallest passing support, so acceptance is
      // detectable here; with bail_edit == 0 we can't know and only the
      // gate skip applies.  Skipped lanes stay at the caller's zeros.
      const bool gated = gate_out[si * 4 + ci] != 0;
      const bool accepted =
          gated && bail_edit > 0 && sub_out[si * 4 + ci] >= bail_edit;
      if (skip_unused && (!gated || accepted || sub_accepted_any)) {
        sub_accepted_any = sub_accepted_any || accepted;
        continue;
      }
      sub_accepted_any = sub_accepted_any || accepted;
      indels_reachable = true;
      // --- insertions for this index char
      const int row = base_row[sub];
      for (int c = 0; c < n_combos; c++) {
        const int m = combo_len[c];
        std::memcpy(patch.data(), seq + w, k - 1);
        std::memcpy(patch.data() + k - 1,
                    combo_codes + ((int64_t)row * n_combos + c) * max_ins, m);
        patch[k - 1 + m] = draft;
        std::memcpy(patch.data() + k + m, suffix.data(), k - 1);
        ins_out[(si * 4 + ci) * n_combos + c] =
            count_patch_probes(patch.data(), k + m + (int)k - 1 + 1 - 1, k,
                               hash_num, bf, bits, j_ins, nj_ins, -1,
                               bail_edit);
      }
    }
    // --- deletions (independent of index char)
    for (int d = 1; d <= max_del && (indels_reachable || !skip_unused); d++) {
      std::memcpy(patch.data(), seq + w, k - 1);
      std::memcpy(patch.data() + k - 1, suffix.data() + d - 1, k);
      // validity: j == 0 needs p+d <= n-1; j > 0 needs p+d+j+1 <= n-1
      int cnt = 0;
      {
        RollState st;
        st.seed(patch.data(), k);
        int ji = 0, w2 = 0;
        for (;;) {
          if (ji >= nj_del) break;
          if (bail_del > 0 && cnt + (nj_del - ji) < bail_del) break;
          if (w2 == j_del[ji]) {
            bool valid = (w2 == 0) ? (p + d <= n - 1)
                                   : (p + d + w2 + 1 <= n - 1);
            if (valid && st.probe(bf, bits, k, hash_num)) cnt++;
            ji++;
            if (ji >= nj_del) break;
          }
          if (w2 + (int)k >= L_del) break;
          st.roll(patch[w2], patch[w2 + k], k);
          w2++;
        }
      }
      del_out[si * max_del + (d - 1)] = cnt;
    }
  }
  return 0;
}

// Bulk clean-run for the editing walk (ntedit.cpp:1461-1760 fast path):
// from a window whose hashes are (fh0, rh0) over seg[0..seg_len), roll
// forward probing every window.  Stops at the first missing window (state
// kept AT that window, *stopped_missing = 1), at the first incoming char
// not in accept_tab (state kept at the last clean window before it), or
// after max_steps rolls.  Returns the number of rolls performed; hashes
// after those rolls land in *fh_out / *rh_out.  Probes are primary-BF
// canonical probes, bit-identical to the Python _probe_fr_primary.
int64_t gp_clean_run(
    const uint8_t* seg, int64_t seg_len, uint32_t k, uint32_t hash_num,
    const uint8_t* bf, uint64_t bf_bytes,
    const uint8_t* accept_tab,  // [256] 1 = is_accepted (ATGC + IUPAC)
    uint64_t fh0, uint64_t rh0, int64_t max_steps,
    uint64_t* fh_out, uint64_t* rh_out, int32_t* stopped_missing) {
  const uint64_t bits = bf_bytes * 8;
  RollState st{fh0, rh0};
  int64_t m = 0;
  *stopped_missing = 0;
  if (max_steps > seg_len - (int64_t)k) max_steps = seg_len - (int64_t)k;
  for (int64_t i = 1; i <= max_steps; i++) {
    const uint8_t cin = seg[i + k - 1];
    if (!accept_tab[cin]) break;
    st.roll(seg[i - 1], cin, k);
    m = i;
    if (!st.probe(bf, bits, k, hash_num)) {
      *stopped_missing = 1;
      break;
    }
  }
  *fh_out = st.fh;
  *rh_out = st.rh;
  return m;
}

// One-call minimizer sketch: canonical-hash every k-window of seq, run
// gp_minimizer_select over them, and emit the selected windows' hashes +
// positions.  Returns the number of minimizers (<= n_windows).
int64_t gp_sketch(const uint8_t* seq, int64_t n, uint32_t k, int32_t w,
                  int64_t* pos_out, uint64_t* hash_out) {
  if (n < (int64_t)k) return 0;
  const int64_t nw = n - (int64_t)k + 1;
  std::vector<uint64_t> h(nw);
  {
    RollState st;
    st.seed(seq, k);
    h[0] = st.fh + st.rh;
    for (int64_t i = 1; i < nw; i++) {
      st.roll(seq[i - 1], seq[i + k - 1], k);
      h[i] = st.fh + st.rh;
    }
  }
  std::vector<uint8_t> mask(nw);
  gp_minimizer_select(h.data(), nw, w, mask.data());
  int64_t m = 0;
  for (int64_t i = 0; i < nw; i++) {
    if (mask[i]) {
      pos_out[m] = i;
      hash_out[m] = h[i];
      m++;
    }
  }
  return m;
}

// Seed the forward/reverse rolling-hash state of one k-window (the scalar
// ntc64_base recurrence, nthash.hpp) — used by the engine when re-anchoring
// the walk at a hot site.
void gp_seed_window(const uint8_t* buf, uint32_t k,
                    uint64_t* fh_out, uint64_t* rh_out) {
  RollState st;
  st.seed(buf, k);
  *fh_out = st.fh;
  *rh_out = st.rh;
}

}  // extern "C"

// ===========================================================================
// Full native editing walk (gp_polish_contig): a C port of the exact oracle
// editor (polish/ntedit_oracle.py, itself a faithful reimplementation of the
// reference kmerizeAndCorrect loop, subprojects/ntedit/ntedit.cpp:1414-1771).
// Semantics are pinned by the engine-vs-oracle differential test suite; every
// structure below mirrors its Python twin by name.
// ===========================================================================

namespace {

struct AcceptTabs {
  uint8_t accepted[256];  // is_accepted(upper(c))
  uint8_t atgc[256];      // is_atgc(c) for UPPERCASE c
  uint8_t upper[256];
  uint8_t lower[256];
  uint8_t rc_c[256];      // complement, 'N' otherwise (oracle rc())
  AcceptTabs() {
    std::memset(accepted, 0, sizeof(accepted));
    std::memset(atgc, 0, sizeof(atgc));
    for (const char* p = "ATGCRYSWKMBDHV"; *p; p++) {
      accepted[(uint8_t)*p] = 1;
      accepted[(uint8_t)(*p + 32)] = 0;  // table is indexed by UPPER(c)
    }
    for (const char* p = "ATGC"; *p; p++) atgc[(uint8_t)*p] = 1;
    for (int c = 0; c < 256; c++) {
      upper[c] = (c >= 'a' && c <= 'z') ? c - 32 : c;
      lower[c] = (c >= 'A' && c <= 'Z') ? c + 32 : c;
      rc_c[c] = 'N';
    }
    rc_c['A'] = 'T'; rc_c['a'] = 'T';
    rc_c['T'] = 'A'; rc_c['t'] = 'A';
    rc_c['G'] = 'C'; rc_c['g'] = 'C';
    rc_c['C'] = 'G'; rc_c['c'] = 'G';
  }
};
const AcceptTabs kTabs;

// rope node (oracle Node / reference seqNode, ntedit.cpp:468-475)
struct RNode {
  int8_t type = -1;  // -1 unset; 0 position-range; 1 literal
  int64_t s = 0, e = 0;
  uint8_t c = 0;
  int32_t supp = 0;
};

struct Cursor {
  int64_t h = 0, t = 0;
  int64_t hn = 0, tn = 0;
};

struct Best {
  int32_t et = 0;
  uint8_t indel[64];
  int32_t indel_len = 0;
  uint8_t alt_indel[64];
  int32_t alt_indel_len = 0;
  uint8_t sub_base = 0;
  int32_t num_support = 0;
  uint8_t ab1 = 0, ab2 = 0, ab3 = 0;
  int32_t as1 = 0, as2 = 0, as3 = 0;
};

struct WalkCtx {
  // config
  uint32_t k, hn_;
  int32_t mode, mask, max_ins, max_del, jump, ins_cap;
  int32_t bail_edit, bail_del, bail_missing;
  int32_t snv = 0;  // SNV mode (reference ntedit.cpp:1540-1556)
  const uint8_t* bf; uint64_t bits;
  const uint8_t* bf2; uint64_t bits2;  // secondary (repeat) BF, nullable
  const uint8_t* sub_cand; const int32_t* sub_cand_n;
  const uint8_t* combo_codes; const int32_t* combo_len; int32_t n_combos;
  const uint8_t* present;  // nullable [n-k+1] probe results on the raw draft
  // precomputed site trial tables (fused device phase-A, ops/scan_eval.py);
  // sites are raw-draft window indices, sorted ascending.  Valid only at
  // pure-draft trailing-node sites (the caller pre-filters interior sites).
  const int64_t* tsite = nullptr;
  int64_t n_tsites = 0;
  const uint8_t* t_gate = nullptr;     // [n_tsites, 4]
  const int8_t* t_sub = nullptr;       // [n_tsites, 4]
  const int8_t* t_del = nullptr;       // [n_tsites, max_del]
  const int8_t* t_ins_lane = nullptr;  // [n_tsites]
  const uint8_t* t_ins_ok = nullptr;   // [n_tsites]
  const int8_t* t_ins = nullptr;       // [n_tsites, n_combos]
  int64_t n_table_hits = 0, n_table_giveups = 0;
  // state
  uint8_t* seq; int64_t n;
  std::vector<RNode> rope;
  Cursor st;
  uint64_t fh = 0, rh = 0;
  uint8_t char_in = 0;
  int64_t last_base_change = -1;  // max draft pos whose BASE was rewritten
  // outputs
  int64_t n_subs = 0, n_ins = 0, n_dels = 0, n_masked = 0, n_nofix = 0;
  int64_t* recs; int64_t recs_cap; int64_t n_recs = 0; bool recs_overflow = false;
  // per-site deletion-trial cache (_ScalarProvider._del)
  int32_t del_cnt[8]; uint8_t del_bytes[8][8]; uint8_t del_done[8];
};

inline uint8_t rope_get_char(const WalkCtx& w, int64_t pos, const RNode& nd) {
  if (nd.type == 0) return w.seq[pos];
  if (nd.type == 1) return nd.c;
  return 0;
}

// oracle _Editor.increment (reference ntedit.cpp:681-699)
inline void rope_increment(const WalkCtx& w, int64_t& pos, int64_t& ni) {
  const RNode& nd = w.rope[ni];
  if (nd.type == 0) {
    pos += 1;
    if (pos > nd.e) {
      ni += 1;
      if (ni < (int64_t)w.rope.size() && w.rope[ni].type == 0)
        pos = w.rope[ni].s;
    }
  } else if (nd.type == 1) {
    ni += 1;
    if (ni < (int64_t)w.rope.size() && w.rope[ni].type == 0)
      pos = w.rope[ni].s;
  }
}

// oracle _Editor.roll (reference ntedit.cpp:939-969)
inline bool rope_roll(const WalkCtx& w, Cursor& st, uint8_t& c_out,
                      uint8_t& c_in) {
  const int64_t R = (int64_t)w.rope.size();
  if (st.h >= w.n || st.hn >= R) return false;
  c_out = rope_get_char(w, st.h, w.rope[st.hn]);
  rope_increment(w, st.h, st.hn);
  if (st.t >= w.n || st.tn >= R) { c_in = 0; return false; }
  rope_increment(w, st.t, st.tn);
  if (st.t >= w.n || st.tn >= R) { c_in = 0; return false; }
  c_in = rope_get_char(w, st.t, w.rope[st.tn]);
  return true;
}

inline void hash_roll(uint64_t& fh, uint64_t& rh, uint32_t k, uint8_t c_out,
                      uint8_t c_in) {
  fh = srol(fh) ^ kSeeds.fwd[c_in] ^ srol_n(kSeeds.fwd[c_out], k);
  uint64_t v = rh ^ srol_n(kSeeds.rc[c_in], k) ^ kSeeds.rc[c_out];
  uint64_t hi = v >> 33, lo = v & M33;
  hi = ((hi >> 1) | (hi << 30)) & M31;
  lo = ((lo >> 1) | (lo << 32)) & M33;
  rh = (hi << 33) | lo;
}

// ntc64_changelast_i (ops/nthash.py)
inline void hash_changelast(uint64_t& fh, uint64_t& rh, uint32_t k,
                            uint8_t c_out, uint8_t c_in) {
  fh = fh ^ kSeeds.fwd[c_out] ^ kSeeds.fwd[c_in];
  uint64_t v = srol(rh) ^ srol_n(kSeeds.rc[c_out], k) ^
               srol_n(kSeeds.rc[c_in], k);
  uint64_t hi = v >> 33, lo = v & M33;
  hi = ((hi >> 1) | (hi << 30)) & M31;
  lo = ((lo >> 1) | (lo << 32)) & M33;
  rh = (hi << 33) | lo;
}

// All-slots-prefetched membership test: issue every hash's cache line
// before the first dependent read, so a fully-present tuple (the accept
// chains' common case) pays one memory latency instead of h chained ones.
inline bool bf_contains_pf(const uint8_t* arr, uint64_t bits,
                           const uint64_t* hashes, unsigned m) {
  uint64_t b[16];
  for (unsigned i = 0; i < m; i++) {
    b[i] = bf_reduce(hashes[i], bits);
    __builtin_prefetch(&arr[b[i] >> 3], 0, 3);
  }
  for (unsigned i = 0; i < m; i++)
    if (!((arr[b[i] >> 3] >> (b[i] & 7)) & 1)) return false;
  return true;
}

// primary-only probe (oracle _probe_fr_primary)
inline bool probe_primary(const WalkCtx& w, uint64_t fh, uint64_t rh) {
  uint64_t hs[16];
  multi_hash(fh + rh, w.k, w.hn_, hs);
  return bf_contains_pf(w.bf, w.bits, hs, w.hn_);
}

// primary + secondary veto (oracle _probe_fr)
inline bool probe_full(const WalkCtx& w, uint64_t fh, uint64_t rh) {
  uint64_t hs[16];
  multi_hash(fh + rh, w.k, w.hn_, hs);
  if (!bf_contains_pf(w.bf, w.bits, hs, w.hn_)) return false;
  if (w.bf2 && bf_contains(w.bf2, w.bits2, hs, w.hn_)) return false;
  return true;
}

// oracle find_first_accepted_kmer (reference ntedit.cpp:392-413)
inline int64_t find_first_accepted(const uint8_t* seq, int64_t n, uint32_t k) {
  int64_t i = 0;
  while (i + (int64_t)k < n) {
    if (kTabs.accepted[kTabs.upper[seq[i]]]) {
      bool good = true;
      for (int64_t j = i + 1; j < i + (int64_t)k; j++) {
        if (!kTabs.accepted[kTabs.upper[seq[j]]]) {
          good = false;
          i = j + 1;
          break;
        }
      }
      if (good) return i;
    } else {
      i += 1;
    }
  }
  return n - 1;
}

// oracle make_insertion (reference ntedit.cpp:480-569); returns new tn
int64_t rope_make_insertion(WalkCtx& w, int64_t tn, int64_t insert_pos,
                            const uint8_t* ins, int32_t ins_len,
                            int32_t supp) {
  std::vector<RNode>& rope = w.rope;
  RNode orig = rope[tn];
  std::vector<RNode> to_insert(ins_len);
  for (int32_t i = 0; i < ins_len; i++)
    to_insert[i] = RNode{1, 0, 0, ins[i], supp};
  if (orig.type == 0) {
    if (insert_pos <= orig.s) {
      std::vector<RNode> reappend;
      int64_t i = tn;
      while (i < (int64_t)rope.size() && rope[i].type != -1) {
        reappend.push_back(rope[i]);
        rope[i].type = -1;
        i++;
      }
      for (int64_t j = 0; j < (int64_t)to_insert.size(); j++) {
        if (tn + j < (int64_t)rope.size()) rope[tn + j] = to_insert[j];
        else rope.push_back(to_insert[j]);
      }
      for (int64_t j = 0; j < (int64_t)reappend.size(); j++) {
        int64_t at = tn + (int64_t)to_insert.size() + j;
        if (at < (int64_t)rope.size()) rope[at] = reappend[j];
        else rope.push_back(reappend[j]);
      }
    } else {
      RNode after{0, insert_pos, orig.e, 0, 0};
      rope[tn].e = insert_pos - 1;
      for (int64_t j = 0; j < (int64_t)to_insert.size(); j++) {
        int64_t at = tn + j + 1;
        if (at < (int64_t)rope.size()) rope[at] = to_insert[j];
        else rope.push_back(to_insert[j]);
      }
      int64_t at = tn + (int64_t)to_insert.size() + 1;
      if (at < (int64_t)rope.size()) rope[at] = after;
      else rope.push_back(after);
      tn += 1;
    }
  } else if (orig.type == 1) {
    std::vector<RNode> reappend;
    int64_t i = tn;
    while (i < (int64_t)rope.size() && rope[i].type != -1) {
      reappend.push_back(rope[i]);
      rope[i].type = -1;
      i++;
    }
    for (int64_t j = 0; j < (int64_t)to_insert.size(); j++) {
      if (tn + j < (int64_t)rope.size()) rope[tn + j] = to_insert[j];
      else rope.push_back(to_insert[j]);
    }
    for (int64_t j = 0; j < (int64_t)reappend.size(); j++) {
      int64_t at = tn + (int64_t)to_insert.size() + j;
      if (at < (int64_t)rope.size()) rope[at] = reappend[j];
      else rope.push_back(reappend[j]);
    }
  }
  return tn;
}

// oracle make_deletion (reference ntedit.cpp:574-664); updates tn and pos
void rope_make_deletion(WalkCtx& w, int64_t& tn, int64_t& pos, int64_t num_del,
                        int32_t supp) {
  std::vector<RNode>& rope = w.rope;
  RNode orig = rope[tn];
  if (orig.type == 0) {
    int64_t leftover = 0;
    if (pos <= orig.s) {
      if (pos + num_del <= orig.e) {
        rope[tn].s = pos + num_del;
        rope[tn].supp = supp;
        pos = rope[tn].s;
        return;
      }
      leftover = pos + num_del - orig.e;
      pos = orig.e + 1;
      int64_t i = tn + 1;
      while (i < (int64_t)rope.size() && rope[i].type != -1) {
        rope[i - 1] = rope[i];
        rope[i] = RNode();
        i++;
      }
    } else {
      if (pos + num_del <= orig.e) {
        RNode split{0, pos + num_del, orig.e, 0, supp};
        rope[tn].e = pos - 1;
        pos = split.s;
        tn += 1;
        if (tn < (int64_t)rope.size()) rope[tn] = split;
        else rope.push_back(split);
        return;
      }
      leftover = pos + num_del - orig.e;
      rope[tn].e = pos - 1;
      pos = orig.e + 1;
      tn += 1;
    }
    if (leftover > 0) {
      if (tn < (int64_t)rope.size() && rope[tn].type != -1) {
        if (rope[tn].type == 0) pos = rope[tn].s;
        rope_make_deletion(w, tn, pos, leftover, supp);
      }
    }
  } else if (orig.type == 1) {
    int64_t i = tn;
    int64_t leftover = num_del;
    while (i < (int64_t)rope.size() && rope[i].type == 1 && leftover > 0) {
      rope[i].type = -1;
      leftover--;
      i++;
    }
    int64_t j = tn;
    while (i < (int64_t)rope.size() && rope[i].type != -1) {
      rope[j] = rope[i];
      rope[i] = RNode();
      i++;
      j++;
    }
    if (leftover > 0) {
      if (tn < (int64_t)rope.size() && rope[tn].type != -1) {
        if (rope[tn].type == 0) pos = rope[tn].s;
        rope_make_deletion(w, tn, pos, leftover, supp);
      }
    }
  }
}

// oracle find_accepted_kmer (reference ntedit.cpp:703-758); advances st,
// fills kmer_out (k bytes) and returns true when found.
bool rope_find_accepted_kmer(WalkCtx& w, Cursor& st, uint8_t* kmer_out) {
  const uint32_t k = w.k;
  const std::vector<RNode>& rope = w.rope;
  int64_t temp_tn = st.tn;
  int64_t i = st.t;
  while (i < w.n && temp_tn < (int64_t)rope.size() &&
         rope[temp_tn].type != -1) {
    uint8_t c = rope_get_char(w, i, rope[temp_tn]);
    if (kTabs.accepted[kTabs.upper[c]]) {
      uint32_t klen = 1;
      kmer_out[0] = c;
      int64_t temp_hn = temp_tn;
      int64_t j = i, temp_tn2 = temp_tn;
      rope_increment(w, j, temp_tn2);
      bool broke_inner = false;
      while (j < w.n && temp_tn2 < (int64_t)rope.size() &&
             rope[temp_tn2].type != -1) {
        c = rope_get_char(w, j, rope[temp_tn2]);
        if (!kTabs.accepted[kTabs.upper[c]]) {
          i = j;
          broke_inner = true;
          break;
        }
        kmer_out[klen++] = c;
        if (klen == k) break;
        rope_increment(w, j, temp_tn2);
      }
      if (klen == k) {
        st.h = i;
        st.t = j;
        st.hn = temp_hn;
        st.tn = temp_tn2;
        return true;
      }
      if (broke_inner) {
        temp_tn = temp_tn2;
        continue;
      }
    }
    rope_increment(w, i, temp_tn);
  }
  st.h = w.n;
  st.t = w.n;
  return false;
}

// oracle get_prev_insertion (reference ntedit.cpp:762-777)
std::string rope_prev_insertion(const WalkCtx& w, int64_t t_seq_i, int64_t tn) {
  std::string prev;
  const std::vector<RNode>& rope = w.rope;
  if ((tn < (int64_t)rope.size() && rope[tn].type == 0 &&
       t_seq_i == rope[tn].s) ||
      rope[tn].type == 1)
    tn -= 1;
  while (tn >= 0 && tn < (int64_t)rope.size() && rope[tn].type == 1) {
    prev.push_back((char)kTabs.rc_c[rope[tn].c]);
    tn -= 1;
  }
  return prev;
}

// oracle _rollback_insertion (reference ntedit.cpp:1043-1056, 1074-1088)
void rope_rollback_insertion(WalkCtx& w, const Cursor& st, int64_t count) {
  std::vector<RNode>& rope = w.rope;
  int64_t j = 1;
  if (rope[st.tn].type == 0 && st.t == rope[st.tn].s) j = 0;
  for (int64_t i = count; i > 0; i--) {
    if (st.tn + j < (int64_t)rope.size() && rope[st.tn + j].type != -1) {
      rope[st.tn - i] = rope[st.tn + j];
      rope[st.tn + j] = RNode();
      j++;
    } else {
      rope[st.tn - i].type = -1;
    }
  }
}

// oracle compute_lps + is_repeat_insertion (reference ntedit.cpp:416-451)
bool is_repeat_insertion_c(const std::string& s) {
  const int64_t n = (int64_t)s.size();
  if (n == 0) return false;
  std::vector<int64_t> lps(n, 0);
  int64_t len = 0, i = 1;
  while (i < n) {
    if (s[i] == s[len]) {
      len++;
      lps[i] = len;
      i++;
    } else if (len != 0) {
      len = lps[len - 1];
    } else {
      lps[i] = 0;
      i++;
    }
  }
  int64_t length = lps[n - 1];
  return length > 0 && n % (n - length) == 0;
}

// Early-bail accounting for a jump-subsampled probe chain: once
// hits + probes-still-ahead < bail, the trial cannot be accepted, and any
// returned value below the accept threshold is decision-equivalent (the
// trial loops read non-accepted counts only through the accept test), so
// the chain may stop.  Accepted trials never bail, keeping their exact
// counts for best/alt bookkeeping and records.
inline int32_t probes_ahead(uint32_t kk, uint32_t kk_last, uint32_t jump) {
  // number of probe points kk' with kk <= kk' <= kk_last and kk' % jump == 0
  if (kk > kk_last) return 0;
  uint32_t first = (kk + jump - 1) / jump * jump;
  if (first > kk_last) return 0;
  return (int32_t)((kk_last - first) / jump + 1);
}

// oracle sub_trial_scalar (reference ntedit.cpp:1558-1619)
void sub_trial_c(WalkCtx& w, int32_t ci, const Cursor& st, uint64_t fh,
                 uint64_t rh, bool& gate, int32_t& check) {
  const uint32_t k = w.k;
  const uint8_t draft =
      kTabs.upper[rope_get_char(w, st.t, w.rope[st.tn])];
  const uint8_t sub = w.sub_cand[(int)draft * 4 + ci];
  uint64_t tfh = fh, trh = rh;
  hash_changelast(tfh, trh, k, draft, sub);
  gate = probe_full(w, tfh, trh);
  check = 0;
  if (!(gate || w.mode == 2)) return;
  Cursor tmp = st;
  RNode& t_node = w.rope[st.tn];
  if (t_node.type == 0) w.seq[st.t] = sub;
  else if (t_node.type == 1) t_node.c = sub;
  uint32_t kk = 0;
  uint64_t cfh = tfh, crh = trh;
  while (kk < k && tmp.h < w.n && tmp.t < w.n) {
    if (check + probes_ahead(kk, k - 1, w.jump) < w.bail_edit) break;
    uint8_t c_out, c_in;
    if (!rope_roll(w, tmp, c_out, c_in)) break;
    hash_roll(cfh, crh, k, c_out, c_in);
    if (kk % w.jump == 0 && probe_full(w, cfh, crh)) check++;
    kk++;
  }
  // revert writes back the UPPERCASED draft char (reference ntedit.cpp:1610)
  RNode& t_node2 = w.rope[st.tn];
  if (t_node2.type == 0) w.seq[st.t] = draft;
  else if (t_node2.type == 1) t_node2.c = draft;
}

// Two-phase insertion trial (oracle try_insertion, reference
// ntedit.cpp:1276-1331): phase A rolls the whole candidate chain —
// pure compute — recording every probe point's Bloom slot indices and
// prefetching their cache lines; phase B counts hits from warm cache.
// Decision-equivalent to the bailed serial chain: counts below the
// accept threshold are never read by the trial loops (see probes_ahead),
// and accepted trials never bailed, so exact counts are preserved
// exactly where the oracle preserves them.  Splitting the phases also
// lets run_indel_trials_c build combo i+1's plan while combo i's
// prefetches are still in flight.
struct ProbePlan {
  // ceil((k-1)/jump)+1 probe points, k<=64 -> at most 64 points.  The
  // plan stores only the hash-pair sum per point (multi_hash's out[0] IS
  // the sum; derived hashes are recomputed lazily when needed), and
  // prefetches only the first slot's cache line: ~75% of wrong-candidate
  // probes fail on that first bit, so warming more lines wastes bandwidth.
  uint64_t sum[64];
  int32_t np = 0;
};

inline void plan_add(ProbePlan& p, const WalkCtx& w, uint64_t fh,
                     uint64_t rh) {
  const uint64_t s = fh + rh;
  p.sum[p.np++] = s;
  __builtin_prefetch(&w.bf[bf_reduce(s, w.bits) >> 3], 0, 3);
}

// count of probe points passing primary-AND-NOT-secondary (probe_full),
// bailing once the accept threshold is unreachable (decision-equivalent:
// counts below the threshold are never read by the trial loops, and
// accepted chains never bail so their exact counts are preserved).
inline int32_t plan_count(const ProbePlan& p, const WalkCtx& w,
                          int32_t bail) {
  int32_t c = 0;
  for (int32_t i = 0; i < p.np; i++) {
    if (c + (p.np - i) < bail) return c;
    const uint64_t s = p.sum[i];
    const uint64_t b0 = bf_reduce(s, w.bits);
    if (!((w.bf[b0 >> 3] >> (b0 & 7)) & 1)) continue;
    uint64_t hs[16];
    multi_hash(s, w.k, w.hn_, hs);
    bool ok = true;
    for (uint32_t hh = 1; hh < w.hn_; hh++) {
      const uint64_t b = bf_reduce(hs[hh], w.bits);
      if (!((w.bf[b >> 3] >> (b & 7)) & 1)) {
        ok = false;
        break;
      }
    }
    if (ok && w.bf2 && bf_contains(w.bf2, w.bits2, hs, w.hn_)) ok = false;
    c += ok;
  }
  return c;
}

// Per-length reference chain for the insertion-combo trials.  ntHash's
// roll is XOR-linear in the hash state (fh' = srol(fh) ^ f(c_in, c_out);
// rh' = sror(rh ^ g(c_in, c_out))), and every combo of the same length
// rolls the SAME (c_out, c_in) sequence except for the combo's own chars
// cc[1..clen-1] (cc[0] is the index char placed by changelast; the final
// rolled char is the shared draft char).  So one chain walk per length
// gives every other combo's probe-point hashes as
//     fh = ref_fh ^ srol^(s-(L-1))(dbase_f)
//     rh = ref_rh ^ sror^(s-(L-1))(dbase_r)
// where s is the point's roll count and dbase the XOR of the differing
// chars' seed deltas aligned to step L-1 — ~10 ops per point instead of
// jump rope+hash rolls.  Exact: identical probe values, order, count.
struct RefPlan {
  uint64_t fh[64], rh[64];
  int32_t s[64];           // rolls completed at each probe point
  int32_t np = 0;
  const uint8_t* cc = nullptr;  // the reference combo's codes
  int32_t clen = 0;
  bool valid = false;
};

void ins_plan_ref_c(WalkCtx& w, uint8_t draft, uint8_t index_char,
                    const uint8_t* cc, int32_t clen, const Cursor& st,
                    uint64_t fh, uint64_t rh, RefPlan& rp, ProbePlan& p) {
  const uint32_t k = w.k;
  uint8_t combo[72];
  std::memcpy(combo, cc, clen);
  combo[clen] = draft;
  const int32_t combo_total = clen + 1;
  Cursor tmp = st;
  uint64_t tfh = fh, trh = rh;
  hash_changelast(tfh, trh, k, draft, index_char);
  rp.np = 0;
  rp.cc = cc;
  rp.clen = clen;
  rp.valid = true;
  p.np = 0;
  int32_t kk = 0;
  while (kk < combo_total - 1 && tmp.h < w.n) {
    uint8_t c_out = rope_get_char(w, tmp.h, w.rope[tmp.hn]);
    hash_roll(tfh, trh, k, c_out, combo[kk + 1]);
    rope_increment(w, tmp.h, tmp.hn);
    if (kk % w.jump == 0) {
      rp.fh[rp.np] = tfh;
      rp.rh[rp.np] = trh;
      rp.s[rp.np++] = kk + 1;
      plan_add(p, w, tfh, trh);
    }
    kk++;
  }
  while (kk < (int32_t)k - 1 && tmp.h < w.n) {
    uint8_t c_out, c_in;
    if (rope_roll(w, tmp, c_out, c_in)) {
      hash_roll(tfh, trh, k, c_out, c_in);
      if (kk % w.jump == 0) {
        rp.fh[rp.np] = tfh;
        rp.rh[rp.np] = trh;
        rp.s[rp.np++] = kk + 1;
        plan_add(p, w, tfh, trh);
      }
    }
    kk++;
  }
}

// Derive combo cc's probe plan from its length group's reference chain.
inline void ins_plan_fast_c(const WalkCtx& w, const RefPlan& rp,
                            const uint8_t* cc, ProbePlan& p) {
  const int32_t L = rp.clen;
  const uint32_t k = w.k;
  // seed deltas of the differing combo chars (j in [1, L-1))
  uint64_t dbf = 0, dbr = 0;
  uint64_t fd[8], rd[8];
  for (int32_t j = 1; j < L; j++) {
    const uint8_t a = cc[j], b = rp.cc[j];
    fd[j] = kSeeds.fwd[a] ^ kSeeds.fwd[b];
    rd[j] = srol_n(kSeeds.rc[a] ^ kSeeds.rc[b], k);
    dbf ^= srol_n(fd[j], (unsigned)(L - 1 - j));
    dbr ^= sror_n(rd[j], (unsigned)(L - j));
  }
  p.np = 0;
  for (int32_t t = 0; t < rp.np; t++) {
    const int32_t s = rp.s[t];
    uint64_t df, dr;
    if (s >= L - 1) {
      df = srol_n(dbf, (unsigned)(s - (L - 1)));
      dr = sror_n(dbr, (unsigned)(s - (L - 1)));
    } else {  // mid-roll-in point: only the first s combo chars are in
      df = 0;
      dr = 0;
      for (int32_t j = 1; j <= s; j++) {
        df ^= srol_n(fd[j], (unsigned)(s - j));
        dr ^= sror_n(rd[j], (unsigned)(s - j + 1));
      }
    }
    plan_add(p, w, rp.fh[t] ^ df, rp.rh[t] ^ dr);
  }
}

// oracle try_deletion (reference ntedit.cpp:1157-1234); cached per d
void try_deletion_c(WalkCtx& w, uint8_t draft, int32_t d, const Cursor& st,
                    uint64_t fh, uint64_t rh) {
  if (w.del_done[d]) return;
  w.del_done[d] = 1;
  const uint32_t k = w.k;
  Cursor tmp = st;
  for (int32_t i = 0; i < d; i++) {
    w.del_bytes[d][i] = rope_get_char(w, tmp.t, w.rope[tmp.tn]);
    rope_increment(w, tmp.t, tmp.tn);
  }
  uint8_t nxt = (tmp.tn < (int64_t)w.rope.size())
                    ? rope_get_char(w, tmp.t, w.rope[tmp.tn])
                    : 0;
  uint64_t tfh = fh, trh = rh;
  hash_changelast(tfh, trh, k, draft, nxt);
  int32_t check = 0;
  if (probe_full(w, tfh, trh)) check++;
  uint32_t kk = 1;
  while (kk <= k - 2 && tmp.h < w.n) {
    if (check + probes_ahead(kk, k - 2, w.jump) < w.bail_del) break;
    uint8_t c_out, c_in;
    if (rope_roll(w, tmp, c_out, c_in)) {
      hash_roll(tfh, trh, k, c_out, c_in);
      if (kk % w.jump == 0 && probe_full(w, tfh, trh)) check++;
    }
    kk++;
  }
  w.del_cnt[d] = check;
}

// oracle update_sub_best (reference ntedit.cpp:1628-1677)
void update_sub_best_c(Best& b, uint8_t sub, int32_t check) {
  if (check >= b.num_support) {
    if (b.as2) { b.ab3 = b.ab2; b.as3 = b.as2; }
    if (b.as1) { b.ab2 = b.ab1; b.as2 = b.as1; }
    if (b.num_support) { b.as1 = b.num_support; b.ab1 = b.sub_base; }
    b.et = 1;
    b.sub_base = sub;
    b.num_support = check;
  } else {
    if (!b.as1) {
      b.ab1 = sub; b.as1 = check;
    } else if (!b.as2) {
      if (check < b.as1) { b.ab2 = sub; b.as2 = check; }
      else { b.ab2 = b.ab1; b.as2 = b.as1; b.ab1 = sub; b.as1 = check; }
    } else if (!b.as3) {
      if (check < b.as2) { b.ab3 = sub; b.as3 = check; }
      else if (check < b.as1) {
        b.ab3 = b.ab2; b.as3 = b.as2; b.ab2 = sub; b.as2 = check;
      } else {
        b.ab3 = b.ab2; b.as3 = b.as2; b.ab2 = b.ab1; b.as2 = b.as1;
        b.ab1 = sub; b.as1 = check;
      }
    }
  }
}

// oracle _run_indel_trials (reference ntedit.cpp:1237-1411)
bool run_indel_trials_c(WalkCtx& w, uint8_t draft, int32_t ci,
                        int32_t& num_deletions, Best& best, const Cursor& st,
                        uint64_t fh, uint64_t rh) {
  int32_t t_best_support = 0, t_alt_support = 0;
  uint8_t t_best_indel[64], t_alt_indel[64];
  int32_t t_best_len = 0, t_alt_len = 0;
  int32_t t_best_type = 0;
  const uint8_t index_char = w.sub_cand[(int)draft * 4 + ci];
  const int row = index_char == 'A' ? 0 : index_char == 'C' ? 1
                  : index_char == 'G' ? 2 : 3;
  // ping-pong: combo i+1's plan (compute + prefetch) is built while combo
  // i's prefetched lines are still arriving, so tests run from warm cache.
  // One full chain walk per combo LENGTH (RefPlan); every other combo's
  // plan derives from its group's chain by XOR-delta (ins_plan_fast_c).
  ProbePlan plans[2];
  RefPlan refs[8];
  auto build_plan = [&](int32_t i, ProbePlan& p) {
    const uint8_t* cc =
        w.combo_codes + ((int64_t)row * w.n_combos + i) * w.max_ins;
    const int32_t clen = w.combo_len[i];
    RefPlan& rp = refs[clen & 7];
    if (!rp.valid)
      ins_plan_ref_c(w, draft, index_char, cc, clen, st, fh, rh, rp, p);
    else
      ins_plan_fast_c(w, rp, cc, p);
  };
  if (w.n_combos > 0) build_plan(0, plans[0]);
  for (int32_t i = 0; i < w.n_combos; i++) {
    if (i + 1 < w.n_combos) build_plan(i + 1, plans[(i + 1) & 1]);
    int32_t check = plan_count(plans[i & 1], w, w.bail_edit);
    const uint8_t* cc =
        w.combo_codes + ((int64_t)row * w.n_combos + i) * w.max_ins;
    const int32_t clen = w.combo_len[i];
    if (check >= w.bail_edit) {
      if (w.mode == 0) {
        best.et = 2;
        std::memcpy(best.indel, cc, clen);
        best.indel_len = clen;
        best.num_support = check;
        return true;
      }
      if (check >= t_best_support) {
        if (t_best_support) {
          std::memcpy(t_alt_indel, t_best_indel, t_best_len);
          t_alt_len = t_best_len;
          t_alt_support = t_best_support;
        }
        t_best_type = 2;
        std::memcpy(t_best_indel, cc, clen);
        t_best_len = clen;
        t_best_support = check;
      }
    }
    if (num_deletions <= w.max_del) {
      try_deletion_c(w, draft, num_deletions, st, fh, rh);
      int32_t del_check = w.del_cnt[num_deletions];
      int32_t del_support = (del_check >= w.bail_del) ? del_check : 0;
      if (del_support > 0) {
        if (w.mode == 0) {
          best.et = 3;
          std::memcpy(best.indel, w.del_bytes[num_deletions], num_deletions);
          best.indel_len = num_deletions;
          best.num_support = del_support;
          num_deletions += 1;
          return true;
        }
        if (del_support >= t_best_support) {
          if (t_best_support) {
            std::memcpy(t_alt_indel, t_best_indel, t_best_len);
            t_alt_len = t_best_len;
            t_alt_support = t_best_support;
          }
          t_best_type = 3;
          std::memcpy(t_best_indel, w.del_bytes[num_deletions], num_deletions);
          t_best_len = num_deletions;
          t_best_support = del_support;
        }
      }
      num_deletions += 1;
    }
  }
  if (t_best_support > 0) {
    if ((w.mode == 2 && t_best_support > best.num_support) || w.mode == 1) {
      best.et = t_best_type;
      std::memcpy(best.indel, t_best_indel, t_best_len);
      best.indel_len = t_best_len;
      best.num_support = t_best_support;
      std::memcpy(best.alt_indel, t_alt_indel, t_alt_len);
      best.alt_indel_len = t_alt_len;
      best.as1 = t_alt_support;
    }
    return true;
  }
  return false;
}

// oracle run_trials (reference ntedit.cpp:1525-1713); check_there is the
// SNV-mode draft-base support baseline (reference :1540-1556 -- the draft
// char competes as "ORI BEST SUB BASE" with edit_type left unset)
Best run_trials_c(WalkCtx& w, uint8_t draft, const Cursor& st, uint64_t fh,
                  uint64_t rh, int32_t check_there = 0) {
  Best best;
  if (w.snv && check_there >= w.bail_edit) {
    best.sub_base = draft;
    best.num_support = check_there;
  }
  int32_t num_deletions = 1;
  std::memset(w.del_done, 0, sizeof(w.del_done));
  const int32_t nb = w.sub_cand_n[draft];
  for (int32_t ci = 0; ci < nb; ci++) {
    const uint8_t sub = w.sub_cand[(int)draft * 4 + ci];
    bool gate;
    int32_t check;
    sub_trial_c(w, ci, st, fh, rh, gate, check);
    if (gate || w.mode == 2) {
      if (check >= w.bail_edit) {
        update_sub_best_c(best, sub, check);
        if (w.mode == 0 || w.mode == 1) continue;
      }
      if (w.mode == 2 || best.et != 1) {
        bool found =
            run_indel_trials_c(w, draft, ci, num_deletions, best, st, fh, rh);
        if (found && (w.mode == 0 || w.mode == 1)) break;
      }
    }
  }
  return best;
}

// Table replay of run_trials_c: reads the fused device phase-A's
// precomputed supports (ops/scan_eval.py) instead of probing the filter.
// Valid ONLY at pure-draft trailing-node sites with no secondary BF, no
// SNV and mode 0/1 (the caller gates all of it).  Returns false ("gave
// up") when the decision needs values the table does not carry — a second
// insertion lane, or a survivor-overflow site; the caller then redoes the
// site natively.  The substitution side effect already applied (the
// apply+revert uppercase of the tail byte) is exactly the native path's,
// so the redo is idempotent.
bool run_trials_table_c(WalkCtx& w, uint8_t draft, int64_t si,
                        const Cursor& st, Best& best) {
  const int32_t C = w.n_combos;
  int32_t num_deletions = 1;
  const int32_t nb = w.sub_cand_n[draft];
  for (int32_t ci = 0; ci < nb; ci++) {
    const uint8_t sub = w.sub_cand[(int)draft * 4 + ci];
    const bool gate = w.t_gate[si * 4 + ci] != 0;
    const int32_t check = w.t_sub[si * 4 + ci];
    if (!gate) continue;  // mode 2 is gated off by the caller
    // native sub_trial_c's apply+revert leaves UPPER(draft) in place
    {
      RNode& t_node = w.rope[st.tn];
      if (t_node.type == 0) w.seq[st.t] = draft;
      else if (t_node.type == 1) t_node.c = draft;
    }
    if (check >= w.bail_edit) {
      update_sub_best_c(best, sub, check);
      continue;  // modes 0/1 skip indels for an accepted sub
    }
    if (best.et == 1) continue;
    // --- indel scan from the table (mirrors run_indel_trials_c)
    if (ci != w.t_ins_lane[si] || !w.t_ins_ok[si]) return false;
    const int row = sub == 'A' ? 0 : sub == 'C' ? 1 : sub == 'G' ? 2 : 3;
    int32_t tb_sup = 0, tb_alt_sup = 0;
    uint8_t tb_indel[64], tb_alt[64];
    int32_t tb_len = 0, tb_alt_len = 0;
    int32_t tb_type = 0;
    bool found = false;
    for (int32_t i = 0; i < C; i++) {
      const int32_t icheck = w.t_ins[si * C + i];
      const uint8_t* cc = w.combo_codes + ((int64_t)row * C + i) * w.max_ins;
      const int32_t clen = w.combo_len[i];
      if (icheck >= w.bail_edit) {
        if (w.mode == 0) {
          best.et = 2;
          std::memcpy(best.indel, cc, clen);
          best.indel_len = clen;
          best.num_support = icheck;
          return true;
        }
        if (icheck >= tb_sup) {
          if (tb_sup) {
            std::memcpy(tb_alt, tb_indel, tb_len);
            tb_alt_len = tb_len;
            tb_alt_sup = tb_sup;
          }
          tb_type = 2;
          std::memcpy(tb_indel, cc, clen);
          tb_len = clen;
          tb_sup = icheck;
        }
      }
      if (num_deletions <= w.max_del) {
        const int32_t del_check =
            w.t_del[si * w.max_del + (num_deletions - 1)];
        const int32_t del_support =
            (del_check >= w.bail_del) ? del_check : 0;
        if (del_support > 0) {
          // deleted bytes: pure-draft trailing node -> consecutive seq
          if (w.mode == 0) {
            best.et = 3;
            for (int32_t j = 0; j < num_deletions; j++)
              best.indel[j] = w.seq[st.t + j];
            best.indel_len = num_deletions;
            best.num_support = del_support;
            return true;
          }
          if (del_support >= tb_sup) {
            if (tb_sup) {
              std::memcpy(tb_alt, tb_indel, tb_len);
              tb_alt_len = tb_len;
              tb_alt_sup = tb_sup;
            }
            tb_type = 3;
            for (int32_t j = 0; j < num_deletions; j++)
              tb_indel[j] = w.seq[st.t + j];
            tb_len = num_deletions;
            tb_sup = del_support;
          }
        }
        num_deletions += 1;
      }
    }
    if (tb_sup > 0) {
      // mode 1 (mode 2 gated off): adopt the scan's best
      best.et = tb_type;
      std::memcpy(best.indel, tb_indel, tb_len);
      best.indel_len = tb_len;
      best.num_support = tb_sup;
      std::memcpy(best.alt_indel, tb_alt, tb_alt_len);
      best.alt_indel_len = tb_alt_len;
      best.as1 = tb_alt_sup;
      found = true;
    }
    if (found) break;  // modes 0/1 exit the sub loop on an indel find
  }
  return true;
}

// oracle _make_edit (reference ntedit.cpp:972-1154)
void make_edit_c(WalkCtx& w, uint8_t draft, const Best& best) {
  const uint32_t k = w.k;
  Cursor& st = w.st;
  const int32_t et = best.et;
  if (et == 1) {
    w.n_subs++;
    RNode& t_node = w.rope[st.tn];
    if (t_node.type == 0) {
      w.seq[st.t] = best.sub_base;
      if (st.t > w.last_base_change) w.last_base_change = st.t;
      if (w.n_recs < w.recs_cap) {
        int64_t* r = w.recs + w.n_recs * 10;
        r[0] = st.t;
        r[1] = draft;
        r[2] = best.sub_base;
        r[3] = best.num_support;
        r[4] = r[5] = r[6] = r[7] = r[8] = r[9] = 0;
        if (best.as1 && best.ab1 != best.sub_base) { r[4] = best.ab1; r[5] = best.as1; }
        if (best.as2 && best.ab2 != best.ab1) { r[6] = best.ab2; r[7] = best.as2; }
        if (best.as3 && best.ab3 != best.ab2) { r[8] = best.ab3; r[9] = best.as3; }
        w.n_recs++;
      } else {
        w.recs_overflow = true;
      }
    } else if (t_node.type == 1) {
      t_node.c = best.sub_base;
    }
    hash_changelast(w.fh, w.rh, k, draft, best.sub_base);
    w.char_in = best.sub_base;
  } else if (et == 2) {
    bool skipped_repeat = false;
    std::string prev = rope_prev_insertion(w, st.t, st.tn);
    std::string indel((const char*)best.indel, best.indel_len);
    uint8_t kmer[72];
    if ((int64_t)prev.size() + (int64_t)indel.size() >= (int64_t)k) {
      if (is_repeat_insertion_c(prev) ||
          (int64_t)prev.size() + (int64_t)indel.size() >= w.ins_cap) {
        rope_rollback_insertion(w, st, (int64_t)prev.size());
        if (rope_find_accepted_kmer(w, st, kmer)) {
          RollState rs;
          rs.seed(kmer, k);
          w.fh = rs.fh;
          w.rh = rs.rh;
          w.char_in = kmer[k - 1];
        }
        skipped_repeat = true;
      } else {
        // NOTE: no break on a repeat hit — the oracle (and reference
        // ntedit.cpp:1071-1100) keeps prepending and may roll back and
        // re-anchor more than once in this loop
        std::string prev_l = prev;
        for (size_t wi = 0; wi < indel.size(); wi++) {
          prev_l.insert(prev_l.begin(),
                        (char)kTabs.rc_c[(uint8_t)indel[wi]]);
          if (is_repeat_insertion_c(prev_l)) {
            rope_rollback_insertion(w, st, (int64_t)prev_l.size() - (int64_t)wi);
            if (rope_find_accepted_kmer(w, st, kmer)) {
              RollState rs;
              rs.seed(kmer, k);
              w.fh = rs.fh;
              w.rh = rs.rh;
              w.char_in = kmer[k - 1];
            }
            skipped_repeat = true;
          }
        }
      }
    }
    if (!skipped_repeat) {
      w.n_ins++;
      st.tn = rope_make_insertion(w, st.tn, st.t, best.indel, best.indel_len,
                                  best.num_support);
      hash_changelast(w.fh, w.rh, k, draft, best.indel[0]);
      w.char_in = best.indel[0];
    }
  } else if (et == 3) {
    w.n_dels++;
    rope_make_deletion(w, st.tn, st.t, best.indel_len, best.num_support);
    uint8_t nxt = (st.tn < (int64_t)w.rope.size())
                      ? rope_get_char(w, st.t, w.rope[st.tn])
                      : 0;
    hash_changelast(w.fh, w.rh, k, draft, nxt);
    w.char_in = nxt;
  } else {
    w.n_nofix++;
    if (w.mask) {
      w.n_masked++;
      RNode& t_node = w.rope[st.tn];
      const uint8_t lo = kTabs.lower[draft];
      if (t_node.type == 0) w.seq[st.t] = lo;
      else if (t_node.type == 1) t_node.c = lo;
      hash_changelast(w.fh, w.rh, k, draft, lo);
      w.char_in = lo;
    }
  }
}

}  // namespace

extern "C" {

// Full-contig native editing walk; byte-identical to the oracle editor.
// present: optional [n-k+1] uint8 of primary-BF probe results on the raw
// draft (device- or host-precomputed); used only where provably valid.
// Returns 0 ok; 1 = out/recs buffer too small (caller retries bigger);
// -1 bad args.  recs rows: [pos, draft, sub, supp, ab1, as1, ab2, as2,
// ab3, as3], alt fields zeroed when the oracle would omit them.
int gp_polish_contig(
    const uint8_t* seq_in, int64_t n, uint32_t k, uint32_t hash_num,
    const uint8_t* bf, uint64_t bf_bytes,
    const uint8_t* bf2, uint64_t bf2_bytes,
    const uint8_t* present,
    const int64_t* tsite, int64_t n_tsites,  // fused phase-A site tables
    const uint8_t* t_gate, const int8_t* t_sub, const int8_t* t_del,
    const int8_t* t_ins_lane, const uint8_t* t_ins_ok, const int8_t* t_ins,
    int32_t mode, int32_t mask_flag, int32_t max_ins, int32_t max_del,
    int32_t jump, int32_t insertion_cap,
    int32_t bail_edit, int32_t bail_del, int32_t bail_missing,
    int32_t snv,
    const uint8_t* sub_cand, const int32_t* sub_cand_n,
    const uint8_t* combo_codes, const int32_t* combo_len, int32_t n_combos,
    uint8_t* out_seq, int64_t out_cap, int64_t* out_len,
    int64_t* recs, int64_t recs_cap, int64_t* n_recs,
    int64_t* stats /* [n_subs, n_ins, n_dels, n_masked, n_nofix,
                       n_table_hits, n_table_giveups] */) {
  if (hash_num > 16 || k > 64 || max_del > 7 || max_ins > 5) return -1;
  WalkCtx w;
  w.k = k;
  w.hn_ = hash_num;
  w.mode = mode;
  w.mask = mask_flag;
  w.max_ins = max_ins;
  w.max_del = max_del;
  w.jump = jump;
  w.ins_cap = insertion_cap;
  w.bail_edit = bail_edit;
  w.bail_del = bail_del;
  w.bail_missing = bail_missing;
  w.snv = snv;
  w.bf = bf;
  w.bits = bf_bytes * 8;
  w.bf2 = bf2;
  w.bits2 = bf2_bytes * 8;
  w.sub_cand = sub_cand;
  w.sub_cand_n = sub_cand_n;
  w.combo_codes = combo_codes;
  w.combo_len = combo_len;
  w.n_combos = n_combos;
  w.present = present;
  w.tsite = tsite;
  w.n_tsites = (present != nullptr) ? n_tsites : 0;  // tables need present
  w.t_gate = t_gate;
  w.t_sub = t_sub;
  w.t_del = t_del;
  w.t_ins_lane = t_ins_lane;
  w.t_ins_ok = t_ins_ok;
  w.t_ins = t_ins;
  w.recs = recs;
  w.recs_cap = recs_cap;

  std::vector<uint8_t> seq_buf(seq_in, seq_in + n);
  w.seq = seq_buf.data();
  w.n = n;
  w.rope.push_back(RNode{0, 0, n - 1, 0, 0});

  Cursor& st = w.st;
  st.h = find_first_accepted(w.seq, n, k);
  st.t = st.h + k - 1;
  st.hn = st.tn = 0;
  if (st.h + (int64_t)k - 1 < n) {
    RollState rs;
    rs.seed(w.seq + st.h, k);
    w.fh = rs.fh;
    w.rh = rs.rh;
    w.char_in = w.seq[st.t];
  }

  // scan_from (oracle ntedit.cpp:1461-1760), exit_check=None
  bool first = true;
  for (;;) {
    if (!first) {
      int64_t target = -1;
      bool alive = true;
      for (;;) {
        uint8_t c_out, c_in;
        if (rope_roll(w, st, c_out, c_in)) {
          if (!kTabs.accepted[kTabs.upper[c_in]]) target = st.t + k;
          hash_roll(w.fh, w.rh, k, c_out, c_in);
          w.char_in = c_in;
        } else {
          alive = false;
          break;
        }
        if (!(target >= 0 && st.t != target)) break;
      }
      if (!alive) break;
    }
    first = false;
    if (st.h + (int64_t)k - 1 >= n) break;
    bool missing = w.snv || !probe_primary(w, w.fh, w.rh);
    if (!missing) {
      // bulk clean-run fast path: when the cursor sits in the trailing
      // pure-draft node, windows are contiguous seq bytes — zero-copy run.
      if (st.hn == st.tn && w.rope[st.hn].type == 0 &&
          w.rope[st.hn].e == n - 1) {
        const int64_t lim = n - (int64_t)k - st.h;
        if (lim > 0) {
          int64_t m = 0;
          int stopped_missing = 0;
          if (w.present && st.h > w.last_base_change) {
            // present[] gives every probe on unmutated draft content; scan
            // it (plus the incoming-char accept gate), then reseed hashes
            // at the stop window — k ops instead of m probe chains.
            int64_t i = 1;
            for (; i <= lim; i++) {
              const uint8_t cin = w.seq[st.h + i + k - 1];
              if (!kTabs.accepted[kTabs.upper[cin]]) break;
              m = i;
              if (!w.present[st.h + i]) {
                stopped_missing = 1;
                break;
              }
            }
            if (m) {
              RollState rs;
              rs.seed(w.seq + st.h + m, k);
              w.fh = rs.fh;
              w.rh = rs.rh;
            }
          } else {
            // Software-pipelined run: roll a block of windows ahead,
            // prefetching every window's Bloom slots while later windows
            // are still hashing, then test from (now-warm) cache.  The
            // serial roll+probe loop pays ~one memory latency per window
            // (its h slots probe in parallel but windows are chained);
            // blocking raises the outstanding-miss count to the hardware
            // limit.  Probing past the first missing window is harmless —
            // the BF is read-only and overshoot hashes are discarded.
            constexpr int B = 32;
            uint64_t fhs[B], rhs[B];
            uint64_t slots[B][16];
            RollState rs{w.fh, w.rh};
            bool hashes_final = true;  // rs holds the hash at window m
            int64_t i = 1;
            while (i <= lim && !stopped_missing) {
              int nb = 0;
              while (nb < B && i + nb <= lim) {
                const uint8_t cin = w.seq[st.h + i + nb + k - 1];
                if (!kTabs.accepted[kTabs.upper[cin]]) break;
                rs.roll(w.seq[st.h + i + nb - 1], cin, k);
                fhs[nb] = rs.fh;
                rhs[nb] = rs.rh;
                uint64_t hs[16];
                multi_hash(rs.fh + rs.rh, k, hash_num, hs);
                for (uint32_t hh = 0; hh < hash_num; hh++) {
                  const uint64_t b = bf_reduce(hs[hh], w.bits);
                  slots[nb][hh] = b;
                  __builtin_prefetch(&w.bf[b >> 3], 0, 3);
                }
                nb++;
              }
              if (!nb) break;  // non-accepted char at the very next window
              int j = 0;
              for (; j < nb; j++) {
                bool ok = true;
                for (uint32_t hh = 0; hh < hash_num; hh++) {
                  const uint64_t b = slots[j][hh];
                  if (!((w.bf[b >> 3] >> (b & 7)) & 1)) {
                    ok = false;
                    break;
                  }
                }
                m = i + j;
                if (!ok) {
                  stopped_missing = 1;
                  hashes_final = false;  // rs rolled past window m
                  w.fh = fhs[j];
                  w.rh = rhs[j];
                  break;
                }
              }
              i += nb;
              if (nb < B && !stopped_missing) break;  // bad char ended the run
            }
            if (hashes_final) {
              w.fh = rs.fh;
              w.rh = rs.rh;
            }
          }
          if (m) {
            st.h += m;
            st.t += m;
            w.char_in = w.seq[st.t];
            if (stopped_missing) {
              first = true;  // state is AT the missing window
              continue;
            }
            continue;  // stopped at a bad char or the end: roll next iter
          }
        }
      }
      continue;
    }
    // detection (reference :1487-1523)
    {
      const uint8_t draft = kTabs.upper[w.char_in];
      // pure-draft trailing-node sites can read detection probes straight
      // from present[] (windows st.h+1..st.h+k are unmutated draft) and
      // replay trials from the fused device tables when provided
      const bool pure = !w.snv && w.present && st.h > w.last_base_change &&
                        st.hn == st.tn && w.rope[st.hn].type == 0 &&
                        w.rope[st.hn].e == n - 1 &&
                        st.h + 2 * (int64_t)k - 1 <= n - 1;
      int32_t check_missing = 0;
      int32_t check_there = 0;  // SNV draft-base support (oracle :952)
      bool do_not_fix = false;
      if (pure) {
        for (uint32_t kk = 0; kk < k; kk++) {
          const uint8_t cin = w.seq[st.t + 1 + kk];
          if (!kTabs.accepted[kTabs.upper[cin]]) {
            do_not_fix = true;
            break;
          }
          if (kk % jump == 0 && !w.present[st.h + 1 + kk]) check_missing++;
        }
      } else {
        Cursor tmp = st;
        uint64_t tfh = w.fh, trh = w.rh;
        uint32_t kk = 0;
        while (kk < k && tmp.h < n) {
          uint8_t c_out, c_in;
          if (rope_roll(w, tmp, c_out, c_in)) {
            hash_roll(tfh, trh, k, c_out, c_in);
            if (!kTabs.accepted[kTabs.upper[c_in]]) {
              do_not_fix = true;
              break;
            }
            if (kk % jump == 0) {
              if (!probe_primary(w, tfh, trh)) check_missing++;
              else if (kTabs.atgc[draft]) check_there++;
            }
          } else {
            do_not_fix = true;
            break;
          }
          kk++;
        }
      }
      if (w.snv || (!do_not_fix && check_missing >= bail_missing)) {
        Best best;
        bool done = false;
        if (pure && w.n_tsites && !w.bf2 && (w.mode == 0 || w.mode == 1)) {
          const int64_t* end = w.tsite + w.n_tsites;
          const int64_t* it = std::lower_bound(w.tsite, end, st.h);
          if (it != end && *it == st.h) {
            const int64_t si = it - w.tsite;
            if (run_trials_table_c(w, draft, si, st, best)) {
              w.n_table_hits++;
              done = true;
            } else {
              w.n_table_giveups++;
              best = Best();
            }
          }
        }
        if (!done) best = run_trials_c(w, draft, st, w.fh, w.rh, check_there);
        make_edit_c(w, draft, best);
      }
    }
  }

  // render (oracle _render / reference writeEditsToFile)
  int64_t olen = 0;
  for (const RNode& nd : w.rope) {
    if (nd.type == -1) break;
    if (nd.type == 0) {
      const int64_t len = nd.e - nd.s + 1;
      if (olen + len > out_cap) return 1;
      std::memcpy(out_seq + olen, w.seq + nd.s, len);
      olen += len;
    } else if (nd.type == 1) {
      if (olen + 1 > out_cap) return 1;
      out_seq[olen++] = nd.c;
    }
  }
  *out_len = olen;
  *n_recs = w.n_recs;
  stats[0] = w.n_subs;
  stats[1] = w.n_ins;
  stats[2] = w.n_dels;
  stats[3] = w.n_masked;
  stats[4] = w.n_nofix;
  stats[5] = w.n_table_hits;
  stats[6] = w.n_table_giveups;
  return w.recs_overflow ? 1 : 0;
}

// 2-bit sequence packing for the device-scan transfer: ACGT/acgt pack to
// classes 0..3 (hashing only distinguishes those four classes plus "other",
// ops/nthash.py seed tables); every other byte is recorded as an exception
// (position + raw byte) that the device scatters back into its one-hot
// channels.  Returns the exception count, or -1 if it exceeds exc_cap
// (caller falls back to the raw-byte transfer).  packed has capacity
// ceil(n/4); every byte of it is written (whole bytes of four bases, so it
// need not arrive zeroed, and a pinned slot is packed in place).
int64_t gp_pack2(const uint8_t* seq, int64_t n, uint8_t* packed,
                 int64_t* exc_pos, uint8_t* exc_byte, int64_t exc_cap) {
  // a function-local static: initialised once, safely across threads
  static const std::array<uint8_t, 256> cls_tab = [] {
    std::array<uint8_t, 256> t;
    t.fill(255);
    const char* b = "ACGT";
    for (int i = 0; i < 4; i++) {
      t[(uint8_t)b[i]] = (uint8_t)i;
      t[(uint8_t)(b[i] + 32)] = (uint8_t)i;
    }
    return t;
  }();
  int64_t m = 0;
  for (int64_t i0 = 0; i0 < n; i0 += 4) {
    const int64_t end = std::min<int64_t>(n, i0 + 4);
    uint8_t out = 0;
    for (int64_t i = i0; i < end; i++) {
      uint8_t cls = cls_tab[seq[i]];
      if (cls == 255) {
        if (m >= exc_cap) return -1;
        exc_pos[m] = i;
        exc_byte[m] = seq[i];
        m++;
        cls = 0;
      }
      out = (uint8_t)(out | (cls << ((i & 3) * 2)));
    }
    packed[i0 >> 2] = out;
  }
  return m;
}

// de Bruijn 4-way extension probe (the gap-filler BFS's hot operation,
// reference Konnector/DBGBloom.h:107-150 adjacency): returns a 4-bit mask
// of which of A/C/G/T extensions of `kmer` probe present in the BF.
// forward=1 tests (kmer[1:] + b); forward=0 tests (b + kmer[:-1]).
// One call replaces a Python-side seed + 4 changelast rehashes + 4 tuple
// probes (~10 us of interpreter work) with ~1 us of C.
int32_t gp_extend4(const uint8_t* kmer, uint32_t k, uint32_t hash_num,
                   const uint8_t* bf, uint64_t bf_bytes, int32_t forward) {
  if (hash_num > 16 || k < 2 || k > 64) return -1;
  const uint64_t bits = bf_bytes * 8;
  static const uint8_t BASES[4] = {'A', 'C', 'G', 'T'};
  uint8_t window[64];
  if (forward) {  // candidates are (kmer[1:] + b)
    std::memcpy(window, kmer + 1, k - 1);
    window[k - 1] = 'A';
  } else {  // candidates are (b + kmer[:-1])
    window[0] = 'A';
    std::memcpy(window + 1, kmer, k - 1);
  }
  RollState rs;
  rs.seed(window, k);
  uint64_t hs[16];
  int32_t mask = 0;
  for (int b = 0; b < 4; b++) {
    uint64_t f = rs.fh, r = rs.rh;
    if (BASES[b] != 'A') {
      if (forward) {
        hash_changelast(f, r, k, 'A', BASES[b]);
      } else {
        // changefirst (ops/nthash.ntc64_changefirst_i): the x_0 term has
        // rotation k-1 in fh and 0 in rh
        f ^= srol_n(kSeeds.fwd['A'] ^ kSeeds.fwd[BASES[b]], (k - 1) % 1023);
        r ^= kSeeds.rc['A'] ^ kSeeds.rc[BASES[b]];
      }
    }
    multi_hash(f + r, k, hash_num, hs);
    if (bf_contains(bf, bits, hs, hash_num)) mask |= 1 << b;
  }
  return mask;
}

// Packed-vertex variant of gp_extend4 for the host search's 2-bit packed
// k-mer vertices (ops/kmers.py; the reference's packed Kmer role,
// Konnector vertices = Common/Kmer.h:58-144): kmer is a uint64 with the
// first base in the HIGH bits, A=0 C=1 G=2 T=3, k <= 32.  Unpacks to
// ASCII on the stack and reuses the string probe — the unpack is 32 table
// reads, dwarfed by the 4*h Bloom probes.
int32_t gp_extend4p(uint64_t kmer, uint32_t k, uint32_t hash_num,
                    const uint8_t* bf, uint64_t bf_bytes, int32_t forward) {
  if (k < 2 || k > 32) return -1;
  static const uint8_t BASES[4] = {'A', 'C', 'G', 'T'};
  uint8_t buf[32];
  for (uint32_t i = 0; i < k; i++)
    buf[i] = BASES[(kmer >> (2 * (k - 1 - i))) & 3];
  return gp_extend4(buf, k, hash_num, bf, bf_bytes, forward);
}

}  // extern "C"

// ===========================================================================
// The sealer's host search for one k round (gp_konnect_pairs): a C port of
// fill/konnector.py's get_start_kmer_pos, _prepare_search, _BidiSearch and
// paths_to_goal on 2-bit packed vertices (first base in the high bits,
// A=0 C=1 G=2 T=3, k <= 32).  Every map, list and counter below mirrors its
// Python twin by name and is updated in the same order, so results, costs,
// abort points and path order are the Python search's (pinned by
// tests/test_torch_konnector_native.py).  No static state: rounds of
// several batches may run at once on separate threads.
// ===========================================================================

namespace {

constexpr int64_t KN_NO_LIMIT = 0xFFFFFFFFLL;  // konnector.NO_LIMIT
constexpr int64_t KN_MEM_COUNTER_ROLLOVER = 1000;
// result codes, in the order of konnector._NATIVE_CODES
enum { KN_NO_PATH, KN_FOUND_PATH, KN_TOO_MANY_PATHS, KN_TOO_MANY_BRANCHES,
       KN_MAX_COST_EXCEEDED, KN_EXCEEDED_MEM_LIMIT };
// what a pair's row holds: no anchors (a flank shorter than k or a missing
// anchor: the default SearchResult), anchored (searched, or identical
// anchors), or left to the Python search (an anchor that does not pack)
enum { KN_UNANCHORED, KN_ANCHORED, KN_FALLBACK };

// Python's // and % (floor division) for the depth split and path quotas
inline int64_t py_floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q--;
  return q;
}
inline int64_t py_mod(int64_t a, int64_t b) { return a - py_floordiv(a, b) * b; }

inline bool kn_acgt(uint8_t c) { return c == 'A' || c == 'C' || c == 'G' || c == 'T'; }

inline int kn_code(uint8_t c) {
  return c == 'A' ? 0 : c == 'C' ? 1 : c == 'G' ? 2 : 3;
}

struct EdgeHash {
  size_t operator()(const std::pair<uint64_t, uint64_t>& e) const {
    return std::hash<uint64_t>()(e.first * 0x9E3779B97F4A7C15ULL ^ e.second);
  }
};

struct KnGraph {
  uint32_t k, h;
  const uint8_t* bf;
  uint64_t bytes;
  uint64_t kmask;
  unsigned top;
  // PackedDBG.successors / predecessors: children in ascending base order
  int succ(uint64_t v, uint64_t* out) const {
    int32_t m = gp_extend4p(v, k, h, bf, bytes, 1);
    uint64_t base = (v << 2) & kmask;
    int n = 0;
    for (int b = 0; b < 4; b++)
      if (m >> b & 1) out[n++] = base | (uint64_t)b;
    return n;
  }
  int pred(uint64_t v, uint64_t* out) const {
    int32_t m = gp_extend4p(v, k, h, bf, bytes, 0);
    uint64_t base = v >> 2;
    int n = 0;
    for (int b = 0; b < 4; b++)
      if (m >> b & 1) out[n++] = base | ((uint64_t)b << top);
    return n;
  }
};

// get_start_kmer_pos: DBG.window_probes' present/valid per window (the
// rolling hash of gp_nthash_all; a window is probed only where valid, the
// only windows the scan reads), then the right-to-left run counting.
int64_t kn_start_pos(const uint8_t* s, int64_t n, const KnGraph& g,
                     int64_t threshold, bool anchor_to_end,
                     std::vector<uint8_t>& ok) {
  const uint32_t k = g.k;
  if (n < (int64_t)k) return -1;
  const int64_t nw = n - k + 1;
  const uint64_t bits = g.bytes * 8;
  ok.assign(nw, 0);  // bit 0 valid, bit 1 present
  uint64_t fh = 0, rh = 0;
  int64_t bad = 0;
  for (uint32_t i = 0; i < k; i++) {
    fh = srol(fh) ^ kSeeds.fwd[s[i]];
    rh = srol(rh) ^ kSeeds.rc[s[k - 1 - i]];
    bad += !kn_acgt(s[i]);
  }
  uint64_t hs[16];
  for (int64_t w = 0; w < nw; w++) {
    if (w > 0) {
      uint8_t out_c = s[w - 1], in_c = s[w + k - 1];
      fh = srol(fh) ^ kSeeds.fwd[in_c] ^ srol_n(kSeeds.fwd[out_c], k);
      uint64_t v = rh ^ srol_n(kSeeds.rc[in_c], k) ^ kSeeds.rc[out_c];
      uint64_t hi = v >> 33, lo = v & M33;
      hi = ((hi >> 1) | (hi << 30)) & M31;
      lo = ((lo >> 1) | (lo << 32)) & M33;
      rh = (hi << 33) | lo;
      bad += (int64_t)!kn_acgt(in_c) - (int64_t)!kn_acgt(out_c);
    }
    if (bad == 0) {
      multi_hash(fh + rh, k, g.h, hs);
      ok[w] = 1 | (bf_contains(g.bf, bits, hs, g.h) ? 2 : 0);
    }
  }
  int64_t match_count = 0, max_len = 0, max_pos = 0, prev_pos = nw;
  bool broke = false;
  for (int64_t p = nw - 1; p >= 0; p--) {
    if (!(ok[p] & 1)) continue;
    if (prev_pos - p > 1 || !(ok[p] & 2)) {
      if (match_count > max_len) {
        max_pos = p + 1;
        max_len = match_count;
      }
      if (anchor_to_end) {
        broke = true;
        break;
      }
      match_count = 0;
    } else {
      match_count++;
      if (match_count >= threshold) return p;
    }
    prev_pos = p;
  }
  if (!broke && match_count > max_len) {
    max_pos = prev_pos;
    max_len = match_count;
  }
  return max_len > 0 ? max_pos : -1;
}

// _BidiSearch (konnector.py): the alternating two-frontier constrained BFS
// and its path enumeration.
struct KnSearch {
  static constexpr int F = 0, R = 1;
  const KnGraph& g;
  uint64_t start, goal;
  int64_t max_paths, min_path_len, max_path_len, max_branches, max_cost,
      mem_limit;
  int64_t max_depth[2];
  std::unordered_map<uint64_t, int64_t> depth[2];
  std::unordered_set<uint64_t> color[2];
  std::unordered_map<uint64_t, std::vector<uint64_t>> trav[2];
  std::vector<std::pair<uint64_t, uint64_t>> common_edges;
  std::unordered_set<std::pair<uint64_t, uint64_t>, EdgeHash> common_set;
  int64_t cost = 0, nodes_visited = 0, peak_branches = 0;
  bool too_many_paths = false, too_many_branches = false,
       max_cost_exceeded = false, exceeded_mem_limit = false;
  int64_t trav_edges = 0, mem_counter = 0;
  std::deque<uint64_t> q[2];

  KnSearch(const KnGraph& g_, uint64_t s, uint64_t t, int64_t mp, int64_t minl,
           int64_t maxl, int64_t mb, int64_t mc, int64_t ml)
      : g(g_), start(s), goal(t), max_paths(mp), min_path_len(minl),
        max_path_len(maxl), max_branches(mb), max_cost(mc), mem_limit(ml) {
    int64_t md = max_path_len - 1;
    max_depth[F] = py_floordiv(md, 2) + py_mod(md, 2);
    max_depth[R] = py_floordiv(md, 2);
  }

  int64_t approx_mem_usage() const {
    int64_t per_vertex = 160 + g.k, per_edge = 60 + g.k;
    int64_t n_vertices = (int64_t)(depth[0].size() + depth[1].size());
    return n_vertices * per_vertex + trav_edges * per_edge;
  }

  bool check_mem() {
    if (mem_limit == KN_NO_LIMIT) return true;
    if (++mem_counter >= KN_MEM_COUNTER_ROLLOVER) {
      mem_counter = 0;
      if (approx_mem_usage() > mem_limit) {
        exceeded_mem_limit = true;
        return false;
      }
    }
    return true;
  }

  int64_t depth_of(int dirn, uint64_t v) const {
    auto it = depth[dirn].find(v);
    return it == depth[dirn].end() ? 0 : it->second;
  }

  void record_traversal(int dirn, uint64_t u, uint64_t v) {
    if (dirn == F)
      trav[F][v].push_back(u);
    else
      trav[R][u].push_back(v);
    trav_edges++;
  }

  bool spend() {  // the cost check and charge of every edge kind
    if (cost >= max_cost) {
      max_cost_exceeded = true;
      return false;
    }
    cost++;
    return true;
  }

  // false aborts the whole search
  bool visit_edge(int dirn, uint64_t u, uint64_t v) {
    if (!check_mem()) return false;
    uint64_t child = dirn == F ? v : u;
    uint64_t parent = dirn == F ? u : v;
    int other = dirn == F ? R : F;
    if (color[other].count(child)) {  // common edge
      if (!spend()) return false;
      if (depth_of(dirn, parent) >= max_depth[dirn]) return true;
      if (common_set.insert({u, v}).second) {
        common_edges.push_back({u, v});
        if (max_paths != KN_NO_LIMIT && (int64_t)common_edges.size() > max_paths) {
          too_many_paths = true;
          return false;
        }
      }
      record_traversal(F, u, v);
      record_traversal(R, u, v);
      return true;
    }
    if (!color[dirn].count(child)) {  // tree edge
      if (!spend()) return false;
      int64_t pd = depth_of(dirn, parent);
      if (pd == max_depth[dirn]) return true;
      depth[dirn][child] = pd + 1;
      record_traversal(dirn, u, v);
      if (max_branches != KN_NO_LIMIT && (int64_t)q[dirn].size() >= max_branches) {
        too_many_branches = true;
        return false;
      }
      nodes_visited++;
      peak_branches = std::max(peak_branches, (int64_t)q[dirn].size() + 1);
      color[dirn].insert(child);
      q[dirn].push_back(child);
      return true;
    }
    if (!spend()) return false;  // non-tree edge
    record_traversal(dirn, u, v);
    return true;
  }

  void run() {
    color[F].insert(start);
    color[R].insert(goal);
    nodes_visited += 2;
    peak_branches = std::max<int64_t>(peak_branches, 2);
    q[F].push_back(start);
    q[R].push_back(goal);
    int dirn = F;
    uint64_t nb[4];
    while (!q[F].empty() || !q[R].empty()) {
      uint64_t u = q[dirn].front();
      q[dirn].pop_front();
      int n = dirn == F ? g.succ(u, nb) : g.pred(u, nb);
      for (int i = 0; i < n; i++) {
        bool go = dirn == F ? visit_edge(F, u, nb[i]) : visit_edge(R, nb[i], u);
        if (!go) return;
      }
      if (dirn == R && !q[F].empty())
        dirn = F;
      else if (dirn == F && !q[R].empty())
        dirn = R;
    }
  }

  // _all_paths: the backtracking DFS whose stack discipline fixes the path
  // order; returns the status and adds its cost to *cost_out
  int all_paths(const std::unordered_map<uint64_t, std::vector<uint64_t>>& graph,
                uint64_t from, uint64_t to, int64_t max_n, int64_t max_d,
                int64_t max_c, std::vector<std::vector<uint64_t>>& paths,
                int64_t* cost_out) const {
    paths.clear();
    int64_t c = 0;
    std::vector<std::pair<uint64_t, int64_t>> stack{{from, 0}};
    std::vector<uint64_t> path;
    std::unordered_set<uint64_t> on_path;
    int status = KN_NO_PATH;
    while (!stack.empty()) {
      c++;
      if (c > max_c) {
        status = KN_MAX_COST_EXCEEDED;
        break;
      }
      auto [node, d] = stack.back();
      stack.pop_back();
      while ((int64_t)path.size() > d) {
        on_path.erase(path.back());
        path.pop_back();
      }
      path.push_back(node);
      on_path.insert(node);
      if (node == to) {
        paths.push_back(path);
        if (max_n != KN_NO_LIMIT && (int64_t)paths.size() > max_n) {
          status = KN_TOO_MANY_PATHS;
          break;
        }
        continue;
      }
      if (d >= max_d) continue;
      auto it = graph.find(node);
      if (it == graph.end()) continue;
      for (uint64_t nxt : it->second) {
        if (on_path.count(nxt)) continue;
        stack.push_back({nxt, d + 1});
      }
    }
    *cost_out += c;
    if (status != KN_NO_PATH) {
      paths.clear();
      return status;
    }
    return paths.empty() ? KN_NO_PATH : KN_FOUND_PATH;
  }

  // paths_to_goal: the status, and the paths in enumeration order
  int paths_to_goal(std::vector<std::vector<uint64_t>>& found) {
    found.clear();
    if (too_many_paths) return KN_TOO_MANY_PATHS;
    if (too_many_branches) return KN_TOO_MANY_BRANCHES;
    if (max_cost_exceeded) return KN_MAX_COST_EXCEEDED;
    if (exceeded_mem_limit) return KN_EXCEEDED_MEM_LIMIT;
    int overall = KN_NO_PATH;
    std::vector<std::vector<uint64_t>> left, right;
    for (const auto& [u, v] : common_edges) {
      if (cost > max_cost) {
        found.clear();
        return KN_MAX_COST_EXCEEDED;
      }
      int64_t max_to_start = max_paths - (int64_t)found.size();
      int st = all_paths(trav[F], u, start, max_to_start, max_depth[F],
                         max_cost - cost, left, &cost);
      if (st == KN_FOUND_PATH) {
        int64_t max_to_goal =
            py_floordiv(max_paths - (int64_t)found.size(), (int64_t)left.size());
        st = all_paths(trav[R], v, goal, max_to_goal, max_depth[R],
                       max_cost - cost, right, &cost);
        if (st == KN_FOUND_PATH) {
          bool added = false;
          for (const auto& lp : left)
            for (const auto& rp : right) {
              int64_t total = (int64_t)(lp.size() + rp.size());
              if (total < min_path_len || total > max_path_len) continue;
              std::vector<uint64_t> p(lp.rbegin(), lp.rend());
              p.insert(p.end(), rp.begin(), rp.end());
              found.push_back(std::move(p));
              added = true;
            }
          st = added ? KN_FOUND_PATH : KN_NO_PATH;
        }
      }
      if (st == KN_FOUND_PATH) {
        overall = KN_FOUND_PATH;
      } else if (st != KN_NO_PATH) {
        found.clear();
        return st;
      }
    }
    return overall;
  }
};

// path_to_seq on packed vertices: the first k-mer, then each later
// vertex's last base
void kn_path_seq(const std::vector<uint64_t>& path, uint32_t k, std::string& out) {
  static const char BASES[4] = {'A', 'C', 'G', 'T'};
  out.clear();
  for (uint32_t i = 0; i < k; i++)
    out.push_back(BASES[(path[0] >> (2 * (k - 1 - i))) & 3]);
  for (size_t i = 1; i < path.size(); i++) out.push_back(BASES[path[i] & 3]);
}

}  // namespace

extern "C" {

// One k round of the sealer's searches (konnector.connect_pairs_batch on a
// plain DBG): for each pair i0, i0+1, ... of reads (read1 = reads[offs[2i] ..
// offs[2i+1]), read2 = reads[offs[2i+1] .. offs[2i+2])), the anchor choice
// on both flanks, the decided cases of _prepare_search, the bidirectional
// search and the path enumeration.
//
// prm: min_merged_seq_len, max_merged_seq_len, max_paths, max_branches,
// max_cost, mem_limit, preserve_reads.  res: 8 int64 a pair: kind (KN_*),
// result code, start and goal k-mer positions, cost (before the path
// enumeration), nodes visited, peak branches, paths.  A found pair's
// connecting sequences go to seqs (concatenated) and their lengths to lens.
// used[0], used[1]: bytes and paths this call wrote.  When a pair's paths
// do not fit, the call stops before it and leaves what that pair needs in
// used[2], used[3].  Returns the index one past the last pair done, or -1
// for arguments out of range.
int64_t gp_konnect_pairs(const uint8_t* reads, const int64_t* offs,
                         int64_t n_pairs, int64_t i0, uint32_t k,
                         uint32_t hash_num, const uint8_t* bf, uint64_t bf_bytes,
                         const int64_t* prm, int64_t* res, uint8_t* seqs,
                         int64_t seqs_cap, int64_t* lens, int64_t lens_cap,
                         int64_t* used) {
  if (k < 2 || k > 32 || hash_num < 1 || hash_num > 16 || i0 < 0) return -1;
  const KnGraph g{k, hash_num, bf, bf_bytes,
                  k == 32 ? ~0ULL : ((1ULL << (2 * k)) - 1), 2 * (k - 1)};
  const int64_t min_merged = prm[0], max_merged = prm[1];
  const bool preserve = prm[6] != 0;
  used[0] = used[1] = used[2] = used[3] = 0;
  std::vector<uint8_t> ok;
  std::vector<std::vector<uint64_t>> paths;
  std::vector<std::string> seq_out;
  for (int64_t i = i0; i < n_pairs; i++) {
    const uint8_t* r1 = reads + offs[2 * i];
    const int64_t n1 = offs[2 * i + 1] - offs[2 * i];
    const uint8_t* r2 = reads + offs[2 * i + 1];
    const int64_t n2 = offs[2 * i + 2] - offs[2 * i + 1];
    int64_t* row = res + 8 * i;
    std::fill(row, row + 8, 0);
    row[0] = KN_UNANCHORED;
    row[2] = row[3] = -1;
    seq_out.clear();
    if (n1 >= (int64_t)k && n2 >= (int64_t)k) {
      int64_t sp = kn_start_pos(r1, n1, g, 3, preserve, ok);
      int64_t gp = kn_start_pos(r2, n2, g, 3, preserve, ok);
      if (sp >= 0 && gp >= 0) {
        bool packable = true;
        uint64_t s = 0, t = 0;
        for (uint32_t j = 0; j < k; j++) {
          uint8_t a = r1[sp + j], b = r2[gp + k - 1 - j];
          packable = packable && kn_acgt(a) && kn_acgt(b);
          s = (s << 2) | (uint64_t)kn_code(a);
          t = (t << 2) | (uint64_t)(3 - kn_code(b));  // revcomp of the goal
        }
        row[0] = packable ? KN_ANCHORED : KN_FALLBACK;
        row[2] = sp;
        row[3] = gp;
        if (packable && s == t) {  // identical anchors: a one-node path
          row[1] = KN_FOUND_PATH;
          seq_out.emplace_back((const char*)r1 + sp, k);
        } else if (packable) {
          int64_t max_path_len = max_merged - k + 1 - sp - gp;
          int64_t min_path_len =
              std::max<int64_t>(0, min_merged - k + 1 - sp - gp);
          min_path_len = std::max({min_path_len, n1 - (int64_t)k + 1 - sp,
                                   n2 - (int64_t)k + 1 - gp});
          KnSearch srch(g, s, t, prm[2], min_path_len, max_path_len, prm[3],
                        prm[4], prm[5]);
          srch.run();
          row[4] = srch.cost;
          row[5] = srch.nodes_visited;
          row[6] = srch.peak_branches;
          row[1] = srch.paths_to_goal(paths);
          if (row[1] == KN_FOUND_PATH) {
            seq_out.resize(paths.size());
            for (size_t j = 0; j < paths.size(); j++)
              kn_path_seq(paths[j], k, seq_out[j]);
          }
        }
      }
    }
    int64_t bytes = 0;
    for (const auto& x : seq_out) bytes += (int64_t)x.size();
    if (used[0] + bytes > seqs_cap || used[1] + (int64_t)seq_out.size() > lens_cap) {
      used[2] = bytes;
      used[3] = (int64_t)seq_out.size();
      return i;
    }
    row[7] = (int64_t)seq_out.size();
    for (const auto& x : seq_out) {
      std::memcpy(seqs + used[0], x.data(), x.size());
      used[0] += (int64_t)x.size();
      lens[used[1]++] = (int64_t)x.size();
    }
  }
  return n_pairs;
}

}  // extern "C"
