// Kernel 4 (K2): the fused phase-A eval — dense scan, hot-site detection,
// cluster heads and the candidate-trial tables the native walker replays.
//
// Replaces: goldpolish_tpu/ops/scan_eval.py `build_fused` -> `run`
// (:235-522), one XLA program whose every Bloom test rides the Pallas probe
// P3 (`_probe_lo32_mxu_i8`, bloom_pallas.py:331) on a TPU.  The plain torch
// version, goldpolish_tpu_torch/ops/scan_eval.py:scan_eval_reference,
// follows the XLA program step by step and is what the tests hold these
// kernels against.
//
// Four launches on one stream (plus the memsets of two outputs), no host
// synchronisation; n_sites stays on the device:
//   se_tile     one block per row tile of kTile windows: stages the tile's
//               bytes with a 2k-1 halo on each side, rolls the window hashes
//               (nthash_roll.cuh), probes, and keeps presence, cleanness
//               (all k bytes accepted) and hot flags in shared memory; writes
//               the packed presence bits, the tile's head count and its heads
//               (hot, no hot in the k-1 windows before), ascending, into a
//               per-tile staging area
//   se_compact  one block: an exclusive scan of the tile counts gives
//               n_sites and puts the S smallest heads, ascending, into site
//               (-1 past them); clears the need bitmap
//   se_sites    one warp per live slot (< min(n_sites, S), a grid-stride
//               loop), plus one warp for global window 0 when a slot is a
//               pad (site -1 evaluates window 0); the warp stages the site's
//               bytes, recomputes the window hashes of the substitutions, and
//               spreads the substitution and deletion windows over its lanes;
//               writes gate, supports and the insertion lane, and sets the
//               slot's need bit
//   se_ins      copies the pad row into the pad slots, then one block per
//               needing slot (the first SI in site order, found in the need
//               bitmap): the MI x T reference points, each hashed directly
//               from the staged bytes, the h1 prescreen of every combo with
//               an early exit once cnt + remaining < thr_edit (a certain
//               fail), and exact full-h probes of the first 48 survivors,
//               one (survivor, point) pair per thread.
// Every window hash is the direct or rolled ntHash of the bytes the XLA
// program's chains arrive at (a changelast and its rolls are XORs, so the
// direct hash of the edited bytes is the chain's value); row edges clamp
// exactly as the XLA program's gathers do.  The per-call scratch is the
// tile staging (ceil(kTile / k) heads per tile) and an S-bit need bitmap,
// no per-window array.
//
// What bounds it on the H100: the bytes it must move are the codes (1 MB
// per [4, 2^18 + 31] call), the filter (4 MiB on bulk's path) and ~1.6 MB
// of tables out, ~2 us.  The real limit is the rate of random 4-byte L2
// requests into the filter: at k = 32, 1 M windows x up to h bit probes
// for the scan, up to S x 4 x 12 substitution and S x MD x 11 deletion
// windows of h probes each (live slots only), and per needing site 341 x T
// h1 probes (fewer with the early exit) plus up to 48 x T x h exact ones.
#include <cuda_runtime.h>

#include <cstdint>

#include "block_scan.cuh"
#include "bloom_probe.cuh"
#include "nthash_roll.cuh"

namespace {

constexpr int kTile = 2048;        // windows per se_tile block
constexpr int kTileThreads = 256;
constexpr int kHeadRun = kTile / kTileThreads;  // windows per thread in the head pass
constexpr int kSurvivors = 48;     // T_SURVIVORS of ops/scan_eval.py
constexpr int kMaxC = 341;
constexpr int kMaxT = 64;
constexpr int kMaxMI = 5;
constexpr int kMaxMD = 7;
// k <= 64, as the native walker that replays the tables (polish/ntedit_gpu.py
// arms this kernel only there); it sizes the static shared memory
constexpr int kEvalMaxK = 64;
constexpr int kCompactThreads = 1024;
constexpr int kSiteWarps = 8;      // warps per se_sites block
constexpr int kMaxSiteBlocks = 1056;
constexpr int kInsThreads = 128;
constexpr int kSiteBytes = 2 * kEvalMaxK + kMaxMD + 2;  // s[w .. w + 2k + 8]
constexpr int kPadRow = 16;        // gate[4] | sub_sup[4] | del_sup[MD] | ins_lane @15
constexpr unsigned kFull = 0xffffffffu;

struct Probe {
  const uint32_t* words;
  uint64_t bits;
  int pow2;
  int h;
  uint64_t kmul;  // k * MULTI_SEED
};

struct Shape {
  int64_t R, L, nw;
  int k, jump, S, SI, C, T, MD, MI;
  float thr_edit, thr_missing;
};

// The constant tables (ops/scan_eval.py:_Consts gives the layout).
struct Consts {
  const uint64_t* dfs;       // [256 * 4]
  const uint64_t* drs;       // [256 * 4]
  const uint64_t* dfi;       // [C * T]
  const uint64_t* dri;       // [C * T]
  const uint8_t* sub_cand;   // [256 * 4]
  const uint8_t* accepted;   // [256]
  const uint8_t* combo_len;  // [C]
};

__device__ __forceinline__ uint64_t probe_index(const Probe& p, uint64_t hv) {
  return p.pow2 ? (hv & (p.bits - 1)) : (hv % p.bits);
}

__device__ __forceinline__ bool probe_bit(const Probe& p, uint64_t hv) {
  return gp_bloom_test(p.words, probe_index(p, hv));
}

// all h bits, stopping at the first miss
__device__ __forceinline__ bool probe_full(const Probe& p, uint64_t base) {
  for (int i = 0; i < p.h; ++i)
    if (!probe_bit(p, gp_nth_hash(base, i, p.kmul))) return false;
  return true;
}

__device__ __forceinline__ int upper(int c) {
  return (c >= 97 && c <= 122) ? c - 32 : c;
}

// ---- 1. the tile pass --------------------------------------------------------

__global__ void __launch_bounds__(kTileThreads)
se_tile(Probe pb, Shape sh, const uint8_t* __restrict__ codes,
        const uint64_t* __restrict__ tf, const uint64_t* __restrict__ tr,
        const uint8_t* __restrict__ fclass, const uint8_t* __restrict__ accepted,
        uint8_t* __restrict__ packed, int64_t nbytes, int32_t* __restrict__ tile_cnt,
        int32_t* __restrict__ tile_heads, int cap) {
  __shared__ GpWindowTables<kEvalMaxK> s_t;
  __shared__ GpRollTables s_r;
  __shared__ uint8_t s_acc[256];
  __shared__ uint8_t s_codes[kTile + 3 * kEvalMaxK];
  __shared__ uint8_t s_pres[kTile + 2 * kEvalMaxK];
  __shared__ uint8_t s_clean[kTile + 2 * kEvalMaxK];
  __shared__ uint8_t s_hot[kTile + kEvalMaxK];

  const int k = sh.k;
  const int64_t row = blockIdx.y, w0 = (int64_t)blockIdx.x * kTile;
  // extended windows x = xs + i, i < E: the tile's, k-1 before, k after
  const int64_t xs = w0 - (k - 1);
  const int E = kTile + 2 * k - 1;
  gp_load_window_tables(s_t, k, tf, tr, fclass);
  for (int i = threadIdx.x; i < 256; i += kTileThreads) s_acc[i] = accepted[i];
  const uint8_t* src = codes + row * sh.L;
  for (int i = threadIdx.x; i < E + k - 1; i += kTileThreads) {
    const int64_t p = xs + i;
    s_codes[i] = (p >= 0 && p < sh.L) ? src[p] : 0;
  }
  __syncthreads();
  gp_load_roll_tables(s_r, s_t, k);
  __syncthreads();

  // presence and cleanness: each thread rolls through a run of windows
  const int run = (E + kTileThreads - 1) / kTileThreads;
  const int i0 = threadIdx.x * run;
  if (i0 < E) {
    const uint8_t* s = s_codes + i0;
    uint64_t fh, rh;
    gp_window_hash(s_t, k, [s](int j) { return s[j]; }, fh, rh);
    int bad = 0;
    for (int j = 0; j < k; ++j) bad += !s_acc[s[j]];
    const int m = E - i0 < run ? E - i0 : run;
    for (int i = 0;;) {
      const int64_t x = xs + i0 + i;
      const bool in = x >= 0 && x < sh.nw;
      s_pres[i0 + i] = in && probe_full(pb, fh + rh);
      s_clean[i0 + i] = in && bad == 0;
      if (++i == m) break;
      const uint8_t co = s[i - 1], ci = s[i - 1 + k];
      gp_roll(s_r, fh, rh, co, ci);
      bad += (int)!s_acc[ci] - (int)!s_acc[co];
    }
  }
  __syncthreads();

  // packed presence of the tile's own windows: window 8q + r is bit r of
  // byte q (0 past nw)
  for (int j = threadIdx.x; j < kTile / 8; j += kTileThreads) {
    const int64_t byte = w0 / 8 + j;
    if (byte < nbytes) {
      unsigned b = 0;
      for (int q = 0; q < 8; ++q) b |= (unsigned)s_pres[k - 1 + 8 * j + q] << q;
      packed[row * nbytes + byte] = (uint8_t)b;
    }
  }

  // hot: clean & miss & eligible (x <= L - 2k and window x + k clean) &
  // misses at x+1, x+1+jump, ... (inside the row) >= thr_missing
  for (int i = threadIdx.x; i < kTile + k - 1; i += kTileThreads) {
    const int64_t x = xs + i;
    bool h = false;
    if (x >= 0 && x < sh.nw && s_clean[i] && !s_pres[i] && x <= sh.L - 2 * k &&
        s_clean[i + k]) {
      int cm = 0;
      for (int kk = 0; kk < k; kk += sh.jump)
        if (x + kk + 1 < sh.nw) cm += !s_pres[i + kk + 1];
      h = (float)cm >= sh.thr_missing;
    }
    s_hot[i] = h;
  }
  __syncthreads();

  // heads of the tile, ascending: thread t owns windows w0 + 8t .. + 7
  const int c0 = threadIdx.x * kHeadRun;
  unsigned mine = 0;
  for (int q = 0; q < kHeadRun; ++q) {
    const int i = c0 + q + k - 1;
    if (w0 + c0 + q >= sh.nw || !s_hot[i]) continue;
    bool head = true;
    for (int d = 1; d < k && head; ++d) head = !s_hot[i - d];
    mine |= (unsigned)head << q;
  }
  int total;
  const int off = gp_block_exclusive_scan(__popc(mine), &total);
  const int64_t tile = row * gridDim.x + blockIdx.x;
  int32_t* out = tile_heads + tile * cap + off;
  for (int q = 0; q < kHeadRun; ++q)
    if ((mine >> q) & 1) *out++ = (int32_t)(row * sh.nw + w0 + c0 + q);
  if (threadIdx.x == 0) tile_cnt[tile] = total;
}

// ---- 2. compaction -----------------------------------------------------------

__global__ void __launch_bounds__(kCompactThreads)
se_compact(int64_t ntiles, const int32_t* __restrict__ tile_cnt,
           const int32_t* __restrict__ tile_heads, int cap, int32_t* __restrict__ tile_off,
           int32_t* __restrict__ n_sites, int32_t* __restrict__ site, int S,
           uint32_t* __restrict__ need_bits) {
  int carry = 0;
  for (int64_t base = 0; base < ntiles; base += kCompactThreads) {
    const int64_t i = base + threadIdx.x;
    int total;
    const int e = gp_block_exclusive_scan(i < ntiles ? tile_cnt[i] : 0, &total);
    if (i < ntiles) tile_off[i] = carry + e;
    carry += total;
  }
  if (threadIdx.x == 0) *n_sites = carry;
  __syncthreads();
  const int lane = threadIdx.x & 31, nwarps = kCompactThreads / 32;
  for (int64_t t = threadIdx.x >> 5; t < ntiles; t += nwarps) {
    const int off = tile_off[t];
    if (off >= S) continue;
    const int n = tile_cnt[t] < S - off ? tile_cnt[t] : S - off;
    for (int j = lane; j < n; j += 32) site[off + j] = tile_heads[t * cap + j];
  }
  for (int i = (carry < S ? carry : S) + threadIdx.x; i < S; i += kCompactThreads)
    site[i] = -1;
  for (int i = threadIdx.x; i < (S + 31) / 32; i += kCompactThreads) need_bits[i] = 0;
}

// ---- 3. the site slots -------------------------------------------------------

// A site slot's window: pad slots (site -1) evaluate global window 0.
struct SiteAt {
  const uint8_t* row;
  int64_t w;  // window in the row (< nw: the JAX w_safe clamp holds already)
  int draft;  // upper-cased draft byte at p = w + k - 1
};

__device__ __forceinline__ SiteAt site_at(const Shape& sh, const uint8_t* codes,
                                          int32_t st) {
  SiteAt a;
  const int64_t sidx = st < 0 ? 0 : st;
  a.w = sidx % sh.nw;
  a.row = codes + (sidx / sh.nw) * sh.L;
  a.draft = upper(a.row[a.w + sh.k - 1]);
  return a;
}

// sb[j] = s[min(w + j, L - 1)] for j < 2k + 9: every byte a site's windows
// read (the XLA program's gathers clamp to the row's last byte)
__device__ __forceinline__ void stage_site(const Shape& sh, const SiteAt& a, uint8_t* sb,
                                           int tid, int nthreads) {
  for (int j = tid; j < 2 * sh.k + kMaxMD + 2; j += nthreads) {
    const int64_t p = a.w + j;
    sb[j] = a.row[p < sh.L ? p : sh.L - 1];
  }
}

__global__ void __launch_bounds__(kSiteWarps * 32)
se_sites(Probe pb, Shape sh, Consts cs, const uint8_t* __restrict__ codes,
         const uint64_t* __restrict__ tf, const uint64_t* __restrict__ tr,
         const uint8_t* __restrict__ fclass, const int32_t* __restrict__ n_sites,
         const int32_t* __restrict__ site, uint8_t* __restrict__ gate,
         int8_t* __restrict__ sub_sup, int8_t* __restrict__ del_sup,
         int8_t* __restrict__ ins_lane, uint32_t* __restrict__ need_bits,
         uint8_t* __restrict__ pad_row) {
  __shared__ GpWindowTables<kEvalMaxK> s_t;
  __shared__ uint8_t s_sb[kSiteWarps][kSiteBytes];
  __shared__ int s_cnt[kSiteWarps][8 + kMaxMD];  // gate[4] | sub[4] | del[MD]

  const int nlive = *n_sites < sh.S ? *n_sites : sh.S;
  const int n_items = nlive + (nlive < sh.S);  // the pad row last
  if ((int64_t)blockIdx.x * kSiteWarps >= n_items) return;  // block-uniform
  gp_load_window_tables(s_t, sh.k, tf, tr, fclass);
  __syncthreads();

  const int k = sh.k, lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  uint8_t* sb = s_sb[wid];
  int* cnt = s_cnt[wid];
  const int nj = (k + sh.jump - 1) / sh.jump;             // substitution windows j > 0
  const int nd = 1 + (k >= 2 ? (k - 2) / sh.jump : 0);    // deletion windows per d
  const int n_sub = 4 * (nj + 1), n_all = n_sub + sh.MD * nd;
  for (int item = blockIdx.x * kSiteWarps + wid; item < n_items;
       item += gridDim.x * kSiteWarps) {
    const int32_t st = item < nlive ? site[item] : -1;
    const SiteAt a = site_at(sh, codes, st);
    stage_site(sh, a, sb, lane, 32);
    if (lane < 8 + kMaxMD) cnt[lane] = 0;
    __syncwarp();
    for (int it = lane; it < n_all; it += 32) {
      uint64_t f, r;
      if (it < n_sub) {
        // substitution of candidate c at p, seen from window j: the scan
        // hash of window min(w + j, nw - 1) XOR the candidate's delta
        const int c = it & 3, ji = it >> 2;
        const int j = ji ? (ji - 1) * sh.jump + 1 : 0;
        const int o = (int)((a.w + j < sh.nw - 1 ? a.w + j : sh.nw - 1) - a.w);
        gp_window_hash(s_t, k, [sb, o](int q) { return sb[o + q]; }, f, r);
        f ^= gp_srol_n(cs.dfs[a.draft * 4 + c], j % 1023);
        r ^= gp_srol_n(cs.drs[a.draft * 4 + c], ((k - 1 - j) % 1023 + 1023) % 1023);
        const bool pres = probe_full(pb, f + r);
        if (ji) atomicAdd(cnt + 4 + c, (int)pres);
        else cnt[c] = pres;
      } else {
        // deletion of d bases at p, the window kk rolls on: bytes before p
        // as they are, then s[p + d ..]
        const int d = 1 + (it - n_sub) / nd, si = (it - n_sub) % nd;
        const int kk = si * sh.jump;
        gp_window_hash(s_t, k, [sb, kk, d, k](int q) {
          return kk + q < k - 1 ? sb[kk + q] : sb[kk + q + d];
        }, f, r);
        atomicAdd(cnt + 8 + d - 1, (int)probe_full(pb, f + r));
      }
    }
    __syncwarp();
    if (lane == 0) {
      // the insertion lane: the first gated candidate whose sub was not
      // accepted, with no accepted sub at an earlier lane (cand 0 never)
      int lane_out = -1;
      bool acc_before = false;
      for (int c = 0; c < 4; ++c) {
        const bool gt = cnt[c] != 0;
        const bool acc = gt && (float)cnt[4 + c] >= sh.thr_edit;
        if (gt && !acc && !acc_before && cs.sub_cand[a.draft * 4 + c] != 0) {
          lane_out = c;
          break;
        }
        acc_before |= acc;
      }
      if (item < nlive) {
        ins_lane[item] = (int8_t)lane_out;
        if (lane_out >= 0) atomicOr(need_bits + (item >> 5), 1u << (item & 31));
      } else {
        pad_row[15] = (uint8_t)lane_out;
      }
    }
    if (lane < 4 + sh.MD + 4) {
      const uint8_t v = (uint8_t)cnt[lane];
      uint8_t* dst = item >= nlive ? pad_row + lane
                     : lane < 4 ? gate + (int64_t)item * 4 + lane
                     : lane < 8 ? (uint8_t*)sub_sup + (int64_t)item * 4 + lane - 4
                                : (uint8_t*)del_sup + (int64_t)item * sh.MD + lane - 8;
      *dst = v;
    }
    __syncwarp();
  }
}

// ---- 4. insertions -----------------------------------------------------------

__global__ void __launch_bounds__(kInsThreads)
se_ins(Probe pb, Shape sh, Consts cs, const uint8_t* __restrict__ codes,
       const uint64_t* __restrict__ tf, const uint64_t* __restrict__ tr,
       const uint8_t* __restrict__ fclass, const int32_t* __restrict__ n_sites,
       const int32_t* __restrict__ site, const uint32_t* __restrict__ need_bits,
       const uint8_t* __restrict__ pad_row, uint8_t* __restrict__ gate,
       int8_t* __restrict__ sub_sup, int8_t* __restrict__ del_sup,
       int8_t* __restrict__ ins_lane, uint8_t* __restrict__ ins_ok,
       int8_t* __restrict__ ins_sup) {
  __shared__ GpWindowTables<kEvalMaxK> s_t;
  __shared__ uint8_t s_sb[kSiteBytes];
  __shared__ uint64_t s_ref_f[kMaxMI * kMaxT];
  __shared__ uint64_t s_ref_r[kMaxMI * kMaxT];
  __shared__ uint8_t s_pass[kMaxC];
  __shared__ int s_surv[kSurvivors], s_exact[kSurvivors];
  __shared__ int s_nsurv, s_slot;

  // the pad slots take the row se_sites computed for window 0
  const int nlive = *n_sites < sh.S ? *n_sites : sh.S;
  for (int64_t s = nlive + (int64_t)blockIdx.x * kInsThreads + threadIdx.x; s < sh.S;
       s += (int64_t)gridDim.x * kInsThreads) {
    for (int c = 0; c < 4; ++c) {
      gate[s * 4 + c] = pad_row[c];
      sub_sup[s * 4 + c] = (int8_t)pad_row[4 + c];
    }
    for (int d = 0; d < sh.MD; ++d) del_sup[s * sh.MD + d] = (int8_t)pad_row[8 + d];
    ins_lane[s] = (int8_t)pad_row[15];
  }

  // this block's slot: the blockIdx.x-th set bit of the need bitmap
  const int nwords = (sh.S + 31) / 32;
  const int per = (nwords + kInsThreads - 1) / kInsThreads;
  const int wa = threadIdx.x * per, wb = wa + per < nwords ? wa + per : nwords;
  int mine = 0;
  for (int i = wa; i < wb; ++i) mine += __popc(need_bits[i]);
  int n_need;
  const int before = gp_block_exclusive_scan(mine, &n_need);
  const int b = blockIdx.x;
  if (b >= n_need || b >= sh.SI) return;  // block-uniform
  if (b >= before && b < before + mine) {
    int rem = b - before;
    for (int i = wa; i < wb; ++i) {
      uint32_t word = need_bits[i];
      const int c = __popc(word);
      if (rem < c) {
        for (; rem; --rem) word &= word - 1;
        s_slot = i * 32 + __ffs(word) - 1;
        break;
      }
      rem -= c;
    }
  }
  gp_load_window_tables(s_t, sh.k, tf, tr, fclass);
  __syncthreads();
  const int s = s_slot;
  const SiteAt a = site_at(sh, codes, site[s]);
  stage_site(sh, a, s_sb, threadIdx.x, kInsThreads);
  __syncthreads();

  const int k = sh.k, T = sh.T, C = sh.C;
  // reference points: length group l's combo is the index char + 'A' *
  // (l - 1); point t (after 1 + t * jump rolls) is the window of the edited
  // draft at w + 1 + t * jump: s before p, the index char, l - 1 'A's, then
  // s from p on
  const int ic = cs.sub_cand[a.draft * 4 + ins_lane[s]];
  for (int it = threadIdx.x; it < sh.MI * T; it += kInsThreads) {
    const int l = it / T + 1, roll = 1 + (it % T) * sh.jump;
    const uint8_t* sb = s_sb;
    uint64_t f, r;
    gp_window_hash(s_t, k, [sb, roll, l, ic, k](int q) {
      const int o = roll + q;
      return o < k - 1 ? sb[o] : o == k - 1 ? (uint8_t)ic : o < k - 1 + l ? (uint8_t)'A'
                                                                         : sb[o - l];
    }, f, r);
    s_ref_f[it] = f;
    s_ref_r[it] = r;
  }
  __syncthreads();
  // stage 1: the h1 bit alone bounds each combo's support from above; a
  // combo stops once even all its remaining points could not reach thr_edit
  for (int c = threadIdx.x; c < C; c += kInsThreads) {
    const int g = cs.combo_len[c] - 1;
    int cnt = 0;
    for (int t = 0; t < T && (float)(cnt + T - t) >= sh.thr_edit; ++t)
      cnt += probe_bit(pb, (s_ref_f[g * T + t] ^ cs.dfi[c * T + t]) +
                               (s_ref_r[g * T + t] ^ cs.dri[c * T + t]));
    s_pass[c] = (float)cnt >= sh.thr_edit;
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // the first kSurvivors passing combos, ascending
    const int lane = threadIdx.x;
    int n = 0;
    for (int base = 0; base < C; base += 32) {
      const int c = base + lane;
      const bool ps = c < C && s_pass[c];
      const unsigned bl = __ballot_sync(kFull, ps);
      const int pos = n + __popc(bl & ((1u << lane) - 1));
      if (ps && pos < kSurvivors) s_surv[pos] = c;
      n += __popc(bl);
    }
    if (lane == 0) {
      s_nsurv = n;
      ins_ok[s] = n <= kSurvivors;
    }
    for (int i = lane; i < kSurvivors; i += 32) s_exact[i] = 0;
  }
  __syncthreads();
  // stage 2: exact full-h counts of the survivors (written on overflow
  // too), one (survivor, point) pair per thread
  const int ns = s_nsurv < kSurvivors ? s_nsurv : kSurvivors;
  for (int it = threadIdx.x; it < ns * T; it += kInsThreads) {
    const int i = it / T, t = it % T;
    const int c = s_surv[i], g = cs.combo_len[c] - 1;
    if (probe_full(pb, (s_ref_f[g * T + t] ^ cs.dfi[c * T + t]) +
                           (s_ref_r[g * T + t] ^ cs.dri[c * T + t])))
      atomicAdd(s_exact + i, 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ns; i += kInsThreads)
    ins_sup[(int64_t)s * C + s_surv[i]] = (int8_t)s_exact[i];
}

// ---- scratch -----------------------------------------------------------------

struct Scratch {
  int32_t *tile_cnt, *tile_off, *tile_heads;
  uint32_t* need_bits;
  uint8_t* pad_row;
  int64_t ntiles, bytes;
  int cap;
};

int64_t align256(int64_t x) { return (x + 255) & ~(int64_t)255; }

Scratch carve(void* base, int64_t R, int64_t L, int k, int S) {
  const int64_t nw = L - k + 1;
  Scratch s;
  s.ntiles = R * ((nw + kTile - 1) / kTile);
  s.cap = (kTile + k - 1) / k;  // heads lie >= k windows apart
  char* p = (char*)base;
  int64_t off = 0;
  auto take = [&](int64_t bytes) {
    char* q = p ? p + off : nullptr;
    off += align256(bytes);
    return q;
  };
  s.tile_cnt = (int32_t*)take(4 * s.ntiles);
  s.tile_off = (int32_t*)take(4 * s.ntiles);
  s.tile_heads = (int32_t*)take(4 * s.ntiles * s.cap);
  s.need_bits = (uint32_t*)take(4 * (int64_t)((S + 31) / 32));
  s.pad_row = (uint8_t*)take(kPadRow);
  s.bytes = off;
  return s;
}

}  // namespace

// Bytes of device scratch one gp_scan_eval call of this shape needs.
extern "C" int64_t gp_scan_eval_scratch_bytes(int64_t R, int64_t L, int k, int S,
                                              int SI) {
  (void)SI;
  return carve(nullptr, R, L, k, S).bytes;
}

// codes: uint8[R, L] row-major; words: uint32[ceil(bits/32)]; tf, tr,
// fclass: kernel 2's scan tables for k; kmul = k * MULTI_SEED (mod 2^64);
// c64 / c8: the constant tables (ops/scan_eval.py:_Consts); scratch:
// gp_scan_eval_scratch_bytes(R, L, k, S, SI) bytes.  The nine outputs as
// ops/scan_eval.scan_eval documents them.  Launches on `stream`; returns
// the first nonzero cudaError_t.
extern "C" int gp_scan_eval(
    const void* words, uint64_t bits, int h, int k, int jump, int max_ins,
    int max_del, float thr_edit, float thr_missing, int S, int SI, int C, int T,
    const void* codes, int64_t R, int64_t L, const void* tf, const void* tr,
    const void* fclass, uint64_t kmul, const void* c64, const void* c8,
    void* scratch, void* packed, void* n_sites, void* site, void* gate,
    void* sub_sup, void* del_sup, void* ins_lane, void* ins_ok, void* ins_sup,
    void* stream) {
  const int64_t nw = L - k + 1;
  if (k < 1 || k > kEvalMaxK || h < 1 || h > 16 || jump < 1 || bits == 0 ||
      max_ins < 0 || max_ins > kMaxMI || max_del < 0 || max_del > kMaxMD ||
      C < 0 || C > kMaxC || T < 0 || T > kMaxT || S < 1 || SI < 1 || R < 1 ||
      R > 65535 || nw < 1 || R * nw >= (int64_t)INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Probe pb{(const uint32_t*)words, bits, (bits & (bits - 1)) == 0, h, kmul};
  const Shape sh{R, L, nw, k, jump, S, SI, C, T, max_del, max_ins, thr_edit,
                 thr_missing};
  const uint64_t* w64 = (const uint64_t*)c64;  // fseed | rseed | dfs | drs | dfi | dri
  const uint8_t* w8 = (const uint8_t*)c8;
  const Consts cs{w64 + 512, w64 + 1536, w64 + 2560, w64 + 2560 + (int64_t)C * T,
                  w8, w8 + 1024, w8 + 1280};
  const Scratch sc = carve(scratch, R, L, k, S);
  const uint8_t* cd = (const uint8_t*)codes;
  const uint64_t *tf64 = (const uint64_t*)tf, *tr64 = (const uint64_t*)tr;
  const uint8_t* fc = (const uint8_t*)fclass;
  cudaError_t err;
#define GP_CHECK(call)                  \
  if ((err = (call)) != cudaSuccess) return (int)err;
#define GP_LAUNCHED()                   \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  GP_CHECK(cudaMemsetAsync(ins_ok, 0, (size_t)S, st));
  GP_CHECK(cudaMemsetAsync(ins_sup, 0, (size_t)S * C, st));
  se_tile<<<dim3((unsigned)((nw + kTile - 1) / kTile), (unsigned)R), kTileThreads, 0, st>>>(
      pb, sh, cd, tf64, tr64, fc, cs.accepted, (uint8_t*)packed, (nw + 7) / 8,
      sc.tile_cnt, sc.tile_heads, sc.cap);
  GP_LAUNCHED();
  se_compact<<<1, kCompactThreads, 0, st>>>(sc.ntiles, sc.tile_cnt, sc.tile_heads, sc.cap,
                                            sc.tile_off, (int32_t*)n_sites,
                                            (int32_t*)site, S, sc.need_bits);
  GP_LAUNCHED();
  const int64_t site_blocks = (S + kSiteWarps) / kSiteWarps;  // S + 1 items at most
  se_sites<<<(unsigned)(site_blocks < kMaxSiteBlocks ? site_blocks : kMaxSiteBlocks),
             kSiteWarps * 32, 0, st>>>(
      pb, sh, cs, cd, tf64, tr64, fc, (const int32_t*)n_sites, (const int32_t*)site,
      (uint8_t*)gate, (int8_t*)sub_sup, (int8_t*)del_sup, (int8_t*)ins_lane,
      sc.need_bits, sc.pad_row);
  GP_LAUNCHED();
  se_ins<<<SI, kInsThreads, 0, st>>>(
      pb, sh, cs, cd, tf64, tr64, fc, (const int32_t*)n_sites, (const int32_t*)site,
      sc.need_bits, sc.pad_row, (uint8_t*)gate, (int8_t*)sub_sup, (int8_t*)del_sup,
      (int8_t*)ins_lane, (uint8_t*)ins_ok, (int8_t*)ins_sup);
  GP_LAUNCHED();
#undef GP_CHECK
#undef GP_LAUNCHED
  return 0;
}
