// Kernel 4 (K2): the fused phase-A eval — dense scan, hot-site detection,
// cluster heads and the candidate-trial tables the native walker replays.
//
// Replaces: goldpolish_tpu/ops/scan_eval.py `build_fused` -> `run`
// (:235-522), one XLA program whose every Bloom test rides the Pallas probe
// P3 (`_probe_lo32_mxu_i8`, bloom_pallas.py:331) on a TPU.  The plain torch
// version, goldpolish_tpu_torch/ops/scan_eval.py:scan_eval_reference,
// follows the same steps and is what the tests hold this chain against.
//
// The chain (all on one stream, no host synchronisation; n_sites stays on
// the device and every later stage runs at the fixed shapes S and SI):
//   se_scan        per window: fh, rh (kernel 2's XOR tables), presence
//                  (h probes), clean (all k bytes accepted); packed bits
//   se_hot         per window: clean & miss & eligible & cm >= thr_missing
//   se_head_count  per window: head = hot & no hot in [w-k+1, w-1];
//                  per-block head counts
//   se_block_scan  one block: exclusive scan of the block counts, n_sites,
//                  pad site[] with -1
//   se_head_write  per window: site[offset + rank] = r * nw + w while < S
//                  (so site holds the S smallest heads, ascending)
//   se_sites       one warp per site slot: lanes 0-3 the substitution gate
//                  and supports (XOR deltas on the scan's fh/rh), lanes 4..
//                  the MD deletion chains (changelast, k-2 rolls); lane 0
//                  the insertion lane and the needing flag
//   se_need_compact one block: the first SI needing sites, in site order
//   se_ins         one block per needing slot: the MI per-length reference
//                  chains, the h1 prescreen of all C x T combo points, and
//                  exact full-h probes of the first 48 passing combos
// Gathers clamp to the row exactly as the JAX program's do, so pad sites
// (site -1 evaluates window 0) and row tails give the same bytes.
//
// What bounds it on the H100: dependent random L2 loads into the filter
// (4 MiB per k on bulk's path, L2-resident).  Per [4, 2^18 + 31] call at
// k = 32 that is 1 M windows x up to h bit probes for the scan, then up to
// 4096 x 4 x 12 substitution and 4096 x 5 x 11 deletion windows of h bit
// probes each, and for up to 1024 needing sites 1,024 x 341 x 11 = 3.8 M
// h1 prescreen probes plus up to 1,024 x 48 x 11 x h = 2.2 M exact bit
// probes (h = 4); the deletion and reference chains add serial rolls (k
// per chain).  HBM traffic is small: the call's scratch fh/rh (16 MiB) and
// ~1.6 MB of tables out.
//
// What the simple design leaves for later: each site's bytes are read
// from global memory (L1/L2), not staged in shared memory; the prescreen
// runs one thread per combo over all T points with no early exit, where a
// warp-cooperative prescreen could stop a combo once its bound fails; the
// head search re-reads k-1 hot flags per window instead of a halo scan.
#include <cuda_runtime.h>

#include <cstdint>

#include "block_scan.cuh"
#include "bloom_probe.cuh"

namespace {

constexpr int kThreads = 256;   // windows per block in the per-window stages
constexpr int kMaxK = 64;
constexpr int kNoClass = 4;     // forward class of bytes without a seed
constexpr int kSurvivors = 48;  // T_SURVIVORS of ops/scan_eval.py
constexpr int kMaxC = 341;
constexpr int kMaxT = 64;
constexpr int kMaxMI = 5;
constexpr int kMaxMD = 7;
constexpr int kScanBlock = 1024;
constexpr int kSiteWarps = 4;   // site slots per block in se_sites
constexpr int kInsThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kMask31 = (1ull << 31) - 1;
constexpr uint64_t kMask33 = (1ull << 33) - 1;

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
  const uint64_t* fseed;     // [256]
  const uint64_t* rseed;     // [256]
  const uint64_t* dfs;       // [256 * 4]
  const uint64_t* drs;       // [256 * 4]
  const uint64_t* dfi;       // [C * T]
  const uint64_t* dri;       // [C * T]
  const uint8_t* sub_cand;   // [256 * 4]
  const uint8_t* accepted;   // [256]
  const uint8_t* combo_len;  // [C]
};

__device__ __forceinline__ uint64_t srol_n(uint64_t v, int n) {
  const int s31 = n % 31, s33 = n % 33;
  uint64_t hi = v >> 33, lo = v & kMask33;
  hi = ((hi << s31) | (hi >> (31 - s31))) & kMask31;
  lo = ((lo << s33) | (lo >> (33 - s33))) & kMask33;
  return (hi << 33) | lo;
}

__device__ __forceinline__ uint64_t sror1(uint64_t v) {
  uint64_t hi = v >> 33, lo = v & kMask33;
  hi = ((hi >> 1) | (hi << 30)) & kMask31;
  lo = ((lo >> 1) | (lo << 32)) & kMask33;
  return (hi << 33) | lo;
}

// ntc64_changelast and one roll with gathered seeds (scan_eval.py:129-150);
// k <= 64 < 1023, so srol^k needs no reduction.
__device__ __forceinline__ void changelast(uint64_t& fh, uint64_t& rh, int k,
                                           uint64_t f_out, uint64_t f_in,
                                           uint64_t r_out, uint64_t r_in) {
  fh = fh ^ f_out ^ f_in;
  rh = sror1(srol_n(rh, 1) ^ srol_n(r_out ^ r_in, k));
}

__device__ __forceinline__ void roll(uint64_t& fh, uint64_t& rh, int k,
                                     uint64_t f_out, uint64_t f_in,
                                     uint64_t r_out, uint64_t r_in) {
  fh = srol_n(fh, 1) ^ f_in ^ srol_n(f_out, k);
  rh = sror1(rh ^ srol_n(r_in, k) ^ r_out);
}

__device__ __forceinline__ bool probe_bit(const Probe& p, uint64_t hv) {
  return gp_bloom_test(p.words, p.pow2 ? (hv & (p.bits - 1)) : (hv % p.bits));
}

__device__ __forceinline__ bool probe_full(const Probe& p, uint64_t base) {
  for (int i = 0; i < p.h; ++i) {
    uint64_t hv = base;
    if (i) {
      const uint64_t t = base * ((uint64_t)i ^ p.kmul);
      hv = t ^ (t >> 27);
    }
    if (!probe_bit(p, hv)) return false;
  }
  return true;
}

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int upper(int c) {
  return (c >= 97 && c <= 122) ? c - 32 : c;
}

// flags bit 0: present; bit 1: clean (all k bytes of the window accepted)
__global__ void se_scan(Probe pb, Shape sh, const uint8_t* __restrict__ codes,
                        const uint64_t* __restrict__ tf,
                        const uint64_t* __restrict__ tr,
                        const uint8_t* __restrict__ fclass,
                        const uint8_t* __restrict__ accepted,
                        uint64_t* __restrict__ fh_out, uint64_t* __restrict__ rh_out,
                        uint8_t* __restrict__ flags, uint8_t* __restrict__ packed,
                        int64_t nbytes) {
  __shared__ uint64_t s_tf[kMaxK * 5];
  __shared__ uint64_t s_tr[kMaxK * 8];
  __shared__ uint8_t s_cls[256];
  __shared__ uint8_t s_acc[256];
  __shared__ uint8_t s_codes[kThreads + kMaxK - 1];

  const int k = sh.k;
  const int64_t row = blockIdx.y;
  const int64_t w0 = (int64_t)blockIdx.x * kThreads;
  for (int i = threadIdx.x; i < k * 5; i += blockDim.x) {
    const int j = i / 5, c = i % 5;
    s_tf[i] = c == kNoClass ? 0ull : tf[j * 4 + c];
  }
  for (int i = threadIdx.x; i < k * 8; i += blockDim.x) s_tr[i] = tr[i];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_cls[i] = fclass[i];
    s_acc[i] = accepted[i];
  }
  const uint8_t* src = codes + row * sh.L;
  for (int i = threadIdx.x; i < kThreads + k - 1; i += blockDim.x) {
    const int64_t p = w0 + i;
    s_codes[i] = p < sh.L ? src[p] : 0;
  }
  __syncthreads();

  const int64_t w = w0 + threadIdx.x;
  bool present = false;
  if (w < sh.nw) {
    uint64_t fh = 0, rh = 0;
    bool clean = true;
    for (int j = 0; j < k; ++j) {
      const uint8_t c = s_codes[threadIdx.x + j];
      fh ^= s_tf[j * 5 + s_cls[c]];
      rh ^= s_tr[j * 8 + (c & 7)];
      clean &= s_acc[c] != 0;
    }
    present = probe_full(pb, fh + rh);
    const int64_t g = row * sh.nw + w;
    fh_out[g] = fh;
    rh_out[g] = rh;
    flags[g] = (uint8_t)(present | (clean << 1));
  }
  // 32 consecutive windows -> 4 bytes; window 8q + r is bit r of byte q
  const unsigned ballot = __ballot_sync(kFull, present);
  const int lane = threadIdx.x & 31;
  if (lane < 4) {
    const int64_t byte = ((w0 + (threadIdx.x & ~31)) >> 3) + lane;
    if (byte < nbytes) packed[row * nbytes + byte] = (uint8_t)(ballot >> (8 * lane));
  }
}

__global__ void se_hot(Shape sh, const uint8_t* __restrict__ flags,
                       uint8_t* __restrict__ hot) {
  const int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= sh.nw) return;
  const uint8_t* f = flags + blockIdx.y * sh.nw;
  const uint8_t fw = f[w];
  bool h = false;
  // eligible: w <= L - 2k and window w + k clean (w + k < nw then)
  if ((fw & 2) && !(fw & 1) && w <= sh.L - 2 * sh.k && (f[w + sh.k] & 2)) {
    int cm = 0;  // misses at windows w+1, w+1+jump, ... (inside the row)
    for (int kk = 0; kk < sh.k; kk += sh.jump) {
      const int64_t x = w + kk + 1;
      if (x < sh.nw) cm += !(f[x] & 1);
    }
    h = (float)cm >= sh.thr_missing;
  }
  hot[blockIdx.y * sh.nw + w] = h;
}

__device__ __forceinline__ bool is_head(const uint8_t* hot_row, int64_t w, int k) {
  if (!hot_row[w]) return false;
  for (int64_t x = w - k + 1 < 0 ? 0 : w - k + 1; x < w; ++x)
    if (hot_row[x]) return false;
  return true;
}

__global__ void se_head_count(Shape sh, const uint8_t* __restrict__ hot,
                              int32_t* __restrict__ blk_cnt) {
  const int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool hd = w < sh.nw && is_head(hot + blockIdx.y * sh.nw, w, sh.k);
  const int n = __syncthreads_count(hd);
  if (threadIdx.x == 0) blk_cnt[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = n;
}

__global__ void se_block_scan(int64_t nblk, const int32_t* __restrict__ blk_cnt,
                              int32_t* __restrict__ blk_off,
                              int32_t* __restrict__ n_sites,
                              int32_t* __restrict__ site, int S) {
  int carry = 0;
  for (int64_t base = 0; base < nblk; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    int total;
    const int e = gp_block_exclusive_scan(i < nblk ? blk_cnt[i] : 0, &total);
    if (i < nblk) blk_off[i] = carry + e;
    carry += total;
  }
  if (threadIdx.x == 0) *n_sites = carry;
  for (int i = (carry < S ? carry : S) + threadIdx.x; i < S; i += blockDim.x)
    site[i] = -1;
}

__global__ void se_head_write(Shape sh, const uint8_t* __restrict__ hot,
                              const int32_t* __restrict__ blk_off,
                              int32_t* __restrict__ site) {
  __shared__ int s_wcnt[kThreads / 32];
  const int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool hd = w < sh.nw && is_head(hot + blockIdx.y * sh.nw, w, sh.k);
  const unsigned b = __ballot_sync(kFull, hd);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) s_wcnt[wid] = __popc(b);
  __syncthreads();
  if (!hd) return;
  int off = blk_off[(int64_t)blockIdx.y * gridDim.x + blockIdx.x];
  for (int i = 0; i < wid; ++i) off += s_wcnt[i];
  off += __popc(b & ((1u << lane) - 1));
  if (off < sh.S) site[off] = (int32_t)(blockIdx.y * sh.nw + w);
}

// A site slot's window: pad slots (site -1) evaluate global window 0.
struct SiteAt {
  const uint8_t* row;
  int64_t w, p, g;  // window (clamped), tail position, r * nw + w
  int draft;        // upper-cased draft byte at p
};

__device__ __forceinline__ SiteAt site_at(const Shape& sh, const uint8_t* codes,
                                          int32_t st) {
  SiteAt a;
  const int64_t sidx = st < 0 ? 0 : st;
  const int64_t r = sidx / sh.nw;
  a.w = sidx % sh.nw;  // < nw: the JAX w_safe clamp holds already
  a.g = r * sh.nw + a.w;
  a.p = clamp64(a.w + sh.k - 1, 0, sh.L - 1);
  a.row = codes + r * sh.L;
  a.draft = upper(a.row[a.p]);
  return a;
}

__global__ void se_sites(Probe pb, Shape sh, Consts cs,
                         const uint8_t* __restrict__ codes,
                         const uint64_t* __restrict__ fh,
                         const uint64_t* __restrict__ rh,
                         const int32_t* __restrict__ site,
                         uint8_t* __restrict__ gate, int8_t* __restrict__ sub_sup,
                         int8_t* __restrict__ del_sup, int8_t* __restrict__ ins_lane,
                         uint8_t* __restrict__ need_flag) {
  const int s = blockIdx.x * kSiteWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= sh.S) return;  // warp-uniform
  const int32_t st = site[s];
  const SiteAt a = site_at(sh, codes, st);
  const int k = sh.k;
  const int64_t rowg = a.g - a.w;  // r * nw
  bool g = false;
  int cnt = 0;
  if (lane < 4) {
    // substitutions: window j of candidate `lane` by XOR delta
    const uint64_t df = cs.dfs[a.draft * 4 + lane], dr = cs.drs[a.draft * 4 + lane];
    // j = 0 (the gate), then j = kk + 1 for kk = 0, jump, 2 jump, ... < k
    for (int i = -1; i * sh.jump < k; ++i) {
      const int j = i < 0 ? 0 : i * sh.jump + 1;
      const int64_t wj = a.w + j < sh.nw - 1 ? a.w + j : sh.nw - 1;
      const uint64_t f = fh[rowg + wj] ^ srol_n(df, j % 1023);
      const uint64_t r = rh[rowg + wj] ^ srol_n(dr, ((k - 1 - j) % 1023 + 1023) % 1023);
      const bool pres = probe_full(pb, f + r);
      if (j == 0) g = pres; else cnt += pres;
    }
    gate[s * 4 + lane] = g;
    sub_sup[s * 4 + lane] = (int8_t)cnt;
  } else if (lane < 4 + sh.MD) {
    // deletion of d bases: changelast(draft -> s[p+d]), then k-2 rolls
    const int d = lane - 3;
    const int nxt = a.row[clamp64(a.p + d, 0, sh.L - 1)];
    uint64_t f = fh[a.g], r = rh[a.g];
    changelast(f, r, k, cs.fseed[a.draft], cs.fseed[nxt], cs.rseed[a.draft],
               cs.rseed[nxt]);
    int c = probe_full(pb, f + r);
    for (int kk = 1; kk < k - 1; ++kk) {
      const int co = a.row[clamp64(a.w + kk - 1, 0, sh.L - 1)];
      const int ci = a.row[clamp64(a.p + d + kk, 0, sh.L - 1)];
      roll(f, r, k, cs.fseed[co], cs.fseed[ci], cs.rseed[co], cs.rseed[ci]);
      if (kk % sh.jump == 0) c += probe_full(pb, f + r);
    }
    del_sup[(int64_t)s * sh.MD + d - 1] = (int8_t)c;
  }
  const unsigned gates = __ballot_sync(kFull, lane < 4 && g);
  int sup[4];
  for (int c = 0; c < 4; ++c) sup[c] = __shfl_sync(kFull, cnt, c);
  if (lane == 0) {
    // the insertion lane: the first gated candidate whose sub was not
    // accepted, with no accepted sub at an earlier lane (cand 0 never)
    int lane_out = -1;
    bool acc_before = false;
    for (int c = 0; c < 4; ++c) {
      const bool gt = (gates >> c) & 1;
      const bool acc = gt && (float)sup[c] >= sh.thr_edit;
      if (gt && !acc && !acc_before && cs.sub_cand[a.draft * 4 + c] != 0) {
        lane_out = c;
        break;
      }
      acc_before |= acc;
    }
    ins_lane[s] = (int8_t)lane_out;
    need_flag[s] = lane_out >= 0 && st >= 0;
  }
}

__global__ void se_need_compact(int S, int SI, const uint8_t* __restrict__ need_flag,
                                int32_t* __restrict__ need_sel,
                                int32_t* __restrict__ n_need) {
  int carry = 0;
  for (int base = 0; base < S; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < S && need_flag[i];
    int total;
    const int pos = carry + gp_block_exclusive_scan(v, &total);
    if (v && pos < SI) need_sel[pos] = i;
    carry += total;
  }
  if (threadIdx.x == 0) *n_need = carry < SI ? carry : SI;
}

__global__ void se_ins(Probe pb, Shape sh, Consts cs, const uint8_t* __restrict__ codes,
                       const uint64_t* __restrict__ fh, const uint64_t* __restrict__ rh,
                       const int32_t* __restrict__ site,
                       const int8_t* __restrict__ ins_lane,
                       const int32_t* __restrict__ need_sel,
                       const int32_t* __restrict__ n_need,
                       uint8_t* __restrict__ ins_ok, int8_t* __restrict__ ins_sup) {
  __shared__ uint64_t s_ref_f[kMaxMI * kMaxT];
  __shared__ uint64_t s_ref_r[kMaxMI * kMaxT];
  __shared__ uint8_t s_pass[kMaxC];
  __shared__ int s_surv[kSurvivors];
  __shared__ int s_nsurv;
  if ((int)blockIdx.x >= *n_need) return;  // block-uniform
  const int s = need_sel[blockIdx.x];
  const SiteAt a = site_at(sh, codes, site[s]);
  const int k = sh.k, T = sh.T, C = sh.C;
  const uint64_t fd = cs.fseed[a.draft], rd = cs.rseed[a.draft];
  if ((int)threadIdx.x < sh.MI) {
    // reference chain of length group l: combo = index char + 'A' * (l-1);
    // c_in at roll t: 'A' (t < l), the draft (t == l), s[p + t - l] (t > l)
    const int l = threadIdx.x + 1;
    const int ic = cs.sub_cand[a.draft * 4 + ins_lane[s]];
    uint64_t f = fh[a.g], r = rh[a.g];
    changelast(f, r, k, fd, cs.fseed[ic], rd, cs.rseed[ic]);
    for (int t = 1, ti = 0; t < k; ++t) {
      const int co = a.row[clamp64(a.w + t - 1, 0, sh.L - 1)];
      uint64_t fi = fd, ri = rd;
      if (t < l) {
        fi = cs.fseed['A'];
        ri = cs.rseed['A'];
      } else if (t > l) {
        const int suf = a.row[clamp64(a.p + t - l, 0, sh.L - 1)];
        fi = cs.fseed[suf];
        ri = cs.rseed[suf];
      }
      roll(f, r, k, cs.fseed[co], fi, cs.rseed[co], ri);
      if ((t - 1) % sh.jump == 0) {  // t in j_ins
        s_ref_f[(l - 1) * T + ti] = f;
        s_ref_r[(l - 1) * T + ti] = r;
        ++ti;
      }
    }
  }
  __syncthreads();
  // stage 1: the h1 bit alone bounds each combo's support from above
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = cs.combo_len[c] - 1;
    int cnt = 0;
    for (int t = 0; t < T; ++t)
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
      const unsigned b = __ballot_sync(kFull, ps);
      const int pos = n + __popc(b & ((1u << lane) - 1));
      if (ps && pos < kSurvivors) s_surv[pos] = c;
      n += __popc(b);
    }
    if (lane == 0) {
      s_nsurv = n;
      ins_ok[s] = n <= kSurvivors;
    }
  }
  __syncthreads();
  // stage 2: exact full-h counts of the survivors (written on overflow too)
  const int ns = s_nsurv < kSurvivors ? s_nsurv : kSurvivors;
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const int c = s_surv[i], g = cs.combo_len[c] - 1;
    int cnt = 0;
    for (int t = 0; t < T; ++t)
      cnt += probe_full(pb, (s_ref_f[g * T + t] ^ cs.dfi[c * T + t]) +
                                (s_ref_r[g * T + t] ^ cs.dri[c * T + t]));
    ins_sup[(int64_t)s * C + c] = (int8_t)cnt;
  }
}

struct Scratch {
  uint64_t *fh, *rh;
  uint8_t *flags, *hot, *need_flag;
  int32_t *blk_cnt, *blk_off, *need_sel, *n_need;
  int64_t bytes;
};

int64_t align256(int64_t x) { return (x + 255) & ~(int64_t)255; }

Scratch carve(void* base, int64_t R, int64_t L, int k, int S, int SI) {
  const int64_t nw = L - k + 1, n = R * nw;
  const int64_t nblk = R * ((nw + kThreads - 1) / kThreads);
  char* p = (char*)base;
  Scratch s;
  int64_t off = 0;
  auto take = [&](int64_t bytes) {
    char* q = p ? p + off : nullptr;
    off += align256(bytes);
    return q;
  };
  s.fh = (uint64_t*)take(8 * n);
  s.rh = (uint64_t*)take(8 * n);
  s.flags = (uint8_t*)take(n);
  s.hot = (uint8_t*)take(n);
  s.blk_cnt = (int32_t*)take(4 * nblk);
  s.blk_off = (int32_t*)take(4 * nblk);
  s.need_flag = (uint8_t*)take(S);
  s.need_sel = (int32_t*)take(4 * (int64_t)SI);
  s.n_need = (int32_t*)take(4);
  s.bytes = off;
  return s;
}

}  // namespace

// Bytes of device scratch one gp_scan_eval call of this shape needs.
extern "C" int64_t gp_scan_eval_scratch_bytes(int64_t R, int64_t L, int k, int S,
                                              int SI) {
  return carve(nullptr, R, L, k, S, SI).bytes;
}

// codes: uint8[R, L] row-major; words: uint32[ceil(bits/32)]; tf, tr,
// fclass: kernel 2's scan tables for k; kmul = k * MULTI_SEED (mod 2^64);
// c64 / c8: the constant tables (ops/scan_eval.py:_Consts); scratch:
// gp_scan_eval_scratch_bytes(R, L, k, S, SI) bytes.  The nine outputs as
// ops/scan_eval.scan_eval documents them.  Launches the chain on `stream`;
// returns the first nonzero cudaError_t.
extern "C" int gp_scan_eval(
    const void* words, uint64_t bits, int h, int k, int jump, int max_ins,
    int max_del, float thr_edit, float thr_missing, int S, int SI, int C, int T,
    const void* codes, int64_t R, int64_t L, const void* tf, const void* tr,
    const void* fclass, uint64_t kmul, const void* c64, const void* c8,
    void* scratch, void* packed, void* n_sites, void* site, void* gate,
    void* sub_sup, void* del_sup, void* ins_lane, void* ins_ok, void* ins_sup,
    void* stream) {
  const int64_t nw = L - k + 1;
  if (k < 1 || k > kMaxK || h < 1 || h > 16 || jump < 1 || bits == 0 ||
      max_ins < 0 || max_ins > kMaxMI || max_del < 0 || max_del > kMaxMD ||
      C < 0 || C > kMaxC || T < 0 || T > kMaxT || S < 1 || SI < 1 || R < 1 ||
      R > 65535 || nw < 1 || R * nw >= (int64_t)INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Probe pb{(const uint32_t*)words, bits, (bits & (bits - 1)) == 0, h, kmul};
  const Shape sh{R, L, nw, k, jump, S, SI, C, T, max_del, max_ins, thr_edit,
                 thr_missing};
  const uint64_t* w64 = (const uint64_t*)c64;
  const uint8_t* w8 = (const uint8_t*)c8;
  const Consts cs{w64, w64 + 256, w64 + 512, w64 + 1536, w64 + 2560,
                  w64 + 2560 + (int64_t)C * T, w8, w8 + 1024, w8 + 1280};
  const Scratch sc = carve(scratch, R, L, k, S, SI);
  const uint8_t* cd = (const uint8_t*)codes;
  const int64_t nbx = (nw + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)nbx, (unsigned)R);
  cudaError_t err;
#define GP_CHECK(call)                  \
  if ((err = (call)) != cudaSuccess) return (int)err;
#define GP_LAUNCHED()                   \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  GP_CHECK(cudaMemsetAsync(ins_ok, 0, (size_t)S, st));
  GP_CHECK(cudaMemsetAsync(ins_sup, 0, (size_t)S * C, st));
  se_scan<<<grid, kThreads, 0, st>>>(
      pb, sh, cd, (const uint64_t*)tf, (const uint64_t*)tr, (const uint8_t*)fclass,
      cs.accepted, sc.fh, sc.rh, sc.flags, (uint8_t*)packed, (nw + 7) / 8);
  GP_LAUNCHED();
  se_hot<<<grid, kThreads, 0, st>>>(sh, sc.flags, sc.hot);
  GP_LAUNCHED();
  se_head_count<<<grid, kThreads, 0, st>>>(sh, sc.hot, sc.blk_cnt);
  GP_LAUNCHED();
  se_block_scan<<<1, kScanBlock, 0, st>>>(R * nbx, sc.blk_cnt, sc.blk_off,
                                          (int32_t*)n_sites, (int32_t*)site, S);
  GP_LAUNCHED();
  se_head_write<<<grid, kThreads, 0, st>>>(sh, sc.hot, sc.blk_off, (int32_t*)site);
  GP_LAUNCHED();
  se_sites<<<(S + kSiteWarps - 1) / kSiteWarps, 32 * kSiteWarps, 0, st>>>(
      pb, sh, cs, cd, sc.fh, sc.rh, (const int32_t*)site, (uint8_t*)gate,
      (int8_t*)sub_sup, (int8_t*)del_sup, (int8_t*)ins_lane, sc.need_flag);
  GP_LAUNCHED();
  se_need_compact<<<1, kScanBlock, 0, st>>>(S, SI, sc.need_flag, sc.need_sel,
                                            sc.n_need);
  GP_LAUNCHED();
  se_ins<<<SI, kInsThreads, 0, st>>>(pb, sh, cs, cd, sc.fh, sc.rh,
                                     (const int32_t*)site, (const int8_t*)ins_lane,
                                     sc.need_sel, sc.n_need, (uint8_t*)ins_ok,
                                     (int8_t*)ins_sup);
  GP_LAUNCHED();
#undef GP_CHECK
#undef GP_LAUNCHED
  return 0;
}
