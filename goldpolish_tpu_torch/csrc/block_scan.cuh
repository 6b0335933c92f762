// The block-wide exclusive prefix sum that kernel 4 (scan_eval.cu) uses to
// compact in order without atomics: a tile's heads, the tile counts, the
// need bitmap's words.
#pragma once

#include <cuda_runtime.h>

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32, at
// most 1024); *total gets the block's sum.  Every thread of the block must
// call it.
__device__ __forceinline__ int gp_block_exclusive_scan(int v, int* total) {
  __shared__ int s_warp[32];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(full, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nwarps ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(full, t, o);
      if (lane >= o) t += y;
    }
    s_warp[lane] = t;
  }
  __syncthreads();
  const int excl = (wid ? s_warp[wid - 1] : 0) + x - v;
  *total = s_warp[nwarps - 1];
  __syncthreads();  // s_warp is reused by the next call
  return excl;
}
