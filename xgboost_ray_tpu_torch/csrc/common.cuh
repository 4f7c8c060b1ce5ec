// Shared device helpers for the hand-written Hopper kernels of
// xgboost_ray_tpu_torch (block scans and reductions over 256-thread CTAs).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define XRT_THREADS 256
#define XRT_WARPS (XRT_THREADS / 32)

// Exclusive block-wide scan of one int per thread; *total gets the block sum.
// Every thread of the CTA must call it (it synchronises).
__device__ __forceinline__ int xrt_block_excl_scan(int v, int* total) {
  __shared__ int warp_sums[XRT_WARPS];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = lane < XRT_WARPS ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < XRT_WARPS) warp_sums[lane] = s;
  }
  __syncthreads();
  const int excl = x - v + (wid > 0 ? warp_sums[wid - 1] : 0);
  *total = warp_sums[XRT_WARPS - 1];
  __syncthreads();
  return excl;
}

// Exclusive block-wide scan of one float pair per thread (g, h).
__device__ __forceinline__ void xrt_block_excl_scan2(float g, float h,
                                                     float* eg, float* eh) {
  __shared__ float wg[XRT_WARPS];
  __shared__ float wh[XRT_WARPS];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  float xg = g, xh = h;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    float yg = __shfl_up_sync(0xffffffffu, xg, o);
    float yh = __shfl_up_sync(0xffffffffu, xh, o);
    if (lane >= o) {
      xg += yg;
      xh += yh;
    }
  }
  if (lane == 31) {
    wg[wid] = xg;
    wh[wid] = xh;
  }
  __syncthreads();
  if (wid == 0) {
    float sg = lane < XRT_WARPS ? wg[lane] : 0.f;
    float sh = lane < XRT_WARPS ? wh[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      float yg = __shfl_up_sync(0xffffffffu, sg, o);
      float yh = __shfl_up_sync(0xffffffffu, sh, o);
      if (lane >= o) {
        sg += yg;
        sh += yh;
      }
    }
    if (lane < XRT_WARPS) {
      wg[lane] = sg;
      wh[lane] = sh;
    }
  }
  // exclusive within the warp is the inclusive value of the lane below
  // (shifted, not inclusive - own: no extra rounding for float sums)
  float ig = __shfl_up_sync(0xffffffffu, xg, 1);
  float ih = __shfl_up_sync(0xffffffffu, xh, 1);
  __syncthreads();
  const float pg = wid > 0 ? wg[wid - 1] : 0.f;
  const float ph = wid > 0 ? wh[wid - 1] : 0.f;
  *eg = lane > 0 ? pg + ig : pg;
  *eh = lane > 0 ? ph + ih : ph;
  __syncthreads();
}
