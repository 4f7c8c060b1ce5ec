// Shared device helpers for the hand-written Hopper kernels of
// xgboost_ray_tpu_torch: block scans and reductions over 256-thread CTAs,
// XLA's float32 exp and log as the plain versions evaluate them, and the
// window-32 sum tree of ops/split.tree_sum.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
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

// A grid-wide barrier of a cooperative launch (B12r, B16): bar[0] counts the CTAs
// arrived (back to 0 when the last arrives), bar[1] is the generation the
// waiters watch. Writes before it are visible to reads after it that do
// not go through L1 (__ldcg, atomics).
__device__ __forceinline__ void xrt_grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// XLA's float32 transcendentals (ops/objectives.exp_f32 / log_f32). Every
// source is compiled with --fmad=false: a multiply-add fuses only where
// __fmaf_rn stands, as XLA's CPU program fuses it.
// ---------------------------------------------------------------------------

constexpr float kXrtTiny = 1.17549435e-38f;  // smallest normal float

// a subnormal flushed to a zero of its sign, as XLA's CPU program flushes
__device__ __forceinline__ float xrt_ftz(float x) {
  return fabsf(x) < kXrtTiny ? x * 0.0f : x;
}

// ops/split._soft_threshold with jnp.sign's semantics (-0.0 and NaN keep
// themselves)
__device__ __forceinline__ float xrt_soft_threshold(float g, float alpha) {
  const float s = g > 0.f ? 1.f : (g < 0.f ? -1.f : g);
  return s * fmaxf(fabsf(g) - alpha, 0.f);
}

// ops/split.leaf_weight, the max_delta_step clamp (0: none) included
__device__ __forceinline__ float xrt_leaf_weight_of(float g, float h,
                                                    float reg_lambda,
                                                    float reg_alpha,
                                                    float max_delta_step) {
  const float den = h + reg_lambda;
  float w = den > 0.f ? -xrt_soft_threshold(g, reg_alpha) / fmaxf(den, 1e-38f)
                      : 0.f;
  if (max_delta_step > 0.f)
    w = fminf(fmaxf(w, -max_delta_step), max_delta_step);
  return w;
}

// torch.maximum / torch.clamp(min=): NaN if either is NaN
__device__ __forceinline__ float xrt_max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// ops/objectives.exp_f32, XLA's CPU exp: the operand clamped to
// [-87.8, 88.8] (NaN stays NaN), Cephes' range reduction with the
// exponent clamped to [-127, 127], the degree-5 polynomial with every
// multiply-add fused, the scale 2^fx from the exponent bits. Finite up to
// 88.72 (2^127 times a polynomial below 2), inf above; a result below
// 2^-126 is subnormal or zero (the callers flush it where XLA does).
__device__ __forceinline__ float xrt_exp_f32(float v) {
  if (v != v) return v;
  const float xc = fminf(fmaxf(v, -87.8f), 88.8f);
  float fx = floorf(__fmaf_rn(xc, 1.44269504088896341f, 0.5f));
  fx = fminf(fmaxf(fx, -127.0f), 127.0f);
  float x = __fmaf_rn(fx, -0.693359375f, xc);
  x = __fmaf_rn(fx, 2.12194440e-4f, x);
  const float z = __fmul_rn(x, x);
  float y = __fmaf_rn(x, 1.9875691500e-4f, 1.3981999507e-3f);
  y = __fmaf_rn(y, x, 8.3334519073e-3f);
  y = __fmaf_rn(y, x, 4.1665795894e-2f);
  y = __fmaf_rn(y, x, 1.6666665459e-1f);
  y = __fmaf_rn(y, x, 5.0000001201e-1f);
  y = __fadd_rn(1.0f, __fmaf_rn(y, z, x));
  return __fmul_rn(y, __int_as_float(((int)fx + 127) << 23));
}

// ops/objectives.log_f32: XLA's float32 log (Cephes), DAZ.
__device__ __forceinline__ float xrt_log_f32(float v) {
  v = xrt_ftz(v);
  const float xm = v > kXrtTiny ? v : kXrtTiny;
  const int b = __float_as_int(xm);
  float e = __fadd_rn((float)((b >> 23) - 127), 1.0f);
  const float mant = __int_as_float((b & 0x007FFFFF) | 0x3F000000);
  const bool small = mant < 0.7071067690849304f;
  float x = __fadd_rn(__fsub_rn(mant, 1.0f), small ? mant : 0.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  float y = __fmaf_rn(x, 0.07037683576345444f, -0.11514610052108765f);
  float y1 = __fmaf_rn(x, -0.12420140951871872f, 0.14249323308467865f);
  float y2 = __fmaf_rn(x, 0.2000071406364441f, -0.24999994039535522f);
  y = __fmaf_rn(y, x, 0.11676998436450958f);
  y1 = __fmaf_rn(y1, x, -0.16668057441711426f);
  y2 = __fmaf_rn(y2, x, 0.3333333134651184f);
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(y, x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(e, -0.00021219444170128554f));
  x = __fadd_rn(__fmaf_rn(x2, -0.5f, x), y);
  float r = __fmaf_rn(e, 0.693359375f, x);
  r = v > 0.0f ? r : __int_as_float(0x7fc00000);
  r = v == 0.0f ? -INFINITY : r;
  return v == INFINITY ? v : r;
}

// The logloss term of the metric partial sums (K4's, ops/metrics.py:36): y
// > 0.5 is the positive class; softplus(z), z = -m for it, m otherwise, as
// max(z, 0) + log1p(exp(-|z|)), the log1p as log(u) e / (u - 1), u = 1 + e.
__device__ __forceinline__ float xrt_binary_logloss(float m, float y) {
  const float z = y > 0.5f ? -m : m;
  const float e = __expf(-fabsf(z));
  const float u = __fadd_rn(1.0f, e);
  const float l1p =
      u == 1.0f ? e : __fmul_rn(__logf(u), __fdividef(e, __fsub_rn(u, 1.0f)));
  return __fadd_rn(fmaxf(z, 0.0f), l1p);
}

// ---------------------------------------------------------------------------
// The window-32 sum tree of ops/split.tree_sum (the order of XLA's CPU
// reduce over more than 32 values), fed one value at a time by one thread:
// m values are padded with zeros to whole windows of 32, (padded - m) / 2
// of them in front; each window is summed in order (its first value
// assigned, the others added), then the window sums the same way while
// there are more than 32 of them, then the last level in order.
// ---------------------------------------------------------------------------

#define XRT_TREE_LEVELS 6  // windowed levels: m up to 2^30

struct XrtTreeShape {
  int levels;                     // windowed levels (0: m <= 32)
  int width[XRT_TREE_LEVELS + 1];  // values at each level (width[0] = m)
  int front[XRT_TREE_LEVELS];     // zeros in front at each windowed level
};

__host__ __device__ __forceinline__ XrtTreeShape xrt_tree_shape(int m) {
  XrtTreeShape t;
  t.levels = 0;
  t.width[0] = m;
  while (m > 32 && t.levels < XRT_TREE_LEVELS) {
    const int nw = (m + 31) / 32;
    t.front[t.levels] = (nw * 32 - m) / 2;
    m = nw;
    t.width[++t.levels] = m;
  }
  return t;
}

struct XrtTreeAcc {
  float acc[XRT_TREE_LEVELS + 1];
  int cnt[XRT_TREE_LEVELS + 1];  // values taken at each level, padding too
};

// add v at level l (a window that fills goes up)
__device__ __forceinline__ void xrt_tree_push(XrtTreeAcc& t,
                                              const XrtTreeShape& s, int l,
                                              float v) {
  while (true) {
    t.acc[l] = (t.cnt[l] % 32 == 0) ? v : __fadd_rn(t.acc[l], v);
    ++t.cnt[l];
    if (l == s.levels || t.cnt[l] % 32 != 0) return;
    v = t.acc[l];
    ++l;
  }
}

__device__ __forceinline__ void xrt_tree_init(XrtTreeAcc& t,
                                              const XrtTreeShape& s) {
  for (int l = 0; l <= s.levels; ++l) {
    t.acc[l] = 0.0f;
    t.cnt[l] = 0;
  }
  for (int l = 0; l < s.levels; ++l)
    for (int i = 0; i < s.front[l]; ++i) xrt_tree_push(t, s, l, 0.0f);
}

// the sum, once the values fed are followed by zeros up to m: a partial
// window adds a zero once (the rest add nothing), then the windows of
// zeros go up one by one
__device__ __forceinline__ float xrt_tree_finish(XrtTreeAcc& t,
                                                 const XrtTreeShape& s) {
  for (int l = 0; l < s.levels; ++l) {
    const int total = 32 * s.width[l + 1];
    if (t.cnt[l] % 32 != 0) {
      t.acc[l] = __fadd_rn(t.acc[l], 0.0f);
      t.cnt[l] += 32 - t.cnt[l] % 32;
      xrt_tree_push(t, s, l + 1, t.acc[l]);
    }
    while (t.cnt[l] < total) {
      t.cnt[l] += 32;
      xrt_tree_push(t, s, l + 1, 0.0f);
    }
  }
  const int top = s.levels;
  if (t.cnt[top] == 0) return 0.0f;
  if (t.cnt[top] < s.width[top]) return __fadd_rn(t.acc[top], 0.0f);
  return t.acc[top];
}

// ---------------------------------------------------------------------------
// JAX's threefry2x32 (20 rounds) of ops/random.threefry2x32: the one device
// copy, which the sampling kernels (csrc/sampling.cu) draw their bits from.
// Element i of a draw of key (k0, k1) has the bits y0 ^ y1 of
// threefry2x32(key, (i >> 32, i mod 2^32)) (jax_threefry_partitionable).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t xrt_rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void xrt_threefry2x32(uint32_t k0, uint32_t k1,
                                                 uint32_t x0, uint32_t x1,
                                                 uint32_t* y0, uint32_t* y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = xrt_rotl32(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  *y0 = x0;
  *y1 = x1;
}

// the 32 random bits of flat element i of a draw
__device__ __forceinline__ uint32_t xrt_random_bits(uint32_t k0, uint32_t k1,
                                                    unsigned long long i) {
  uint32_t y0, y1;
  xrt_threefry2x32(k0, k1, (uint32_t)(i >> 32), (uint32_t)i, &y0, &y1);
  return y0 ^ y1;
}

// jax.random.uniform's float in [0, 1) of the bits: (bits >> 9) * 2^-23
__device__ __forceinline__ float xrt_bits_to_unit(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}
