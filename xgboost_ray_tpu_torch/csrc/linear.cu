// B16: the coordinate-descent round of booster="gblinear", CUDA C++ for
// sm_90a.
//
// Replaces the bias step and the lax.scan over features of
// xgboost_ray_tpu/linear.py:460-525 (LinearEngine._build_round_fn), after
// the margins and the objective's gradients: the bias step
// (CoordinateDeltaBias: sg = sum g, sh = sum h, db = eta (-sg / sh) where
// sh > 1e-5, g += h db), then for each feature j in turn sg = sum g x_j,
// sh = sum h (x_j x_j), dw = eta coordinate_delta(sg, sh, w_j) (the
// elastic-net soft threshold, the penalties denormalized by the weight sum
// on the host), w_j += dw, g += (h x_j) dw. K outputs are K independent
// passes sharing the rows.
//
// The sums' order is fixed by the rows alone, never by the grid: rows in
// chunks of 1,024; thread t of a chunk adds rows t, t + 256, t + 512,
// t + 768 in turn (from +0), then the 256 thread sums are halved in a tree
// (s[t] += s[t + stride], stride 128 .. 1): the chunk's partial. The chunk
// partials are summed the same way: thread t adds chunks t, t + 256, ... in
// turn, then the tree. ops/linear.blocked_sum is that order in PyTorch, so
// the card equals the plain version bit for bit on any card. No operation
// is fused (--fmad=false); the divisions are IEEE.
//
// What bounds it on an H100: bytes. A coordinate reads x_j (4 B a row) and
// the K (g, h) pairs (8 K B), and writes the K g's (4 K B; a 32-byte sector
// holds 4 rows' pairs, so the write costs the sector's bytes again), once
// for all: the update of one coordinate is fused with the sums of the next
// in one pass over a CTA's rows. Design: one cooperative launch of a
// persistent grid (every CTA resident), a CTA owns chunks blockIdx.x,
// blockIdx.x + grid, ... for the whole round (so the update of a row and
// the next coordinate's sums of it need no barrier between them). After a
// coordinate's pass, one grid barrier (xrt_grid_sync); then every CTA sums
// the chunk partials itself, in the fixed order, and computes the same dw.
// The partials are double-buffered by coordinate, so a CTA that runs ahead
// never overwrites partials another is still reading.
//
// At world > 1 the round is split at the all-reduce of each coordinate's
// [2K] sums: XRT_LIN_SUMS (the bias's sums) and then, per coordinate c,
// XRT_LIN_STEP (read the merged sums of c, update c, and write the sums of
// c + 1 into `sums`, CTA 0 after the grid barrier).

#include "common.cuh"

constexpr int kThreads = XRT_THREADS;  // 256
constexpr int kRowsPerThread = 4;
constexpr int kChunk = kThreads * kRowsPerThread;  // ops/linear.CHUNK_ROWS
constexpr int kMaxOutputs = 64;                    // ops/linear.MAX_OUTPUTS

enum { XRT_LIN_ROUND = 0, XRT_LIN_SUMS = 1, XRT_LIN_STEP = 2 };

// Mirrors ops/_build.LinearArgs field by field: edit both together.
struct XrtLinearArgs {
  const float* x;   // [F][n] feature-major, NaN as 0
  float* gh;        // [K][n][2] (g, h); g updated in place
  const float* w;   // [F][K] the round's starting weights
  const float* b;   // [K]
  float* w_out;     // [F][K] the updated weights (a coordinate each step)
  float* b_out;     // [K]
  float* part;      // [2][n_chunks][2K] chunk partials
  float* sums;      // [2K] (sg, sh) of a coordinate: out of SUMS / STEP,
                    // in (merged) at STEP
  unsigned* bar;    // [2] grid barrier words, zero between launches
  long long n;
  int n_features, k, n_chunks;
  float eta, lam, alp;
  int mode;   // XRT_LIN_ROUND | XRT_LIN_SUMS | XRT_LIN_STEP
  int coord;  // STEP: the coordinate updated (-1 the bias, else a feature)
  int grid;
};

__device__ __forceinline__ float xrt_min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// linear.py:471-479 coordinate_delta in float32, operation by operation
__device__ __forceinline__ float xrt_coordinate_delta(float sg, float sh,
                                                      float w, float lam,
                                                      float alp) {
  const float sg_l2 = __fadd_rn(sg, __fmul_rn(lam, w));
  const float sh_l2 = xrt_max_nan(__fadd_rn(sh, lam), 1e-38f);
  const float tmp = __fsub_rn(w, __fdiv_rn(sg_l2, sh_l2));
  const float pos = xrt_max_nan(__fdiv_rn(-__fadd_rn(sg_l2, alp), sh_l2), -w);
  const float neg = xrt_min_nan(__fdiv_rn(-__fsub_rn(sg_l2, alp), sh_l2), -w);
  const float d = tmp >= 0.0f ? pos : neg;
  return sh < 1e-5f ? 0.0f : d;
}

// CoordinateDeltaBias (linear.py:508)
__device__ __forceinline__ float xrt_bias_delta(float sg, float sh) {
  return sh > 1e-5f ? __fdiv_rn(-sg, xrt_max_nan(sh, 1e-38f)) : 0.0f;
}

// s[0 .. 255] halved in a tree into s[0]; every thread calls it
__device__ __forceinline__ void xrt_tree256(float* s) {
#pragma unroll
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    __syncthreads();
    if (threadIdx.x < stride)
      s[threadIdx.x] = __fadd_rn(s[threadIdx.x], s[threadIdx.x + stride]);
  }
  __syncthreads();
}

// One pass over this CTA's chunks: with upd >= -1, g += h x_upd dw[k]
// (upd -1: g += h dw[k], the bias); with nxt >= -1, the chunk partials of
// coordinate nxt into part_out ([n_chunks][2K]).
__device__ void xrt_lin_pass(const XrtLinearArgs& a, int upd, const float* dw,
                             int nxt, float* part_out, float* s_g,
                             float* s_h) {
  const long long n = a.n;
  const int K = a.k;
  const float* xu = upd >= 0 ? a.x + (long long)upd * n : nullptr;
  const float* xn = nxt >= 0 ? a.x + (long long)nxt * n : nullptr;
  for (int ch = blockIdx.x; ch < a.n_chunks; ch += gridDim.x) {
    const long long r0 = (long long)ch * kChunk + threadIdx.x;
    for (int k = 0; k < K; ++k) {
      float2* gh = reinterpret_cast<float2*>(a.gh) + (long long)k * n;
      float sg = 0.0f, sh = 0.0f;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const long long r = r0 + (long long)i * kThreads;
        if (r >= n) continue;
        float2 v = gh[r];
        if (upd >= -1) {
          const float hx = upd >= 0 ? __fmul_rn(v.y, __ldg(xu + r)) : v.y;
          v.x = __fadd_rn(v.x, __fmul_rn(hx, dw[k]));
          gh[r].x = v.x;
        }
        if (nxt >= -1) {
          if (nxt >= 0) {
            const float xv = __ldg(xn + r);
            sg = __fadd_rn(sg, __fmul_rn(v.x, xv));
            sh = __fadd_rn(sh, __fmul_rn(v.y, __fmul_rn(xv, xv)));
          } else {
            sg = __fadd_rn(sg, v.x);
            sh = __fadd_rn(sh, v.y);
          }
        }
      }
      if (nxt >= -1) {
        s_g[threadIdx.x] = sg;
        s_h[threadIdx.x] = sh;
        xrt_tree256(s_g);
        xrt_tree256(s_h);
        if (threadIdx.x == 0) {
          part_out[(long long)ch * 2 * K + 2 * k] = s_g[0];
          part_out[(long long)ch * 2 * K + 2 * k + 1] = s_h[0];
        }
        __syncthreads();
      }
    }
  }
}

// The merged chunk partials of one coordinate, (sg, sh) of output k for
// k < K, into tot[2K] (shared); every thread calls it. Reads go around L1:
// other CTAs wrote them before the barrier.
__device__ void xrt_lin_total(const XrtLinearArgs& a, const float* part_in,
                              float* tot, float* s_g, float* s_h) {
  const int K = a.k;
  for (int k = 0; k < K; ++k) {
    float sg = 0.0f, sh = 0.0f;
    for (int ch = threadIdx.x; ch < a.n_chunks; ch += kThreads) {
      sg = __fadd_rn(sg, __ldcg(part_in + (long long)ch * 2 * K + 2 * k));
      sh = __fadd_rn(sh, __ldcg(part_in + (long long)ch * 2 * K + 2 * k + 1));
    }
    s_g[threadIdx.x] = sg;
    s_h[threadIdx.x] = sh;
    xrt_tree256(s_g);
    xrt_tree256(s_h);
    if (threadIdx.x == 0) {
      tot[2 * k] = s_g[0];
      tot[2 * k + 1] = s_h[0];
    }
    __syncthreads();
  }
}

// dw[k] of coordinate c from its sums tot[2K]; CTA 0 writes the updated
// weight (or bias) to w_out / b_out
__device__ void xrt_lin_delta(const XrtLinearArgs& a, int c, const float* tot,
                              float* dw) {
  if (threadIdx.x < a.k) {
    const int k = threadIdx.x;
    float d;
    if (c < 0) {
      d = __fmul_rn(a.eta, xrt_bias_delta(tot[2 * k], tot[2 * k + 1]));
      if (blockIdx.x == 0) a.b_out[k] = __fadd_rn(a.b[k], d);
    } else {
      const float w = a.w[(long long)c * a.k + k];
      d = __fmul_rn(a.eta, xrt_coordinate_delta(tot[2 * k], tot[2 * k + 1], w,
                                                a.lam, a.alp));
      if (blockIdx.x == 0) a.w_out[(long long)c * a.k + k] = __fadd_rn(w, d);
    }
    dw[k] = d;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) xrt_linear_kernel(
    const XrtLinearArgs a) {
  __shared__ float s_g[kThreads], s_h[kThreads];
  __shared__ float tot[2 * kMaxOutputs], dw[kMaxOutputs];
  const long long half = (long long)a.n_chunks * 2 * a.k;
  if (a.mode == XRT_LIN_SUMS) {
    xrt_lin_pass(a, -2, dw, -1, a.part, s_g, s_h);
  } else if (a.mode == XRT_LIN_STEP) {
    if (threadIdx.x < 2 * a.k) tot[threadIdx.x] = a.sums[threadIdx.x];
    __syncthreads();
    xrt_lin_delta(a, a.coord, tot, dw);
    const int nxt = a.coord + 1 < a.n_features ? a.coord + 1 : -2;
    xrt_lin_pass(a, a.coord, dw, nxt, a.part, s_g, s_h);
    if (nxt < -1) return;
  } else {
    // the whole round: the bias's sums, then for each coordinate its
    // update fused with the next one's sums
    xrt_lin_pass(a, -2, dw, -1, a.part, s_g, s_h);
    for (int c = -1; c < a.n_features; ++c) {
      const float* part_in = a.part + ((c + 1) & 1) * half;
      xrt_grid_sync(a.bar);
      xrt_lin_total(a, part_in, tot, s_g, s_h);
      xrt_lin_delta(a, c, tot, dw);
      const int nxt = c + 1 < a.n_features ? c + 1 : -2;
      xrt_lin_pass(a, c, dw, nxt, a.part + ((c + 2) & 1) * half, s_g, s_h);
    }
    return;
  }
  // SUMS / STEP: the launch's sums, by CTA 0 after every chunk is written
  xrt_grid_sync(a.bar);
  if (blockIdx.x == 0) {
    xrt_lin_total(a, a.part, tot, s_g, s_h);
    if (threadIdx.x < 2 * a.k) a.sums[threadIdx.x] = tot[threadIdx.x];
  }
}

// The CTAs of the persistent grid: as many as every SM holds at once (a
// cooperative launch needs them all resident).
extern "C" int xrt_linear_ctas(int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, xrt_linear_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *grid = per_sm * sms;
  return 0;
}

extern "C" int xrt_linear(const XrtLinearArgs* a, void* stream) {
  if (a->n < 1 || a->k < 1 || a->k > kMaxOutputs || a->n_features < 0 ||
      a->grid < 1 || a->n_chunks != (int)((a->n + kChunk - 1) / kChunk) ||
      a->mode < XRT_LIN_ROUND || a->mode > XRT_LIN_STEP ||
      (a->mode == XRT_LIN_STEP &&
       (a->coord < -1 || a->coord >= a->n_features)) ||
      a->gh == nullptr || a->part == nullptr || a->bar == nullptr ||
      a->b == nullptr || a->b_out == nullptr || a->sums == nullptr ||
      (a->n_features > 0 &&
       (a->x == nullptr || a->w == nullptr || a->w_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  XrtLinearArgs args = *a;
  void* params[] = {&args};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)xrt_linear_kernel, dim3(a->grid), dim3(kThreads), params,
      0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
