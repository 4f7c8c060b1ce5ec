// K4, the fused per-round elementwise pass of binary:logistic and
// reg:squarederror, CUDA C++ for sm_90a. One pass over [N] f32 margins, in
// two modes:
//   gh (XRT_K4_LOGISTIC / XRT_K4_SQUARED): margin += row_value, written
//     back; the metric partial sums of the new margins; the next round's
//     gradients gh [N, 2] (g, h interleaved, what K1 reads);
//   eval (XRT_K4_EVAL): the same without gradients (a held-out set).
//
// Replaces xgboost_ray_tpu/ops/objectives.py:88 _make_logistic (its gh,
// with scale_pos_weight) and :57 _make_squarederror, and the metrics the
// round reads, ops/metrics.py:36 _logloss, :43 _error and :27 _rmse, as
// four sums: sum(w logloss), sum(w wrong), sum(w d^2), sum(w). The margins
// and the gradients are bitwise the plain version (ops/objectives
// round_update_plain), which is bitwise the reference's compiled CPU
// program:
//   - the sigmoid is the Cephes exp of ops/objectives.exp_f32 (clamped,
//     with its final NaN-propagating max) with __fmaf_rn where it fuses and
//     nowhere else (--fmad=false, ops/_build.py), then p = __fdiv_rn(1,
//     1 + e), correctly rounded, a subnormal p flushed to zero;
//   - XLA's CPU program reads subnormal operands as zero and flushes
//     subnormal results to a zero of their sign: margin, label and weight
//     are read that way for the gradients, and every product and
//     difference of g and h is flushed explicitly (no -ftz, no fast math);
//   - max(p (1 - p), 1e-16) NaN-propagating, and scale_pos_weight selected
//     by label > 0.5, in the plain version's order.
// The partial sums are not bitwise the plain version's torch.sum (another
// order; the logloss's log1p(exp(-|z|)) from the fast __expf / __logf, as
// log(u) e / (u - 1) with u = 1 + e): they are held within 1e-5 relative.
// The error term's sigmoid(m) > 0.5 is m >= kHalfMargin, the least float32
// margin whose plain sigmoid exceeds 0.5 (tests/test_torch_objective_kernel
// holds the two tests equal), so the eval mode evaluates no exp_f32. The
// sums are bitwise from launch to launch and between the two modes: each
// CTA sums its rows in a fixed order into one f32 quadruple (each thread
// its rows in order, an xor tree of warp shuffles, the warps in order; no
// float atomics), and the last CTA to finish (a ticket counter taken with
// acquire-release semantics, which resets itself) adds the quadruples in
// f64 in a fixed order that keeps CTA order (a run of CTAs a thread, then
// an order-preserving pairwise tree) into a fresh [4] f64 output: one
// launch a call.
//
// What bounds it on an H100: bytes. Each row reads margin, row_value,
// label and weight (16 B) and writes its margin (4 B), and in gh mode its
// (g, h) pair (8 B): 20 B a row in eval mode (500,000 HIGGS test rows:
// 10 MB, 2.985 us at 3.35 TB/s), 28 B in gh mode (11M rows: 0.0919 ms).
// Design: a persistent grid of at most 2 CTAs of 512 threads an SM
// (ops/objectives.k4_plan: the grid depends on N and the card only, so
// both modes sum the same rows in the same CTAs) walks tiles of 2,048 rows,
// 4 a thread: a thread loads its rows of the four inputs as 16-byte
// vectors, the next tile's four loads issued before the current tile is
// computed (registers double-buffered); the margins go back as one float4
// a thread, and each warp's (g, h) pairs are staged through shared memory
// so that a store instruction writes 512 contiguous bytes. The loads and
// stores carry no cache hint: evict-first ones lowered neither mode's time
// (chip_smoke.py --k4-variants prices them). Where a pointer
// is not 16-byte aligned the whole launch takes the scalar path (the same
// rows for the same threads, so the same sums), and the vector that holds
// the last row takes it inside the vector path. What is left above the
// bound at 500,000 rows is the last CTA's serial tail (the ticket's and
// the partials' round trips to L2) and the launch's ramp: PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kThreads = 512;
constexpr int kTileRows = kThreads * 4;  // ops/objectives.K4_TILE_ROWS
constexpr int kCtasPerSm = 2;            // ops/objectives.K4_CTAS_PER_SM

enum { XRT_K4_EVAL = 0, XRT_K4_LOGISTIC = 1, XRT_K4_SQUARED = 2 };

// Mirrors ops/_build.K4Args field by field: edit both together.
struct XrtK4Args {
  float* margin;           // [n], updated in place
  const float* row_value;  // [n]
  const float* label;      // [n]
  const float* weight;     // [n]
  float* gh;               // [n, 2] (gh modes)
  float* part;             // [grid, 4] scratch: the CTAs' f32 quadruples
  unsigned* ticket;        // 0 between launches (the last CTA resets it)
  double* out;             // [4]: logloss, error, sqerr, weight sums
  long long n;
  int grid;                // ops/objectives.k4_plan(n, SMs).grid
  int mode;
  float scale_pos_weight;  // as float32
};

constexpr float kTiny = 1.17549435e-38f;  // smallest normal float
// the least float32 margin m with sigmoid(m) > 0.5 (0x33c00001)
constexpr float kHalfMargin = 8.9406974e-08f;

// a subnormal flushed to a zero of its sign, as XLA's CPU program flushes
__device__ __forceinline__ float xrt_ftz(float x) {
  return fabsf(x) < kTiny ? x * 0.0f : x;
}

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float xrt_max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// ops/objectives.exp_f32: the clamp (NaN stays NaN), Cephes' range
// reduction and degree-5 polynomial with every multiply-add fused, the
// scale 2^fx from the exponent bits, then torch.maximum(y * 2^fx, v).
__device__ __forceinline__ float xrt_exp_f32(float v) {
  const float xc =
      v != v ? v : fminf(fmaxf(v, -88.3762626647949f), 88.3762626647950f);
  const float fx = floorf(__fmaf_rn(xc, 1.44269504088896341f, 0.5f));
  float x = __fmaf_rn(fx, -0.693359375f, xc);
  x = __fmaf_rn(fx, 2.12194440e-4f, x);
  const float z = __fmul_rn(x, x);
  float y = __fmaf_rn(x, 1.9875691500e-4f, 1.3981999507e-3f);
  y = __fmaf_rn(y, x, 8.3334519073e-3f);
  y = __fmaf_rn(y, x, 4.1665795894e-2f);
  y = __fmaf_rn(y, x, 1.6666665459e-1f);
  y = __fmaf_rn(y, x, 5.0000001201e-1f);
  y = __fadd_rn(1.0f, __fmaf_rn(y, z, x));
  const unsigned bits = (unsigned)((int)fx + 127) << 23;
  return xrt_max_nan(__fmul_rn(y, __int_as_float((int)bits)), v);
}

// One row: its metric terms added to the thread's sums (raw margin, label
// and weight, as ops/metrics.metric_partials takes them) and, in gh mode,
// its (g, h) from the operands read as the reference reads them.
template <int MODE>
__device__ __forceinline__ float2 xrt_row(float m, float y, float w,
                                          float spw, float (&acc)[4]) {
  const bool pos = y > 0.5f;
  // logloss: softplus(-m) for y = 1, softplus(m) for y = 0
  const float z = pos ? -m : m;
  const float e = __expf(-fabsf(z));
  const float u = __fadd_rn(1.0f, e);
  const float l1p =
      u == 1.0f ? e : __fmul_rn(__logf(u), __fdividef(e, __fsub_rn(u, 1.0f)));
  acc[0] = __fadd_rn(acc[0], __fmul_rn(w, __fadd_rn(fmaxf(z, 0.0f), l1p)));
  // error: sigmoid(m) > 0.5 against label > 0.5
  const bool up = m >= kHalfMargin;
  acc[1] = __fadd_rn(acc[1], __fmul_rn(w, up != pos ? 1.0f : 0.0f));
  const float d = __fsub_rn(m, y);
  acc[2] = __fadd_rn(acc[2], __fmul_rn(__fmul_rn(w, d), d));
  acc[3] = __fadd_rn(acc[3], w);
  if (MODE == XRT_K4_EVAL) return make_float2(0.0f, 0.0f);
  const float md = xrt_ftz(m), yd = xrt_ftz(y), wd = xrt_ftz(w);
  if (MODE == XRT_K4_LOGISTIC) {
    float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, xrt_exp_f32(-md)));
    p = p < kTiny ? 0.0f : p;
    const float ws = xrt_ftz(__fmul_rn(wd, yd > 0.5f ? spw : 1.0f));
    const float g = xrt_ftz(__fmul_rn(xrt_ftz(__fsub_rn(p, yd)), ws));
    float t = __fmul_rn(p, __fsub_rn(1.0f, p));
    t = t != t ? t : fmaxf(t, 1e-16f);
    return make_float2(g, xrt_ftz(__fmul_rn(t, ws)));
  }
  // the squared error's h is the weight itself, as the reference passes it
  return make_float2(xrt_ftz(__fmul_rn(xrt_ftz(__fsub_rn(md, yd)), wd)), w);
}

// A thread's four rows of one tile: margin, row_value, label, weight.
struct XrtRows {
  float4 m, r, y, w;
};

__device__ __forceinline__ float xrt_lane(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

__device__ __forceinline__ void xrt_set(float4& v, int j, float x) {
  if (j == 0) v.x = x;
  else if (j == 1) v.y = x;
  else if (j == 2) v.z = x;
  else v.w = x;
}

// The rows 4q .. 4q + 3 (q: the thread's vector), by one 16-byte load of
// each input where all four rows exist and the pointers are aligned (VEC),
// else row by row; rows past n read as 0. The margins are written by this
// kernel, so only the other three take the read-only path.
template <bool VEC>
__device__ __forceinline__ void xrt_load(const XrtK4Args& a, long long q,
                                         XrtRows& r) {
  if (VEC && 4 * q + 3 < a.n) {
    r.m = reinterpret_cast<const float4*>(a.margin)[q];
    r.r = __ldg(reinterpret_cast<const float4*>(a.row_value) + q);
    r.y = __ldg(reinterpret_cast<const float4*>(a.label) + q);
    r.w = __ldg(reinterpret_cast<const float4*>(a.weight) + q);
    return;
  }
  r.m = r.r = r.y = r.w = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long row = 4 * q + j;
    if (row < a.n) {
      xrt_set(r.m, j, a.margin[row]);
      xrt_set(r.r, j, __ldg(a.row_value + row));
      xrt_set(r.y, j, __ldg(a.label + row));
      xrt_set(r.w, j, __ldg(a.weight + row));
    }
  }
}

// The thread's rows of a tile: margins updated and stored, sums, gradients.
// A warp whose 32 vectors are all whole writes its (g, h) pairs through
// `stage` (its 64 float4 of shared memory): two store instructions of 512
// contiguous bytes, where each thread's own 32 bytes would take two
// instructions that each cover half of 32 sectors.
template <int MODE, bool VEC>
__device__ __forceinline__ void xrt_rows(const XrtK4Args& a, long long q,
                                         const XrtRows& r, float (&acc)[4],
                                         float4* stage) {
  float4 mo = make_float4(0.f, 0.f, 0.f, 0.f), g01 = mo, g23 = mo;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long row = 4 * q + j;
    if (row < a.n) {
      const float m = __fadd_rn(xrt_lane(r.m, j), xrt_lane(r.r, j));
      xrt_set(mo, j, m);
      const float2 gh = xrt_row<MODE>(m, xrt_lane(r.y, j), xrt_lane(r.w, j),
                                      a.scale_pos_weight, acc);
      float4& out = j < 2 ? g01 : g23;
      xrt_set(out, 2 * (j & 1), gh.x);
      xrt_set(out, 2 * (j & 1) + 1, gh.y);
    }
  }
  if (VEC && 4 * q + 3 < a.n) {
    reinterpret_cast<float4*>(a.margin)[q] = mo;
    if (MODE == XRT_K4_EVAL) return;
    float4* gh = reinterpret_cast<float4*>(a.gh);
    if (__activemask() == 0xffffffffu) {
      const int l = threadIdx.x & 31;
      stage[2 * l] = g01;
      stage[2 * l + 1] = g23;
      __syncwarp();
      gh += 2 * (q - l);  // the warp's first vector's pairs
      gh[l] = stage[l];
      gh[32 + l] = stage[32 + l];
      __syncwarp();
    } else {
      gh[2 * q] = g01;
      gh[2 * q + 1] = g23;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long row = 4 * q + j;
    if (row < a.n) {
      a.margin[row] = xrt_lane(mo, j);
      if (MODE != XRT_K4_EVAL) {
        const float4& out = j < 2 ? g01 : g23;
        a.gh[2 * row] = xrt_lane(out, 2 * (j & 1));
        a.gh[2 * row + 1] = xrt_lane(out, 2 * (j & 1) + 1);
      }
    }
  }
}

// The last CTA: the grid's quadruples added in f64, a run of CTAs a thread
// in CTA order, then an order-preserving pairwise tree over the threads.
__device__ __forceinline__ void xrt_final(const XrtK4Args& a) {
  __shared__ double ws[4][kThreads / 32];
  const int per = (gridDim.x + kThreads - 1) / kThreads;
  const int c0 = threadIdx.x * per;
  const int c1 = min((int)gridDim.x, c0 + per);
  double s[4] = {0.0, 0.0, 0.0, 0.0};
  for (int c = c0; c < c1; ++c) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(a.part) + c);
    s[0] = __dadd_rn(s[0], (double)v.x);
    s[1] = __dadd_rn(s[1], (double)v.y);
    s[2] = __dadd_rn(s[2], (double)v.z);
    s[3] = __dadd_rn(s[3], (double)v.w);
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const double v = __shfl_down_sync(0xffffffffu, s[k], o);
      if ((threadIdx.x & (2 * o - 1)) == 0) s[k] = __dadd_rn(s[k], v);
    }
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) ws[k][wid] = s[k];
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    double t = ws[threadIdx.x][0];
    for (int i = 1; i < kThreads / 32; ++i)
      t = __dadd_rn(t, ws[threadIdx.x][i]);
    a.out[threadIdx.x] = t;
  }
}

// atomicInc with acquire-release semantics at device scope: it makes the
// thread's quadruple visible before its ticket, and the last CTA's reads
// of the others' after it, without a separate fence on either side.
__device__ __forceinline__ unsigned xrt_ticket(unsigned* p, unsigned wrap) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(wrap)
               : "memory");
  return old;
}

template <int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    xrt_k4_kernel(const XrtK4Args a) {
  __shared__ float4 stage[MODE == XRT_K4_EVAL ? 1 : 2 * kThreads];
  float4* mine = MODE == XRT_K4_EVAL ? stage : stage + 2 * (threadIdx.x & ~31);
  const long long tiles = (a.n + kTileRows - 1) / kTileRows;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  long long tile = blockIdx.x;
  XrtRows cur, nxt;
  if (tile < tiles) xrt_load<VEC>(a, tile * kThreads + threadIdx.x, cur);
  for (; tile < tiles; tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < tiles) xrt_load<VEC>(a, next * kThreads + threadIdx.x, nxt);
    xrt_rows<MODE, VEC>(a, tile * kThreads + threadIdx.x, cur, acc, mine);
    cur = nxt;
  }

  // the CTA's quadruple: an xor tree in each warp, then the warps in order
  __shared__ float wsum[4][kThreads / 32];
  __shared__ bool last;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[k] = __fadd_rn(acc[k], __shfl_xor_sync(0xffffffffu, acc[k], o));
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) wsum[k][wid] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float4 t = make_float4(wsum[0][0], wsum[1][0], wsum[2][0], wsum[3][0]);
    for (int i = 1; i < kThreads / 32; ++i) {
      t.x = __fadd_rn(t.x, wsum[0][i]);
      t.y = __fadd_rn(t.y, wsum[1][i]);
      t.z = __fadd_rn(t.z, wsum[2][i]);
      t.w = __fadd_rn(t.w, wsum[3][i]);
    }
    reinterpret_cast<float4*>(a.part)[blockIdx.x] = t;
    // wraps to 0 at gridDim.x - 1: the last CTA resets the ticket
    last = xrt_ticket(a.ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) xrt_final(a);
}

typedef void (*XrtK4Kernel)(const XrtK4Args);

template <bool VEC>
static XrtK4Kernel k4_kernel(int mode) {
  switch (mode) {
    case XRT_K4_EVAL: return xrt_k4_kernel<XRT_K4_EVAL, VEC>;
    case XRT_K4_LOGISTIC: return xrt_k4_kernel<XRT_K4_LOGISTIC, VEC>;
    case XRT_K4_SQUARED: return xrt_k4_kernel<XRT_K4_SQUARED, VEC>;
    default: return nullptr;
  }
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// One launch of K4 over a->n rows on `stream`: a->grid CTAs (a->part
// holds that many quadruples), the sums into a->out. The vector path where
// every row pointer is 16-byte aligned, else the scalar path.
extern "C" int xrt_k4(const XrtK4Args* a, void* stream) {
  if (a->n < 0 || a->grid < 1 || a->mode < XRT_K4_EVAL ||
      a->mode > XRT_K4_SQUARED || a->part == nullptr ||
      a->ticket == nullptr || a->out == nullptr ||
      (a->mode != XRT_K4_EVAL && a->n > 0 && a->gh == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(a->margin) && aligned16(a->row_value) &&
                   aligned16(a->label) && aligned16(a->weight) &&
                   (a->mode == XRT_K4_EVAL || aligned16(a->gh));
  const XrtK4Kernel kernel = vec ? k4_kernel<true>(a->mode)
                                 : k4_kernel<false>(a->mode);
  kernel<<<(unsigned)a->grid, kThreads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
