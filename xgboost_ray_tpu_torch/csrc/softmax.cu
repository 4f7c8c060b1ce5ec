// The softmax pass: K4's counterpart for multi:softprob / multi:softmax,
// CUDA C++ for sm_90a. One pass over the rows of [N, K] margins, in four
// modes:
//   training (XRT_SMX_TRAIN): margins += the round's K row values [K, N],
//     written back; the mlogloss / merror / weight partial sums of the new
//     margins; the next round's gradients as [K, N, 2] planes (class k's
//     [N, 2] contiguous, what K1-K3 read);
//   eval (XRT_SMX_EVAL): the same without gradients (a held-out set);
//   transform (XRT_SMX_PROB / XRT_SMX_CLASS): probabilities [N, K] or the
//     first argmax class [N] (f32) of the probabilities, for predict and
//     serve; margins only read.
//
// Replaces xgboost_ray_tpu/ops/objectives.py:107 _make_softmax (grad_hess
// and transform) and the metrics it feeds, ops/metrics.py:49 _merror and
// :55 _mlogloss. Every output but the partial sums is bitwise the plain
// version (ops/objectives.softmax_update_plain / softmax_transform_plain),
// which is bitwise the reference's compiled CPU program:
//   - the max over classes NaN-propagating (torch.maximum; fmaxf is not);
//   - the sum of exp(m - max) as XLA's CPU reduce takes it: in class order
//     up to 32 classes; above that windows of 32 over the zero-padded class
//     axis, half the padding in front, each window summed in order, then
//     the window sums, windowed again while more than 32 (ops/split
//     tree_sum);
//   - exp is the Cephes exp of ops/objectives.exp_f32 with __fmaf_rn where
//     it fuses and nowhere else (--fmad=false, ops/_build.py);
//   - every subnormal result flushed to a zero of its sign, explicitly (no
//     -ftz, no fast math); p = __fdiv_rn(e, s), correctly rounded;
//   - labels cast as label_class casts them (cvt.rzi: truncated,
//     saturated, NaN to 0); the mlogloss term's class wraps in [-K, 0) and
//     is NaN beyond, as take_along_axis gives.
// The partial sums are one f32 triple per CTA, reduced in a fixed order (no
// float atomics: reruns are bitwise); the wrapper adds them in f64.
//
// What bounds it on an H100: bytes (training at K = 7: 148 bytes a row,
// margins read and written, K row values, label and weight, K (g, h)
// pairs). Design: a CTA takes 256 rows, one a thread. Up to 32 classes
// (templated on a bound KMAX of 4, 8, 16 or 32 with the runtime K inside)
// the CTA copies its rows' R x K margins, which are contiguous, into shared
// memory, at a row pitch of K floats (K odd: 16-byte loads) or K + 1 (K
// even: 4-byte loads, each to its padded place), so that thread r's reads
// of its row at r * pitch + k hit 32 distinct banks across a warp; each
// thread then keeps its row's K values in registers: every element is
// loaded once and exp is evaluated once an element. The row values come
// from [K, N] (coalesced across rows for each class), the gradients go out
// as one float2 a (class, row), coalesced; updated margins and
// probabilities go back through the tile, coalesced. Above 32 classes a
// thread walks its row's classes three times (max, windowed sum, outputs),
// re-reading them from memory (L1 / L2): the general path, off the main
// path's shapes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kThreads = 256;  // rows per CTA, one a thread
constexpr int kWin = 32;       // the reference's reduce window
constexpr int kLevels = 6;     // window levels of the wide path (K < 2^25)

enum { XRT_SMX_TRAIN = 0, XRT_SMX_EVAL = 1, XRT_SMX_PROB = 2,
       XRT_SMX_CLASS = 3 };

// Mirrors ops/_build.SoftmaxArgs field by field: edit both together.
struct XrtSoftmaxArgs {
  float* margin;           // [n, k]
  const float* row_value;  // [k, n] (training, eval)
  const float* label;      // [n] (training, eval)
  const float* weight;     // [n] (training, eval)
  float* gh;               // [k, n, 2] (training)
  float* part;             // [grid, 3] (training, eval)
  float* out;              // [n, k] probabilities or [n] classes
  long long n;
  int k, mode;
  int kmax;                // 4, 8, 16, 32: the register path; 0: wide
  int pitch;               // floats a row of the shared tile
  int shared_bytes;        // the register path's two stage buffers
  unsigned kmagic;         // ceil(2^32 / k): i / k as __umulhi(i, kmagic)
  int front0, top;         // the window tree over classes (wide path)
  int front[kLevels];
  int grid;                // CTAs: the register path's persistent grid
};

constexpr float kTiny = 1.17549435e-38f;  // smallest normal float

__device__ __forceinline__ float xrt_ftz(float x) {
  return fabsf(x) < kTiny ? x * 0.0f : x;
}

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float xrt_max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// ops/objectives.exp_f32 of a shifted margin v = m - max, which is at
// most 0 or NaN: Cephes' range reduction and degree-5 polynomial, every
// multiply-add fused. There the clamp's upper bound never applies, and the
// final torch.maximum(y * 2^fx, v) is y * 2^fx (a number >= 0 >= v, or NaN
// with v), so neither is evaluated.
__device__ __forceinline__ float xrt_exp_f32(float v) {
  const float xc = v != v ? v : fmaxf(v, -88.3762626647949f);
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
  return __fmul_rn(y, __int_as_float(((int)fx + 127) << 23));
}

// the flushed exp of a flushed shifted margin: e_k of softmax_parts
__device__ __forceinline__ float xrt_e(float v, float mx) {
  return xrt_ftz(xrt_exp_f32(xrt_ftz(__fsub_rn(v, mx))));
}

// jnp.argmax's rule in a scan: a larger value, or the first NaN, wins
__device__ __forceinline__ bool xrt_better(float v, float best) {
  return v > best || (v != v && best == best);
}

// g = (p - onehot) w, h = max(2 p (1 - p), 1e-16) w, both flushed
__device__ __forceinline__ float2 xrt_gh(float p, bool hot, float w) {
  const float g = xrt_ftz(__fmul_rn(__fsub_rn(p, hot ? 1.0f : 0.0f), w));
  float t = __fmul_rn(__fmul_rn(2.0f, p), __fsub_rn(1.0f, p));
  t = t != t ? t : fmaxf(t, 1e-16f);
  return make_float2(g, xrt_ftz(__fmul_rn(t, w)));
}

// The CTA's three partial sums in a fixed order (xor tree in each warp,
// then the warps' sums in order), written by thread 0.
__device__ __forceinline__ void xrt_partials(float a, float b, float c,
                                             float* part) {
  __shared__ float ws[3][kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
    c = __fadd_rn(c, __shfl_xor_sync(0xffffffffu, c, o));
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    ws[0][wid] = a;
    ws[1][wid] = b;
    ws[2][wid] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s0 = ws[0][0], s1 = ws[1][0], s2 = ws[2][0];
    for (int i = 1; i < kThreads / 32; ++i) {
      s0 = __fadd_rn(s0, ws[0][i]);
      s1 = __fadd_rn(s1, ws[1][i]);
      s2 = __fadd_rn(s2, ws[2][i]);
    }
    float* p = part + (long long)blockIdx.x * 3;
    p[0] = s0;
    p[1] = s1;
    p[2] = s2;
  }
}

// The label's class and its wrap: (yi, yk), yk = -1 where no class.
__device__ __forceinline__ void xrt_label(const XrtSoftmaxArgs& a,
                                          long long row, float* w, int* yi,
                                          int* yk) {
  *w = a.weight[row];
  *yi = __float2int_rz(a.label[row]);  // cvt.rzi: saturated, NaN -> 0
  const int c = *yi < 0 ? *yi + a.k : *yi;
  *yk = c >= 0 && c < a.k ? c : -1;
}

// ---------------------------------------------------------------------------
// up to 32 classes: a row a thread, its K values in registers
// ---------------------------------------------------------------------------

// flat element i of the tile's rows -> its place at the padded pitch
__device__ __forceinline__ int xrt_at(int i, const XrtSoftmaxArgs& a) {
  return a.pitch == a.k ? i : i + (int)__umulhi((unsigned)i, a.kmagic);
}

__device__ __forceinline__ void xrt_cp4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void xrt_cp16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Tile `tile`'s inputs into buf by cp.async, one commit group: the margins
// 16 bytes a thread where the rows are unpadded and aligned, else 4 bytes
// a thread to each element's padded place (consecutive threads, consecutive
// elements: coalesced reads, conflict-free writes at either pitch); each
// thread its own row's row values, label and weight.
template <bool kLabels>
__device__ __forceinline__ void xrt_stage(const XrtSoftmaxArgs& a,
                                          float* buf, long long tile) {
  const long long row0 = tile * kThreads;
  const int nr = (int)min((long long)kThreads, a.n - row0);
  const int nel = nr * a.k;
  const float* g = a.margin + row0 * a.k;
  int done = 0;
  if (a.pitch == a.k && ((uintptr_t)g & 15) == 0) {
    done = nel & ~3;
    for (int i = threadIdx.x * 4; i < done; i += kThreads * 4)
      xrt_cp16(buf + i, g + i);
  }
  for (int i = done + threadIdx.x; i < nel; i += kThreads)
    xrt_cp4(buf + xrt_at(i, a), g + i);
  if (kLabels && (int)threadIdx.x < nr) {
    float* rest = buf + kThreads * a.pitch;
    const long long row = row0 + threadIdx.x;
    for (int k = 0; k < a.k; ++k)
      xrt_cp4(rest + k * kThreads + threadIdx.x,
              a.row_value + (long long)k * a.n + row);
    xrt_cp4(rest + a.k * kThreads + threadIdx.x, a.label + row);
    xrt_cp4(rest + (a.k + 1) * kThreads + threadIdx.x, a.weight + row);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// the tile's nel margins (or probabilities) out of the stage buffer
__device__ __forceinline__ void xrt_tile_out(const float* tile, float* g,
                                             int nel,
                                             const XrtSoftmaxArgs& a) {
  int done = 0;
  if (a.pitch == a.k && ((uintptr_t)g & 15) == 0) {
    done = nel & ~3;
    for (int i = threadIdx.x * 4; i < done; i += kThreads * 4)
      *reinterpret_cast<float4*>(g + i) =
          *reinterpret_cast<const float4*>(tile + i);
  }
  for (int i = done + threadIdx.x; i < nel; i += kThreads)
    g[i] = tile[xrt_at(i, a)];
}

// Persistent CTAs (a.grid of them, as many as the SMs hold) walk the tiles
// of kThreads rows in turn, the next tile's inputs in flight (cp.async,
// two stage buffers) while the current one is computed and written.
template <int KMAX, int MODE>
__global__ void __launch_bounds__(kThreads)
    xrt_softmax_rows(const XrtSoftmaxArgs a) {
  constexpr bool kLabels = MODE <= XRT_SMX_EVAL;
  extern __shared__ __align__(16) float smem[];
  const int K = a.k;
  // a stage buffer: the tile's rows at the pitch, then (training and eval)
  // the rows' K row values [K][kThreads], labels and weights
  const int stage_floats = a.shared_bytes / (2 * (int)sizeof(float));
  const long long n_tiles = (a.n + kThreads - 1) / kThreads;
  const int r = threadIdx.x;
  float acc_ll = 0.f, acc_wrong = 0.f, acc_w = 0.f;  // this thread's rows
  long long tile = blockIdx.x;
  if (tile < n_tiles) xrt_stage<kLabels>(a, smem, tile);
  for (int b = 0; tile < n_tiles; tile += gridDim.x, b ^= 1) {
    if (tile + gridDim.x < n_tiles) {
      xrt_stage<kLabels>(a, smem + (b ^ 1) * stage_floats, tile + gridDim.x);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    float* buf = smem + b * stage_floats;
    const float* rest = buf + kThreads * a.pitch;
    const long long row0 = tile * kThreads;
    const int nr = (int)min((long long)kThreads, a.n - row0);
    const bool live = r < nr;
    const long long row = row0 + r;
    float* mine = buf + r * a.pitch;
    float w = 0.f;
    int yi = 0, yk = -1;
    if (kLabels && live) {
      w = rest[(K + 1) * kThreads + r];
      yi = __float2int_rz(rest[K * kThreads + r]);  // saturated, NaN -> 0
      const int c = yi < 0 ? yi + K : yi;
      yk = c >= 0 && c < K ? c : -1;
    }

    float v[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        float x = live ? mine[k] : 0.f;
        if (kLabels && live) {
          x = __fadd_rn(x, rest[k * kThreads + r]);
          mine[k] = x;
        }
        v[k] = x;
      }
    }
    // the max, the first argmax (merror) and the label's shifted margin
    float mx = v[0], best = v[0];
    int arg = 0;
#pragma unroll
    for (int k = 1; k < KMAX; ++k) {
      if (k < K) {
        mx = xrt_max_nan(mx, v[k]);
        if (xrt_better(v[k], best)) {
          best = v[k];
          arg = k;
        }
      }
    }
    float dy = __int_as_float(0x7fc00000);  // NaN: no class
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        if (k == yk) dy = xrt_ftz(__fsub_rn(v[k], mx));
        v[k] = xrt_e(v[k], mx);
        s = __fadd_rn(s, v[k]);
      }
    }
    if (MODE == XRT_SMX_TRAIN || MODE >= XRT_SMX_PROB) {
      float pbest = 0.f;
      int parg = 0;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < K) {
          const float p = xrt_ftz(__fdiv_rn(v[k], s));
          if (MODE == XRT_SMX_TRAIN) {
            if (live)
              reinterpret_cast<float2*>(a.gh)[(long long)k * a.n + row] =
                  xrt_gh(p, k == yi, w);
          } else if (MODE == XRT_SMX_PROB) {
            mine[k] = p;
          } else if (k == 0 || xrt_better(p, pbest)) {
            pbest = p;
            parg = k;
          }
        }
      }
      if (MODE == XRT_SMX_CLASS && live) a.out[row] = (float)parg;
    }
    if (kLabels && live) {
      // mlogloss: log(s) - d_y = -log_softmax(m)[y]; merror: argmax != y
      acc_ll = __fadd_rn(acc_ll, __fmul_rn(w, __fsub_rn(logf(s), dy)));
      acc_wrong = __fadd_rn(acc_wrong, arg != yi ? w : 0.f);
      acc_w = __fadd_rn(acc_w, w);
    }
    if (MODE != XRT_SMX_CLASS) {
      __syncthreads();
      xrt_tile_out(buf, (MODE == XRT_SMX_PROB ? a.out : a.margin) + row0 * K,
                   nr * K, a);
    }
    __syncthreads();  // the buffer is free for the copy after the next
  }
  if (kLabels) xrt_partials(acc_ll, acc_wrong, acc_w, a.part);
}

// ---------------------------------------------------------------------------
// above 32 classes: a row a thread, its classes re-read
// ---------------------------------------------------------------------------

// Item j of level 1 (a window sum) joins the open level-2 window, closing
// every window it ends; part[lv] is the running sum of the open window of
// level lv + 1 (part[0] unused).
__device__ __forceinline__ void xrt_push(const XrtSoftmaxArgs& a,
                                         float (&part)[kLevels], float v,
                                         int j) {
  part[1] = __fadd_rn(part[1], v);
#pragma unroll
  for (int lv = 1; lv < kLevels - 1; ++lv) {
    if (lv >= a.top || (j + a.front[lv] + 1) % kWin != 0) break;
    part[lv + 1] = __fadd_rn(part[lv + 1], part[lv]);
    part[lv] = 0.f;
    j = (j + a.front[lv]) / kWin;
  }
}

// close what is still open after the last class and return the sum: the
// zeros the reference pads after it change no sum
__device__ __forceinline__ float xrt_total(const XrtSoftmaxArgs& a,
                                           float (&part)[kLevels], float ws) {
  part[1] = __fadd_rn(part[1], ws);
#pragma unroll
  for (int lv = 1; lv < kLevels - 1; ++lv)
    if (lv < a.top) part[lv + 1] = __fadd_rn(part[lv + 1], part[lv]);
  float s = part[1];
#pragma unroll
  for (int lv = 2; lv < kLevels; ++lv)
    if (lv == a.top) s = part[lv];
  return s;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    xrt_softmax_wide(const XrtSoftmaxArgs a) {
  const int K = a.k;
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < a.n;
  const int kk = live ? K : 0;  // classes this thread walks
  float* m = a.margin + (live ? row : 0) * K;
  float w = 0.f;
  int yi = 0, yk = -1;
  if (MODE <= XRT_SMX_EVAL && live) xrt_label(a, row, &w, &yi, &yk);

  float mx = 0.f, best = 0.f, my = 0.f;
  int arg = 0;
  for (int k = 0; k < kk; ++k) {
    float x = m[k];
    if (MODE <= XRT_SMX_EVAL) {
      x = __fadd_rn(x, a.row_value[(long long)k * a.n + row]);
      m[k] = x;
    }
    if (k == 0) {
      mx = best = x;
    } else {
      mx = xrt_max_nan(mx, x);
      if (xrt_better(x, best)) {
        best = x;
        arg = k;
      }
    }
    if (k == yk) my = x;
  }
  // the window tree's sum of e
  float part[kLevels] = {};
  float ws = 0.f;
  for (int k = 0; k < kk; ++k) {
    ws = __fadd_rn(ws, xrt_e(m[k], mx));
    if (((a.front0 + k) & (kWin - 1)) == kWin - 1) {
      xrt_push(a, part, ws, (a.front0 + k) / kWin);
      ws = 0.f;
    }
  }
  const float s = xrt_total(a, part, ws);
  if (MODE == XRT_SMX_TRAIN || MODE >= XRT_SMX_PROB) {
    float pbest = 0.f;
    int parg = 0;
    for (int k = 0; k < kk; ++k) {
      const float p = xrt_ftz(__fdiv_rn(xrt_e(m[k], mx), s));
      if (MODE == XRT_SMX_TRAIN) {
        reinterpret_cast<float2*>(a.gh)[(long long)k * a.n + row] =
            xrt_gh(p, k == yi, w);
      } else if (MODE == XRT_SMX_PROB) {
        a.out[row * K + k] = p;
      } else if (k == 0 || xrt_better(p, pbest)) {
        pbest = p;
        parg = k;
      }
    }
    if (MODE == XRT_SMX_CLASS && live) a.out[row] = (float)parg;
  }
  if (MODE <= XRT_SMX_EVAL) {
    const float dy =
        yk >= 0 ? xrt_ftz(__fsub_rn(my, mx)) : __int_as_float(0x7fc00000);
    const float ll = live ? __fmul_rn(w, __fsub_rn(logf(s), dy)) : 0.f;
    const float wrong = live && arg != yi ? w : 0.f;
    xrt_partials(ll, wrong, w, a.part);
  }
}

// ---------------------------------------------------------------------------

typedef void (*XrtSmxKernel)(const XrtSoftmaxArgs);

template <int KMAX>
static XrtSmxKernel rows_kernel(int mode) {
  switch (mode) {
    case XRT_SMX_TRAIN: return xrt_softmax_rows<KMAX, XRT_SMX_TRAIN>;
    case XRT_SMX_EVAL: return xrt_softmax_rows<KMAX, XRT_SMX_EVAL>;
    case XRT_SMX_PROB: return xrt_softmax_rows<KMAX, XRT_SMX_PROB>;
    default: return xrt_softmax_rows<KMAX, XRT_SMX_CLASS>;
  }
}

static XrtSmxKernel wide_kernel(int mode) {
  switch (mode) {
    case XRT_SMX_TRAIN: return xrt_softmax_wide<XRT_SMX_TRAIN>;
    case XRT_SMX_EVAL: return xrt_softmax_wide<XRT_SMX_EVAL>;
    case XRT_SMX_PROB: return xrt_softmax_wide<XRT_SMX_PROB>;
    default: return xrt_softmax_wide<XRT_SMX_CLASS>;
  }
}

static XrtSmxKernel pick_kernel(const XrtSoftmaxArgs* a) {
  switch (a->kmax) {
    case 4: return rows_kernel<4>(a->mode);
    case 8: return rows_kernel<8>(a->mode);
    case 16: return rows_kernel<16>(a->mode);
    case 32: return rows_kernel<32>(a->mode);
    case 0: return wide_kernel(a->mode);
    default: return nullptr;
  }
}

// the plan's shared memory holds the register path's two stage buffers
static bool smem_fits(const XrtSoftmaxArgs* a) {
  const int labels = a->mode <= XRT_SMX_EVAL ? a->k + 2 : 0;
  return (size_t)a->shared_bytes >=
         2 * sizeof(float) * (size_t)kThreads * (a->pitch + labels);
}

// The register path's persistent grid's most for these args into *ctas:
// the CTAs all SMs hold at the plan's shared memory (the wrapper sizes the
// partials by it). It also sets the kernel's opt-in shared memory to the
// device's most and its carveout to the most shared memory, for every
// later launch: the wrapper calls it once a device, K and mode
// (ops/objectives._smx_ctas). The wide path takes a CTA a tile.
extern "C" int xrt_softmax_ctas(const XrtSoftmaxArgs* a, int* ctas) {
  const XrtSmxKernel kernel = pick_kernel(a);
  if (kernel == nullptr || a->kmax == 0 || !smem_fits(a))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaFuncAttributes fa;
  cudaError_t err;
  // the most dynamic shared memory: the opt-in limit less the static
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           optin - (int)fa.sharedSizeBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
           (int)cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, a->shared_bytes)) != cudaSuccess)
    return (int)err;
  *ctas = sms * per_sm;
  return 0;
}

// One launch of the pass over a->n rows: a->grid CTAs (register path,
// from xrt_softmax_ctas, which also set the kernel's attributes) or
// ceil(n / 256) (wide path), a->part holding that many triples
// (ops/objectives.softmax_update).
extern "C" int xrt_softmax(const XrtSoftmaxArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  if (a->k < 2 || a->mode < 0 || a->mode > XRT_SMX_CLASS ||
      (a->kmax != 0 && (a->k > a->kmax || a->pitch < a->k || a->grid < 1 ||
                        !smem_fits(a))) ||
      (a->kmax == 0 && (a->top < 1 || a->top >= kLevels)))
    return (int)cudaErrorInvalidValue;
  const XrtSmxKernel kernel = pick_kernel(a);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (a->n + kThreads - 1) / kThreads;
  if (a->kmax == 0) {
    kernel<<<(unsigned)tiles, kThreads, 0, s>>>(*a);
  } else {
    kernel<<<(unsigned)min(tiles, (long long)a->grid), kThreads,
             a->shared_bytes, s>>>(*a);
  }
  return (int)cudaGetLastError();
}
