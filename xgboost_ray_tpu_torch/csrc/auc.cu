// B9a, the binned AUC histogram, CUDA C++ for sm_90a.
//
// Replaces xgboost_ray_tpu/ops/metrics.py:147-157 (auc_hist): over one
// set's updated margins, a [2, 4096] (positive, negative) weight histogram
// of the bins clip(int(sigmoid(score) * 4096), 0, 4095), from which the
// host reads auc and aucpr (ops/metrics.auc_from_hist / aucpr_from_hist,
// after the round's one metric all-reduce). One launch a set a round.
//
// The sigmoid is ops/objectives.sigmoid (Cephes' exp with every
// multiply-add fused, __fmaf_rn; 1 / (1 + e) correctly rounded; a
// subnormal result flushed), so the bins are the JAX package's bit for
// bit; NaN scores fall in bin 0, as XLA casts NaN to 0. A label above 0.5
// counts positive, one at or below it negative, NaN neither.
//
// Sums are int64 fixed point: each row adds rint(w * scale) (scale a power
// of two, ops/metrics.auc_scale: the set's largest |weight| times its
// global row count times it stays at or below 2^52), so a bin's sum is an
// integer that no order of additions changes: bitwise from rerun to rerun
// and between 1 and 2 ranks (the merged sums are exact in float64). A
// float atomic would not be. Each CTA sums into a private [2][4096] int64
// histogram in shared memory (64 KB; two CTAs an SM fit the card's 227 KB),
// then adds its nonzero bins into the output with 64-bit global atomics.
//
// What bounds it on an H100: bytes. Each row reads its score, label and
// weight (12 B), and the kernel writes the 64 KB histogram: at 11M rows
// 132 MB, 39.4 us at 3.35 TB/s; at 500,000 rows 6 MB, 1.81 us. The sigmoid
// is a dozen FMAs a row; the shared atomics on a 64-bit word are a
// compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN.64), and scores that
// crowd into few bins serialise on them: a simple kernel, right first.

#include "common.cuh"

constexpr int kThreads = 512;
constexpr int kCtasPerSm = 2;  // ops/metrics.AUC_CTAS_PER_SM
constexpr int kBins = 4096;    // ops/metrics.AUC_BINS
constexpr int kSmemBytes = 2 * kBins * 8;

// Mirrors ops/_build.AucArgs field by field: edit both together.
struct XrtAucArgs {
  const float* score;   // [n] with row stride `stride`
  const float* label;   // [n]
  const float* weight;  // [n]
  long long* hist;      // [2, kBins], zero before the launch
  long long n;
  double scale;         // ops/metrics.auc_scale
  int stride;
  int grid;
};

constexpr float kTiny = 1.17549435e-38f;

// ops/metrics.auc_bins of one score.
__device__ __forceinline__ int xrt_auc_bin(float s) {
  float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, xrt_exp_f32(-s)));
  p = p < kTiny ? 0.0f : p;
  const float b = __fmul_rn(p, (float)kBins);
  if (b != b) return 0;
  return min(max((int)b, 0), kBins - 1);
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    xrt_auc_kernel(const XrtAucArgs a) {
  extern __shared__ unsigned long long sh[];  // [2][kBins]
  for (int i = threadIdx.x; i < 2 * kBins; i += kThreads) sh[i] = 0ull;
  __syncthreads();
  const long long step = (long long)gridDim.x * kThreads;
  for (long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
       row < a.n; row += step) {
    const float y = __ldg(a.label + row);
    const bool pos = y > 0.5f, neg = y <= 0.5f;
    if (!pos && !neg) continue;  // NaN label
    const long long q = __double2ll_rn((double)__ldg(a.weight + row) * a.scale);
    if (q == 0) continue;
    const int b = xrt_auc_bin(__ldg(a.score + row * a.stride));
    atomicAdd(sh + (neg ? kBins : 0) + b, (unsigned long long)q);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * kBins; i += kThreads) {
    const unsigned long long v = sh[i];
    if (v != 0ull)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.hist) + i, v);
  }
}

// One B9a launch on `stream`: a->grid CTAs over a->n rows into a->hist
// (which the caller zeroes). Sets the kernel's shared-memory attribute on
// its first call on each device.
extern "C" int xrt_auc_hist(const XrtAucArgs* a, void* stream) {
  if (a->n < 0 || a->grid < 1 || a->stride < 1 || a->hist == nullptr ||
      (a->n > 0 && (a->score == nullptr || a->label == nullptr ||
                    a->weight == nullptr)))
    return (int)cudaErrorInvalidValue;
  static bool attr[64] = {};  // per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64 || !attr[dev]) {
    e = cudaFuncSetAttribute(xrt_auc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 0 && dev < 64) attr[dev] = true;
  }
  xrt_auc_kernel<<<(unsigned)a->grid, kThreads, kSmemBytes,
                   (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
