// B12 — the random draws of stochastic boosting, CUDA C++ for sm_90a:
//   B12r (xrt_sample_rows): one tree's row selection over a block of row
//     slots, uniform (subsample) or a stage of GOSS, compacted;
//   B12f (xrt_feature_mask): the colsample_bytree / _bylevel / _bynode
//     feature masks, Bernoulli or Gumbel-top-k over feature_weights.
//
// Replaces xgboost_ray_tpu/ops/sampling.py:105-227 (sample_rows) and
// xgboost_ray_tpu/ops/grow.py:132-161 (sample_feature_mask). The bits are
// JAX's threefry2x32 (xrt_threefry2x32 in common.cuh), generated from the
// key where they are needed and never stored, and the selections are
// exactly the reference's:
//   * B12r selects the k slots of the largest keys, ties to the lower slot
//     (lax.top_k's set): every key above the k-th largest, then as many of
//     the keys equal to it as are missing, in slot order. It writes the
//     selected slots in slot order (not top_k's order: on the card K1 sums
//     in int64 fixed point, where the order of the rows changes no sum)
//     and their gradients as the reference scales them.
//   * B12f's Gumbel-top-k keeps a feature where fewer than k scores exceed
//     its own (the reference's score >= k-th score), at a finite weight,
//     and the first maximum (argmax's) in any case; the Bernoulli mask
//     keeps u < rate and its first kept feature (feature 0 where none is).
//
// Keys. Uniform: the top 23 bits of the random bits (the uniform float is
// (bits >> 9) * 2^-23, so the order is theirs). GOSS's top stage: the
// order-preserving unsigned image of the f32 score |g| sqrt(max(h, 0))
// (-inf on padding slots). GOSS's sampled stage: (bits >> 9) + 1 on the
// real rows the top stage did not take, 0 elsewhere (the reference's -1).
//
// Design of B12r: one cooperative launch of a persistent grid (every CTA
// resident; a grid barrier of its own between phases). A radix select on
// the key, 12 bits a pass from the top (two passes for the 24-bit keys,
// three for the score's 32 bits): each pass regenerates the keys, counts
// the digits of those under the prefix found so far in a shared 4,096-bin
// histogram, adds it into a global one, and after the barrier every CTA
// reads the merged histogram and finds the digit holding the k-th key. Then
// the compaction: each CTA counts the keys above the threshold and equal
// to it in its contiguous slice of slots; after a barrier each CTA takes
// the counts of the slices before it and writes its selected slots, a tile
// of 256 at a time, at their ranks (block scans). What bounds it: the
// threefry rounds (about a hundred integer operations a key), four to five
// generations of every key; the bytes (the top stage reads 8 B of
// gradients a slot each pass) are far below them.
//
// B12f: a CTA a mask row, the row's features strided over its threads,
// the Gumbel scores in shared memory and each one's count of greater
// scores by a pass over them (O(F^2 / 256) a thread: F is a few hundred at
// most in practice; a first design).
#include "common.cuh"

constexpr int kThreads = XRT_THREADS;  // 256: xrt_block_excl_scan's CTA
constexpr int kBins = 4096;            // 12-bit digits
constexpr int kWorkFixed = 3 * kBins + 8;  // ops/sampling._WORK_FIXED
constexpr int kBar = 3 * kBins;            // barrier: count, generation
constexpr int kPool = 3 * kBins + 2;       // eligible slots (sampled stage)

enum { XRT_SAMPLE_UNIFORM = 0, XRT_SAMPLE_TOP = 1, XRT_SAMPLE_RAND = 2 };

// Mirrors ops/_build.SampleArgs field by field: edit both together.
struct XrtSampleArgs {
  const float* gh;   // [n_valid, 2]: the block's real rows (null if none)
  uint8_t* taken;    // [n_slots]: the top stage writes it, the sampled reads
  int* rows;         // [k] out: row_offset + slot
  float* gh_sel;     // [k, 2] out
  unsigned* work;    // kWorkFixed + 2 grid words (ops/sampling)
  long long n_slots;
  long long n_valid;
  long long k;
  long long row_offset;
  unsigned key0;
  unsigned key1;
  int mode;
  int grid;
};

// |g| sqrt(max(h, 0)) as ops/sampling.goss_score (operands and result
// flushed, the sqrt correctly rounded)
__device__ __forceinline__ float xrt_goss_score(float2 v) {
  const float g = fabsf(xrt_ftz(v.x));
  const float h = fmaxf(xrt_ftz(v.y), 0.0f);
  return xrt_ftz(__fmul_rn(g, __fsqrt_rn(h)));
}

// slot i's key under MODE; *real: a real row (i < n_valid); *ok: the
// reference's multiplier of its gradients is 1 (else 0)
template <int MODE>
__device__ __forceinline__ uint32_t xrt_sample_key(const XrtSampleArgs& a,
                                                   long long i, float2* gh,
                                                   bool* ok) {
  const bool real = i < a.n_valid;
  *gh = real ? __ldg(reinterpret_cast<const float2*>(a.gh) + i)
             : make_float2(0.0f, 0.0f);
  if (MODE == XRT_SAMPLE_TOP) {
    if (!real) {
      *ok = false;
      return 0x007FFFFFu;  // -inf
    }
    const float s = xrt_goss_score(*gh);
    *ok = isfinite(s);
    const uint32_t b = __float_as_uint(s);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  const uint32_t bits = xrt_random_bits(a.key0, a.key1,
                                        (unsigned long long)i);
  if (MODE == XRT_SAMPLE_UNIFORM) {
    *ok = real;
    return bits & 0xFFFFFE00u;
  }
  const bool elig = real && a.taken[i] == 0;
  *ok = elig;
  return elig ? (((bits >> 9) + 1u) << 8) : 0u;
}

// After a pass's histogram is merged: the digit of the kk-th largest key
// under the prefix (every CTA computes the same). Thread t holds the bins
// of group 255 - t, so the exclusive scan counts the keys in the groups
// above its own.
__device__ __forceinline__ void xrt_select_digit(const unsigned* hist,
                                                 int nbins, long long* kk,
                                                 int* digit) {
  __shared__ int s_digit;
  __shared__ long long s_above;
  const int per = nbins / kThreads;
  const int grp = kThreads - 1 - threadIdx.x;
  int s = 0;
  for (int j = 0; j < per; ++j) s += (int)__ldcg(hist + grp * per + j);
  int total;
  const int above = xrt_block_excl_scan(s, &total);
  if (above < *kk && *kk <= (long long)above + s) {
    long long c = above;
    for (int b = grp * per + per - 1; b >= grp * per; --b) {
      const unsigned h = __ldcg(hist + b);
      if (c + h >= *kk) {
        s_digit = b;
        s_above = c;
        break;
      }
      c += h;
    }
  }
  __syncthreads();
  *digit = s_digit;
  *kk -= s_above;
  __syncthreads();
}

// the sum over the CTA of one long long a thread (every thread gets it)
__device__ __forceinline__ long long xrt_block_sum(long long v) {
  __shared__ long long part[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  long long t = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += part[w];
  __syncthreads();
  return t;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    xrt_sample_rows_kernel(const XrtSampleArgs a) {
  __shared__ unsigned sh[kBins];
  unsigned* work = a.work;
  unsigned* bar = work + kBar;
  const long long n = a.n_slots;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long w = first; w < kWorkFixed; w += stride)
    if (w < kBar || w >= kBar + 2) work[w] = 0u;
  xrt_grid_sync(bar);

  // the radix select: prefix / pmask of the k-th largest key, and kk, the
  // keys equal to it that the selection takes
  const int passes = MODE == XRT_SAMPLE_TOP ? 3 : 2;
  uint32_t prefix = 0u, pmask = 0u;
  long long kk = a.k;
  for (int p = 0; p < passes; ++p) {
    const int shift = p == 0 ? 20 : (p == 1 ? 8 : 0);
    const int nbins = p < 2 ? kBins : 256;
    for (int b = threadIdx.x; b < nbins; b += kThreads) sh[b] = 0u;
    __syncthreads();
    long long elig = 0;
    for (long long i = first; i < n; i += stride) {
      float2 gh;
      bool ok;
      const uint32_t key = xrt_sample_key<MODE>(a, i, &gh, &ok);
      if (MODE == XRT_SAMPLE_RAND && p == 0) elig += ok ? 1 : 0;
      if ((key & pmask) == prefix)
        atomicAdd(&sh[(key >> shift) & (nbins - 1)], 1u);
    }
    if (MODE == XRT_SAMPLE_RAND && p == 0) {
      const long long e = xrt_block_sum(elig);
      if (threadIdx.x == 0 && e) atomicAdd(work + kPool, (unsigned)e);
    }
    __syncthreads();
    unsigned* hist = work + p * kBins;
    for (int b = threadIdx.x; b < nbins; b += kThreads)
      if (sh[b]) atomicAdd(hist + b, sh[b]);
    xrt_grid_sync(bar);
    int digit;
    xrt_select_digit(hist, nbins, &kk, &digit);
    prefix |= (uint32_t)digit << shift;
    pmask |= (uint32_t)(nbins - 1) << shift;
  }
  const uint32_t thr = prefix;  // the k-th largest key (low bits are 0)
  const long long need = kk;    // the keys equal to it that are taken
  float amp = 0.0f;
  if (MODE == XRT_SAMPLE_RAND) {
    const float pool = (float)__ldcg(work + kPool);
    amp = pool > 0.0f ? __fdiv_rn(pool, fminf(pool, (float)a.k)) : 0.0f;
  }

  // compaction: this CTA's contiguous tiles of 256 slots
  const long long tiles = (n + kThreads - 1) / kThreads;
  const long long per_cta = (tiles + gridDim.x - 1) / gridDim.x;
  const long long t0 = (long long)blockIdx.x * per_cta;
  const long long t1 = min(tiles, t0 + per_cta);
  long long gt = 0, eq = 0;
  for (long long t = t0; t < t1; ++t) {
    const long long i = t * kThreads + threadIdx.x;
    if (i < n) {
      float2 gh;
      bool ok;
      const uint32_t key = xrt_sample_key<MODE>(a, i, &gh, &ok);
      gt += key > thr ? 1 : 0;
      eq += key == thr ? 1 : 0;
    }
  }
  gt = xrt_block_sum(gt);
  eq = xrt_block_sum(eq);
  unsigned* cta_gt = work + kWorkFixed;
  unsigned* cta_eq = cta_gt + a.grid;
  if (threadIdx.x == 0) {
    cta_gt[blockIdx.x] = (unsigned)gt;
    cta_eq[blockIdx.x] = (unsigned)eq;
  }
  xrt_grid_sync(bar);
  long long base_gt = 0, base_eq = 0;
  for (int c = threadIdx.x; c < (int)blockIdx.x; c += kThreads) {
    base_gt += __ldcg(cta_gt + c);
    base_eq += __ldcg(cta_eq + c);
  }
  base_gt = xrt_block_sum(base_gt);
  base_eq = xrt_block_sum(base_eq);
  for (long long t = t0; t < t1; ++t) {
    const long long i = t * kThreads + threadIdx.x;
    float2 gh = make_float2(0.0f, 0.0f);
    bool ok = false;
    uint32_t key = 0u;
    if (i < n) key = xrt_sample_key<MODE>(a, i, &gh, &ok);
    const int g = i < n && key > thr ? 1 : 0;
    const int e = i < n && key == thr ? 1 : 0;
    int tot;
    const int ex = xrt_block_excl_scan(g | (e << 16), &tot);
    const long long rank_eq = base_eq + (ex >> 16);
    const bool take = g || (e && rank_eq < need);
    if (take) {
      const long long pos = base_gt + (ex & 0xFFFF) + min(rank_eq, need);
      const float m = ok ? 1.0f : 0.0f;
      float2 o;
      if (MODE == XRT_SAMPLE_RAND) {
        o.x = __fmul_rn(__fmul_rn(gh.x, amp), m);
        o.y = __fmul_rn(__fmul_rn(gh.y, amp), m);
      } else {
        o.x = __fmul_rn(gh.x, m);
        o.y = __fmul_rn(gh.y, m);
      }
      a.rows[pos] = (int)(a.row_offset + i);
      reinterpret_cast<float2*>(a.gh_sel)[pos] = o;
    }
    if (MODE == XRT_SAMPLE_TOP && i < n) a.taken[i] = take ? 1 : 0;
    base_gt += tot & 0xFFFF;
    base_eq += tot >> 16;
  }
}

typedef void (*XrtSampleKernel)(const XrtSampleArgs);

static XrtSampleKernel sample_kernel(int mode) {
  switch (mode) {
    case XRT_SAMPLE_UNIFORM: return xrt_sample_rows_kernel<XRT_SAMPLE_UNIFORM>;
    case XRT_SAMPLE_TOP: return xrt_sample_rows_kernel<XRT_SAMPLE_TOP>;
    case XRT_SAMPLE_RAND: return xrt_sample_rows_kernel<XRT_SAMPLE_RAND>;
    default: return nullptr;
  }
}

// The cooperative grid of B12r on the current device: as many CTAs as
// every mode's kernel keeps resident at once.
extern "C" int xrt_sample_ctas(int* grid) {
  int dev = 0, sms = 0, fewest = 1 << 30;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int mode = 0; mode < 3 && err == cudaSuccess; ++mode) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sample_kernel(mode), kThreads, 0);
    fewest = min(fewest, per_sm);
  }
  if (err != cudaSuccess) return (int)err;
  *grid = fewest * sms;
  return 0;
}

// One stage's selection of a->k of a->n_slots slots (1 <= k <= n_slots).
extern "C" int xrt_sample_rows(const XrtSampleArgs* a, void* stream) {
  if (a->mode < XRT_SAMPLE_UNIFORM || a->mode > XRT_SAMPLE_RAND ||
      a->k < 1 || a->k > a->n_slots || a->n_valid < 0 ||
      a->n_valid > a->n_slots || a->grid < 1 || a->rows == nullptr ||
      a->gh_sel == nullptr || a->work == nullptr ||
      (a->n_valid > 0 && a->gh == nullptr) ||
      (a->mode != XRT_SAMPLE_UNIFORM && a->taken == nullptr))
    return (int)cudaErrorInvalidValue;
  XrtSampleArgs args = *a;
  void* params[] = {&args};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)sample_kernel(a->mode), dim3(a->grid), dim3(kThreads),
      params, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B12f
// ---------------------------------------------------------------------------

// Mirrors ops/_build.MaskArgs field by field: edit both together.
struct XrtMaskArgs {
  const float* log_fw;  // [F] log(feature_weights) (-inf at 0), or null
  const uint8_t* base;  // [F] mask ANDed into every row, or null
  uint8_t* out;         // [rows, F]
  int rows;
  int n_features;
  int k;                // Gumbel-top-k's k
  float rate;           // the Bernoulli rate (float32)
  unsigned key0;
  unsigned key1;
};

// (value, index) of the first maximum, over the CTA
__device__ __forceinline__ int xrt_block_first_max(float v, int idx) {
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
  if ((threadIdx.x & 31) == 0) {
    sv[threadIdx.x >> 5] = v;
    si[threadIdx.x >> 5] = idx;
  }
  __syncthreads();
  float bv = sv[0];
  int bi = si[0];
  for (int w = 1; w < kThreads / 32; ++w) {
    if (sv[w] > bv || (sv[w] == bv && si[w] < bi)) {
      bv = sv[w];
      bi = si[w];
    }
  }
  __syncthreads();
  return bi;
}

__global__ void __launch_bounds__(kThreads)
    xrt_feature_mask_kernel(const XrtMaskArgs a) {
  extern __shared__ float score[];  // [F] (Gumbel only)
  __shared__ int s_first;
  const int F = a.n_features;
  const long long row0 = (long long)blockIdx.x * F;
  const bool gumbel = a.log_fw != nullptr;
  if (threadIdx.x == 0) s_first = F;
  __syncthreads();
  float best = -INFINITY;
  int best_i = 0x7fffffff;
  for (int f = threadIdx.x; f < F; f += kThreads) {
    const float u = xrt_bits_to_unit(
        xrt_random_bits(a.key0, a.key1, (unsigned long long)(row0 + f)));
    if (gumbel) {
      // jax.random.uniform(minval=tiny, maxval=1): u * 1 + tiny, then at
      // least tiny; the Gumbel variate -log(-log(u)) with XLA's log
      const float ut = fmaxf(kXrtTiny, __fadd_rn(u, kXrtTiny));
      const float g = -xrt_log_f32(-xrt_log_f32(ut));
      const float s = __fadd_rn(__ldg(a.log_fw + f), g);
      score[f] = s;
      if (s > best || (s == best && f < best_i)) {
        best = s;
        best_i = f;
      }
    } else if (u < a.rate) {
      atomicMin(&s_first, f);
    }
  }
  int guard;
  if (gumbel) {
    guard = xrt_block_first_max(best, best_i);
    if (guard == 0x7fffffff) guard = 0;
  } else {
    __syncthreads();
    guard = s_first < F ? s_first : 0;
  }
  for (int f = threadIdx.x; f < F; f += kThreads) {
    bool keep;
    if (gumbel) {
      const float s = score[f];
      int greater = 0;
      for (int j = 0; j < F; ++j) greater += score[j] > s ? 1 : 0;
      keep = greater < a.k && isfinite(__ldg(a.log_fw + f));
    } else {
      const float u = xrt_bits_to_unit(
          xrt_random_bits(a.key0, a.key1, (unsigned long long)(row0 + f)));
      keep = u < a.rate;
    }
    keep = keep || f == guard;
    if (a.base != nullptr) keep = keep && __ldg(a.base + f) != 0;
    a.out[row0 + f] = keep ? 1 : 0;
  }
}

// a->rows mask rows of a->n_features features in one launch (a CTA a row)
extern "C" int xrt_feature_mask(const XrtMaskArgs* a, void* stream) {
  if (a->rows < 1 || a->n_features < 1 || a->out == nullptr ||
      (a->log_fw != nullptr && (a->k < 1 || a->k > a->n_features)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = a->log_fw != nullptr ? sizeof(float) * a->n_features : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        xrt_feature_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  xrt_feature_mask_kernel<<<a->rows, kThreads, smem, (cudaStream_t)stream>>>(
      *a);
  return (int)cudaGetLastError();
}
