// B10 and B11 — quantized gradients at the source and the quantized
// histogram wire, CUDA C++ for sm_90a.
//
// B10 (xrt_quantize_gh) replaces the reference's quantize_gh
// (xgboost_ray_tpu/ops/objectives.py:316-381): one pass over a device
// block's rows of (g, h) f32 writes int8 or int16
//   q = clip(floor(x / s + u), -qmax, qmax),
// u the jax.random.uniform draw of flat element 2 r + c of the block's
// [slots, 2] (threefry2x32 of the tree's key folded with SALT_SR and the
// block: xrt_random_bits, xrt_bits_to_unit of common.cuh), s the channel's
// scale (computed once by the caller). IEEE division (__fdiv_rn), no fast
// math; operands and results flushed to zero as XLA's CPU program flushes
// them, so the kernel and ops/objectives.quantize_gh_plain agree bit for bit.
//
// B11 replaces the reference's quantized_hist_allreduce and
// _block_scaled_allreduce (xgboost_ray_tpu/ops/histogram.py:188-385), their
// arithmetic between the collectives:
//   * xrt_wire_quant (B11q): for each group of `group` values of a segment
//     of `length` (the last group ragged), its absmax (or a given one), the
//     scale amax * f32(1 / qmax) (1 where 0; XLA folds the constant
//     divisor), and rintf(x / scale) clipped to +-qmax as int8 or int16,
//     the scale's four bytes after the segment's values where the payload
//     carries them in-band, else into a separate f32 array;
//   * xrt_wire_acc (B11acc): the row mode's int32 sum of the n received
//     narrow pieces of a row times the row's scale, or a ring hop's
//     fma(f32(q), scale, x) (XLA's CPU program contracts the dequantize
//     and the add into one fused multiply-add);
//   * xrt_wire_deq (B11deq): f32(q) * scale of a payload.
// The histogram's groups are rows of n_nodes * F (2 * nbt values) or blocks
// of the flat histogram (64 to 2^20 values), so B11q takes one CTA a group;
// the other two are elementwise.
#include "common.cuh"

#define XRT_QUANT_THREADS 256

// x flushed to a zero of its sign where subnormal (XLA's CPU FTZ)
__device__ __forceinline__ float xrt_q_ftz(float x) {
  return fabsf(x) < 1.17549435e-38f ? x * 0.0f : x;
}

__device__ __forceinline__ void xrt_store_narrow(void* base, int itemsize,
                                                 long long i, int v) {
  if (itemsize == 1)
    ((int8_t*)base)[i] = (int8_t)v;
  else
    ((int16_t*)base)[i] = (int16_t)v;
}

__device__ __forceinline__ int xrt_load_narrow(const void* base, int itemsize,
                                               long long i) {
  return itemsize == 1 ? (int)((const int8_t*)base)[i]
                       : (int)((const int16_t*)base)[i];
}

// the f32 whose bytes start at narrow element i (in-band scale words)
__device__ __forceinline__ float xrt_load_scale(const void* base,
                                                int itemsize, long long i) {
  const uint8_t* p = (const uint8_t*)base + i * itemsize;
  const uint32_t w = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                     ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
  return __uint_as_float(w);
}

__device__ __forceinline__ void xrt_store_scale(void* base, int itemsize,
                                                long long i, float s) {
  uint8_t* p = (uint8_t*)base + i * itemsize;
  const uint32_t w = __float_as_uint(s);
  p[0] = (uint8_t)w;
  p[1] = (uint8_t)(w >> 8);
  p[2] = (uint8_t)(w >> 16);
  p[3] = (uint8_t)(w >> 24);
}

// ---------------------------------------------------------------------------
// B10
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(XRT_QUANT_THREADS)
xrt_quantize_gh_kernel(const float* __restrict__ gh, void* __restrict__ out,
                       long long n_values, int itemsize,
                       const float* __restrict__ scale, int qmax,
                       uint32_t k0, uint32_t k1) {
  const float s0 = scale[0], s1 = scale[1];
  const float lim = (float)qmax;
  for (long long i = blockIdx.x * (long long)XRT_QUANT_THREADS + threadIdx.x;
       i < n_values; i += (long long)gridDim.x * XRT_QUANT_THREADS) {
    const float u = xrt_bits_to_unit(xrt_random_bits(k0, k1, i));
    const float x =
        xrt_q_ftz(__fdiv_rn(xrt_q_ftz(__ldg(gh + i)), (i & 1) ? s1 : s0));
    const float v = fminf(fmaxf(floorf(xrt_q_ftz(__fadd_rn(x, u))), -lim),
                          lim);
    xrt_store_narrow(out, itemsize, i, (int)v);
  }
}

// gh [n, 2] f32 -> out [n, 2] int8 (itemsize 1) or int16 (2); scale [2]
// f32 on the device; (k0, k1) the block's key.
extern "C" int xrt_quantize_gh(const float* gh, void* out, long long n,
                               int itemsize, const float* scale, int qmax,
                               unsigned k0, unsigned k1, void* stream) {
  if (n <= 0) return 0;
  if (itemsize != 1 && itemsize != 2) return (int)cudaErrorInvalidValue;
  const long long values = 2 * n;
  const int grid = (int)min((values + XRT_QUANT_THREADS - 1) /
                                XRT_QUANT_THREADS,
                            (long long)65536);
  xrt_quantize_gh_kernel<<<grid, XRT_QUANT_THREADS, 0,
                           (cudaStream_t)stream>>>(
      gh, out, values, itemsize, scale, qmax, k0, k1);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B11q: one CTA a group
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(XRT_QUANT_THREADS)
xrt_wire_quant_kernel(const float* __restrict__ x, int length, int group,
                      int groups, const float* __restrict__ amax_in,
                      float* __restrict__ amax_out, void* __restrict__ q,
                      int itemsize, long long pitch,
                      float* __restrict__ scale_out, int qmax, float rq) {
  __shared__ float s_red[XRT_QUANT_THREADS / 32];
  __shared__ float s_scale;
  const long long gid = blockIdx.x;
  const long long seg = gid / groups;
  const int j = (int)(gid - seg * groups);
  const int a = j * group;
  const int len = min(group, length - a);
  const float* xs = x + seg * (long long)length + a;
  float amax;
  if (amax_in != nullptr) {
    amax = amax_in[gid];
  } else {
    float m = 0.0f;
    for (int i = threadIdx.x; i < len; i += XRT_QUANT_THREADS)
      m = fmaxf(m, fabsf(__ldg(xs + i)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = s_red[0];
      for (int w = 1; w < XRT_QUANT_THREADS / 32; ++w) t = fmaxf(t, s_red[w]);
      s_red[0] = t;
    }
    __syncthreads();
    amax = s_red[0];
  }
  if (amax_out != nullptr) {
    if (threadIdx.x == 0) amax_out[gid] = amax;
    return;
  }
  if (threadIdx.x == 0)
    s_scale = amax > 0.0f ? xrt_q_ftz(__fmul_rn(amax, rq)) : 1.0f;
  __syncthreads();
  const float sc = s_scale;
  const float lim = (float)qmax;
  const long long base = seg * pitch + a;
  for (int i = threadIdx.x; i < len; i += XRT_QUANT_THREADS) {
    const float v = rintf(xrt_q_ftz(__fdiv_rn(__ldg(xs + i), sc)));
    xrt_store_narrow(q, itemsize, base + i, (int)fminf(fmaxf(v, -lim), lim));
  }
  if (threadIdx.x == 0) {
    if (scale_out != nullptr)
      scale_out[gid] = sc;
    else  // in-band: the scale's bytes after the segment's values
      xrt_store_scale(q, itemsize, seg * pitch + length + j * (4 / itemsize),
                      sc);
  }
}

// x [n_seg, length] f32; groups of `group` values a segment (the last
// ragged). amax_in [n_seg * groups] or null (computed). With amax_out only
// the absmax is written. Else q [n_seg, pitch] narrow (itemsize 1 or 2):
// pitch == length with scale_out [n_seg * groups] f32, or in-band pitch ==
// length + groups * 4 / itemsize with scale_out null.
extern "C" int xrt_wire_quant(const float* x, long long n_seg, int length,
                              int group, const float* amax_in,
                              float* amax_out, void* q, int itemsize,
                              long long pitch, float* scale_out, int qmax,
                              float rq, void* stream) {
  if (length <= 0 || group <= 0) return (int)cudaErrorInvalidValue;
  const int groups = (length + group - 1) / group;
  const long long n = n_seg * groups;
  if (n <= 0) return 0;
  if (amax_out == nullptr &&
      ((itemsize != 1 && itemsize != 2) || q == nullptr ||
       pitch != (scale_out != nullptr
                     ? (long long)length
                     : (long long)length + groups * (4 / itemsize))))
    return (int)cudaErrorInvalidValue;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  xrt_wire_quant_kernel<<<(unsigned)n, XRT_QUANT_THREADS, 0,
                          (cudaStream_t)stream>>>(
      x, length, group, groups, amax_in, amax_out, q, itemsize, pitch,
      scale_out, qmax, rq);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B11acc and B11deq: elementwise
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(XRT_QUANT_THREADS)
xrt_wire_acc_rows_kernel(const void* __restrict__ q, int itemsize, int n_src,
                         long long rows, int length,
                         const float* __restrict__ scale,
                         float* __restrict__ out) {
  const long long total = rows * length;
  for (long long i = blockIdx.x * (long long)XRT_QUANT_THREADS + threadIdx.x;
       i < total; i += (long long)gridDim.x * XRT_QUANT_THREADS) {
    int acc = 0;
    for (int s = 0; s < n_src; ++s)
      acc += xrt_load_narrow(q, itemsize, s * total + i);
    out[i] = xrt_q_ftz(__fmul_rn(__int2float_rn(acc), scale[i / length]));
  }
}

__global__ void __launch_bounds__(XRT_QUANT_THREADS)
xrt_wire_acc_block_kernel(const void* __restrict__ q, int itemsize,
                          int length, int group,
                          const float* __restrict__ x,
                          float* __restrict__ out) {
  const int words = 4 / itemsize;
  for (long long i = blockIdx.x * (long long)XRT_QUANT_THREADS + threadIdx.x;
       i < length; i += (long long)gridDim.x * XRT_QUANT_THREADS) {
    const float sc =
        xrt_load_scale(q, itemsize, length + (i / group) * words);
    const float v = __int2float_rn(xrt_load_narrow(q, itemsize, i));
    out[i] = xrt_q_ftz(__fmaf_rn(v, sc, xrt_q_ftz(__ldg(x + i))));
  }
}

// Row mode (n_src > 0): q [n_src, rows, length] narrow, scale_or_x the rows'
// scales [rows]; out [rows, length] = f32(sum over n_src) * scale. Block
// mode (n_src == 0): q an in-band payload [length + groups * 4 / itemsize],
// scale_or_x the local values [length]; out [length] = fma(f32(q), scale,
// x).
extern "C" int xrt_wire_acc(const void* q, int itemsize, int n_src,
                            long long rows, int length, int group,
                            const float* scale_or_x, float* out,
                            void* stream) {
  if (itemsize != 1 && itemsize != 2) return (int)cudaErrorInvalidValue;
  const long long total = n_src > 0 ? rows * length : (long long)length;
  if (total <= 0) return 0;
  const int grid = (int)min((total + XRT_QUANT_THREADS - 1) /
                                XRT_QUANT_THREADS,
                            (long long)65536);
  cudaStream_t s = (cudaStream_t)stream;
  if (n_src > 0) {
    xrt_wire_acc_rows_kernel<<<grid, XRT_QUANT_THREADS, 0, s>>>(
        q, itemsize, n_src, rows, length, scale_or_x, out);
  } else {
    if (group <= 0) return (int)cudaErrorInvalidValue;
    xrt_wire_acc_block_kernel<<<grid, XRT_QUANT_THREADS, 0, s>>>(
        q, itemsize, length, group, scale_or_x, out);
  }
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(XRT_QUANT_THREADS)
xrt_wire_deq_kernel(const void* __restrict__ q, int itemsize,
                    long long pitch, long long n_seg, int length, int group,
                    const float* __restrict__ scale,
                    float* __restrict__ out) {
  const int groups = (length + group - 1) / group;
  const int words = 4 / itemsize;
  const long long total = n_seg * length;
  for (long long i = blockIdx.x * (long long)XRT_QUANT_THREADS + threadIdx.x;
       i < total; i += (long long)gridDim.x * XRT_QUANT_THREADS) {
    const long long seg = i / length;
    const int e = (int)(i - seg * length);
    const int j = e / group;
    const float sc = scale != nullptr
                         ? scale[seg * groups + j]
                         : xrt_load_scale(q, itemsize,
                                          seg * pitch + length + j * words);
    const float v = __int2float_rn(xrt_load_narrow(q, itemsize,
                                                   seg * pitch + e));
    out[i] = xrt_q_ftz(__fmul_rn(v, sc));
  }
}

// q [n_seg, pitch] narrow: pitch == length with scale [n_seg * groups] f32,
// or an in-band payload (pitch == length + groups * 4 / itemsize, scale
// null); out [n_seg, length] f32.
extern "C" int xrt_wire_deq(const void* q, int itemsize, long long pitch,
                            long long n_seg, int length, int group,
                            const float* scale, float* out, void* stream) {
  if ((itemsize != 1 && itemsize != 2) || length <= 0 || group <= 0)
    return (int)cudaErrorInvalidValue;
  const long long total = n_seg * length;
  if (total <= 0) return 0;
  const int grid = (int)min((total + XRT_QUANT_THREADS - 1) /
                                XRT_QUANT_THREADS,
                            (long long)65536);
  xrt_wire_deq_kernel<<<grid, XRT_QUANT_THREADS, 0, (cudaStream_t)stream>>>(
      q, itemsize, pitch, n_seg, length, group, scale, out);
  return (int)cudaGetLastError();
}
