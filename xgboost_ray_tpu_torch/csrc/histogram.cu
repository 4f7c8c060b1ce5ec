// K1 — per-level gradient histogram build (+ node totals), CUDA C++ for sm_90a.
//
// Replaces the JAX package's histogram providers (xgboost_ray_tpu/ops/
// histogram.py: hist_scatter, hist_onehot, hist_partition_presorted /
// _blocked_hist, node_sums) and the deleted Pallas kernel hist_pallas_blocks
// (46abde5^:xgboost_ray_tpu/ops/hist_pallas.py:70, pallas_call at :105).
// Like that kernel it keeps the per-node accumulator out of device memory;
// unlike it, it does not contract a one-hot against gh on a matrix unit:
// on Hopper the histogram is a scatter-accumulate.
//
// Input rows arrive node-sorted: `rows[seg[k] .. seg[k+1])` are the rows of
// node k (the partition order of K3, or K3's compacted smaller-child list
// under sibling subtraction). Each CTA takes one contiguous slice of that
// list (the slice size is read on the device from seg[n_nodes], so no host
// sync is needed) and one tile of features, accumulates (g, h) into a
// shared-memory histogram and, at every node boundary inside its slice and
// at its end, flushes the non-zero cells to the global histogram.
//
// Fixed point. Every sum is an int64 sum of per-row quantised values:
// g becomes llrint(g * 2^eg) and h llrint(h * 2^eh) (__float2ll_rn of an
// exact product), with eg and eh chosen once per round so that
// n_global * (max|v| * 2^e + 1) < 2^62 (ops/histogram.quant_scales); the
// exponents stay on the device and are read through `qscale` =
// (2^eg, 2^eh, 2^-eg, 2^-eh). Integer adds are associative, so the atomics
// give the same bits in any order, the same sums come out of any shard
// layout, and an integer all-reduce of them is exact: the histogram K2
// reads is bitwise the same from run to run and at every world size.
// xrt_hist_dequant turns the merged sums into f32 (float(sum) * 2^-e:
// round to nearest, then an exact power-of-two scale).
//
// What bounds it: the bins gather (N x F x sizeof(bin) bytes read once,
// plus one gh pair and one row id per row and feature tile) and the
// shared-memory atomics (2 x N x F values). The design is about the
// atomics and about keeping enough gathers in flight:
//   * on sm_90 a shared 64-bit integer atomicAdd, like a float one,
//     compiles to a compare-and-swap loop (ATOMS.CAST.SPIN.64: a load, the
//     add and a compare-and-swap, retried on a collision). So each
//     int64 cell is two 32-bit words in separate planes, both taken by
//     native ATOMS.ADD: the value's low word into the lo plane (the add
//     returns the old word, which shows whether it wrapped) and its high
//     word plus that carry into the hi plane; hi * 2^32 + lo is then the
//     int64 sum mod 2^64 in any order of the adds, exact since every sum
//     is below 2^62 (no shared 64-bit atomic is left in the kernel);
//   * lanes map to features, not rows (the ELLPACK mapping of xgboost's
//     gpu_hist): a CTA takes a tile of nf features, a warp takes 32 / nf
//     rows a step and lane l adds feature l % nf of row l / nf, so the
//     warp's bin loads are contiguous runs of the row-major bins;
//   * the four planes (g lo, g hi, h lo, h hi) are bin-major [nbt][nf]:
//     the lanes of one row hit nf consecutive words, so an instruction of
//     a warp that takes one row (nf > 16) has no bank conflict. The planes
//     take 16 x nf x nbt bytes; a tile is as wide as two CTAs an SM allow
//     (about 113 KB each: nf = 28 at 257 buckets, so the HIGGS width is one
//     tile and each row's id, gh and bins are gathered once);
//   * 768-thread CTAs, two per SM (1,536 resident threads), in a
//     persistent grid of 2 x SMs CTAs per tile;
//   * each warp keeps XRT_HIST_UNROLL rows in flight and loads the next
//     step's row ids before it gathers the current step's bins and gh;
//   * the flush adds each non-zero cell with one 64-bit global atomic per
//     plane (native: REDG.E.ADD.64) into the interleaved [.., nbt, 2]
//     layout, and reads the node totals off feature 0's cells (every row
//     adds to one bin of each feature), summed per warp and then in warp
//     order.
// The missing bucket (bin == nbt - 1) is accumulated directly.
#include "common.cuh"

#define XRT_HIST_THREADS 768
#define XRT_HIST_WARPS (XRT_HIST_THREADS / 32)
#define XRT_HIST_CTAS_PER_SM 2
#define XRT_HIST_UNROLL 4

typedef unsigned long long xrt_u64;

__device__ __forceinline__ void xrt_atomic_add_i64(long long* p, long long v) {
  atomicAdd(reinterpret_cast<xrt_u64*>(p), static_cast<xrt_u64>(v));
}

// node of position p0: the last k < n_nodes with seg[k] <= p0
__device__ __forceinline__ int xrt_hist_node_of(const int* __restrict__ seg,
                                                int n_nodes, int p0) {
  int lo = 0, hi = n_nodes;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (seg[mid] <= p0) lo = mid; else hi = mid;
  }
  return lo;
}

// Add the quantised (g, h) of every row id in r[] (-1 = none) into the
// shared planes at this lane's feature fl of the tile's nf. Each int64
// value q goes in as two 32-bit words, both with native shared integer
// adds: its low word into the lo plane (the add returns the old word,
// which shows whether it wrapped) and its high word plus that carry into
// the hi plane, so hi * 2^32 + lo is the int64 sum of the values in any
// order.
template <typename BinT>
__device__ __forceinline__ void xrt_hist_accumulate(
    const BinT* __restrict__ bins, const float2* __restrict__ gh,
    const int (&r)[XRT_HIST_UNROLL], int n_features, int f0, int fl, int nf,
    int plane, float2 sc, unsigned* sh) {
  float2 v[XRT_HIST_UNROLL];
  int bv[XRT_HIST_UNROLL];
#pragma unroll
  for (int u = 0; u < XRT_HIST_UNROLL; ++u) {
    v[u] = make_float2(0.f, 0.f);
    bv[u] = 0;
    if (r[u] >= 0) {
      v[u] = __ldg(gh + r[u]);
      bv[u] = (int)bins[(size_t)r[u] * n_features + f0 + fl];
    }
  }
#pragma unroll
  for (int u = 0; u < XRT_HIST_UNROLL; ++u) {
    if (r[u] < 0) continue;
    const int c = bv[u] * nf + fl;
    const long long qg = __float2ll_rn(v[u].x * sc.x);
    const long long qh = __float2ll_rn(v[u].y * sc.y);
    const unsigned lg = (unsigned)qg, lh = (unsigned)qh;
    const unsigned og = atomicAdd(sh + c, lg);
    const unsigned oh = atomicAdd(sh + 2 * plane + c, lh);
    atomicAdd(sh + plane + c, (unsigned)(qg >> 32) + (og + lg < og));
    atomicAdd(sh + 3 * plane + c, (unsigned)(qh >> 32) + (oh + lh < oh));
  }
}

// The int64 sum held by a (lo, hi) word pair; the pair is zeroed.
__device__ __forceinline__ long long xrt_take_words(unsigned* lo,
                                                    unsigned* hi) {
  const long long s = (long long)(((unsigned long long)*hi << 32) | *lo);
  *lo = 0;
  *hi = 0;
  return s;
}

template <typename BinT>
__global__ void __launch_bounds__(XRT_HIST_THREADS, XRT_HIST_CTAS_PER_SM)
xrt_hist_kernel(const BinT* __restrict__ bins, const float2* __restrict__ gh,
                const int* __restrict__ rows, const int* __restrict__ seg,
                int n_nodes, int n_features, int nbt, int ftile,
                int min_rows, const float* __restrict__ qscale,
                long long* __restrict__ hist, long long* __restrict__ totals) {
  extern __shared__ unsigned xrt_hist_smem[];
  __shared__ long long wtot[XRT_HIST_WARPS][2];  // a warp's node totals
  const int f0 = blockIdx.y * ftile;
  const int nf = min(ftile, n_features - f0);
  const int plane = nf * nbt;
  unsigned* sh = xrt_hist_smem;  // g lo, g hi, h lo, h hi planes
  const int m = seg[n_nodes];
  int per = (m + gridDim.x - 1) / gridDim.x;
  per = max(per, min_rows);
  const int p0 = blockIdx.x * per;
  const int p1 = min(m, p0 + per);
  if (p0 >= p1) return;  // uniform across the CTA
  for (int i = threadIdx.x; i < 4 * plane; i += blockDim.x) xrt_hist_smem[i] = 0;
  const float2 sc = make_float2(qscale[0], qscale[1]);

  // lane -> (row of the warp step, feature)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rpw = 32 / nf;  // rows per warp step
  const int sub = lane / nf;
  const int fl = lane - sub * nf;
  const bool on = sub < rpw;  // lanes past rpw * nf idle
  const int step = rpw * XRT_HIST_UNROLL;  // positions per warp iteration
  const int stride = XRT_HIST_WARPS * step;
  const int cells = nf * nbt;
  __syncthreads();

  for (int node = xrt_hist_node_of(seg, n_nodes, p0);
       node < n_nodes && seg[node] < p1; ++node) {
    const int a = max(p0, seg[node]);
    const int b = min(p1, seg[node + 1]);
    if (a >= b) continue;  // empty node: uniform across the CTA
    int r[XRT_HIST_UNROLL];
    int q = a + warp * step;
#pragma unroll
    for (int u = 0; u < XRT_HIST_UNROLL; ++u) {
      const int p = q + u * rpw + sub;
      r[u] = (on && p < b) ? __ldg(rows + p) : -1;
    }
    for (; q < b; q += stride) {  // q is warp-uniform
      int rn[XRT_HIST_UNROLL];
#pragma unroll
      for (int u = 0; u < XRT_HIST_UNROLL; ++u) {
        const int p = q + stride + u * rpw + sub;
        rn[u] = (on && p < b) ? __ldg(rows + p) : -1;
      }
      xrt_hist_accumulate<BinT>(bins, gh, r, n_features, f0, fl, nf, plane,
                                sc, sh);
#pragma unroll
      for (int u = 0; u < XRT_HIST_UNROLL; ++u) r[u] = rn[u];
    }
    __syncthreads();
    // flush: cell (bin, f) of this tile in plane order, so a warp reads
    // consecutive words; every row adds to one bin of feature 0, so
    // feature 0's cells also give the node totals (tile 0)
    long long* out = hist + ((size_t)node * n_features + f0) * nbt * 2;
    long long tg = 0, th = 0;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const int bin = i / nf;
      const int f = i - bin * nf;
      const long long g = xrt_take_words(sh + i, sh + plane + i);
      const long long h = xrt_take_words(sh + 2 * plane + i, sh + 3 * plane + i);
      if (g != 0 || h != 0) {
        xrt_atomic_add_i64(out + 2 * (f * nbt + bin), g);
        xrt_atomic_add_i64(out + 2 * (f * nbt + bin) + 1, h);
      }
      if (f == 0) {
        tg += g;
        th += h;
      }
    }
    if (blockIdx.y == 0) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        tg += __shfl_down_sync(0xffffffffu, tg, o);
        th += __shfl_down_sync(0xffffffffu, th, o);
      }
      if (lane == 0) {
        wtot[warp][0] = tg;
        wtot[warp][1] = th;
      }
    }
    __syncthreads();
    if (blockIdx.y == 0 && threadIdx.x == 0) {
      tg = 0;
      th = 0;
      for (int w = 0; w < XRT_HIST_WARPS; ++w) {
        tg += wtot[w][0];
        th += wtot[w][1];
      }
      if (tg != 0 || th != 0) {
        xrt_atomic_add_i64(totals + 2 * node, tg);
        xrt_atomic_add_i64(totals + 2 * node + 1, th);
      }
    }
    __syncthreads();
  }
}

// Totals only (the last level): one position per thread, a warp sum per
// node piece, one pair of 64-bit atomics per warp.
__global__ void __launch_bounds__(XRT_HIST_THREADS)
xrt_node_totals_kernel(const float2* __restrict__ gh,
                       const int* __restrict__ rows,
                       const int* __restrict__ seg, int n_nodes, int min_rows,
                       const float* __restrict__ qscale,
                       long long* __restrict__ totals) {
  const int m = seg[n_nodes];
  int per = (m + gridDim.x - 1) / gridDim.x;
  per = max(per, min_rows);
  const int p0 = blockIdx.x * per;
  const int p1 = min(m, p0 + per);
  if (p0 >= p1) return;
  const float2 sc = make_float2(qscale[0], qscale[1]);
  for (int node = xrt_hist_node_of(seg, n_nodes, p0);
       node < n_nodes && seg[node] < p1; ++node) {
    const int a = max(p0, seg[node]);
    const int b = min(p1, seg[node + 1]);
    if (a >= b) continue;
    long long tg = 0, th = 0;
    for (int p = a + threadIdx.x; p < b; p += blockDim.x) {
      const float2 v = __ldg(gh + __ldg(rows + p));
      tg += __float2ll_rn(v.x * sc.x);
      th += __float2ll_rn(v.y * sc.y);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      tg += __shfl_down_sync(0xffffffffu, tg, o);
      th += __shfl_down_sync(0xffffffffu, th, o);
    }
    if ((threadIdx.x & 31) == 0 && (tg != 0 || th != 0)) {
      xrt_atomic_add_i64(totals + 2 * node, tg);
      xrt_atomic_add_i64(totals + 2 * node + 1, th);
    }
  }
}

// The f32 histogram (or totals) K2 reads: float(sum) * 2^-e per plane, round
// to nearest then an exact power-of-two scale. One (g, h) pair a thread,
// 16 bytes in and 8 out, grid-stride.
__global__ void __launch_bounds__(256)
xrt_dequant_kernel(const longlong2* __restrict__ in, float2* __restrict__ out,
                   long long n_pairs, const float* __restrict__ qscale) {
  const float2 inv = make_float2(qscale[2], qscale[3]);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_pairs; i += (long long)gridDim.x * blockDim.x) {
    const longlong2 v = in[i];
    out[i] = make_float2(__ll2float_rn(v.x) * inv.x, __ll2float_rn(v.y) * inv.y);
  }
}

template <typename BinT>
static int launch_hist(const void* bins, const float* gh, const int* rows,
                       const int* seg, int n_nodes, int n_features, int nbt,
                       int ftile, int grid_x, int min_rows,
                       const float* qscale, long long* hist,
                       long long* totals, cudaStream_t stream) {
  const size_t smem = (size_t)4 * ftile * nbt * sizeof(unsigned);
  auto kernel = xrt_hist_kernel<BinT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(grid_x, (n_features + ftile - 1) / ftile);
  kernel<<<grid, XRT_HIST_THREADS, smem, stream>>>(
      (const BinT*)bins, (const float2*)gh, rows, seg, n_nodes, n_features,
      nbt, ftile, min_rows, qscale, hist, totals);
  return (int)cudaGetLastError();
}

// hist [n_nodes, F, nbt, 2] and totals [n_nodes, 2] int64 must be zeroed by
// the caller; gh is [N, 2] f32 (8-byte aligned); qscale is the round's
// (2^eg, 2^eh, 2^-eg, 2^-eh) f32 on the device. bin_bytes is 1 (uint8 bins)
// or 2 (int16 bins); ftile <= 32 features a CTA, whose four word planes
// take 16 x ftile x nbt bytes of shared memory. with_hist = 0 computes the
// node totals only (hist and bins may then be null).
extern "C" int xrt_hist_build(const void* bins, int bin_bytes, const float* gh,
                              const int* rows, const int* seg, int n_nodes,
                              int n_features, int nbt, int ftile, int grid_x,
                              int min_rows, int with_hist,
                              const float* qscale, long long* hist,
                              long long* totals, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!with_hist) {
    xrt_node_totals_kernel<<<grid_x, XRT_HIST_THREADS, 0, s>>>(
        (const float2*)gh, rows, seg, n_nodes, min_rows, qscale, totals);
    return (int)cudaGetLastError();
  }
  if (ftile < 1 || ftile > 32) return (int)cudaErrorInvalidValue;
  auto launch = bin_bytes == 1 ? launch_hist<uint8_t> : launch_hist<int16_t>;
  return launch(bins, gh, rows, seg, n_nodes, n_features, nbt, ftile, grid_x,
                min_rows, qscale, hist, totals, s);
}

// out[i] = (float(in[2i]) * qscale[2], float(in[2i+1]) * qscale[3]) for
// n_pairs pairs; in 16-byte aligned int64, out 8-byte aligned f32.
extern "C" int xrt_hist_dequant(const long long* in, float* out,
                                long long n_pairs, const float* qscale,
                                int grid, void* stream) {
  if (n_pairs <= 0) return 0;
  xrt_dequant_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const longlong2*)in, (float2*)out, n_pairs, qscale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1's integer instantiation (gh_precision): int8 / int16 gradients, exact
// int32 sums. The reference's max_rows cap (qmax * global rows < 2^31)
// proves that no sum overflows, so each cell is one 32-bit word a channel:
// two planes (g, h), bin-major [nbt][nf] as above, taken by native shared
// ATOMS.ADD with no carry word, flushed with native 32-bit global atomics
// (RED.E.ADD) into the int32 [.., nbt, 2] layout. Integer adds are
// associative: any order of the atomics gives the same bits, and so does
// the plain version's scatter.
// ---------------------------------------------------------------------------

template <typename BinT, typename QT>
__device__ __forceinline__ void xrt_hist_accumulate_int(
    const BinT* __restrict__ bins, const QT* __restrict__ gh,
    const int (&r)[XRT_HIST_UNROLL], int n_features, int f0, int fl, int nf,
    int plane, unsigned* sh) {
  int qg[XRT_HIST_UNROLL], qh[XRT_HIST_UNROLL];
  int bv[XRT_HIST_UNROLL];
#pragma unroll
  for (int u = 0; u < XRT_HIST_UNROLL; ++u) {
    qg[u] = qh[u] = 0;
    bv[u] = 0;
    if (r[u] >= 0) {
      qg[u] = (int)gh[2 * (size_t)r[u]];
      qh[u] = (int)gh[2 * (size_t)r[u] + 1];
      bv[u] = (int)bins[(size_t)r[u] * n_features + f0 + fl];
    }
  }
#pragma unroll
  for (int u = 0; u < XRT_HIST_UNROLL; ++u) {
    if (r[u] < 0) continue;
    const int c = bv[u] * nf + fl;
    atomicAdd(sh + c, (unsigned)qg[u]);
    atomicAdd(sh + plane + c, (unsigned)qh[u]);
  }
}

template <typename BinT, typename QT>
__global__ void __launch_bounds__(XRT_HIST_THREADS, XRT_HIST_CTAS_PER_SM)
xrt_hist_int_kernel(const BinT* __restrict__ bins, const QT* __restrict__ gh,
                    const int* __restrict__ rows, const int* __restrict__ seg,
                    int n_nodes, int n_features, int nbt, int ftile,
                    int min_rows, int* __restrict__ hist,
                    int* __restrict__ totals) {
  extern __shared__ unsigned xrt_hist_smem[];
  __shared__ unsigned wtot[XRT_HIST_WARPS][2];
  const int f0 = blockIdx.y * ftile;
  const int nf = min(ftile, n_features - f0);
  const int plane = nf * nbt;
  unsigned* sh = xrt_hist_smem;  // g, h planes
  // the CTAs split [seg[0], seg[n_nodes]): the first node may start past 0
  // (the lossguide grower's two children, the middle of a three-node level)
  const int base = seg[0];
  const int m = seg[n_nodes];
  int per = (m - base + gridDim.x - 1) / gridDim.x;
  per = max(per, min_rows);
  const int p0 = base + blockIdx.x * per;
  const int p1 = min(m, p0 + per);
  if (p0 >= p1) return;
  for (int i = threadIdx.x; i < 2 * plane; i += blockDim.x) sh[i] = 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rpw = 32 / nf;
  const int sub = lane / nf;
  const int fl = lane - sub * nf;
  const bool on = sub < rpw;
  const int step = rpw * XRT_HIST_UNROLL;
  const int stride = XRT_HIST_WARPS * step;
  const int cells = nf * nbt;
  __syncthreads();

  for (int node = xrt_hist_node_of(seg, n_nodes, p0);
       node < n_nodes && seg[node] < p1; ++node) {
    const int a = max(p0, seg[node]);
    const int b = min(p1, seg[node + 1]);
    if (a >= b) continue;
    int r[XRT_HIST_UNROLL];
    int q = a + warp * step;
#pragma unroll
    for (int u = 0; u < XRT_HIST_UNROLL; ++u) {
      const int p = q + u * rpw + sub;
      r[u] = (on && p < b) ? __ldg(rows + p) : -1;
    }
    for (; q < b; q += stride) {
      int rn[XRT_HIST_UNROLL];
#pragma unroll
      for (int u = 0; u < XRT_HIST_UNROLL; ++u) {
        const int p = q + stride + u * rpw + sub;
        rn[u] = (on && p < b) ? __ldg(rows + p) : -1;
      }
      xrt_hist_accumulate_int<BinT, QT>(bins, gh, r, n_features, f0, fl, nf,
                                        plane, sh);
#pragma unroll
      for (int u = 0; u < XRT_HIST_UNROLL; ++u) r[u] = rn[u];
    }
    __syncthreads();
    int* out = hist + ((size_t)node * n_features + f0) * nbt * 2;
    unsigned tg = 0, th = 0;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const int bin = i / nf;
      const int f = i - bin * nf;
      const unsigned g = sh[i];
      const unsigned h = sh[plane + i];
      sh[i] = 0;
      sh[plane + i] = 0;
      if (g != 0 || h != 0) {
        atomicAdd((unsigned*)out + 2 * (f * nbt + bin), g);
        atomicAdd((unsigned*)out + 2 * (f * nbt + bin) + 1, h);
      }
      if (f == 0) {
        tg += g;
        th += h;
      }
    }
    if (blockIdx.y == 0) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        tg += __shfl_down_sync(0xffffffffu, tg, o);
        th += __shfl_down_sync(0xffffffffu, th, o);
      }
      if (lane == 0) {
        wtot[warp][0] = tg;
        wtot[warp][1] = th;
      }
    }
    __syncthreads();
    if (blockIdx.y == 0 && threadIdx.x == 0) {
      tg = 0;
      th = 0;
      for (int w = 0; w < XRT_HIST_WARPS; ++w) {
        tg += wtot[w][0];
        th += wtot[w][1];
      }
      if (tg != 0 || th != 0) {
        atomicAdd((unsigned*)totals + 2 * node, tg);
        atomicAdd((unsigned*)totals + 2 * node + 1, th);
      }
    }
    __syncthreads();
  }
}

template <typename QT>
__global__ void __launch_bounds__(XRT_HIST_THREADS)
xrt_node_totals_int_kernel(const QT* __restrict__ gh,
                           const int* __restrict__ rows,
                           const int* __restrict__ seg, int n_nodes,
                           int min_rows, int* __restrict__ totals) {
  const int m = seg[n_nodes];
  int per = (m + gridDim.x - 1) / gridDim.x;
  per = max(per, min_rows);
  const int p0 = blockIdx.x * per;
  const int p1 = min(m, p0 + per);
  if (p0 >= p1) return;
  for (int node = xrt_hist_node_of(seg, n_nodes, p0);
       node < n_nodes && seg[node] < p1; ++node) {
    const int a = max(p0, seg[node]);
    const int b = min(p1, seg[node + 1]);
    if (a >= b) continue;
    unsigned tg = 0, th = 0;
    for (int p = a + threadIdx.x; p < b; p += blockDim.x) {
      const int r = __ldg(rows + p);
      tg += (unsigned)(int)gh[2 * (size_t)r];
      th += (unsigned)(int)gh[2 * (size_t)r + 1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      tg += __shfl_down_sync(0xffffffffu, tg, o);
      th += __shfl_down_sync(0xffffffffu, th, o);
    }
    if ((threadIdx.x & 31) == 0 && (tg != 0 || th != 0)) {
      atomicAdd((unsigned*)totals + 2 * node, tg);
      atomicAdd((unsigned*)totals + 2 * node + 1, th);
    }
  }
}

template <typename BinT, typename QT>
static int launch_hist_int(const void* bins, const void* gh, const int* rows,
                           const int* seg, int n_nodes, int n_features,
                           int nbt, int ftile, int grid_x, int min_rows,
                           int* hist, int* totals, cudaStream_t stream) {
  const size_t smem = (size_t)2 * ftile * nbt * sizeof(unsigned);
  auto kernel = xrt_hist_int_kernel<BinT, QT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(grid_x, (n_features + ftile - 1) / ftile);
  kernel<<<grid, XRT_HIST_THREADS, smem, stream>>>(
      (const BinT*)bins, (const QT*)gh, rows, seg, n_nodes, n_features, nbt,
      ftile, min_rows, hist, totals);
  return (int)cudaGetLastError();
}

// K1 over integer gradients: gh [N, 2] int8 (gh_bytes 1) or int16 (2);
// hist [n_nodes, F, nbt, 2] and totals [n_nodes, 2] int32, zeroed by the
// caller; the rest as xrt_hist_build (two word planes: 8 x ftile x nbt
// bytes of shared memory).
extern "C" int xrt_hist_build_int(const void* bins, int bin_bytes,
                                  const void* gh, int gh_bytes,
                                  const int* rows, const int* seg,
                                  int n_nodes, int n_features, int nbt,
                                  int ftile, int grid_x, int min_rows,
                                  int with_hist, int* hist, int* totals,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (gh_bytes != 1 && gh_bytes != 2) return (int)cudaErrorInvalidValue;
  if (!with_hist) {
    if (gh_bytes == 1)
      xrt_node_totals_int_kernel<int8_t><<<grid_x, XRT_HIST_THREADS, 0, s>>>(
          (const int8_t*)gh, rows, seg, n_nodes, min_rows, totals);
    else
      xrt_node_totals_int_kernel<int16_t><<<grid_x, XRT_HIST_THREADS, 0, s>>>(
          (const int16_t*)gh, rows, seg, n_nodes, min_rows, totals);
    return (int)cudaGetLastError();
  }
  if (ftile < 1 || ftile > 32) return (int)cudaErrorInvalidValue;
  auto launch = bin_bytes == 1
                    ? (gh_bytes == 1 ? launch_hist_int<uint8_t, int8_t>
                                     : launch_hist_int<uint8_t, int16_t>)
                    : (gh_bytes == 1 ? launch_hist_int<int16_t, int8_t>
                                     : launch_hist_int<int16_t, int16_t>);
  return launch(bins, gh, rows, seg, n_nodes, n_features, nbt, ftile, grid_x,
                min_rows, hist, totals, s);
}

// ---------------------------------------------------------------------------
// The one dequantisation point of the quantized-gradient path
// (xgboost_ray_tpu/ops/grow.py:577-601): a level's histogram formed in the
// integer domain (each parent's smaller child as merged, its sibling as
// parent - smaller child: int32 where both are int32, else f32 of each),
// kept as int32 or f32 for the next level, and dequantised once, f32(v) *
// scale[c]; with `totals`, each node's (G, H) as the exact int32 sum of
// feature 0's buckets, dequantised. Blocks [0, n_nodes) take the totals
// (one a node, an int32 block sum: any order gives the same bits), the
// others the pairs, grid-stride.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void xrt_formed_pair(
    const void* small, int small_int, const void* prev, int prev_int,
    const uint8_t* sir, long long node, long long rest, long long per_node,
    int* iv, float* fv, bool* is_int) {
  // rest: the pair's index within its node, (f * nbt + b)
  if (prev == nullptr) {
    const long long k = node * per_node + rest;
    if (small_int) {
      const int2 v = ((const int2*)small)[k];
      iv[0] = v.x;
      iv[1] = v.y;
      *is_int = true;
    } else {
      const float2 v = ((const float2*)small)[k];
      fv[0] = v.x;
      fv[1] = v.y;
      *is_int = false;
    }
    return;
  }
  const long long par = node >> 1;
  const bool right = (node & 1) != 0;
  const bool small_here = right == (sir[par] != 0);
  const long long k = par * per_node + rest;
  if (small_int && prev_int) {
    const int2 s = ((const int2*)small)[k];
    if (small_here) {
      iv[0] = s.x;
      iv[1] = s.y;
    } else {
      const int2 p = ((const int2*)prev)[k];
      iv[0] = (int)((unsigned)p.x - (unsigned)s.x);
      iv[1] = (int)((unsigned)p.y - (unsigned)s.y);
    }
    *is_int = true;
    return;
  }
  float s0, s1;
  if (small_int) {
    const int2 s = ((const int2*)small)[k];
    s0 = __int2float_rn(s.x);
    s1 = __int2float_rn(s.y);
  } else {
    const float2 s = ((const float2*)small)[k];
    s0 = s.x;
    s1 = s.y;
  }
  if (small_here) {
    fv[0] = s0;
    fv[1] = s1;
  } else {
    float p0, p1;
    if (prev_int) {
      const int2 p = ((const int2*)prev)[k];
      p0 = __int2float_rn(p.x);
      p1 = __int2float_rn(p.y);
    } else {
      const float2 p = ((const float2*)prev)[k];
      p0 = p.x;
      p1 = p.y;
    }
    fv[0] = __fsub_rn(p0, s0);
    fv[1] = __fsub_rn(p1, s1);
  }
  *is_int = false;
}

__global__ void __launch_bounds__(256)
xrt_form_dequant_kernel(const void* __restrict__ small, int small_int,
                        const void* __restrict__ prev, int prev_int,
                        const uint8_t* __restrict__ sir, int n_nodes,
                        int n_features, int nbt,
                        const float* __restrict__ scale,
                        void* __restrict__ formed, int formed_int,
                        float2* __restrict__ values,
                        float* __restrict__ totals) {
  const float2 sc = make_float2(scale[0], scale[1]);
  const long long per_node = (long long)n_features * nbt;
  if (totals != nullptr && blockIdx.x < (unsigned)n_nodes) {
    __shared__ unsigned red[2][8];
    const int node = blockIdx.x;
    unsigned tg = 0, th = 0;
    for (int b = threadIdx.x; b < nbt; b += blockDim.x) {
      int iv[2];
      float fv[2];
      bool is_int;
      xrt_formed_pair(small, small_int, prev, prev_int, sir, node, b,
                      per_node, iv, fv, &is_int);
      tg += (unsigned)iv[0];
      th += (unsigned)iv[1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      tg += __shfl_down_sync(0xffffffffu, tg, o);
      th += __shfl_down_sync(0xffffffffu, th, o);
    }
    if ((threadIdx.x & 31) == 0) {
      red[0][threadIdx.x >> 5] = tg;
      red[1][threadIdx.x >> 5] = th;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      tg = th = 0;
      for (int w = 0; w < 8; ++w) {
        tg += red[0][w];
        th += red[1][w];
      }
      totals[2 * node] = __fmul_rn(__int2float_rn((int)tg), sc.x);
      totals[2 * node + 1] = __fmul_rn(__int2float_rn((int)th), sc.y);
    }
    return;
  }
  const int first = totals != nullptr ? n_nodes : 0;
  const long long pairs = (long long)n_nodes * per_node;
  for (long long i = (blockIdx.x - first) * (long long)blockDim.x +
                     threadIdx.x;
       i < pairs; i += (long long)(gridDim.x - first) * blockDim.x) {
    const long long node = i / per_node;
    int iv[2];
    float fv[2];
    bool is_int;
    xrt_formed_pair(small, small_int, prev, prev_int, sir, node,
                    i - node * per_node, per_node, iv, fv, &is_int);
    if (is_int && !formed_int) {
      fv[0] = __int2float_rn(iv[0]);
      fv[1] = __int2float_rn(iv[1]);
    }
    if (formed_int) {
      ((int2*)formed)[i] = make_int2(iv[0], iv[1]);
      values[i] = make_float2(__fmul_rn(__int2float_rn(iv[0]), sc.x),
                              __fmul_rn(__int2float_rn(iv[1]), sc.y));
    } else {
      ((float2*)formed)[i] = make_float2(fv[0], fv[1]);
      values[i] = make_float2(__fmul_rn(fv[0], sc.x), __fmul_rn(fv[1], sc.y));
    }
  }
}

// small [n, F, nbt, 2] int32 (small_int) or f32; prev the same shape
// (int32 with prev_int, else f32) or null; sir [n] bool with prev; n_nodes
// = 2n with prev, else n; scale [2] f32; formed [n_nodes, F, nbt, 2] int32
// (formed_int: only from int32 inputs) or f32; values the same f32; totals
// [n_nodes, 2] f32 or null (int32 inputs only). grid: the pairs' blocks
// (the totals take n_nodes more).
extern "C" int xrt_hist_form_dequant(const void* small, int small_int,
                                     const void* prev, int prev_int,
                                     const uint8_t* sir, int n_nodes,
                                     int n_features, int nbt,
                                     const float* scale, void* formed,
                                     int formed_int, float* values,
                                     float* totals, int grid, void* stream) {
  if (n_nodes <= 0) return 0;
  const int blocks = grid + (totals != nullptr ? n_nodes : 0);
  xrt_form_dequant_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      small, small_int, prev, prev_int, sir, n_nodes, n_features, nbt, scale,
      formed, formed_int, (float2*)values, totals);
  return (int)cudaGetLastError();
}

// The CTAs per SM the wrapper sizes its persistent grid with.
extern "C" int xrt_hist_ctas_per_sm() { return XRT_HIST_CTAS_PER_SM; }
