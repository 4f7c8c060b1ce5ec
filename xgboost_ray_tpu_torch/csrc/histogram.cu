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
// sync is needed) and one tile of features. It accumulates (g, h) into a
// shared-memory histogram of ftile x nbt x 2 floats with shared atomics and,
// at every node boundary inside its slice and at its end, flushes the
// non-zero cells to the global histogram with one atomicAdd each. The CTA of
// feature tile 0 also sums (g, h) for the node totals in the same pass.
//
// What bounds it: the bins gather (N x F x sizeof(bin) bytes read once) and
// shared-memory atomics (2 x N x F); the global flush is
// grid x ftile x nbt x 2 atomics, kept small by giving each CTA many rows.
// The missing bucket (bin == nbt - 1) is accumulated directly.
#include "common.cuh"

template <typename BinT>
__global__ void __launch_bounds__(XRT_THREADS)
xrt_hist_kernel(const BinT* __restrict__ bins, const float* __restrict__ gh,
                const int* __restrict__ rows, const int* __restrict__ seg,
                int n_nodes, int n_features, int nbt, int ftile,
                int min_rows, int with_hist, float* __restrict__ hist,
                float* __restrict__ totals) {
  extern __shared__ float smem[];
  float* sh = smem;                       // [ftile * nbt * 2]
  float* tot = smem + (with_hist ? ftile * nbt * 2 : 0);  // [2]
  const int f0 = blockIdx.y * ftile;
  const int nf = min(ftile, n_features - f0);
  const int m = seg[n_nodes];
  int per = (m + gridDim.x - 1) / gridDim.x;
  per = max(per, min_rows);
  const int p0 = blockIdx.x * per;
  const int p1 = min(m, p0 + per);
  if (p0 >= p1) return;  // uniform across the CTA
  const int hsize = with_hist ? nf * nbt * 2 : 0;
  for (int i = threadIdx.x; i < hsize; i += blockDim.x) sh[i] = 0.f;
  if (threadIdx.x < 2) tot[threadIdx.x] = 0.f;
  // node of the first position: the last k with seg[k] <= p0
  int lo = 0, hi = n_nodes;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (seg[mid] <= p0) lo = mid; else hi = mid;
  }
  __syncthreads();
  const bool do_tot = blockIdx.y == 0;
  for (int node = lo; node < n_nodes && seg[node] < p1; ++node) {
    const int a = max(p0, seg[node]);
    const int b = min(p1, seg[node + 1]);
    if (a >= b) continue;  // empty node: uniform across the CTA
    float tg = 0.f, th = 0.f;
    for (int p = a + threadIdx.x; p < b; p += blockDim.x) {
      const int r = rows[p];
      const float g = gh[2 * (size_t)r];
      const float h = gh[2 * (size_t)r + 1];
      const BinT* br = bins + (size_t)r * n_features + f0;
      for (int f = 0; f < (with_hist ? nf : 0); ++f) {
        float* cell = sh + 2 * (f * nbt + (int)br[f]);
        atomicAdd(cell, g);
        atomicAdd(cell + 1, h);
      }
      tg += g;
      th += h;
    }
    if (do_tot) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        tg += __shfl_down_sync(0xffffffffu, tg, o);
        th += __shfl_down_sync(0xffffffffu, th, o);
      }
      if ((threadIdx.x & 31) == 0) {
        atomicAdd(tot, tg);
        atomicAdd(tot + 1, th);
      }
    }
    __syncthreads();
    float* out = hist + ((size_t)node * n_features + f0) * nbt * 2;
    for (int i = threadIdx.x; i < hsize; i += blockDim.x) {
      const float v = sh[i];
      if (v != 0.f) atomicAdd(out + i, v);
      sh[i] = 0.f;
    }
    if (do_tot && threadIdx.x < 2) {
      const float v = tot[threadIdx.x];
      if (v != 0.f) atomicAdd(totals + 2 * node + threadIdx.x, v);
      tot[threadIdx.x] = 0.f;
    }
    __syncthreads();
  }
}

template <typename BinT>
static int launch_hist(const void* bins, const float* gh, const int* rows,
                       const int* seg, int n_nodes, int n_features, int nbt,
                       int ftile, int grid_x, int min_rows, int with_hist,
                       float* hist, float* totals, cudaStream_t stream) {
  const size_t smem =
      (size_t)((with_hist ? ftile * nbt * 2 : 0) + 2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      xrt_hist_kernel<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(grid_x, with_hist ? (n_features + ftile - 1) / ftile : 1);
  xrt_hist_kernel<BinT><<<grid, XRT_THREADS, smem, stream>>>(
      (const BinT*)bins, gh, rows, seg, n_nodes, n_features, nbt, ftile,
      min_rows, with_hist, hist, totals);
  return (int)cudaGetLastError();
}

// hist [n_nodes, F, nbt, 2] and totals [n_nodes, 2] must be zeroed by the
// caller. bin_bytes is 1 (uint8 bins) or 2 (int16 bins). with_hist = 0
// computes the node totals only (hist may then be null).
extern "C" int xrt_hist_build(const void* bins, int bin_bytes, const float* gh,
                              const int* rows, const int* seg, int n_nodes,
                              int n_features, int nbt, int ftile, int grid_x,
                              int min_rows, int with_hist, float* hist,
                              float* totals, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bin_bytes == 1)
    return launch_hist<uint8_t>(bins, gh, rows, seg, n_nodes, n_features,
                                nbt, ftile, grid_x, min_rows, with_hist, hist,
                                totals, s);
  return launch_hist<int16_t>(bins, gh, rows, seg, n_nodes, n_features, nbt,
                              ftile, grid_x, min_rows, with_hist, hist,
                              totals, s);
}
