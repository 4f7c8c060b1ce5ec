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
// What bounds it: the bins gather (N x F x sizeof(bin) bytes read once,
// plus one gh pair and one row id per row) and the shared-memory float
// atomics (2 x N x F). On sm_90 a shared float atomicAdd compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN: a load, the add, the CAS), so
// every bank conflict costs twice. The design is about the atomics and
// about keeping enough gathers in flight:
//   * lanes map to features, not rows (the ELLPACK mapping of xgboost's
//     gpu_hist): a CTA takes a tile of at most 32 features, a warp takes
//     32 / nf rows at a time, and lane l adds feature l % nf of row l / nf.
//     The warp's bin loads are one contiguous run of the row-major bins;
//   * g and h live in separate planes laid out [bin][32 lanes], so the 32
//     lanes of an atomic instruction hit 32 different banks whatever the
//     bins are, and never the same address (rows of one warp step keep
//     separate copies of a feature, summed at the flush). This needs
//     256 x nbt bytes; past nbt = 296 the planes are feature-major
//     [nf][nbt] instead;
//   * 512-thread CTAs, three per SM (1,536 resident threads; 65.8 KB of
//     planes each at 257 buckets), in a persistent grid of 3 x SMs CTAs;
//   * each warp keeps XRT_HIST_UNROLL rows in flight and loads the next
//     step's row ids before it gathers the current step's bins and gh;
//   * the flush adds a (g, h) pair with one float2 atomic (sm_90) into the
//     interleaved [.., nbt, 2] layout, and reads the node totals off
//     feature 0's cells (every row adds to one bin of each feature).
// The missing bucket (bin == nbt - 1) is accumulated directly. Sums stay
// f32 (no fixed-point gh): the order of the atomics varies from run to run,
// the values only by rounding.
#include "common.cuh"

#define XRT_HIST_THREADS 512
#define XRT_HIST_WARPS (XRT_HIST_THREADS / 32)
#define XRT_HIST_CTAS_PER_SM 3
#define XRT_HIST_UNROLL 4

__device__ __forceinline__ void xrt_atomic_add_pair(float* p, float g,
                                                    float h) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && \
    (__CUDACC_VER_MAJOR__ > 12 ||                      \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(g, h));
#else
  atomicAdd(p, g);
  atomicAdd(p + 1, h);
#endif
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

// Add the (g, h) of every row id in r[] (-1 = none) into the shared planes
// at this lane's feature fl.
template <typename BinT, bool LANE_COLS>
__device__ __forceinline__ void xrt_hist_accumulate(
    const BinT* __restrict__ bins, const float2* __restrict__ gh,
    const int (&r)[XRT_HIST_UNROLL], int n_features, int f0, int fl,
    int lane, int nbt, float* sh_g, float* sh_h) {
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
    const int c = LANE_COLS ? bv[u] * 32 + lane : fl * nbt + bv[u];
    atomicAdd(sh_g + c, v[u].x);
    atomicAdd(sh_h + c, v[u].y);
  }
}

// LANE_COLS: each plane is [nbt][32], one column per lane, so the 32 lanes
// of an atomic instruction always hit 32 different banks, whatever the
// bins (lanes of different rows of one warp step keep separate copies of
// a feature, summed at the flush). It needs 256 x nbt bytes, so it serves
// nbt <= 296 (max_bin 256: 65.8 KB); above that each plane is [nf][nbt]
// (feature-major), where a lane's bank is (f x nbt + bin) mod 32.
template <typename BinT, bool LANE_COLS>
__global__ void __launch_bounds__(XRT_HIST_THREADS, XRT_HIST_CTAS_PER_SM)
xrt_hist_kernel(const BinT* __restrict__ bins, const float2* __restrict__ gh,
                const int* __restrict__ rows, const int* __restrict__ seg,
                int n_nodes, int n_features, int nbt, int ftile,
                int min_rows, float* __restrict__ hist,
                float* __restrict__ totals) {
  extern __shared__ float smem[];
  __shared__ float tot[2];
  const int f0 = blockIdx.y * ftile;
  const int nf = min(ftile, n_features - f0);  // <= 32
  const int plane = LANE_COLS ? nbt * 32 : nf * nbt;
  float* sh_g = smem;
  float* sh_h = smem + plane;
  const int m = seg[n_nodes];
  int per = (m + gridDim.x - 1) / gridDim.x;
  per = max(per, min_rows);
  const int p0 = blockIdx.x * per;
  const int p1 = min(m, p0 + per);
  if (p0 >= p1) return;  // uniform across the CTA
  for (int i = threadIdx.x; i < 2 * plane; i += blockDim.x) smem[i] = 0.f;
  if (threadIdx.x < 2) tot[threadIdx.x] = 0.f;

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
      xrt_hist_accumulate<BinT, LANE_COLS>(bins, gh, r, n_features, f0, fl,
                                           lane, nbt, sh_g, sh_h);
#pragma unroll
      for (int u = 0; u < XRT_HIST_UNROLL; ++u) r[u] = rn[u];
    }
    __syncthreads();
    // flush: cell (f, bin) of this tile, bin-major under LANE_COLS so a
    // warp reads consecutive columns; every row adds to one bin of feature
    // 0, so feature 0's cells also give the node totals (tile 0)
    float* out = hist + ((size_t)node * n_features + f0) * nbt * 2;
    float tg = 0.f, th = 0.f;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      float g = 0.f, h = 0.f;
      int f, bin;
      if (LANE_COLS) {
        bin = i / nf;
        f = i - bin * nf;
        for (int s = 0; s < rpw; ++s) {
          const int c = bin * 32 + s * nf + f;
          g += sh_g[c];
          h += sh_h[c];
          sh_g[c] = 0.f;
          sh_h[c] = 0.f;
        }
      } else {
        f = i / nbt;
        bin = i - f * nbt;
        g = sh_g[i];
        h = sh_h[i];
        sh_g[i] = 0.f;
        sh_h[i] = 0.f;
      }
      if (g != 0.f || h != 0.f)
        xrt_atomic_add_pair(out + 2 * (f * nbt + bin), g, h);
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
      if (lane == 0 && (tg != 0.f || th != 0.f)) {
        atomicAdd(tot, tg);
        atomicAdd(tot + 1, th);
      }
    }
    __syncthreads();
    if (blockIdx.y == 0 && threadIdx.x == 0) {
      if (tot[0] != 0.f || tot[1] != 0.f)
        xrt_atomic_add_pair(totals + 2 * node, tot[0], tot[1]);
      tot[0] = 0.f;
      tot[1] = 0.f;
    }
    __syncthreads();
  }
}

// Totals only (the last level): one position per thread, a warp sum per
// node piece, one pair of atomics per warp.
__global__ void __launch_bounds__(XRT_HIST_THREADS)
xrt_node_totals_kernel(const float2* __restrict__ gh,
                       const int* __restrict__ rows,
                       const int* __restrict__ seg, int n_nodes, int min_rows,
                       float* __restrict__ totals) {
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
    float tg = 0.f, th = 0.f;
    for (int p = a + threadIdx.x; p < b; p += blockDim.x) {
      const float2 v = __ldg(gh + __ldg(rows + p));
      tg += v.x;
      th += v.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      tg += __shfl_down_sync(0xffffffffu, tg, o);
      th += __shfl_down_sync(0xffffffffu, th, o);
    }
    if ((threadIdx.x & 31) == 0 && (tg != 0.f || th != 0.f))
      xrt_atomic_add_pair(totals + 2 * node, tg, th);
  }
}

template <typename BinT, bool LANE_COLS>
static int launch_hist(const void* bins, const float* gh, const int* rows,
                       const int* seg, int n_nodes, int n_features, int nbt,
                       int ftile, int grid_x, int min_rows, float* hist,
                       float* totals, cudaStream_t stream) {
  const size_t smem = (size_t)2 * (LANE_COLS ? 32 : ftile) * nbt * sizeof(float);
  auto kernel = xrt_hist_kernel<BinT, LANE_COLS>;
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
      nbt, ftile, min_rows, hist, totals);
  return (int)cudaGetLastError();
}

// hist [n_nodes, F, nbt, 2] and totals [n_nodes, 2] must be zeroed by the
// caller; gh is [N, 2] f32 (8-byte aligned). bin_bytes is 1 (uint8 bins) or
// 2 (int16 bins); ftile <= 32 features per CTA; lane_cols picks the
// [nbt][32] shared layout (needs 256 x nbt bytes of shared memory, else
// 8 x ftile x nbt). with_hist = 0 computes the node totals only (hist and
// bins may then be null).
extern "C" int xrt_hist_build(const void* bins, int bin_bytes, const float* gh,
                              const int* rows, const int* seg, int n_nodes,
                              int n_features, int nbt, int ftile,
                              int lane_cols, int grid_x, int min_rows,
                              int with_hist, float* hist, float* totals,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!with_hist) {
    xrt_node_totals_kernel<<<grid_x, XRT_HIST_THREADS, 0, s>>>(
        (const float2*)gh, rows, seg, n_nodes, min_rows, totals);
    return (int)cudaGetLastError();
  }
  if (ftile < 1 || ftile > 32) return (int)cudaErrorInvalidValue;
  auto launch = bin_bytes == 1
      ? (lane_cols ? launch_hist<uint8_t, true> : launch_hist<uint8_t, false>)
      : (lane_cols ? launch_hist<int16_t, true> : launch_hist<int16_t, false>);
  return launch(bins, gh, rows, seg, n_nodes, n_features, nbt, ftile, grid_x,
                min_rows, hist, totals, s);
}

// The CTAs per SM the wrapper sizes its persistent grid with.
extern "C" int xrt_hist_ctas_per_sm() { return XRT_HIST_CTAS_PER_SM; }
