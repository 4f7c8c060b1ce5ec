// K2 — node totals and best split per node from a level's histogram, CUDA
// C++ for sm_90a.
//
// Replaces the JAX package's find_splits (xgboost_ray_tpu/ops/split.py:79-166,
// unconstrained numeric branch) and the node-total readout of build_tree
// (ops/grow.py:594, hist[:, 0].sum over feature 0's buckets): a prefix scan
// over the present bins of each (node, feature), the gain with the missing
// bucket sent left and sent right under the min_child_weight gate, the
// first-max argmax over the flattened (feature, bin) candidates
// (split.py:158 — the LOWEST flat index feature * (n_bins - 1) + bin wins
// ties, or trees diverge), and the gamma check.
//
// The float sums are associated exactly as the compiled JAX program
// associates them, so the kernel, its plain version and the JAX package
// agree bitwise on the same histogram:
//   * the readout is a tree reduction in windows of 32 (the buckets padded
//     with zeros, half the padding in front), each window and then the
//     window sums added in order;
//   * the prefix scan works in blocks of 16 bins: in order within a block,
//     then each block adds the (recursively blocked) scan of the earlier
//     blocks' totals.
// The library is built with --fmad=false, so score() and the gain round as
// the plain PyTorch version does.
//
// Design: pass 0 is one thread per node (the readout); pass 1 is one CTA
// per (feature, node) in which thread t scans bins [16 t, 16 t + 16) and
// scores them, then a block argmax over (gain, bin); pass 2 is one thread
// per node: the argmax over features, keeping the first (lowest) feature on
// ties. What bounds it: reading the histogram once (n_nodes x F x nbt x 2
// floats); a candidate costs a few dozen flops.
#include "common.cuh"
#include <math.h>

#define XRT_SCAN_BLOCK 16
#define XRT_SPLIT_THREADS 64  // 64 blocks of 16 bins: max_bin <= 1024
#define XRT_MAX_WINDOWS 64

struct XrtSplitParams {
  float reg_lambda;
  float reg_alpha;
  float gamma;
  float min_child_weight;
};

__device__ __forceinline__ float xrt_soft_threshold(float g, float alpha) {
  const float s = g > 0.f ? 1.f : (g < 0.f ? -1.f : 0.f);
  return s * fmaxf(fabsf(g) - alpha, 0.f);
}

__device__ __forceinline__ float xrt_score(float g, float h,
                                           const XrtSplitParams& p) {
  const float t = xrt_soft_threshold(g, p.reg_alpha);
  const float den = h + p.reg_lambda;
  return den > 0.f ? (t * t) / fmaxf(den, 1e-38f) : 0.f;
}

__device__ __forceinline__ float xrt_gain(float gl, float hl, float gp,
                                          float hp, float parent_score,
                                          const XrtSplitParams& p) {
  const float gr = gp - gl;
  const float hr = hp - hl;
  const bool ok = (hl >= p.min_child_weight) && (hr >= p.min_child_weight);
  const float gain =
      (xrt_score(gl, hl, p) + xrt_score(gr, hr, p)) - parent_score;
  return ok ? gain : -INFINITY;
}

// better(a, b): a beats b under the first-max rule on (gain, index)
__device__ __forceinline__ bool xrt_better(float ga, int ia, float gb, int ib) {
  return ga > gb || (ga == gb && ia < ib);
}

// Sum of m values x[0], x[stride], ... in the tree-of-32-windows order.
__device__ float xrt_tree_sum(const float* x, int stride, int m) {
  float w[XRT_MAX_WINDOWS];
  int nw = m;
  bool direct = true;  // first round reads x, later rounds read w
  while (nw > 32) {
    const int nwin = (nw + 31) / 32;
    const int front = (nwin * 32 - nw) / 2;
    for (int k = 0; k < nwin; ++k) {
      float acc = 0.f;
      for (int j = 0; j < 32; ++j) {
        const int i = k * 32 + j - front;
        const float v = (i >= 0 && i < nw)
                            ? (direct ? x[(size_t)i * stride] : w[i]) : 0.f;
        acc += v;
      }
      w[k] = acc;  // safe in place: window k reads indices >= 32k - front > k
    }
    nw = nwin;
    direct = false;
  }
  float acc = 0.f;
  for (int i = 0; i < nw; ++i) acc += direct ? x[(size_t)i * stride] : w[i];
  return acc;
}

__global__ void xrt_split_totals_kernel(const float* __restrict__ hist,
                                        int n_nodes, int n_features, int nbt,
                                        float* __restrict__ node_gh) {
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n_nodes) return;
  const float* h0 = hist + (size_t)node * n_features * nbt * 2;  // feature 0
  node_gh[2 * node] = xrt_tree_sum(h0, 2, nbt);
  node_gh[2 * node + 1] = xrt_tree_sum(h0 + 1, 2, nbt);
}

__global__ void __launch_bounds__(XRT_SPLIT_THREADS)
xrt_split_feature_kernel(const float* __restrict__ hist,
                         const float* __restrict__ node_gh, int n_features,
                         int nbt, XrtSplitParams p, float* __restrict__ f_gain,
                         int* __restrict__ f_bin, uint8_t* __restrict__ f_dl) {
  __shared__ float tg[XRT_SPLIT_THREADS], th[XRT_SPLIT_THREADS];
  __shared__ float w_gain[XRT_SPLIT_THREADS / 32];
  __shared__ int w_idx[XRT_SPLIT_THREADS / 32];
  __shared__ int w_dl[XRT_SPLIT_THREADS / 32];
  const int f = blockIdx.x;
  const int node = blockIdx.y;
  const float* hrow = hist + ((size_t)node * n_features + f) * nbt * 2;
  const int nb = nbt - 1;    // present bins; bucket nb is "missing"
  const int ncand = nb - 1;  // candidate s: bins <= s go left
  const int nblk = (nb + XRT_SCAN_BLOCK - 1) / XRT_SCAN_BLOCK;
  const int t = threadIdx.x;
  const int b0 = t * XRT_SCAN_BLOCK;
  // in-order scan of this thread's block
  float lg[XRT_SCAN_BLOCK], lh[XRT_SCAN_BLOCK];
  float sg = 0.f, sh = 0.f;
#pragma unroll
  for (int j = 0; j < XRT_SCAN_BLOCK; ++j) {
    const int b = b0 + j;
    if (t < nblk && b < nb) {
      sg += hrow[2 * b];
      sh += hrow[2 * b + 1];
    }
    lg[j] = sg;
    lh[j] = sh;
  }
  tg[t] = sg;
  th[t] = sh;
  __syncthreads();
  // scan of the earlier blocks' totals: in order up to 16 blocks, else in
  // groups of 16 plus the in-order scan of the group totals
  bool has_pre = t > 0 && t < nblk;
  float pg = 0.f, ph = 0.f;
  if (has_pre) {
    const int last = t - 1;  // inclusive scan position
    const int grp = last / XRT_SCAN_BLOCK;
    if (nblk <= XRT_SCAN_BLOCK || grp == 0) {
      pg = tg[0];
      ph = th[0];
      for (int k = 1; k <= last; ++k) {
        pg += tg[k];
        ph += th[k];
      }
    } else {
      float gg = 0.f, gh = 0.f;  // in-order scan of earlier group totals
      for (int q = 0; q < grp; ++q) {
        float a = tg[q * XRT_SCAN_BLOCK], c = th[q * XRT_SCAN_BLOCK];
        for (int k = 1; k < XRT_SCAN_BLOCK; ++k) {
          a += tg[q * XRT_SCAN_BLOCK + k];
          c += th[q * XRT_SCAN_BLOCK + k];
        }
        if (q == 0) {
          gg = a;
          gh = c;
        } else {
          gg += a;
          gh += c;
        }
      }
      float wg = tg[grp * XRT_SCAN_BLOCK], wh = th[grp * XRT_SCAN_BLOCK];
      for (int k = grp * XRT_SCAN_BLOCK + 1; k <= last; ++k) {
        wg += tg[k];
        wh += th[k];
      }
      pg = wg + gg;
      ph = wh + gh;
    }
  }
  const float gm = hrow[2 * nb];
  const float hm = hrow[2 * nb + 1];
  const float gp = node_gh[2 * node];
  const float hp = node_gh[2 * node + 1];
  const float parent = xrt_score(gp, hp, p);
  float best = -INFINITY;
  int bidx = 0x7fffffff;
  int bdl = 1;
#pragma unroll
  for (int j = 0; j < XRT_SCAN_BLOCK; ++j) {
    const int s = b0 + j;
    if (t < nblk && s < ncand) {
      const float GL = has_pre ? lg[j] + pg : lg[j];
      const float HL = has_pre ? lh[j] + ph : lh[j];
      const float gml = xrt_gain(GL + gm, HL + hm, gp, hp, parent, p);
      const float gmr = xrt_gain(GL, HL, gp, hp, parent, p);
      const float gain = fmaxf(gml, gmr);
      if (xrt_better(gain, s, best, bidx)) {
        best = gain;
        bidx = s;
        bdl = gml >= gmr ? 1 : 0;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float og = __shfl_down_sync(0xffffffffu, best, o);
    const int oi = __shfl_down_sync(0xffffffffu, bidx, o);
    const int od = __shfl_down_sync(0xffffffffu, bdl, o);
    if (xrt_better(og, oi, best, bidx)) {
      best = og;
      bidx = oi;
      bdl = od;
    }
  }
  if ((t & 31) == 0) {
    w_gain[t >> 5] = best;
    w_idx[t >> 5] = bidx;
    w_dl[t >> 5] = bdl;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < XRT_SPLIT_THREADS / 32; ++w) {
      if (xrt_better(w_gain[w], w_idx[w], best, bidx)) {
        best = w_gain[w];
        bidx = w_idx[w];
        bdl = w_dl[w];
      }
    }
    const size_t o = (size_t)node * n_features + f;
    // no candidate at all (a single present bin): index 0, as jnp.argmax
    const bool none = bidx == 0x7fffffff;
    f_gain[o] = best;
    f_bin[o] = none ? 0 : bidx;
    f_dl[o] = none ? 1 : (uint8_t)bdl;
  }
}

__global__ void xrt_split_node_kernel(
    int n_nodes, int n_features, float gamma, const float* __restrict__ f_gain,
    const int* __restrict__ f_bin, const uint8_t* __restrict__ f_dl,
    float* __restrict__ gain, int* __restrict__ feature,
    int* __restrict__ split_bin, uint8_t* __restrict__ default_left,
    uint8_t* __restrict__ valid) {
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n_nodes) return;
  const size_t base = (size_t)node * n_features;
  int bf = 0;
  float bg = f_gain[base];
  for (int f = 1; f < n_features; ++f) {
    const float g = f_gain[base + f];
    if (g > bg) {  // equal gains keep the lower feature (lower flat index)
      bg = g;
      bf = f;
    }
  }
  gain[node] = bg;
  feature[node] = bf;
  split_bin[node] = f_bin[base + bf];
  default_left[node] = f_dl[base + bf];
  valid[node] = (isfinite(bg) && bg > gamma) ? 1 : 0;
}

// hist [n_nodes, F, nbt, 2]; scratch f_* [n_nodes * F]; outputs node_gh
// [n_nodes, 2] and [n_nodes] split records.
extern "C" int xrt_find_splits(const float* hist, int n_nodes, int n_features,
                               int nbt, float reg_lambda, float reg_alpha,
                               float gamma, float min_child_weight,
                               float* f_gain, int* f_bin, uint8_t* f_dl,
                               float* node_gh, float* gain, int* feature,
                               int* split_bin, uint8_t* default_left,
                               uint8_t* valid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nbt - 1 > XRT_SPLIT_THREADS * XRT_SCAN_BLOCK || nbt < 3)
    return (int)cudaErrorInvalidValue;
  XrtSplitParams p;
  p.reg_lambda = reg_lambda;
  p.reg_alpha = reg_alpha;
  p.gamma = gamma;
  p.min_child_weight = min_child_weight;
  const int t0 = 64;
  xrt_split_totals_kernel<<<(n_nodes + t0 - 1) / t0, t0, 0, s>>>(
      hist, n_nodes, n_features, nbt, node_gh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid1(n_features, n_nodes);
  xrt_split_feature_kernel<<<grid1, XRT_SPLIT_THREADS, 0, s>>>(
      hist, node_gh, n_features, nbt, p, f_gain, f_bin, f_dl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int t2 = 128;
  xrt_split_node_kernel<<<(n_nodes + t2 - 1) / t2, t2, 0, s>>>(
      n_nodes, n_features, gamma, f_gain, f_bin, f_dl, gain, feature,
      split_bin, default_left, valid);
  return (int)cudaGetLastError();
}
