// B8 — the forest walk of prediction, CUDA C++ for sm_90a.
//
// Replaces the JAX package's raw-x tree walk: xgboost_ray_tpu/ops/predict.py
// _walk_one_tree (:36), predict_margin (:52) and predict_leaf_index (:512),
// and their node-array twins in ops/node_array.py (_walk_levels :105,
// predict_margin_na :141, predict_leaf_index_na :171). One kernel; the
// forest layout (padded heap or breadth-first node array) and the mode
// (margins or leaf indices) are template parameters. The layouts differ
// only in where node (tree t, level k, slot p) lives:
//   heap:       t * heap + 2^k - 1 + p
//   node array: T * (2^k - 1) + t * 2^k + p
//
// Work split: a CTA of 256 threads owns R rows (R = 1, 2, 4 or 8, chosen
// by the wrapper so that a small batch still fills the card) and walks the
// trees in chunks of TC = 256 / R: thread i walks tree (chunk + i / R) for
// row (i % R), so even a one-row request spreads its trees over a CTA. In
// the leaf mode each thread writes its heap index and goes on. In the
// margin mode each thread leaves its tree's contribution (leaf value times
// the tree weight; 0.0 past ntree_limit) in shared memory, and the sums
// take the plain version's order: a window-32 tree (32 trees a window, the
// padding half in front; the window sums, windowed again while more than
// 32, added in order), which is the reference's compiled CPU reduce over
// more than 32 trees. Chunks are aligned to those windows (TC is a
// multiple of 32), so one thread per (row, class, window) sums a window's
// trees in tree order, and one thread per (row, class) adds the window sums
// up the window tree (partials per level in shared memory). The result is
// bitwise the plain version's; then base + sum / npt.
//
// Routing (ops/predict.py:23-33): NaN follows !default_left; a categorical
// feature goes right when rintf(x) (half to even, as jnp.round) differs from
// split_bin; else x >= threshold goes right. The feature index is clamped
// to [0, F - 1] before the gather (leaves and unused slots hold -1). A row
// stops at its first leaf; a row that meets none reads value at the node it
// reaches at level max_depth. --fmad=false (ops/_build.py) keeps the
// leaf * weight product and the sums unfused, as the plain version is.
//
// What bounds it: neither bytes nor arithmetic, but the chain of dependent
// loads. Each level of a walk loads the node's fields, then x[row, f] at
// the feature it names, then the next node: about 2 x depth dependent
// loads per (row, tree), from L1/L2 (a 500-tree depth-6 forest is about
// 1 MB and stays in L2). Node fields are read through the read-only path
// (__ldg), the x row from device memory. Later designs: stage the forest
// and an x tile in shared memory, pack a node in 8 bytes, walk several
// trees per thread for more loads in flight, a persistent tree-tiled grid,
// and overlap the window sums with the next chunk's walk.
#include "common.cuh"

#define XRT_WIN 32     // trees per window of the reference's reduce
#define XRT_LEVELS 4   // window levels (T < 2^20)

enum { XRT_HEAP = 0, XRT_NODE_ARRAY = 1 };
enum { XRT_MARGIN = 0, XRT_LEAF = 1 };

// Mirrors ops/_build.PredictArgs field by field: edit both together.
struct XrtPredictArgs {
  const float* x;                // [n_rows, n_features] f32
  const int* feature;            // [T * heap] in the layout's order
  const int* split_bin;
  const float* threshold;
  const unsigned char* default_left;
  const unsigned char* is_leaf;
  const float* value;
  const unsigned char* cat_mask;  // [n_features] or null
  const float* tree_weights;      // [T] or null
  const float* base;              // [n_rows, K] or null (then base0)
  float* out_margin;              // [n_rows, K]
  int* out_leaf;                  // [n_rows, T]
  long long n_rows;
  int n_features, n_trees, max_depth, ntree_limit, num_parallel_tree;
  int num_outputs, rows_per_block;
  int front0, padded, top;       // the window tree (ops/predict.tree_windows)
  int m[XRT_LEVELS], front[XRT_LEVELS];
  float base0;
};

template <int LAYOUT>
__device__ __forceinline__ int xrt_node(int t, int k, int p, int n_trees,
                                        int heap) {
  return LAYOUT == XRT_HEAP ? t * heap + (1 << k) - 1 + p
                            : n_trees * ((1 << k) - 1) + (t << k) + p;
}

// Walk tree t for the row at xrow; *val = its leaf value; returns the leaf's
// heap index.
template <int LAYOUT>
__device__ __forceinline__ int xrt_walk(const XrtPredictArgs& a,
                                        const float* __restrict__ xrow, int t,
                                        int heap, float* val) {
  int p = 0;
  for (int k = 0; k < a.max_depth; ++k) {
    const int pos = xrt_node<LAYOUT>(t, k, p, a.n_trees, heap);
    if (__ldg(a.is_leaf + pos)) {
      *val = __ldg(a.value + pos);
      return (1 << k) - 1 + p;
    }
    const int f = min(max(__ldg(a.feature + pos), 0), a.n_features - 1);
    const float xv = __ldg(xrow + f);
    bool right;
    if (isnan(xv)) {
      right = !__ldg(a.default_left + pos);
    } else if (a.cat_mask != nullptr && __ldg(a.cat_mask + f)) {
      right = rintf(xv) != (float)__ldg(a.split_bin + pos);
    } else {
      right = xv >= __ldg(a.threshold + pos);
    }
    p = 2 * p + (int)right;
  }
  *val = __ldg(a.value + xrt_node<LAYOUT>(t, a.max_depth, p, a.n_trees, heap));
  return (1 << a.max_depth) - 1 + p;
}

// Add item j of window level `lv` (a window sum, or a sum of them) to the
// partials of one (row, class), closing every window it ends.
__device__ __forceinline__ void xrt_push(const XrtPredictArgs& a,
                                         float* part, float v, int j) {
  int lv = 1;
  part[lv] += v;
  while (lv < a.top &&
         ((j + a.front[lv] + 1) % XRT_WIN == 0 || j == a.m[lv] - 1)) {
    part[lv + 1] += part[lv];
    part[lv] = 0.f;
    j = (j + a.front[lv]) / XRT_WIN;
    ++lv;
  }
}

template <int LAYOUT, int MODE>
__global__ void __launch_bounds__(XRT_THREADS)
    xrt_predict_kernel(const XrtPredictArgs a) {
  extern __shared__ float smem[];
  const int R = a.rows_per_block;
  const int TC = XRT_THREADS / R;  // trees per chunk, a multiple of 32
  const int W = TC / XRT_WIN;      // windows per chunk
  const int K = a.num_outputs;
  const int heap = (2 << a.max_depth) - 1;
  const int r = threadIdx.x % R;
  const int tt = threadIdx.x / R;
  const long long row0 = (long long)blockIdx.x * R;
  const long long row = row0 + r;
  const bool row_ok = row < a.n_rows;
  const float* xrow = a.x + (row_ok ? row : 0) * a.n_features;

  if constexpr (MODE == XRT_LEAF) {
    if (!row_ok) return;
    int* out = a.out_leaf + row * a.n_trees;
    for (int t = tt; t < a.n_trees; t += TC) {
      float v;
      out[t] = xrt_walk<LAYOUT>(a, xrow, t, heap, &v);
    }
    return;
  }

  float* contrib = smem;                             // [TC][R]
  int* tcls = (int*)(contrib + XRT_THREADS);         // [TC] class of a slot
  float* wsum = (float*)(tcls + XRT_THREADS);        // [R * K][W]
  float* part = wsum + R * K * W;                    // [R * K][XRT_LEVELS]
  const int pairs = R * K;
  for (int i = threadIdx.x; i < pairs * XRT_LEVELS; i += XRT_THREADS)
    part[i] = 0.f;
  for (int c0 = 0; c0 < a.padded; c0 += TC) {
    const int t = c0 + tt - a.front0;
    float c = 0.f;
    if (row_ok && t >= 0 && t < a.n_trees &&
        (a.ntree_limit == 0 || t < a.ntree_limit)) {
      float v;
      xrt_walk<LAYOUT>(a, xrow, t, heap, &v);
      c = a.tree_weights != nullptr ? v * __ldg(a.tree_weights + t) : v;
    }
    contrib[tt * R + r] = c;
    if (r == 0) tcls[tt] = K == 1 ? 0 : (max(t, 0) / a.num_parallel_tree) % K;
    __syncthreads();
    // each window of the chunk: its trees of one class, in tree order. A
    // slot outside the forest holds 0.0 and another class's tree adds 0.0:
    // neither changes a sum that starts at +0.0 (it is never -0.0), as the
    // plain version's zero padding does not
    for (int i = threadIdx.x; i < pairs * W; i += XRT_THREADS) {
      const int win = i % W;
      const int rk = i / W;
      const int k = rk % K;
      const float* cw = contrib + win * XRT_WIN * R + rk / K;
      const int* kw = tcls + win * XRT_WIN;
      float s = 0.f;
#pragma unroll 8
      for (int j = 0; j < XRT_WIN; ++j) s += kw[j] == k ? cw[j * R] : 0.f;
      wsum[i] = s;
    }
    __syncthreads();
    // the window sums, in order, up the window tree
    for (int rk = threadIdx.x; rk < pairs; rk += XRT_THREADS) {
      for (int win = 0; win < W; ++win) {
        const int j = c0 / XRT_WIN + win;
        if (j >= a.m[1]) break;
        xrt_push(a, part + rk * XRT_LEVELS, wsum[rk * W + win], j);
      }
    }
    // contrib and wsum are written again only after the next barrier
  }
  for (int rk = threadIdx.x; rk < pairs; rk += XRT_THREADS) {
    const long long rw = row0 + rk / K;
    if (rw >= a.n_rows) continue;
    const int k = rk % K;
    const long long o = rw * K + k;
    const float b = a.base != nullptr ? a.base[o] : a.base0;
    a.out_margin[o] =
        b + part[rk * XRT_LEVELS + a.top] / (float)a.num_parallel_tree;
  }
}

template <int LAYOUT, int MODE>
static int launch_predict(const XrtPredictArgs* a, cudaStream_t s) {
  const int R = a->rows_per_block;
  const long long blocks = (a->n_rows + R - 1) / R;
  size_t smem = 0;
  if constexpr (MODE == XRT_MARGIN) {
    const int W = XRT_THREADS / R / XRT_WIN;
    smem = sizeof(float) * (2 * XRT_THREADS + (size_t)R * a->num_outputs * W +
                            (size_t)R * a->num_outputs * XRT_LEVELS);
  }
  xrt_predict_kernel<LAYOUT, MODE>
      <<<(unsigned)blocks, XRT_THREADS, smem, s>>>(*a);
  return (int)cudaGetLastError();
}

// layout: 0 heap, 1 node array; mode: 0 margins, 1 leaf indices.
extern "C" int xrt_predict(const XrtPredictArgs* a, int layout, int mode,
                           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int R = a->rows_per_block;
  if (R < 1 || R > 8 || (R & (R - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (layout == XRT_HEAP)
    return mode == XRT_MARGIN ? launch_predict<XRT_HEAP, XRT_MARGIN>(a, s)
                              : launch_predict<XRT_HEAP, XRT_LEAF>(a, s);
  return mode == XRT_MARGIN ? launch_predict<XRT_NODE_ARRAY, XRT_MARGIN>(a, s)
                            : launch_predict<XRT_NODE_ARRAY, XRT_LEAF>(a, s);
}
