// B8 — the forest walk of prediction, CUDA C++ for sm_90a.
//
// Replaces the JAX package's raw-x tree walk: xgboost_ray_tpu/ops/predict.py
// _walk_one_tree (:36), predict_margin (:52) and predict_leaf_index (:512),
// and their node-array twins in ops/node_array.py (_walk_levels :105,
// predict_margin_na :141, predict_leaf_index_na :171). Outputs: margins,
// values (the margins through the objective's transform, fused into the
// epilogue) or leaf heap indices.
//
// The forest comes as one packed 8-byte record per node (ops/predict.py
// pack_nodes, built once per model), in the padded-heap or the node-array
// order. Above the last level: a float (the threshold of a numeric split,
// the category code of a categorical one, the value of a leaf) and a word
// (the feature index, clamped to [0, F - 1], in 24 bits; the flags leaf,
// default-left and categorical above them). On the last level: the value a
// row ends with and the heap index of its leaf. Every node below a leaf
// holds a copy of the leaf's record, so every walk takes exactly max_depth
// steps and reads its value and leaf index at the last level: no leaf test
// per step, and walks of different rows and trees run in lock step. That
// costs the visits a shallow leaf saves; on the 500-tree HIGGS model the
// data needs 5.95 visits of 6 per (row, tree) (PERF.md), so a leaf
// test would save 1 % of the visits for about 2 of the 10-12 instructions a
// visit takes.
//
// Routing, as the reference's _step_right: NaN follows !default_left; a
// categorical feature goes right when rintf(x) (half to even, as jnp.round)
// differs from the code; else x >= threshold goes right.
//
// Sums over trees: a window-32 tree (32 trees a window, the padding half in
// front; the window sums, windowed again while more than 32, added in
// order: ops/split.tree_sum), the reference's compiled CPU reduce over more
// than 32 trees. Every sum starts at +0.0 and so is never -0.0: adding the
// +0.0 of a tree of another class, past ntree_limit or in the padding
// changes nothing, so such trees are skipped, and a window tree still open
// after the last tree is closed by carrying each level's partial sum up in
// order. Then base + sum / num_parallel_tree, and for XRT_VALUE the
// sigmoid, computed step by step as ops/objectives.sigmoid (every fused
// multiply-add of the plain version rounded as it rounds it: the exact
// product and the add in double, then to float; NaN propagated through
// the clamp and the max; results below 2^-126 flushed to +0.0).
// --fmad=false (ops/_build.py) keeps the leaf * weight product and the sums
// unfused, as the plain version is. Every mode is bitwise its plain
// version.
//
// Two mappings, one launch each (grid.y = the class of a margin):
//   rows (large batches): a CTA of 256 threads owns 512 rows, two a thread;
//     its x rows sit in shared memory feature-major ([F][512]), so a warp's
//     gathers at any features hit 32 distinct banks (an odd row stride
//     would keep only lanes at the same feature apart). The forest goes
//     through in tiles of trees_per_tile whole trees in heap order (either
//     layout is staged into it), double-buffered with cp.async: one tile is
//     copied from L2 while the CTA walks the previous one; 8-tree tiles
//     leave three CTAs an SM. A thread walks two trees for each of its two
//     rows in lock step (four chains of dependent shared-memory loads in
//     flight) on byte addresses, 8 instructions a step (record load,
//     gather address, gather, default-left flag, NaN test, compare, child
//     select, shift-add), and adds each tree's contribution to its rows'
//     window sums in registers in tree order, so no contribution array,
//     class array or per-chunk barrier is needed. Leaf indices go through a
//     [512][tile + 1] shared tile, written out row-contiguous (4 bytes a
//     tree of the tile: leaf launches take the largest tile a CTA holds).
//     When the tiles do not fit (very wide rows or deep trees) the same
//     walk reads x and the records from device memory.
//   windows (small batches, as serving sends): a CTA owns R = 1-8 rows and
//     all trees; one thread per (row, tree slot), two slots in lock step,
//     reads the records from device memory (L2) and leaves each
//     contribution in shared memory; then one thread per (row, window) sums
//     its window in order, and one per row carries the window sums up the
//     window tree.
//
// What bounds it: neither bytes nor arithmetic but shared-memory wavefronts
// and issue slots. A warp's visit is an 8-byte record load (2 wavefronts,
// more where its 32 rows sit at nodes 16 apart), a conflict-free gather (1)
// and 8 instructions, for every row, tree and level. The forest is re-read
// from L2 once per 512 rows (about 11 GB for 11M rows and a 500-tree
// depth-6 forest), which the double buffer overlaps with the walk.
#include "common.cuh"

#define XRT_WIN 32          // trees per window of the reference's reduce
#define XRT_LEVELS 4        // window levels (T < 2^20): partials 1..3
// rows mapping: rows a thread, trees a step (walks in flight: their
// product), CTAs an SM the registers must allow: 2 rows x 2 trees beat
// 2 x 1, 2 x 4 and one row a thread on the H100 (PERF.md).
// ops/predict.py's _ROW_TILE is XRT_ROW_TILE.
#define XRT_RPT 2
#define XRT_TPS 2
#define XRT_MIN_CTAS 3
#define XRT_ROW_TILE (XRT_RPT * XRT_THREADS)  // rows per CTA
#define XRT_FEATURE_MASK 0x00FFFFFFu  // above it: leaf (1 << 24, unread),
#define XRT_F_DEFAULT_LEFT (1u << 25)
#define XRT_F_CATEGORICAL (1u << 26)

enum { XRT_HEAP = 0, XRT_NODE_ARRAY = 1 };
enum { XRT_MARGIN = 0, XRT_LEAF_INDEX = 1, XRT_VALUE = 2 };
enum { XRT_ROWS = 0, XRT_WINDOWS = 1 };
enum { XRT_SUM = 0, XRT_LEAVES = 1 };  // kernel template: sums or leaves

// Mirrors ops/_build.PredictArgs field by field: edit both together.
struct XrtPredictArgs {
  const float* x;             // [n_rows, n_features] f32
  const uint2* nodes;         // [T * heap] packed records, layout order
  const float* tree_weights;  // [T] or null
  const float* base;          // [n_rows, K] or null (then base0)
  float* out_margin;          // [n_rows, K]
  int* out_leaf;              // [n_rows, T]
  long long n_rows;
  int n_features, n_trees, max_depth, ntree_limit, num_parallel_tree;
  int num_outputs;
  int layout, mode, mapping, has_cat;
  int rows_per_block;  // windows mapping: rows per CTA (1, 2, 4 or 8)
  int trees_per_tile;  // rows mapping: trees per staged tile (even)
  int staged;          // rows mapping: tiles in shared memory
  int shared_bytes;    // dynamic shared memory per CTA
  int front0, padded, top;  // the window tree (ops/predict.tree_windows)
  int m[XRT_LEVELS], front[XRT_LEVELS];
  float base0;
};

// Record of tree t, level k, slot p in device memory, in the layout's order.
__device__ __forceinline__ uint2 xrt_record(const XrtPredictArgs& a, int t,
                                            int k, int p, int heap) {
  const int pos = a.layout == XRT_HEAP
                      ? t * heap + (1 << k) - 1 + p
                      : a.n_trees * ((1 << k) - 1) + (t << k) + p;
  return __ldg(a.nodes + pos);
}

// Written as one boolean expression so that it compiles to predicate logic
// (x >= v is false for NaN; rintf(NaN) != v is not).
template <bool CAT>
__device__ __forceinline__ bool xrt_right(uint2 nd, float xv) {
  const float v = __uint_as_float(nd.x);
  const bool nan_right = isnan(xv) && !(nd.y & XRT_F_DEFAULT_LEFT);
  if (CAT && (nd.y & XRT_F_CATEGORICAL))
    return (!isnan(xv) && rintf(xv) != v) || nan_right;
  return xv >= v || nan_right;
}

// NC walks in lock step: node(c, k, p) is chain c's record at level k, slot
// p; xval(c, f) its row's feature f. leaf[c] gets the last-level record.
template <int NC, bool CAT, class Node, class XVal>
__device__ __forceinline__ void xrt_walk(int depth, Node node, XVal xval,
                                         uint2 (&leaf)[NC]) {
  int p[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) p[c] = 0;
  for (int k = 0; k < depth; ++k) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint2 nd = node(c, k, p[c]);
      p[c] = 2 * p[c] +
             (int)xrt_right<CAT>(nd, xval(c, nd.y & XRT_FEATURE_MASK));
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) leaf[c] = node(c, depth, p[c]);
}

// The same walk over a heap-ordered tile in shared memory, on byte
// addresses: chain c's tree starts at byte tree[c] of sm, its row's
// feature f is the float at byte xrow[c] + f * XRT_ROW_TILE * 4. A node at
// heap index h sits at tree + 8h and its child 2h + 1 + right at
// 2 (tree + 8h) + 8 - tree + 8 right: one select and one shift-add a step.
template <int NC, bool CAT>
__device__ __forceinline__ void xrt_walk_shared(
    int depth, const unsigned char* sm, const unsigned (&tree)[NC],
    const unsigned (&xrow)[NC], uint2 (&leaf)[NC]) {
  unsigned at[NC], left[NC], right[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    at[c] = tree[c];
    left[c] = 8u - tree[c];
    right[c] = 16u - tree[c];
  }
  for (int k = 0; k < depth; ++k) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint2 nd = *(const uint2*)(sm + at[c]);
      const float xv = *(const float*)(
          sm + xrow[c] + (nd.y & XRT_FEATURE_MASK) * (XRT_ROW_TILE * 4u));
      at[c] = 2u * at[c] + (xrt_right<CAT>(nd, xv) ? right[c] : left[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) leaf[c] = *(const uint2*)(sm + at[c]);
}

// One (row, class)'s sums up the window tree: part[lv] is the running sum
// of the open window of level lv + 1 (part[0] unused). Item j of level 1 (a
// window sum) is added, closing every window it ends.
__device__ __forceinline__ void xrt_push(const XrtPredictArgs& a,
                                         float (&part)[XRT_LEVELS], float v,
                                         int j) {
  part[1] += v;
#pragma unroll
  for (int lv = 1; lv < XRT_LEVELS - 1; ++lv) {
    if (lv >= a.top || (j + a.front[lv] + 1) % XRT_WIN != 0) break;
    part[lv + 1] += part[lv];
    part[lv] = 0.f;
    j = (j + a.front[lv]) / XRT_WIN;
  }
}

// Close what is still open after the last tree, level by level, and return
// the total. The zeros the reference adds after it change no sum.
__device__ __forceinline__ float xrt_total(const XrtPredictArgs& a,
                                           float (&part)[XRT_LEVELS],
                                           float ws) {
  part[1] += ws;
#pragma unroll
  for (int lv = 1; lv < XRT_LEVELS - 1; ++lv)
    if (lv < a.top) part[lv + 1] += part[lv];
  return a.top == 1 ? part[1] : a.top == 2 ? part[2] : part[3];
}

// fma as the plain version's _fma rounds it: the product of two floats is
// exact in double, the add rounds there, then to float.
__device__ __forceinline__ float xrt_fma_f32(float a, float b, float c) {
  return __double2float_rn((double)a * (double)b + (double)c);
}

// ops/objectives.sigmoid: 1 / (1 + exp_f32(-m)), flushed below 2^-126.
__device__ float xrt_sigmoid(float m) {
  const float v = -m;
  const float xc =
      isnan(v) ? v : fminf(fmaxf(v, -88.3762626647949f), 88.3762626647950f);
  const float fx = floorf(xrt_fma_f32(xc, 1.44269504088896341f, 0.5f));
  float x = xrt_fma_f32(fx, -0.693359375f, xc);
  x = xrt_fma_f32(fx, 2.12194440e-4f, x);
  const float z = x * x;
  float y = xrt_fma_f32(x, 1.9875691500e-4f, 1.3981999507e-3f);
  y = xrt_fma_f32(y, x, 8.3334519073e-3f);
  y = xrt_fma_f32(y, x, 4.1665795894e-2f);
  y = xrt_fma_f32(y, x, 1.6666665459e-1f);
  y = xrt_fma_f32(y, x, 5.0000001201e-1f);
  y = 1.0f + xrt_fma_f32(y, z, x);
  float e = y * __int_as_float(((int)fx + 127) << 23);
  e = isnan(e) ? e : (isnan(v) ? v : fmaxf(e, v));  // torch.maximum
  const float p = 1.0f / (1.0f + e);
  return p < 1.17549435e-38f ? 0.f : p;
}

__device__ __forceinline__ void xrt_write(const XrtPredictArgs& a,
                                          long long row, int k, float s) {
  const long long o = row * a.num_outputs + k;
  const float b = a.base != nullptr ? a.base[o] : a.base0;
  const float margin = b + s / (float)a.num_parallel_tree;
  a.out_margin[o] = a.mode == XRT_VALUE ? xrt_sigmoid(margin) : margin;
}

// Trees the margins walk: ntree_limit cuts them (the rest add +0.0).
__device__ __forceinline__ int xrt_walked_trees(const XrtPredictArgs& a) {
  return a.ntree_limit > 0 ? min(a.ntree_limit, a.n_trees) : a.n_trees;
}

__device__ __forceinline__ bool xrt_in_class(const XrtPredictArgs& a, int t,
                                             int k) {
  return a.num_outputs == 1 ||
         (t / a.num_parallel_tree) % a.num_outputs == k;
}

__device__ __forceinline__ void xrt_cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

// Copy trees [t0, t0 + nt) into buf in heap order ([nt][heap]).
__device__ __forceinline__ void xrt_stage(const XrtPredictArgs& a, uint2* buf,
                                          int t0, int nt, int heap) {
  for (int h = threadIdx.x; h < heap; h += XRT_THREADS) {
    const int k = 31 - __clz(h + 1);
    const int p = h + 1 - (1 << k);
    long long src, step;
    if (a.layout == XRT_HEAP) {
      src = (long long)t0 * heap + h;
      step = heap;
    } else {
      src = (long long)a.n_trees * ((1 << k) - 1) + ((long long)t0 << k) + p;
      step = 1 << k;
    }
    for (int tl = 0; tl < nt; ++tl)
      xrt_cp_async8(buf + tl * heap + h, a.nodes + src + tl * step);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// ---------------------------------------------------------------------------
// rows mapping
// ---------------------------------------------------------------------------

template <int MODE, bool STAGED, bool CAT>
__global__ void __launch_bounds__(XRT_THREADS, XRT_MIN_CTAS)
    xrt_rows_kernel(const XrtPredictArgs a) {
  constexpr int NC = XRT_RPT * XRT_TPS;  // chains: c = tree * RPT + row
  extern __shared__ __align__(16) unsigned char smem[];
  const int heap = (2 << a.max_depth) - 1;
  const int F = a.n_features;
  const int TT = a.trees_per_tile;
  const int cls = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * XRT_ROW_TILE;
  uint2* tiles = (uint2*)smem;  // [2][TT][heap]
  float* xs = (float*)(tiles + (STAGED ? 2 * TT * heap : 0));  // [F][tile]
  int* outs = (int*)(xs + (STAGED ? F * XRT_ROW_TILE : 0));  // [tile][TT+1]
  int r[XRT_RPT];
  const float* xrow[XRT_RPT];
#pragma unroll
  for (int i = 0; i < XRT_RPT; ++i) {
    r[i] = threadIdx.x + i * XRT_THREADS;
    const long long g = row0 + r[i];
    xrow[i] = a.x + (g < a.n_rows ? g : 0) * F;
  }
  const int n_walk = MODE == XRT_LEAVES ? a.n_trees : xrt_walked_trees(a);
  const int n_tiles = (n_walk + TT - 1) / TT;

  if constexpr (STAGED) {
    // each thread copies its own rows (16 bytes a load where rows allow):
    // the row's next loads hit the same sectors in L1, and lanes of
    // consecutive rows write distinct banks
    if ((F & 3) == 0 && ((uintptr_t)a.x & 15) == 0) {
      for (int f = 0; f < F; f += 4) {
#pragma unroll
        for (int i = 0; i < XRT_RPT; ++i) {
          const float4 v = row0 + r[i] < a.n_rows
                               ? __ldg((const float4*)(xrow[i] + f))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          xs[f * XRT_ROW_TILE + r[i]] = v.x;
          xs[(f + 1) * XRT_ROW_TILE + r[i]] = v.y;
          xs[(f + 2) * XRT_ROW_TILE + r[i]] = v.z;
          xs[(f + 3) * XRT_ROW_TILE + r[i]] = v.w;
        }
      }
    } else {
      for (int f = 0; f < F; ++f) {
#pragma unroll
        for (int i = 0; i < XRT_RPT; ++i)
          xs[f * XRT_ROW_TILE + r[i]] =
              row0 + r[i] < a.n_rows ? __ldg(xrow[i] + f) : 0.f;
      }
    }
    if (n_tiles > 0) xrt_stage(a, tiles, 0, min(TT, n_walk), heap);
  }

  float ws[XRT_RPT] = {};
  float part[XRT_RPT][XRT_LEVELS] = {};
  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = i * TT;
    const int nt = min(TT, n_walk - t0);
    const uint2* tile = tiles + (i & 1) * TT * heap;
    if constexpr (STAGED) {
      if (i + 1 < n_tiles) {
        xrt_stage(a, tiles + ((i + 1) & 1) * TT * heap, t0 + TT,
                  min(TT, n_walk - t0 - TT), heap);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
    }
    if (STAGED || MODE == XRT_LEAVES) __syncthreads();
    for (int tl = 0; tl < nt; tl += XRT_TPS) {
      // the step's trees; past the tile's last tree a chain walks it again
      int ts[XRT_TPS];
#pragma unroll
      for (int s = 0; s < XRT_TPS; ++s) ts[s] = min(tl + s, nt - 1);
      uint2 leaf[NC];
      if constexpr (STAGED) {
        unsigned tree[NC], xrow_at[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tree[c] = (unsigned)((const unsigned char*)(
                        tile + ts[c / XRT_RPT] * heap) - smem);
          xrow_at[c] = (unsigned)((const unsigned char*)(
                           xs + r[c % XRT_RPT]) - smem);
        }
        xrt_walk_shared<NC, CAT>(a.max_depth, smem, tree, xrow_at, leaf);
      } else {
        xrt_walk<NC, CAT>(
            a.max_depth,
            [&](int c, int k, int p) {
              return xrt_record(a, t0 + ts[c / XRT_RPT], k, p, heap);
            },
            [&](int c, unsigned f) { return __ldg(xrow[c % XRT_RPT] + f); },
            leaf);
      }
#pragma unroll
      for (int s = 0; s < XRT_TPS; ++s) {
        if (s > 0 && tl + s >= nt) break;
        const int t = t0 + tl + s;
        if constexpr (MODE == XRT_LEAVES) {
#pragma unroll
          for (int i = 0; i < XRT_RPT; ++i)
            outs[r[i] * (TT + 1) + tl + s] = (int)leaf[s * XRT_RPT + i].y;
        } else {
          if (xrt_in_class(a, t, cls)) {
            const float w =
                a.tree_weights != nullptr ? __ldg(a.tree_weights + t) : 1.f;
#pragma unroll
            for (int i = 0; i < XRT_RPT; ++i) {
              const float v = __uint_as_float(leaf[s * XRT_RPT + i].x);
              ws[i] += a.tree_weights != nullptr ? v * w : v;
            }
          }
          if (((a.front0 + t) & (XRT_WIN - 1)) == XRT_WIN - 1) {
            const int j = (a.front0 + t) / XRT_WIN;
#pragma unroll
            for (int i = 0; i < XRT_RPT; ++i) {
              xrt_push(a, part[i], ws[i], j);
              ws[i] = 0.f;
            }
          }
        }
      }
    }
    if (STAGED || MODE == XRT_LEAVES) __syncthreads();
    if constexpr (MODE == XRT_LEAVES) {
      // TT is a power of two: row e / TT, tree slot e % TT
      const int lg = __ffs(TT) - 1;
      for (int e = threadIdx.x; e < XRT_ROW_TILE * TT; e += XRT_THREADS) {
        const int rr = e >> lg;
        const int tl = e & (TT - 1);
        const long long g = row0 + rr;
        if (tl < nt && g < a.n_rows)
          a.out_leaf[g * a.n_trees + t0 + tl] = outs[rr * (TT + 1) + tl];
      }
    }
  }
  if constexpr (MODE == XRT_SUM) {
#pragma unroll
    for (int i = 0; i < XRT_RPT; ++i) {
      const float s = xrt_total(a, part[i], ws[i]);
      if (row0 + r[i] < a.n_rows) xrt_write(a, row0 + r[i], cls, s);
    }
  }
}

// ---------------------------------------------------------------------------
// windows mapping
// ---------------------------------------------------------------------------

template <int MODE, bool CAT>
__global__ void __launch_bounds__(XRT_THREADS)
    xrt_windows_kernel(const XrtPredictArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = a.rows_per_block;
  const int TC = XRT_THREADS / R;  // tree slots a row's threads take at once
  const int heap = (2 << a.max_depth) - 1;
  const int cls = blockIdx.y;
  const int r = threadIdx.x / TC;
  const int tt = threadIdx.x % TC;
  const long long row0 = (long long)blockIdx.x * R;
  const long long row = row0 + r;
  const bool row_ok = row < a.n_rows;
  const float* xrow = a.x + (row_ok ? row : 0) * a.n_features;
  auto xval = [&](int, unsigned f) { return __ldg(xrow + f); };

  if constexpr (MODE == XRT_LEAVES) {
    if (!row_ok) return;
    int* out = a.out_leaf + row * a.n_trees;
    for (int t = tt; t < a.n_trees; t += 2 * TC) {
      const int tg[2] = {t, t + TC < a.n_trees ? t + TC : t};
      uint2 leaf[2];
      xrt_walk<2, CAT>(
          a.max_depth,
          [&](int c, int k, int p) { return xrt_record(a, tg[c], k, p, heap); },
          xval, leaf);
      out[t] = (int)leaf[0].y;
      if (t + TC < a.n_trees) out[t + TC] = (int)leaf[1].y;
    }
    return;
  }

  // contributions by padded slot, windows 33 words apart ([R][m1][33]):
  // the writers (consecutive slots) and the window summers (consecutive
  // windows) both hit distinct banks
  const int m1 = a.m[1];
  float* contrib = (float*)smem;
  float* wsum = contrib + R * m1 * (XRT_WIN + 1);  // [R][m1]
  const int n_walk = xrt_walked_trees(a);
  for (int s0 = tt; s0 < a.padded; s0 += 2 * TC) {
    bool ok[2];
    int tg[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int t = s0 + c * TC - a.front0;
      ok[c] = row_ok && s0 + c * TC < a.padded && t >= 0 && t < n_walk &&
              xrt_in_class(a, t, cls);
      tg[c] = min(max(t, 0), a.n_trees - 1);
    }
    float v[2] = {0.f, 0.f};
    if (ok[0] || ok[1]) {
      uint2 leaf[2];
      xrt_walk<2, CAT>(
          a.max_depth,
          [&](int c, int k, int p) { return xrt_record(a, tg[c], k, p, heap); },
          xval, leaf);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (!ok[c]) continue;
        v[c] = __uint_as_float(leaf[c].x);
        if (a.tree_weights != nullptr)
          v[c] = v[c] * __ldg(a.tree_weights + tg[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int s = s0 + c * TC;
      if (s < a.padded)
        contrib[(r * m1 + s / XRT_WIN) * (XRT_WIN + 1) + s % XRT_WIN] = v[c];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * m1; i += XRT_THREADS) {
    const float* cw = contrib + i * (XRT_WIN + 1);
    float s = 0.f;
#pragma unroll 8
    for (int j = 0; j < XRT_WIN; ++j) s += cw[j];
    wsum[i] = s;
  }
  __syncthreads();
  if (threadIdx.x < R && row0 + threadIdx.x < a.n_rows) {
    float part[XRT_LEVELS] = {};
    const float* w = wsum + threadIdx.x * m1;
    for (int j = 0; j < m1; ++j) xrt_push(a, part, w[j], j);
    xrt_write(a, row0 + threadIdx.x, cls, xrt_total(a, part, 0.f));
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <class Kernel>
static int xrt_launch(Kernel kernel, dim3 grid, const XrtPredictArgs* a,
                      cudaStream_t s) {
  if (a->shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->shared_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, XRT_THREADS, a->shared_bytes, s>>>(*a);
  return (int)cudaGetLastError();
}

template <int MODE, bool CAT>
static int xrt_dispatch(const XrtPredictArgs* a, cudaStream_t s) {
  const unsigned classes = MODE == XRT_LEAVES ? 1u : (unsigned)a->num_outputs;
  if (a->mapping == XRT_WINDOWS) {
    const long long blocks =
        (a->n_rows + a->rows_per_block - 1) / a->rows_per_block;
    return xrt_launch(xrt_windows_kernel<MODE, CAT>,
                      dim3((unsigned)blocks, classes), a, s);
  }
  const dim3 grid(
      (unsigned)((a->n_rows + XRT_ROW_TILE - 1) / XRT_ROW_TILE), classes);
  return a->staged ? xrt_launch(xrt_rows_kernel<MODE, true, CAT>, grid, a, s)
                   : xrt_launch(xrt_rows_kernel<MODE, false, CAT>, grid, a, s);
}

extern "C" int xrt_predict(const XrtPredictArgs* a, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int R = a->rows_per_block;
  const int TT = a->trees_per_tile;
  if (R < 1 || R > 8 || (R & (R - 1)) != 0 || TT < 2 || (TT & (TT - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int mode = a->mode == XRT_LEAF_INDEX ? XRT_LEAVES : XRT_SUM;
  if (mode == XRT_LEAVES)
    return a->has_cat ? xrt_dispatch<XRT_LEAVES, true>(a, s)
                      : xrt_dispatch<XRT_LEAVES, false>(a, s);
  return a->has_cat ? xrt_dispatch<XRT_SUM, true>(a, s)
                    : xrt_dispatch<XRT_SUM, false>(a, s);
}
