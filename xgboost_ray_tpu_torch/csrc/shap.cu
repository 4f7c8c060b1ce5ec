// B15 — SHAP values on raw features, CUDA C++ for sm_90a.
//
// Replaces the JAX package's XLA formulations in xgboost_ray_tpu/ops/
// predict.py (no Pallas kernel was written for them): predict_contribs
// (:82-146, Saabas path attribution), predict_contribs_exact (exact
// TreeSHAP, _shap_one_tree :252, :299-347) and predict_interactions
// (_shap_interactions_one_tree :350-446, :449-498). Three entry points,
// one launch each: xrt_shap_saabas, xrt_shap_exact, xrt_shap_interactions.
//
// Inputs: the forest's SHAP tables (ops/shap.py shap_forest, built once per
// model): per heap node a packed 8-byte record (split value; feature |
// leaf | default-left | categorical, as B8's) and its base weight; per tree
// its canonical leaves in slot order, each with its path steps (node |
// branch bit << 24 | element << 25) and its merged elements (the tree's
// feature slot, the cover ratio z), the leaf value and element count m;
// the tree's split features ascending; the Shapley weight table; per call
// the tree scales and classes and the row-independent bias column.
//
// Mapping: one thread owns one row for the whole forest, so a row's result
// depends on nothing else in the launch and reruns are bitwise (no atomics;
// every sum runs in the plain version's order: a leaf's elements in path
// order, a tree's leaves in slot order, the trees in order). The threads of
// a warp walk the same tree, leaf and element in lock step: every table
// read is a broadcast, and the per-row state lives in a scratch the wrapper
// allocates, transposed ([word][row]), so the warp's read-modify-writes of
// a feature's sum are coalesced: the class accumulators (K x F, for
// interactions K x F x F and the feature-bias column), then the current
// tree's per-slot sums. The output row is written once at the end (its
// bias column from the wrapper's host sums; Phi[F][F] = E - sum of the
// feature-bias column).
//
// Per leaf: the elements' indicators o(x) (each step's routing test, the
// product over the steps merged into an element), EXTEND of prod_e (z_e +
// o_e t) into registers, then per element UNWIND (o == 1: the downward
// recurrence r[k-1] = q[k] - z r[k]; o == 0: the guarded quotient q[k] / z)
// and v (o - z) sum_k r[k] w[m][k]. Interactions add, per element i, the
// prefix-free product of the other z's (the feature-bias term), the
// polynomial with i unwound, and for each other element j that polynomial
// unwound by j, weighted by w[m - 1]. Arrays are MAXD wide (8 for trees up
// to depth 8, else 16): loops run over MAXD with m-predicates; at width 8
// they unroll, so indices are compile-time and the arrays stay in
// registers.
// --fmad=false (ops/_build.py) keeps every product and sum unfused, as the
// plain version computes them.
//
// What bounds it: operations. Per row and tree, exact TreeSHAP needs about
// sum over leaves of 4 m^2 + 1.5 m^2 f32 operations (EXTEND, then an
// UNWIND and a weighted sum per element), interactions about m times that;
// Saabas a few per step of one walk (chip_smoke.py counts them from the
// forest's actual leaves: ops/shap.leaf_ops). The bytes (x read once, the
// output written once) are far below. A thread's work is serial, so the
// launch needs rows for the card's ~270,000 resident threads: small batches
// (serving) leave most of the card idle.
//
// The later lever: GPUTreeShap's design (Mitchell, Frank and Holmes, 2022):
// path elements across a warp's lanes, EXTEND and UNWIND by shuffles, paths
// bin-packed into warps, so a row's work spreads over 32 lanes and small
// batches fill the card. Not built here.
#include "common.cuh"

#define XRT_SHAP_THREADS 128
#define XRT_FEATURE_MASK 0x00FFFFFFu
#define XRT_F_LEAF (1u << 24)
#define XRT_F_DEFAULT_LEFT (1u << 25)
#define XRT_F_CATEGORICAL (1u << 26)
#define XRT_NODE_MASK 0x00FFFFFF
#define XRT_BIT_SHIFT 24
#define XRT_ELEM_SHIFT 25

// Mirrors ops/_build.ShapArgs field by field: edit both together.
struct XrtShapArgs {
  const float* x;            // [n_rows, n_features] f32
  const uint2* nodes;        // [T * heap] split records
  const float* base_weight;  // [T * heap]
  const int* steps;          // [T, L, DD]: node | bit << 24 | element << 25
  const int* elem_slot;      // [T, L, DD]
  const float* elem_z;       // [T, L, DD]
  const float* leaf_value;   // [T, L]
  const int* leaf_m;         // [T, L]
  const int* n_leaves;       // [T]
  const int* tree_feats;     // [T, U]
  const int* n_feats;        // [T]
  const float* weights;      // [D + 1, weights_width]
  const float* scale;        // [T]
  const int* tree_class;     // [T]
  const float* bias;         // [K]
  float* scratch;            // [words][n_rows]
  float* out;                // [n_rows, K, F + 1] or [n_rows, K, F + 1, F + 1]
  long long n_rows;
  int n_features, n_trees, max_depth, max_leaves, max_feats, num_outputs;
  int has_cat, weights_width;
};

// The port's routing rule (ops/predict._step_right), as B8's xrt_right;
// cat: the forest has categorical splits (uniform over the launch).
__device__ __forceinline__ bool xrt_shap_right(uint2 nd, float xv, bool cat) {
  const float v = __uint_as_float(nd.x);
  const bool nan_right = isnan(xv) && !(nd.y & XRT_F_DEFAULT_LEFT);
  if (cat && (nd.y & XRT_F_CATEGORICAL))
    return (!isnan(xv) && rintf(xv) != v) || nan_right;
  return xv >= v || nan_right;
}

// Loops over path elements (#pragma unroll (MAXD <= 8 ? MAXD : 1)) unroll
// at width 8, so the register arrays keep compile-time indices; at width 16
// (trees deeper than 8) they stay rolled and the arrays go to local memory:
// fully unrolled, the interactions kernel's three nested element loops took
// minutes to compile.

// A leaf's merged elements: o (product of its steps' tests), z and slot.
template <int MAXD>
__device__ __forceinline__ void xrt_leaf_path(const XrtShapArgs& a,
                                              const float* xr,
                                              const uint2* nodes,
                                              long long sb, int dd, int m,
                                              float* o, float* z, int* slot) {
  const bool cat = a.has_cat != 0;
#pragma unroll (MAXD <= 8 ? MAXD : 1)
  for (int e = 0; e < MAXD; ++e) {
    o[e] = 1.f;
    z[e] = e < m ? __ldg(a.elem_z + sb + e) : 0.f;
    slot[e] = e < m ? __ldg(a.elem_slot + sb + e) : 0;
  }
#pragma unroll (MAXD <= 8 ? MAXD : 1)
  for (int s = 0; s < MAXD; ++s) {
    if (s < dd) {
      const int st = __ldg(a.steps + sb + s);
      if (st >= 0) {
        const uint2 nd = __ldg(nodes + (st & XRT_NODE_MASK));
        const float xv = __ldg(xr + (nd.y & XRT_FEATURE_MASK));
        const int right = xrt_shap_right(nd, xv, cat) ? 1 : 0;
        const int bit = (st >> XRT_BIT_SHIFT) & 1;
        const int el = st >> XRT_ELEM_SHIFT;
        if (right != bit) {
          if constexpr (MAXD <= 8) {
#pragma unroll
            for (int e = 0; e < MAXD; ++e)
              if (e == el) o[e] = 0.f;
          } else {
            o[el] = 0.f;
          }
        }
      }
    }
  }
}

// EXTEND: q = prod over the m elements of (z_e + o_e t), degree m.
template <int MAXD>
__device__ __forceinline__ void xrt_extend(float* q, const float* o,
                                           const float* z, int m) {
  q[0] = 1.f;
#pragma unroll
  for (int k = 1; k <= MAXD; ++k) q[k] = 0.f;
#pragma unroll (MAXD <= 8 ? MAXD : 1)
  for (int e = 0; e < MAXD; ++e) {
    if (e < m) {
#pragma unroll
      for (int k = MAXD; k >= 1; --k) q[k] = z[e] * q[k] + o[e] * q[k - 1];
      q[0] = z[e] * q[0];
    }
  }
}

// UNWIND q (MAXD + 1 coefficients) by (z + o t) into r (MAXD).
template <int MAXD>
__device__ __forceinline__ void xrt_unwind(const float* q, float z, float o,
                                           float* r) {
  if (o > 0.5f) {
    float acc = q[MAXD];
#pragma unroll
    for (int k = MAXD - 1; k >= 0; --k) {
      r[k] = acc;
      acc = q[k] - z * acc;
    }
  } else {
    const bool pos = z > 0.f;
    const float den = fmaxf(z, 1e-12f);
#pragma unroll
    for (int k = 0; k < MAXD; ++k) r[k] = pos ? q[k] / den : 0.f;
  }
}

// The output row: features from the transposed accumulators, then bias.
__device__ __forceinline__ void xrt_write_contribs(const XrtShapArgs& a,
                                                   const float* acc,
                                                   long long row, long long n) {
  const int f_ = a.n_features;
  float* orow = a.out + row * (long long)a.num_outputs * (f_ + 1);
  for (int k = 0; k < a.num_outputs; ++k) {
    for (int f = 0; f < f_; ++f)
      orow[k * (f_ + 1) + f] = acc[(long long)(k * f_ + f) * n];
    orow[k * (f_ + 1) + f_] = __ldg(a.bias + k);
  }
}

template <int MAXD>
__global__ void __launch_bounds__(XRT_SHAP_THREADS)
    xrt_shap_saabas_kernel(const XrtShapArgs a) {
  const long long row =
      (long long)blockIdx.x * XRT_SHAP_THREADS + threadIdx.x;
  if (row >= a.n_rows) return;
  const long long n = a.n_rows;
  const int f_ = a.n_features;
  const int kf = a.num_outputs * f_;
  const int heap = (2 << a.max_depth) - 1;
  const float* xr = a.x + row * f_;
  float* acc = a.scratch + row;
  for (int j = 0; j < kf; ++j) acc[(long long)j * n] = 0.f;
  for (int t = 0; t < a.n_trees; ++t) {
    const uint2* nodes = a.nodes + (long long)t * heap;
    const float* bw = a.base_weight + (long long)t * heap;
    int idx = 0, nu = 0;
    int fs[MAXD];
    float vals[MAXD];
#pragma unroll
    for (int s = 0; s < MAXD; ++s) {
      fs[s] = -1;
      vals[s] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < MAXD; ++s) {
      if (s < a.max_depth) {
        const uint2 nd = __ldg(nodes + idx);
        if (!(nd.y & XRT_F_LEAF)) {
          const int f = nd.y & XRT_FEATURE_MASK;
          const int right =
              xrt_shap_right(nd, __ldg(xr + f), a.has_cat != 0) ? 1 : 0;
          const int nxt = 2 * idx + 1 + right;
          const float d = __ldg(bw + nxt) - __ldg(bw + idx);
          // a repeated feature sums into its first occurrence, in order
          bool found = false;
#pragma unroll
          for (int j = 0; j < MAXD; ++j) {
            if (!found && j < nu && fs[j] == f) {
              vals[j] = vals[j] + d;
              found = true;
            }
          }
          if (!found) {
#pragma unroll
            for (int j = 0; j < MAXD; ++j) {
              if (j == nu) {
                fs[j] = f;
                vals[j] = d;
              }
            }
            ++nu;
          }
          idx = nxt;
        }
      }
    }
    const float sc = __ldg(a.scale + t);
    const int k = __ldg(a.tree_class + t);
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
      if (j < nu) acc[(long long)(k * f_ + fs[j]) * n] += vals[j] * sc;
  }
  xrt_write_contribs(a, acc, row, n);
}

template <int MAXD>
__global__ void __launch_bounds__(XRT_SHAP_THREADS)
    xrt_shap_exact_kernel(const XrtShapArgs a) {
  const long long row =
      (long long)blockIdx.x * XRT_SHAP_THREADS + threadIdx.x;
  if (row >= a.n_rows) return;
  const long long n = a.n_rows;
  const int f_ = a.n_features;
  const int kf = a.num_outputs * f_;
  const int heap = (2 << a.max_depth) - 1;
  const int dd = a.max_depth > 0 ? a.max_depth : 1;
  const int u_ = a.max_feats;
  const float* xr = a.x + row * f_;
  float* acc = a.scratch + row;         // [K * F] class accumulators
  float* ph = acc + (long long)kf * n;  // [U] the tree's feature sums
  for (int j = 0; j < kf; ++j) acc[(long long)j * n] = 0.f;
  for (int t = 0; t < a.n_trees; ++t) {
    const int nu = __ldg(a.n_feats + t);
    for (int u = 0; u < nu; ++u) ph[(long long)u * n] = 0.f;
    const uint2* nodes = a.nodes + (long long)t * heap;
    const int nl = __ldg(a.n_leaves + t);
    for (int l = 0; l < nl; ++l) {
      const long long lb = (long long)t * a.max_leaves + l;
      const int m = __ldg(a.leaf_m + lb);
      const float v = __ldg(a.leaf_value + lb);
      float o[MAXD], z[MAXD], q[MAXD + 1];
      int slot[MAXD];
      xrt_leaf_path<MAXD>(a, xr, nodes, lb * dd, dd, m, o, z, slot);
      xrt_extend<MAXD>(q, o, z, m);
      const float* w = a.weights + m * a.weights_width;
#pragma unroll (MAXD <= 8 ? MAXD : 1)
      for (int e = 0; e < MAXD; ++e) {
        if (e < m) {
          float r[MAXD];
          xrt_unwind<MAXD>(q, z[e], o[e], r);
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < MAXD; ++k)
            if (k < m) s += r[k] * __ldg(w + k);
          ph[(long long)slot[e] * n] += (v * (o[e] - z[e])) * s;
        }
      }
    }
    const float sc = __ldg(a.scale + t);
    const int k = __ldg(a.tree_class + t);
    for (int u = 0; u < nu; ++u) {
      const int f = __ldg(a.tree_feats + (long long)t * u_ + u);
      acc[(long long)(k * f_ + f) * n] += ph[(long long)u * n] * sc;
    }
  }
  xrt_write_contribs(a, acc, row, n);
}

template <int MAXD>
__global__ void __launch_bounds__(XRT_SHAP_THREADS)
    xrt_shap_interactions_kernel(const XrtShapArgs a) {
  const long long row =
      (long long)blockIdx.x * XRT_SHAP_THREADS + threadIdx.x;
  if (row >= a.n_rows) return;
  const long long n = a.n_rows;
  const int f_ = a.n_features;
  const int kf = a.num_outputs * f_;
  const int heap = (2 << a.max_depth) - 1;
  const int dd = a.max_depth > 0 ? a.max_depth : 1;
  const int u_ = a.max_feats;
  const float* xr = a.x + row * f_;
  float* mat = a.scratch + row;                  // [K][F][F]
  float* fbias = mat + (long long)kf * f_ * n;   // [K][F]
  float* pm = fbias + (long long)kf * n;         // [U][U] the tree's pairs
  float* pb = pm + (long long)u_ * u_ * n;       // [U] its feature-bias terms
  float* pp = pb + (long long)u_ * n;            // [U] its plain SHAP values
  for (long long j = 0; j < (long long)kf * f_; ++j) mat[j * n] = 0.f;
  for (int j = 0; j < kf; ++j) fbias[(long long)j * n] = 0.f;
  for (int t = 0; t < a.n_trees; ++t) {
    const int nu = __ldg(a.n_feats + t);
    for (int u = 0; u < nu; ++u) {
      for (int v2 = 0; v2 < nu; ++v2) pm[(long long)(u * u_ + v2) * n] = 0.f;
      pb[(long long)u * n] = 0.f;
      pp[(long long)u * n] = 0.f;
    }
    const uint2* nodes = a.nodes + (long long)t * heap;
    const int nl = __ldg(a.n_leaves + t);
    for (int l = 0; l < nl; ++l) {
      const long long lb = (long long)t * a.max_leaves + l;
      const int m = __ldg(a.leaf_m + lb);
      const float v = __ldg(a.leaf_value + lb);
      float o[MAXD], z[MAXD], q[MAXD + 1];
      int slot[MAXD];
      xrt_leaf_path<MAXD>(a, xr, nodes, lb * dd, dd, m, o, z, slot);
      xrt_extend<MAXD>(q, o, z, m);
      const float* w_m = a.weights + m * a.weights_width;
      const float* w_m1 = a.weights + (m > 0 ? m - 1 : 0) * a.weights_width;
#pragma unroll (MAXD <= 8 ? MAXD : 1)
      for (int i = 0; i < MAXD; ++i) {
        if (i < m) {
          float pr = v;
#pragma unroll (MAXD <= 8 ? MAXD : 1)
          for (int j = 0; j < MAXD; ++j)
            if (j < m && j != i) pr = pr * z[j];
          const float doi = o[i] - z[i];
          pb[(long long)slot[i] * n] += (0.5f * doi) * pr;
          float qi[MAXD + 1];
          xrt_unwind<MAXD>(q, z[i], o[i], qi);
          qi[MAXD] = 0.f;
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < MAXD; ++k)
            if (k < m) s += qi[k] * __ldg(w_m + k);
          pp[(long long)slot[i] * n] += (v * doi) * s;
#pragma unroll (MAXD <= 8 ? MAXD : 1)
          for (int j = 0; j < MAXD; ++j) {
            if (j < m && j != i) {
              float r[MAXD];
              xrt_unwind<MAXD>(qi, z[j], o[j], r);
              float s1 = 0.f;
#pragma unroll
              for (int k = 0; k < MAXD; ++k)
                if (k < m - 1) s1 += r[k] * __ldg(w_m1 + k);
              const float base = (o[j] - z[j]) * s1;
              pm[(long long)(slot[i] * u_ + slot[j]) * n] +=
                  ((0.5f * v) * base) * doi;
            }
          }
        }
      }
    }
    // the tree's diagonal is each feature row's remainder; then its cells
    // into the tree's class
    const float sc = __ldg(a.scale + t);
    const int k = __ldg(a.tree_class + t);
    const int* tf = a.tree_feats + (long long)t * u_;
    for (int u = 0; u < nu; ++u) {
      float ro = 0.f;
      for (int v2 = 0; v2 < nu; ++v2) ro += pm[(long long)(u * u_ + v2) * n];
      const float diag = (pp[(long long)u * n] - ro) - pb[(long long)u * n];
      const int fu = __ldg(tf + u);
      float* mrow = mat + (long long)(k * f_ + fu) * f_ * n;
      for (int v2 = 0; v2 < nu; ++v2) {
        const float cell = v2 == u ? diag : pm[(long long)(u * u_ + v2) * n];
        mrow[(long long)__ldg(tf + v2) * n] += cell * sc;
      }
      fbias[(long long)(k * f_ + fu) * n] += pb[(long long)u * n] * sc;
    }
  }
  const int f1 = f_ + 1;
  float* orow = a.out + row * (long long)a.num_outputs * f1 * f1;
  for (int k = 0; k < a.num_outputs; ++k) {
    float* ob = orow + (long long)k * f1 * f1;
    float tot = 0.f;
    for (int f = 0; f < f_; ++f) {
      const float* mrow = mat + (long long)(k * f_ + f) * f_ * n;
      for (int g = 0; g < f_; ++g) ob[f * f1 + g] = mrow[(long long)g * n];
      const float b = fbias[(long long)(k * f_ + f) * n];
      ob[f * f1 + f_] = b;
      ob[f_ * f1 + f] = b;
      tot += b;
    }
    ob[f_ * f1 + f_] = __ldg(a.bias + k) - tot;
  }
}

#define XRT_SHAP_LAUNCH(KERNEL, A, STREAM)                                  \
  do {                                                                      \
    const unsigned blocks = (unsigned)(((A).n_rows + XRT_SHAP_THREADS - 1) / \
                                       XRT_SHAP_THREADS);                   \
    if ((A).max_depth <= 8)                                                 \
      KERNEL<8><<<blocks, XRT_SHAP_THREADS, 0, STREAM>>>(A);                \
    else                                                                    \
      KERNEL<16><<<blocks, XRT_SHAP_THREADS, 0, STREAM>>>(A);               \
  } while (0)

extern "C" int xrt_shap_saabas(const XrtShapArgs* a, cudaStream_t stream) {
  if (a->n_rows > 0) XRT_SHAP_LAUNCH(xrt_shap_saabas_kernel, *a, stream);
  return (int)cudaGetLastError();
}

extern "C" int xrt_shap_exact(const XrtShapArgs* a, cudaStream_t stream) {
  if (a->n_rows > 0) XRT_SHAP_LAUNCH(xrt_shap_exact_kernel, *a, stream);
  return (int)cudaGetLastError();
}

extern "C" int xrt_shap_interactions(const XrtShapArgs* a,
                                     cudaStream_t stream) {
  if (a->n_rows > 0)
    XRT_SHAP_LAUNCH(xrt_shap_interactions_kernel, *a, stream);
  return (int)cudaGetLastError();
}
