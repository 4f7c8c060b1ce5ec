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
// model). For forests up to depth 10 the Saabas kernel reads one walk table
// a tree (saabas_tab, ops/shap.py saabas_layout): the node records of
// levels 0..D-1, then for each last-level position p of a D-step walk (one
// that goes on below a leaf ends under it) an entry of the credits of the
// leaf above p, at most D (feature, credit) pairs, features distinct, at
// an odd pitch. For forests up to
// depth 8 the exact and interaction kernels read
// one blob a tree (tree_tab): a header (split nodes, leaves, features), the
// tree's features ascending (its slots), its split nodes' packed 8-byte
// records by split ordinal (ascending heap index), and its leaves in slot
// order as 16-word records: m | steps << 8, the leaf value, the merged
// elements' cover ratios z[8], their slots (a byte each) and the path's
// steps (split ordinal | branch bit << 8 | element << 9, a half each).
// Also the Shapley weight table, and per call the tree scales and classes
// and the row-independent bias column.
//
// What fixes the bits (ops/shap.py's plain versions): per leaf, EXTEND of
// prod_e (z_e + o_e t), each element's UNWIND (o == 1: the downward
// recurrence r[k-1] = q[k] - z r[k]; o == 0: the guarded quotient q[k] / z)
// and its weighted sum v (o - z) sum_k r[k] w[m][k] (interactions: per
// element i the prefix-free product of the other z's, the polynomial with i
// unwound and, per other element j, that polynomial unwound by j, weighted
// by w[m - 1]), all unfused f32 (--fmad=false, ops/_build.py) in a fixed
// order; then the leaves fold into the tree's slot sums in slot order, the
// interactions' remainder goes on the diagonal, and the trees fold into
// the class accumulators in tree order. Any mapping that keeps both gives
// the plain version's bits: no atomics, and a row's result depends on no
// other row of the launch.
//
// Design (exact and interactions, forests up to depth 8):
// - Route once a tree. A row tests each split node once into bits (word s
//   / 32, bit s % 32: goes right at split ordinal s); a leaf's indicators
//   come from its steps' ordinals and branch bits by integer operations
//   (xrt_fail), where the thread-a-row kernels re-test every step of
//   every leaf.
// - Exact trip counts. The leaf bodies are templated on M = 1..8 and their
//   loops run M iterations, not the register width with predicates: EXTEND
//   updates only the live triangle, UNWIND's recurrence starts at q[M] (the
//   higher coefficients are +0, so the values are the same) and the o == 0
//   quotient divides M coefficients. The interactions' loop over the other
//   element j stays rolled (its z from the record), so the build stays
//   short.
// - Two mappings (ops/shap.py shap_plan picks one from n and the shapes):
//   rows: a thread a row, 128 rows a CTA. The CTA walks the trees in order;
//   each tree's blob is staged into shared memory by cp.async, double-
//   buffered (the next tree lands while this one runs), and the CTA's rows
//   of x sit feature-major in shared memory. All threads walk the same leaf
//   (a uniform switch on m, every table read a broadcast). The tree's slot
//   sums and the class accumulators stay in shared memory ([word][row])
//   where they fit, else in the scratch ([word][n], coalesced).
//   lanes: a row a CTA of 4 warps. Warps take trees (t = g + warp); a
//   warp's lanes take the tree's leaves 32 at a time, routing by ballot over
//   the split nodes. The round runs the body of M = the lanes' largest m
//   (lanes with fewer elements skip the rest: their higher coefficients are
//   +0); each lane stages its leaf's contributions, then the round folds
//   into the warp's tree sums leaf by leaf in slot order (lanes over the
//   leaf's cells). After each group of 4 trees the CTA folds the 4 trees'
//   sums into the class accumulators in tree order. A small batch thus
//   spreads over whole CTAs, and the interactions' U x U pair cells stay in
//   shared memory.
// Forests deeper than 8 take the rolled thread-a-row kernels (a thread a row,
// every step re-tested, the sums in the scratch): "deep".
//
// Design (Saabas, forests up to depth 10). What fixes the bits
// (predict_contribs_plain): per tree a row's credit vector, +0.0 then
// bw[child] - bw[node] added into its feature step by step, then acc[k_t] +
// credit * scale_t over every feature, trees in order. Given the leaf a row
// reaches, the credits are fixed, so the host builds them once per model
// with the same f32 operations (the walk tables); a credit off the path is
// +0.0, and +0.0 * scale_t added to an accumulator that starts at +0.0 (so
// is never -0.0) changes no bits: the rows mapping adds only the leaf's
// pairs, the lanes mapping every credit, as the plain version does.
// - rows: a thread a row, 256 rows a CTA (fewer where the class
//   accumulators of K * F words a row do not fit); the CTA's rows of x
//   feature-major and the accumulators ([K * F][rows]: lanes at any
//   features hit distinct banks) in shared memory, written out once,
//   row-contiguous; the walk tables staged in tiles of whole trees by
//   cp.async, double-buffered; a thread walks two trees in lock step, D
//   levels without a leaf test, then adds each leaf's pairs (B8's rows
//   mapping, csrc/predict.cu, with the credits in place of the value).
// - lanes: 1-8 rows a CTA of 128 threads; each walks a tree of the group
//   for a row from device memory and stages its credit vector densely in
//   shared memory, then threads over the rows' class accumulators add the
//   group's trees in order. A small batch spreads over whole CTAs.
// Deeper forests take the thread-a-row kernel (the accumulators in the
// scratch): "deep".
//
// What bounds it: operations. Per row and tree, exact TreeSHAP needs about
// sum over leaves of 4 m^2 + 1.5 m^2 f32 operations (EXTEND, then an
// UNWIND and a weighted sum per element), interactions about m times that;
// Saabas a compare per split test of the walk to the row's leaf and a
// multiply and an add per pair of that leaf (chip_smoke.py counts them
// from the leaves the rows reach: ops/shap.saabas_ops); what holds the
// Saabas rows mapping is shared-memory wavefronts, as B8's walk (a record
// and a gather a level), and the read-modify-write of an accumulator a
// pair. Unfused,
// each multiply and add is an instruction of its own, so the card's f32
// rate halves (33.5 T a second): the unfused ceiling is twice the bound.
// The o == 0 quotient is an IEEE division of about ten instructions a
// coefficient, and the rows of a warp take both UNWIND branches where
// their o differ.
#include "common.cuh"

#define XRT_SHAP_THREADS 128
#define XRT_ROWS_CTA 128    // rows mapping: rows (threads) a CTA
#define XRT_LANES_WARPS 4   // lanes mapping: warps a CTA (one row)
#define XRT_LEAF_WORDS 24   // a leaf record of a tree blob
#define XRT_EXACT_STAGE 9   // lanes mapping: staged words a leaf, odd pitch
#define XRT_INTER_STAGE 73  // 8 x 8 pair cells (plain terms on the
                            // diagonal), 8 bias terms, odd pitch
#define XRT_FULL 0xffffffffu
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
  // the exact and interaction kernels' plan (ops/shap.py shap_plan)
  const int* tree_tab;  // [T][tab_words] tree blobs (max_depth <= 8)
  int tab_words, feat_off, node_off, leaf_off, route_words;
  int mapping;  // 0 rows, 1 lanes, 2 deep
  int threads, grid, shared_bytes;
  // word offsets into the dynamic shared memory, -1: in the scratch
  int off_tab, off_route, off_x, off_sums, off_stage, off_acc;
  int acc_words, sums_words, scratch_words;
  // the Saabas kernel's walk tables (ops/shap.py saabas_layout; forests up
  // to depth 10): entries at sb_entry_off, each sb_pitch words, its feature
  // halves at sb_half_off within it; the rows mapping's trees a staged tile
  const int* saabas_tab;  // [T][sb_words]
  int sb_words, sb_entry_off, sb_half_off, sb_pitch, tile_trees;
  int cta_rows;  // the Saabas lanes mapping's rows a CTA
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

// The thread-a-row kernels at width 16: the "deep" mapping of forests
// without walk tables (Saabas) or tree blobs (exact and interactions), and
// of any forest when forced. Loops over path elements
// (#pragma unroll (MAXD <= 8 ? MAXD : 1)) stay rolled at width 16 and the
// arrays go to local memory: fully unrolled, the interactions kernel's three
// nested element loops took minutes to compile.

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


// ---------------------------------------------------------------------------
// The exact and interaction kernels for forests up to depth 8
// ---------------------------------------------------------------------------

// A leaf record of a tree blob, its first 16 words unpacked into registers
// (the reciprocals are read from the record where they are used).
struct XrtLeaf {
  int m;
  float v;
  float z[8];
  unsigned slot_lo, slot_hi;  // the elements' slots, a byte each
  unsigned st[4];             // the steps, a half each
  __device__ __forceinline__ int slot(int e) const {
    return (int)(((e < 4 ? slot_lo : slot_hi) >> (8 * (e & 3))) & 0xffu);
  }
};

__device__ __forceinline__ XrtLeaf xrt_unpack_leaf(int4 a, int4 b, int4 c,
                                                   int4 d) {
  XrtLeaf L;
  L.m = a.x & 0xff;
  L.v = __int_as_float(a.y);
  L.z[0] = __int_as_float(a.z);
  L.z[1] = __int_as_float(a.w);
  L.z[2] = __int_as_float(b.x);
  L.z[3] = __int_as_float(b.y);
  L.z[4] = __int_as_float(b.z);
  L.z[5] = __int_as_float(b.w);
  L.z[6] = __int_as_float(c.x);
  L.z[7] = __int_as_float(c.y);
  L.slot_lo = (unsigned)c.z;
  L.slot_hi = (unsigned)c.w;
  L.st[0] = (unsigned)d.x;
  L.st[1] = (unsigned)d.y;
  L.st[2] = (unsigned)d.z;
  L.st[3] = (unsigned)d.w;
  return L;
}

// From a staged blob in shared memory (rows mapping: a broadcast).
__device__ __forceinline__ XrtLeaf xrt_leaf_shared(const int* rec) {
  const int4* p = reinterpret_cast<const int4*>(rec);
  return xrt_unpack_leaf(p[0], p[1], p[2], p[3]);
}

// From the blob in device memory (lanes mapping: a lane's own leaf).
__device__ __forceinline__ XrtLeaf xrt_leaf_global(const int* rec) {
  const int4* p = reinterpret_cast<const int4*>(rec);
  return xrt_unpack_leaf(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ XrtLeaf xrt_leaf_none() {
  const int4 zero = make_int4(0, 0, 0, 0);
  return xrt_unpack_leaf(zero, zero, zero, zero);
}

// Bit e set where element e's indicator is 0: a step whose branch bit
// differs from the row's bit at its split ordinal (route word w at
// route[w * RS]). All 8 steps, without a branch: a step past the leaf's
// depth tests ordinal 0 into bit 8, which no element reads.
template <int RS>
__device__ __forceinline__ unsigned xrt_fail(const XrtLeaf& L,
                                             const unsigned* route) {
  unsigned fail = 0;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const unsigned h = (L.st[s >> 1] >> ((s & 1) << 4)) & 0xffffu;
    const unsigned rb = route[((h >> 5) & 7u) * RS] >> (h & 31u);
    fail |= ((rb ^ (h >> 8)) & 1u) << (h >> 9);
  }
  return fail;
}

// EXTEND over the m (<= M) elements: q[0..M] = prod_e (z_e + o_e t); each
// element updates only the coefficients it can reach (the rest stay +0,
// as the plain version's full-width update leaves them).
template <int M>
__device__ __forceinline__ void xrt_extend_m(float* q, const float* z,
                                             const float* o, int m) {
  q[0] = 1.f;
#pragma unroll
  for (int k = 1; k <= M; ++k) q[k] = 0.f;
#pragma unroll
  for (int e = 0; e < M; ++e) {
    if (e < m) {
#pragma unroll
      for (int k = e + 1; k >= 1; --k) q[k] = z[e] * q[k] + o[e] * q[k - 1];
      q[0] = z[e] * q[0];
    }
  }
}

// The smallest cover ratio of a leaf of M elements for the quotients'
// fast path: every nonzero coefficient of its polynomial is then at least
// 2^-72 (a product of at most M ratios of at least 2^-floor(72 / M)).
template <int M>
__device__ __forceinline__ constexpr float xrt_zlo() {
  return 1.f / (float)(1ull << (72 / M > 60 ? 60 : 72 / M));
}

// RN(a / d) from y = RN(1 / d) (the record's, made on the host): q0 = a y
// is within 1.5 ulps of a / d; one correction by the remainder a - d q0
// leaves q1 within an ulp (faithful); the second is Markstein's: with q1
// faithful and y within half an ulp of 1 / d, RN(q1 + (a - d q1) y) =
// RN(a / d), the remainder exact by the FMA. Valid where every
// intermediate is a normal number (the callers' guards); 5 instructions
// where the compiler's division takes about ten and a branch.
__device__ __forceinline__ float xrt_qdiv(float a, float d, float y) {
  const float q0 = __fmul_rn(a, y);
  const float q1 = __fmaf_rn(__fmaf_rn(-d, q0, a), y, q0);
  return __fmaf_rn(__fmaf_rn(-d, q1, a), y, q1);
}

// a = +0 or |a| in [2^-76, 2^76): with d in [2^-36, 16] every
// intermediate of xrt_qdiv is normal
__device__ __forceinline__ bool xrt_qdiv_range(float a) {
  const unsigned u = __float_as_uint(a);
  return (u & 0x7fffffffu) - 0x19800000u < 0x4c000000u || u == 0u;
}

// UNWIND q (N + 1 coefficients) by (z + o t) into r (N), both branches
// without a branch (the rows of a warp differ in o): o == 1 the recurrence
// from q[N] (the plain version's coefficients above N are +0 and give the
// same values), o == 0 the guarded quotients q[k] / max(z, 1e-12) (0 where
// z <= 0). fast: every quotient's intermediates are normal (the leaf's
// ratios passed xrt_leaf_fast and q came from EXTEND: nonnegative, its
// nonzero coefficients in [2^-72, 2^39]; or q passed xrt_qdiv_range), so
// xrt_qdiv from y = RN(1 / max(z, 1e-12)) gives the IEEE quotient; else
// the compiler's division.
template <int N>
__device__ __forceinline__ void xrt_unwind_m(const float* q, float z, float y,
                                             bool one, bool fast, float* r) {
  float rr[N], rq[N];
  float acc = q[N];
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    rr[k] = acc;
    acc = q[k] - z * acc;
  }
  const float den = fmaxf(z, 1e-12f);
  if (fast) {
#pragma unroll
    for (int k = 0; k < N; ++k) rq[k] = xrt_qdiv(q[k], den, y);
  } else {
    const bool pos = z > 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) rq[k] = pos ? q[k] / den : 0.f;
  }
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = one ? rr[k] : rq[k];
}

// The leaf's guard for the quotients' fast path: every live ratio in
// [xrt_zlo<M>, 16].
template <int M>
__device__ __forceinline__ bool xrt_leaf_fast(const float* z, int m) {
  bool fast = true;
#pragma unroll
  for (int e = 0; e < M; ++e)
    if (e < m) fast = fast && z[e] >= xrt_zlo<M>() && z[e] <= 16.f;
  return fast;
}

// Where a leaf's contributions go. Rows mapping: straight into the row's
// tree sums (pair cells [U][U], then the bias terms, then the plain
// terms), word j at sums[j * ss].
struct XrtRowSink {
  float* sums;
  long long ss;
  int u_;
  __device__ __forceinline__ void exact(int, int slot, float c) {
    sums[slot * ss] += c;
  }
  __device__ __forceinline__ void bias(int, int slot, float b) {
    sums[(long long)(u_ * u_ + slot) * ss] += b;
  }
  __device__ __forceinline__ void plain(int, int slot, float c) {
    sums[(long long)(u_ * u_ + u_ + slot) * ss] += c;
  }
  __device__ __forceinline__ void pair(int, int, int si, int sj, float d) {
    sums[(long long)(si * u_ + sj) * ss] += d;
  }
};

// Lanes mapping: the lane's stage row, folded in slot order afterwards.
struct XrtStageSink {
  float* st;
  __device__ __forceinline__ void exact(int e, int, float c) { st[e] = c; }
  __device__ __forceinline__ void bias(int i, int, float b) {
    st[64 + i] = b;
  }
  __device__ __forceinline__ void plain(int i, int, float c) {
    st[9 * i] = c;
  }
  __device__ __forceinline__ void pair(int i, int j, int, int, float d) {
    st[i * 8 + j] = d;
  }
};

// One leaf of exact TreeSHAP with M coefficients (m <= M elements live);
// recf: the record in memory.
template <int M, class Sink>
__device__ __forceinline__ void xrt_exact_leaf(const XrtLeaf& L,
                                               const float* recf,
                                               unsigned fail,
                                               const float* __restrict__ w,
                                               Sink& sink) {
  float z[M], o[M], q[M + 1], wk[M];
#pragma unroll
  for (int e = 0; e < M; ++e) {
    z[e] = L.z[e];
    o[e] = (fail >> e) & 1u ? 0.f : 1.f;
    wk[e] = __ldg(w + e);
  }
  xrt_extend_m<M>(q, z, o, L.m);
  const bool fast = xrt_leaf_fast<M>(z, L.m);
#pragma unroll
  for (int e = 0; e < M; ++e) {
    if (e < L.m) {
      float r[M];
      xrt_unwind_m<M>(q, z[e], recf[16 + e], o[e] > 0.5f, fast, r);
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < M; ++k) s += r[k] * wk[k];
      sink.exact(e, L.slot(e), (L.v * (o[e] - z[e])) * s);
    }
  }
}

// One leaf of interaction values with M coefficients; recf: the record in
// memory (the rolled loop over j reads z_j and its reciprocal there).
template <int M, class Sink>
__device__ __forceinline__ void xrt_inter_leaf(const XrtLeaf& L,
                                               const float* recf,
                                               unsigned fail,
                                               const float* __restrict__ wm,
                                               const float* __restrict__ wm1,
                                               Sink& sink) {
  float z[M], o[M], q[M + 1], wk[M], w1[M];
#pragma unroll
  for (int e = 0; e < M; ++e) {
    z[e] = L.z[e];
    o[e] = (fail >> e) & 1u ? 0.f : 1.f;
    wk[e] = __ldg(wm + e);
    w1[e] = __ldg(wm1 + e);
  }
  xrt_extend_m<M>(q, z, o, L.m);
  const bool fast = xrt_leaf_fast<M>(z, L.m);
  const float v = L.v;
  const float hv = 0.5f * v;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (i < L.m) {
      float pr = v;
#pragma unroll
      for (int j = 0; j < M; ++j)
        if (j != i && j < L.m) pr = pr * z[j];
      const float doi = o[i] - z[i];
      const int si = L.slot(i);
      sink.bias(i, si, (0.5f * doi) * pr);
      float qi[M];
      xrt_unwind_m<M>(q, z[i], recf[16 + i], o[i] > 0.5f, fast, qi);
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < M; ++k) s += qi[k] * wk[k];
      sink.plain(i, si, (v * doi) * s);
      if constexpr (M > 1) {
        // qi may hold any values (o_i = 1: a recurrence): its quotients
        // take the fast path where all its coefficients are in range
        bool fast_i = fast;
#pragma unroll
        for (int k = 0; k < M; ++k) fast_i = fast_i && xrt_qdiv_range(qi[k]);
#pragma unroll 1
        for (int j = 0; j < L.m; ++j) {
          if (j == i) continue;
          const float zj = recf[2 + j];
          const float oj = (fail >> j) & 1u ? 0.f : 1.f;
          float r[M - 1];
          xrt_unwind_m<M - 1>(qi, zj, recf[16 + j], oj > 0.5f, fast_i, r);
          float s1 = 0.f;
#pragma unroll
          for (int k = 0; k < M - 1; ++k) s1 += r[k] * w1[k];
          const float base = (oj - zj) * s1;
          sink.pair(i, j, si, L.slot(j), (hv * base) * doi);
        }
      }
    }
  }
}

// The body of M coefficients (warp-uniform M; M = 0: nothing to do).
template <bool INTER, class Sink>
__device__ __forceinline__ void xrt_leaf(int M, const XrtLeaf& L,
                                         const float* recf, unsigned fail,
                                         const XrtShapArgs& a, Sink& sink) {
  const float* wm = a.weights + L.m * a.weights_width;
  const float* wm1 = a.weights + (L.m > 0 ? L.m - 1 : 0) * a.weights_width;
  switch (M) {
#define XRT_LEAF_CASE(K)                                        \
  case K:                                                       \
    if constexpr (INTER)                                        \
      xrt_inter_leaf<K>(L, recf, fail, wm, wm1, sink);          \
    else                                                        \
      xrt_exact_leaf<K>(L, recf, fail, wm, sink);               \
    break;
    XRT_LEAF_CASE(1)
    XRT_LEAF_CASE(2)
    XRT_LEAF_CASE(3)
    XRT_LEAF_CASE(4)
    XRT_LEAF_CASE(5)
    XRT_LEAF_CASE(6)
    XRT_LEAF_CASE(7)
    XRT_LEAF_CASE(8)
#undef XRT_LEAF_CASE
    default:
      break;
  }
}

// A tree blob into shared memory by cp.async, one commit group.
__device__ __forceinline__ void xrt_stage_blob(int* dst, const int* src,
                                               int words, int tid,
                                               int nthreads) {
  const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
  for (int i = 4 * tid; i < words; i += 4 * nthreads)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + 4u * (unsigned)i),
                 "l"(src + i));
  asm volatile("cp.async.commit_group;\n" ::);
}

// rows mapping: a thread a row, the CTA's 128 rows through every tree.
template <bool INTER>
__global__ void __launch_bounds__(XRT_ROWS_CTA)
    xrt_shap_rows_kernel(const XrtShapArgs a) {
  extern __shared__ __align__(16) int xrt_smem[];
  const int tid = threadIdx.x;
  const long long n = a.n_rows;
  const long long row0 = (long long)blockIdx.x * XRT_ROWS_CTA;
  const long long row = row0 + tid;
  const bool live = row < n;
  const int f_ = a.n_features;
  const int kf = a.num_outputs * f_;
  const int u_ = a.max_feats;
  const bool cat = a.has_cat != 0;
  // the CTA's rows of x feature-major ([F][R]), or the row in device memory
  const float* xr;
  int xs;
  if (a.off_x >= 0) {
    float* xt = reinterpret_cast<float*>(xrt_smem + a.off_x);
    const int rows = (int)min((long long)XRT_ROWS_CTA, n - row0);
    const float* src = a.x + row0 * f_;
    for (int i = tid; i < XRT_ROWS_CTA * f_; i += XRT_ROWS_CTA) {
      const int r = i / f_;
      xt[(i - r * f_) * XRT_ROWS_CTA + r] = r < rows ? src[i] : 0.f;
    }
    xr = xt + tid;
    xs = XRT_ROWS_CTA;
  } else {
    xr = a.x + (live ? row : n - 1) * f_;
    xs = 1;
  }
  // the class accumulators, then the tree's sums: [word][R] on chip, else
  // in the scratch, [word][n]
  float* acc;
  long long as;
  if (a.off_acc >= 0) {
    acc = reinterpret_cast<float*>(xrt_smem + a.off_acc) + tid;
    as = XRT_ROWS_CTA;
  } else {
    acc = a.scratch + row;
    as = n;
  }
  float* sums;
  long long ss;
  if (a.off_sums >= 0) {
    sums = reinterpret_cast<float*>(xrt_smem + a.off_sums) + tid;
    ss = XRT_ROWS_CTA;
  } else {
    sums = a.scratch + (a.off_acc >= 0 ? 0 : (long long)a.acc_words) * n + row;
    ss = n;
  }
  unsigned* route = reinterpret_cast<unsigned*>(xrt_smem + a.off_route) + tid;
  if (live)
    for (int j = 0; j < a.acc_words; ++j) acc[j * as] = 0.f;
  int* tabs = xrt_smem + a.off_tab;
  xrt_stage_blob(tabs, a.tree_tab, a.tab_words, tid, XRT_ROWS_CTA);
  XrtRowSink sink{sums, ss, u_};
  for (int t = 0; t < a.n_trees; ++t) {
    // tree t has landed, and every thread is done with tree t - 1's buffer,
    // which tree t + 1 takes
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (t + 1 < a.n_trees)
      xrt_stage_blob(tabs + ((t + 1) & 1) * a.tab_words,
                     a.tree_tab + (long long)(t + 1) * a.tab_words,
                     a.tab_words, tid, XRT_ROWS_CTA);
    if (!live) continue;
    const int* tb = tabs + (t & 1) * a.tab_words;
    const int ns = tb[0], nl = tb[1], nu = tb[2];
    // route once: every split node tested into the row's bits
    const int2* nodes = reinterpret_cast<const int2*>(tb + a.node_off);
    for (int w0 = 0; w0 < ns; w0 += 32) {
      unsigned word = 0;
      const int cnt = min(32, ns - w0);
      for (int j = 0; j < cnt; ++j) {
        const int2 nd = nodes[w0 + j];
        const float xv = xr[(nd.y & XRT_FEATURE_MASK) * xs];
        word |= (xrt_shap_right(make_uint2((unsigned)nd.x, (unsigned)nd.y),
                                xv, cat) ? 1u : 0u) << j;
      }
      route[(w0 >> 5) * XRT_ROWS_CTA] = word;
    }
    if constexpr (INTER) {
      for (int u = 0; u < nu; ++u) {
        for (int v2 = 0; v2 < nu; ++v2) sums[(long long)(u * u_ + v2) * ss] = 0.f;
        sums[(long long)(u_ * u_ + u) * ss] = 0.f;
        sums[(long long)(u_ * u_ + u_ + u) * ss] = 0.f;
      }
    } else {
      for (int u = 0; u < nu; ++u) sums[u * ss] = 0.f;
    }
    const int* leaves = tb + a.leaf_off;
    for (int l = 0; l < nl; ++l) {
      const int* rec = leaves + l * XRT_LEAF_WORDS;
      const XrtLeaf L = xrt_leaf_shared(rec);
      const unsigned fail = xrt_fail<XRT_ROWS_CTA>(L, route);
      xrt_leaf<INTER>(L.m, L, reinterpret_cast<const float*>(rec), fail, a,
                      sink);
    }
    // the tree's sums into its class (the diagonal: each feature row's
    // remainder), trees in order
    const float sc = __ldg(a.scale + t);
    const int k = __ldg(a.tree_class + t);
    const int* tf = tb + a.feat_off;
    if constexpr (INTER) {
      const float* pb = sums + (long long)u_ * u_ * ss;
      const float* pp = pb + u_ * ss;
      float* fbias = acc + (long long)kf * f_ * as;
      for (int u = 0; u < nu; ++u) {
        float ro = 0.f;
        for (int v2 = 0; v2 < nu; ++v2) ro += sums[(long long)(u * u_ + v2) * ss];
        const float diag = (pp[u * ss] - ro) - pb[u * ss];
        const int fu = tf[u];
        float* mrow = acc + (long long)(k * f_ + fu) * f_ * as;
        for (int v2 = 0; v2 < nu; ++v2) {
          const float cell =
              v2 == u ? diag : sums[(long long)(u * u_ + v2) * ss];
          mrow[(long long)tf[v2] * as] += cell * sc;
        }
        fbias[(long long)(k * f_ + fu) * as] += pb[u * ss] * sc;
      }
    } else {
      for (int u = 0; u < nu; ++u)
        acc[(long long)(k * f_ + tf[u]) * as] += sums[u * ss] * sc;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  if (!live) return;
  if constexpr (INTER) {
    const int f1 = f_ + 1;
    float* orow = a.out + row * (long long)a.num_outputs * f1 * f1;
    const float* fbias = acc + (long long)kf * f_ * as;
    for (int k = 0; k < a.num_outputs; ++k) {
      float* ob = orow + (long long)k * f1 * f1;
      float tot = 0.f;
      for (int f = 0; f < f_; ++f) {
        const float* mrow = acc + (long long)(k * f_ + f) * f_ * as;
        for (int g = 0; g < f_; ++g) ob[f * f1 + g] = mrow[g * as];
        const float b = fbias[(long long)(k * f_ + f) * as];
        ob[f * f1 + f_] = b;
        ob[f_ * f1 + f] = b;
        tot += b;
      }
      ob[f_ * f1 + f_] = __ldg(a.bias + k) - tot;
    }
  } else {
    float* orow = a.out + row * (long long)a.num_outputs * (f_ + 1);
    for (int k = 0; k < a.num_outputs; ++k) {
      for (int f = 0; f < f_; ++f)
        orow[k * (f_ + 1) + f] = acc[(long long)(k * f_ + f) * as];
      orow[k * (f_ + 1) + f_] = __ldg(a.bias + k);
    }
  }
}

// lanes mapping: one warp's tree t for the CTA's row: route by ballot, the
// leaves 32 at a time (a lane a leaf), each round folded into the warp's
// tree sums leaf by leaf in slot order; interactions end with the diagonal.
template <bool INTER>
__device__ __forceinline__ void xrt_lanes_tree(const XrtShapArgs& a, int t,
                                               const float* xr, bool cat,
                                               unsigned* route, float* stage,
                                               float* sums, int lane) {
  constexpr int SS = INTER ? XRT_INTER_STAGE : XRT_EXACT_STAGE;
  const int* tb = a.tree_tab + (long long)t * a.tab_words;
  const int ns = __ldg(tb), nl = __ldg(tb + 1), nu = __ldg(tb + 2);
  const int u_ = a.max_feats;
  const int2* nodes = reinterpret_cast<const int2*>(tb + a.node_off);
  for (int w0 = 0; w0 < ns; w0 += 32) {
    const int s = w0 + lane;
    bool right = false;
    if (s < ns) {
      const int2 nd = __ldg(nodes + s);
      right = xrt_shap_right(make_uint2((unsigned)nd.x, (unsigned)nd.y),
                             xr[nd.y & XRT_FEATURE_MASK], cat);
    }
    const unsigned word = __ballot_sync(XRT_FULL, right);
    if (lane == 0) route[w0 >> 5] = word;
  }
  const int sw = INTER ? u_ * u_ + 2 * u_ : u_;
  for (int j = lane; j < sw; j += 32) sums[j] = 0.f;
  __syncwarp();
  XrtStageSink sink{stage + lane * SS};
  const int* leaves = tb + a.leaf_off;
  for (int base = 0; base < nl; base += 32) {
    const int l = base + lane;
    const int* rec = leaves + l * XRT_LEAF_WORDS;
    const XrtLeaf L = l < nl ? xrt_leaf_global(rec) : xrt_leaf_none();
    const unsigned fail = xrt_fail<1>(L, route);
    const int M = __reduce_max_sync(XRT_FULL, (unsigned)L.m);
    xrt_leaf<INTER>(M, L, reinterpret_cast<const float*>(rec), fail, a,
                    sink);
    __syncwarp();
    const int cnt = min(32, nl - base);
    for (int j = 0; j < cnt; ++j) {
      const int mj = __shfl_sync(XRT_FULL, L.m, j);
      const unsigned lo = __shfl_sync(XRT_FULL, L.slot_lo, j);
      const unsigned hi = __shfl_sync(XRT_FULL, L.slot_hi, j);
      const float* sj = stage + j * SS;
      if constexpr (INTER) {
#pragma unroll
        for (int c = lane; c < 64; c += 32) {
          const int i = c >> 3, jj = c & 7;
          if (i < mj && jj < mj) {
            const int si = (int)(((i < 4 ? lo : hi) >> (8 * (i & 3))) & 0xffu);
            if (i == jj) {
              sums[u_ * u_ + u_ + si] += sj[c];
            } else {
              const int sj2 =
                  (int)(((jj < 4 ? lo : hi) >> (8 * (jj & 3))) & 0xffu);
              sums[si * u_ + sj2] += sj[c];
            }
          }
        }
        if (lane < mj) {
          const int si =
              (int)(((lane < 4 ? lo : hi) >> (8 * (lane & 3))) & 0xffu);
          sums[u_ * u_ + si] += sj[64 + lane];
        }
      } else {
        if (lane < mj) {
          const int si =
              (int)(((lane < 4 ? lo : hi) >> (8 * (lane & 3))) & 0xffu);
          sums[si] += sj[lane];
        }
      }
      __syncwarp();
    }
  }
  if constexpr (INTER) {
    for (int u = lane; u < nu; u += 32) {
      float ro = 0.f;
      for (int v2 = 0; v2 < nu; ++v2) ro += sums[u * u_ + v2];
      sums[u * u_ + u] = (sums[u_ * u_ + u_ + u] - ro) - sums[u_ * u_ + u];
    }
  }
}

// lanes mapping: a row a CTA, its warps taking the trees, the trees' sums
// folded into the class accumulators in tree order after each group.
template <bool INTER>
__global__ void __launch_bounds__(XRT_LANES_WARPS * 32)
    xrt_shap_lanes_kernel(const XrtShapArgs a) {
  extern __shared__ __align__(16) int xrt_smem[];
  constexpr int NT = XRT_LANES_WARPS * 32;
  constexpr int SS = INTER ? XRT_INTER_STAGE : XRT_EXACT_STAGE;
  const long long row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f_ = a.n_features;
  const int kf = a.num_outputs * f_;
  const int u_ = a.max_feats;
  const bool cat = a.has_cat != 0;
  const float* xr = a.x + row * f_;
  if (a.off_x >= 0) {
    float* xt = reinterpret_cast<float*>(xrt_smem + a.off_x);
    for (int f = tid; f < f_; f += NT) xt[f] = xr[f];
    xr = xt;
  }
  float* acc = a.off_acc >= 0
                   ? reinterpret_cast<float*>(xrt_smem + a.off_acc)
                   : a.scratch + row * a.scratch_words;
  for (int j = tid; j < a.acc_words; j += NT) acc[j] = 0.f;
  unsigned* route =
      reinterpret_cast<unsigned*>(xrt_smem + a.off_route) + warp * a.route_words;
  float* stage =
      reinterpret_cast<float*>(xrt_smem + a.off_stage) + warp * 32 * SS;
  float* sums_all = reinterpret_cast<float*>(xrt_smem + a.off_sums);
  __syncthreads();
  for (int g = 0; g < a.n_trees; g += XRT_LANES_WARPS) {
    if (g + warp < a.n_trees)
      xrt_lanes_tree<INTER>(a, g + warp, xr, cat, route, stage,
                            sums_all + warp * a.sums_words, lane);
    __syncthreads();
    for (int j = 0; j < XRT_LANES_WARPS && g + j < a.n_trees; ++j) {
      const int t = g + j;
      const int* tb = a.tree_tab + (long long)t * a.tab_words;
      const int nu = __ldg(tb + 2);
      const int* tf = tb + a.feat_off;
      const float sc = __ldg(a.scale + t);
      const int k = __ldg(a.tree_class + t);
      const float* sj = sums_all + j * a.sums_words;
      if constexpr (INTER) {
        float* fbias = acc + (long long)kf * f_;
        for (int u = warp; u < nu; u += XRT_LANES_WARPS) {
          const int fu = __ldg(tf + u);
          float* mrow = acc + (long long)(k * f_ + fu) * f_;
          for (int v2 = lane; v2 < nu; v2 += 32)
            mrow[__ldg(tf + v2)] += sj[u * u_ + v2] * sc;
          if (lane == 0) fbias[k * f_ + fu] += sj[u_ * u_ + u] * sc;
        }
      } else {
        for (int u = tid; u < nu; u += NT)
          acc[k * f_ + __ldg(tf + u)] += sj[u] * sc;
      }
      __syncthreads();
    }
  }
  if constexpr (INTER) {
    const int f1 = f_ + 1;
    float* orow = a.out + row * (long long)a.num_outputs * f1 * f1;
    const float* fbias = acc + (long long)kf * f_;
    const int words = a.num_outputs * f1 * f1;
    for (int i = tid; i < words; i += NT) {
      const int k = i / (f1 * f1);
      const int rem = i - k * f1 * f1;
      const int f = rem / f1, g = rem - f * f1;
      float val;
      if (f < f_ && g < f_) {
        val = acc[(long long)(k * f_ + f) * f_ + g];
      } else if (f < f_) {
        val = fbias[k * f_ + f];
      } else if (g < f_) {
        val = fbias[k * f_ + g];
      } else {
        float tot = 0.f;
        for (int h = 0; h < f_; ++h) tot += fbias[k * f_ + h];
        val = __ldg(a.bias + k) - tot;
      }
      orow[i] = val;
    }
  } else {
    float* orow = a.out + row * (long long)a.num_outputs * (f_ + 1);
    const int words = a.num_outputs * (f_ + 1);
    for (int i = tid; i < words; i += NT) {
      const int k = i / (f_ + 1), f = i - k * (f_ + 1);
      orow[i] = f < f_ ? acc[k * f_ + f] : __ldg(a.bias + k);
    }
  }
}

// ---------------------------------------------------------------------------
// The Saabas kernels for forests with walk tables (depth <= 10)
// ---------------------------------------------------------------------------

#define XRT_SAABAS_MAX_DEPTH 10
#define XRT_SAABAS_PAD 0xffffu  // a feature half past the leaf's pairs

// rows mapping: entry p of a staged walk table into the row's class
// accumulators (word j at acc[j * pitch]): acc += credit * scale for each
// of the leaf's pairs, at most D, a pair at a time (on the H100 all reads
// before all writes took 6.74-6.75 ms over 1M HIGGS rows, this 5.87 ms:
// chip_smoke.py --b15-variants).
__device__ __forceinline__ void xrt_saabas_fold(const XrtShapArgs& a,
                                                const int* tab, int p, int t,
                                                float* acc, int pitch) {
  const float sc = __ldg(a.scale + t);
  float* acc_k = acc + __ldg(a.tree_class + t) * a.n_features * pitch;
  const int* entry = tab + a.sb_entry_off + p * a.sb_pitch;
  const float* credit = reinterpret_cast<const float*>(entry);
  const unsigned* half =
      reinterpret_cast<const unsigned*>(entry + a.sb_half_off);
#pragma unroll
  for (int j = 0; j < XRT_SAABAS_MAX_DEPTH; ++j) {
    if (j < a.max_depth) {
      const unsigned f = (half[j >> 1] >> (16 * (j & 1))) & XRT_SAABAS_PAD;
      if (f != XRT_SAABAS_PAD) {
        float* c = acc_k + (int)f * pitch;
        *c = *c + credit[j] * sc;
      }
    }
  }
}

// rows mapping: a thread a row, the CTA's rows (a.threads) through every
// tree. Tiles of tile_trees walk tables are staged by cp.async, double-
// buffered; each thread walks two trees in lock step over the staged node
// records (D levels, on below a leaf) and its row of the feature-major x
// tile, then folds the two entries in tree order into its accumulators.
template <bool CAT>
__global__ void __launch_bounds__(256) xrt_shap_saabas_rows_kernel(
    const XrtShapArgs a) {
  extern __shared__ __align__(16) int xrt_smem[];
  const int rc = a.threads;
  const int tid = threadIdx.x;
  const long long n = a.n_rows;
  const long long row0 = (long long)blockIdx.x * rc;
  const int f_ = a.n_features;
  const int kf = a.num_outputs * f_;
  const int depth = a.max_depth;
  const int words = a.sb_words, tt = a.tile_trees, n_trees = a.n_trees;
  float* xt = reinterpret_cast<float*>(xrt_smem + a.off_x);
  float* acc = reinterpret_cast<float*>(xrt_smem + a.off_acc);
  int* tiles = xrt_smem + a.off_tab;
  const int n_tiles = (n_trees + tt - 1) / tt;
  if (n_tiles > 0)
    xrt_stage_blob(tiles, a.saabas_tab, min(tt, n_trees) * words, tid, rc);
  {
    // the thread's own row, feature-major ([F][rows]): lanes at any
    // features read distinct banks
    const long long g = row0 + tid;
    const bool live = g < n;
    const float* xr = a.x + (live ? g : 0) * f_;
    for (int f = 0; f < f_; ++f) xt[f * rc + tid] = live ? __ldg(xr + f) : 0.f;
  }
  for (int j = 0; j < kf; ++j) acc[j * rc + tid] = 0.f;
  const float* xm = xt + tid;
  float* am = acc + tid;
  const int top = (1 << depth) - 1;
  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = i * tt;
    const int nt = min(tt, n_trees - t0);
    // tile i has landed, and every thread is done with tile i - 1's
    // buffer, which tile i + 1 takes
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (i + 1 < n_tiles)
      xrt_stage_blob(tiles + ((i + 1) & 1) * tt * words,
                     a.saabas_tab + (long long)(t0 + tt) * words,
                     min(tt, n_trees - t0 - tt) * words, tid, rc);
    const int* tile = tiles + (i & 1) * tt * words;
    for (int j = 0; j < nt; j += 2) {
      const int j1 = min(j + 1, nt - 1);
      const int* tab0 = tile + j * words;
      const int* tab1 = tile + j1 * words;
      const uint2* nd0 = reinterpret_cast<const uint2*>(tab0);
      const uint2* nd1 = reinterpret_cast<const uint2*>(tab1);
      int h0 = 0, h1 = 0;
      for (int k = 0; k < depth; ++k) {
        const uint2 r0 = nd0[h0];
        const uint2 r1 = nd1[h1];
        const bool b0 =
            xrt_shap_right(r0, xm[(r0.y & XRT_FEATURE_MASK) * rc], CAT);
        const bool b1 =
            xrt_shap_right(r1, xm[(r1.y & XRT_FEATURE_MASK) * rc], CAT);
        h0 = 2 * h0 + (b0 ? 2 : 1);
        h1 = 2 * h1 + (b1 ? 2 : 1);
      }
      xrt_saabas_fold(a, tab0, h0 - top, t0 + j, am, rc);
      if (j + 1 < nt) xrt_saabas_fold(a, tab1, h1 - top, t0 + j1, am, rc);
    }
  }
  __syncthreads();
  // the CTA's rows out, row-contiguous: the accumulators, then the bias
  const int rows = (int)min((long long)rc, n - row0);
  const int wd = a.num_outputs * (f_ + 1);
  float* ob = a.out + row0 * wd;
  for (int i = tid; i < rows * wd; i += rc) {
    const int r = i / wd, c = i - r * wd;
    const int k = c / (f_ + 1), f = c - k * (f_ + 1);
    ob[i] = f < f_ ? acc[(k * f_ + f) * rc + r] : __ldg(a.bias + k);
  }
}

// lanes mapping: a.cta_rows rows a CTA (R, a power of two up to 8), 128 / R
// trees a group. Thread (tree slot s, row r) = (tid / R, tid % R) walks
// its tree of the group for its row (the node records from device memory:
// a warp's 32 loads touch 32 / R trees' lines) and stages the tree's
// credit vector densely (+0.0 off the leaf's path, an odd pitch of F | 1
// words), slot s its scale and class; then threads over the rows' class
// accumulators add every tree of their class, trees in order: the plain
// version's operations one for one.
template <bool CAT>
__global__ void __launch_bounds__(XRT_LANES_WARPS * 32)
    xrt_shap_saabas_lanes_kernel(const XrtShapArgs a) {
  extern __shared__ __align__(16) int xrt_smem[];
  constexpr int NT = XRT_LANES_WARPS * 32;
  const int rc = a.cta_rows;
  const int group = NT / rc;
  const long long n = a.n_rows;
  const long long row0 = (long long)blockIdx.x * rc;
  const int rows = (int)min((long long)rc, n - row0);
  const int tid = threadIdx.x;
  const int r = tid & (rc - 1), slot = tid / rc;
  const int f_ = a.n_features;
  const int kf = a.num_outputs * f_;
  const int depth = a.max_depth;
  const int top = (1 << depth) - 1;
  const int sp = f_ | 1;
  float* xs = reinterpret_cast<float*>(xrt_smem + a.off_x);  // [R][F]
  float* acc = reinterpret_cast<float*>(xrt_smem + a.off_acc);  // [R][K * F]
  float* stage = reinterpret_cast<float*>(xrt_smem + a.off_stage);
  float* st_scale = stage + NT * sp;
  int* st_class = reinterpret_cast<int*>(st_scale + NT);
  for (int i = tid; i < rc * f_; i += NT)
    xs[i] = i < rows * f_ ? __ldg(a.x + row0 * f_ + i) : 0.f;
  for (int j = tid; j < rc * kf; j += NT) acc[j] = 0.f;
  __syncthreads();
  const float* xr = xs + r * f_;
  for (int g = 0; g < a.n_trees; g += group) {
    const int cnt = min(group, a.n_trees - g);
    if (slot < cnt) {
      const int t = g + slot;
      const int* tab = a.saabas_tab + (long long)t * a.sb_words;
      const uint2* nodes = reinterpret_cast<const uint2*>(tab);
      int h = 0;
      for (int k = 0; k < depth; ++k) {
        const uint2 nd = __ldg(nodes + h);
        h = 2 * h + (xrt_shap_right(nd, xr[nd.y & XRT_FEATURE_MASK], CAT)
                         ? 2
                         : 1);
      }
      float* srow = stage + tid * sp;  // (slot * R + r) * sp
      for (int f = 0; f < f_; ++f) srow[f] = 0.f;
      const int* entry = tab + a.sb_entry_off + (h - top) * a.sb_pitch;
      const float* credit = reinterpret_cast<const float*>(entry);
      const unsigned* half =
          reinterpret_cast<const unsigned*>(entry + a.sb_half_off);
      for (int j = 0; j < depth; ++j) {
        const unsigned f =
            (__ldg(half + (j >> 1)) >> (16 * (j & 1))) & XRT_SAABAS_PAD;
        if (f != XRT_SAABAS_PAD) srow[f] = __ldg(credit + j);
      }
      if (r == 0) {
        st_scale[slot] = __ldg(a.scale + t);
        st_class[slot] = __ldg(a.tree_class + t);
      }
    }
    __syncthreads();
    for (int c = tid; c < rows * kf; c += NT) {
      const int rr = c / kf, ck = c - rr * kf;
      const int k = ck / f_, f = ck - k * f_;
      const float* sr = stage + rr * sp + f;
      float s = acc[c];
      for (int j = 0; j < cnt; ++j)
        if (st_class[j] == k) s = s + sr[j * rc * sp] * st_scale[j];
      acc[c] = s;
    }
    __syncthreads();
  }
  const int wd = a.num_outputs * (f_ + 1);
  float* ob = a.out + row0 * wd;
  for (int i = tid; i < rows * wd; i += NT) {
    const int rr = i / wd, c = i - rr * wd;
    const int k = c / (f_ + 1), f = c - k * (f_ + 1);
    ob[i] = f < f_ ? acc[rr * kf + k * f_ + f] : __ldg(a.bias + k);
  }
}

// ---------------------------------------------------------------------------
// Entry points
// ---------------------------------------------------------------------------

template <class K>
static int xrt_shap_launch_planned(K kernel, const XrtShapArgs* a,
                                   cudaStream_t stream) {
  if (a->shared_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->shared_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)a->grid, a->threads, a->shared_bytes, stream>>>(*a);
  return (int)cudaGetLastError();
}

template <bool INTER>
static int xrt_shap_planned(const XrtShapArgs* a, cudaStream_t stream) {
  if (a->n_rows <= 0) return (int)cudaGetLastError();
  if (a->mapping == 0)
    return xrt_shap_launch_planned(xrt_shap_rows_kernel<INTER>, a, stream);
  if (a->mapping == 1)
    return xrt_shap_launch_planned(xrt_shap_lanes_kernel<INTER>, a, stream);
  // deep: the rolled kernel of a thread a row
  const unsigned blocks =
      (unsigned)((a->n_rows + XRT_SHAP_THREADS - 1) / XRT_SHAP_THREADS);
  if constexpr (INTER)
    xrt_shap_interactions_kernel<16><<<blocks, XRT_SHAP_THREADS, 0, stream>>>(
        *a);
  else
    xrt_shap_exact_kernel<16><<<blocks, XRT_SHAP_THREADS, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int xrt_shap_saabas(const XrtShapArgs* a, cudaStream_t stream) {
  if (a->n_rows <= 0) return (int)cudaGetLastError();
  const bool cat = a->has_cat != 0;
  if (a->mapping == 0)
    return xrt_shap_launch_planned(cat ? xrt_shap_saabas_rows_kernel<true>
                                       : xrt_shap_saabas_rows_kernel<false>,
                                   a, stream);
  if (a->mapping == 1)
    return xrt_shap_launch_planned(cat ? xrt_shap_saabas_lanes_kernel<true>
                                       : xrt_shap_saabas_lanes_kernel<false>,
                                   a, stream);
  // deep: the kernel of a thread a row, the accumulators in the scratch
  const unsigned blocks =
      (unsigned)((a->n_rows + XRT_SHAP_THREADS - 1) / XRT_SHAP_THREADS);
  xrt_shap_saabas_kernel<16><<<blocks, XRT_SHAP_THREADS, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int xrt_shap_exact(const XrtShapArgs* a, cudaStream_t stream) {
  return xrt_shap_planned<false>(a, stream);
}

extern "C" int xrt_shap_interactions(const XrtShapArgs* a,
                                     cudaStream_t stream) {
  return xrt_shap_planned<true>(a, stream);
}
