// B4: the binned tree walk. T trees of equal depth over pre-binned rows;
// every row's leaf value in each tree, which the engine adds to an eval
// set's margins each round (ops/objectives.round_update's eval mode for
// one tree, the softmax pass's eval mode for a round's K class trees).
//
// Replaces xgboost_ray_tpu/ops/grow.py:786 predict_tree_binned with the rule
// of route_right_binned (:65): a numeric bin > split_bin goes right, the
// missing bin (max_bin) follows the learned default; a leaf keeps its index
// for the remaining steps (jnp.where(is_leaf[idx], idx, nxt)), so a row
// stops at its leaf. The result is integer routing plus one gather of
// value[leaf]: bitwise the plain version (ops/grow.predict_tree_binned_plain).
//
// What bounds it on an H100: bytes. A row costs one gathered bin a step
// (row-major bins: one 32-byte sector a visit, a row's visits mostly in the
// sectors of its own 28-108 bytes), and its 4-byte output per tree. Design:
// one thread a row, 256 rows a CTA; the thread walks the T trees one after
// the other, so its row's sectors are read from device memory once and
// then hit L1 for the other trees. The T heaps (feature, split_bin,
// default_left | is_leaf, value: 13 bytes a node) are staged once per CTA
// in shared memory when they have at most kMaxStagedNodes nodes together
// (7 trees of 127 at depth 6: 889), otherwise each visit reads them through
// the read-only path. Row values are written tree-major, [T][n_rows]:
// consecutive threads write consecutive words.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
// 3584 nodes x 13 bytes = 46.6 KB of shared memory, under the 48 KB a
// launch may take without an opt-in (one tree of depth 10: 2047 nodes)
constexpr int kMaxStagedNodes = 3584;

template <typename BinT, bool kStaged>
__global__ void __launch_bounds__(kThreads)
xrt_walk_binned_kernel(const int* __restrict__ feature,
                       const int* __restrict__ split_bin,
                       const uint8_t* __restrict__ default_left,
                       const uint8_t* __restrict__ is_leaf,
                       const float* __restrict__ value, int heap, int n_trees,
                       const BinT* __restrict__ bins, long long n_rows,
                       int n_features, int max_depth, int missing_bin,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nodes = heap * n_trees;
  int* s_feat = reinterpret_cast<int*>(smem);
  int* s_sbin = s_feat + nodes;
  float* s_val = reinterpret_cast<float*>(s_sbin + nodes);
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_val + nodes);
  if (kStaged) {
    for (int i = threadIdx.x; i < nodes; i += kThreads) {
      s_feat[i] = feature[i];
      s_sbin[i] = split_bin[i];
      s_val[i] = value[i];
      s_flag[i] = (default_left[i] ? 1 : 0) | (is_leaf[i] ? 2 : 0);
    }
    __syncthreads();
  }
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= n_rows) return;
  const BinT* rb = bins + row * n_features;
  for (int t = 0; t < n_trees; ++t) {
    const int base = t * heap;
    int idx = 0;
    for (int d = 0; d < max_depth; ++d) {
      const int node = base + idx;
      const int flag = kStaged ? s_flag[node]
                               : ((__ldg(default_left + node) ? 1 : 0) |
                                  (__ldg(is_leaf + node) ? 2 : 0));
      if (flag & 2) break;  // a leaf keeps its index
      int f = kStaged ? s_feat[node] : __ldg(feature + node);
      f = min(max(f, 0), n_features - 1);
      const int b = (int)rb[f];
      const int sb = kStaged ? s_sbin[node] : __ldg(split_bin + node);
      const bool right = b == missing_bin ? !(flag & 1) : b > sb;
      idx = 2 * idx + 1 + (right ? 1 : 0);
    }
    out[(long long)t * n_rows + row] =
        kStaged ? s_val[base + idx] : __ldg(value + base + idx);
  }
}

template <typename BinT>
static int launch_walk(const int* feature, const int* split_bin,
                const uint8_t* default_left, const uint8_t* is_leaf,
                const float* value, int heap, int n_trees, const void* bins,
                long long n_rows, int n_features, int max_depth,
                int missing_bin, float* out, cudaStream_t s) {
  const long long blocks = (n_rows + kThreads - 1) / kThreads;
  const BinT* b = static_cast<const BinT*>(bins);
  if ((long long)heap * n_trees <= kMaxStagedNodes) {
    const size_t smem = (size_t)heap * n_trees * 13;
    xrt_walk_binned_kernel<BinT, true><<<(unsigned)blocks, kThreads, smem, s>>>(
        feature, split_bin, default_left, is_leaf, value, heap, n_trees, b,
        n_rows, n_features, max_depth, missing_bin, out);
  } else {
    xrt_walk_binned_kernel<BinT, false><<<(unsigned)blocks, kThreads, 0, s>>>(
        feature, split_bin, default_left, is_leaf, value, heap, n_trees, b,
        n_rows, n_features, max_depth, missing_bin, out);
  }
  return (int)cudaGetLastError();
}

// out[t * n_rows + r] = value[t][leaf of row r in tree t] for n_rows rows of
// bins [n_rows, n_features] (bin_bytes 1: uint8, 2: int16) and n_trees
// trees, each a padded heap of `heap` = 2^(max_depth + 1) - 1 nodes, the
// trees' arrays back to back (int32 feature and split_bin, bool
// default_left and is_leaf, f32 value).
extern "C" int xrt_walk_binned(const int* feature, const int* split_bin,
                               const uint8_t* default_left,
                               const uint8_t* is_leaf, const float* value,
                               int heap, int n_trees, const void* bins,
                               int bin_bytes, long long n_rows, int n_features,
                               int max_depth, int missing_bin, float* out,
                               void* stream) {
  if (n_rows <= 0) return 0;
  if (n_features < 1 || n_trees < 1 || heap != (1 << (max_depth + 1)) - 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto launch = bin_bytes == 1 ? launch_walk<uint8_t> : launch_walk<int16_t>;
  return launch(feature, split_bin, default_left, is_leaf, value, heap,
                n_trees, bins, n_rows, n_features, max_depth, missing_bin, out,
                s);
}
