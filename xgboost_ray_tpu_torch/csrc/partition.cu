// K3 — routing + stable partition + smaller-child compaction, CUDA C++ for
// sm_90a.
//
// Replaces, for one tree level, the JAX package's route_right_binned and
// the pos update in build_tree (xgboost_ray_tpu/ops/grow.py:65, :687-708),
// update_partition_order (ops/histogram.py:558) and select_small_child_rows
// (ops/histogram.py:603). Rows are kept sorted by node: order[seg[k] ..
// seg[k+1]) are the rows of node k, in increasing row id. After the level,
// every node's rows are split stably into (left child, right child), and
// the rows of each parent's smaller child are packed, by parent, into
// `small_rows` — the input of the next level's histogram build (K1).
//
// Node state: 1 = splits this level, 2 = becomes a leaf this level,
// 0 = inactive (a leaf above). Rows of non-splitting nodes route left, as
// the JAX grower's done rows do (grow.py:539-542, :704). The same pass
// writes each row's leaf value when its node becomes a leaf now (state 2);
// the grower's last call marks every final node a leaf.
//
// Three phases, no sort and no library scan:
//   1. per tile of TILE positions: go-right of each row from
//      bins[row, feature[node]], the tile's left count, and the left count
//      before every node boundary that falls in the tile;
//   2. one CTA: scan of the tile counts, children's counts and segment
//      starts, the smaller child of each parent (right on ties, from the
//      exact row counts, as grow.py:526) and the compacted segment starts;
//   3. per tile again: block scan of the left flags, then a stable scatter
//      of every row to its child segment, and of the smaller child's rows
//      to the compacted list.
// What bounds it: the per-row traffic (order read twice, one bin gathered
// twice per row, order + compacted list written): ~8 + 2 x 32-byte sector
// gathers per row; the scan is over N / TILE tile counts.
#include "common.cuh"

#define XRT_ITEMS 8
#define XRT_TILE (XRT_THREADS * XRT_ITEMS)

enum { XRT_INACTIVE = 0, XRT_SPLIT = 1, XRT_LEAF = 2 };

// node k of position p: the last k with seg[k] <= p (seg is non-decreasing)
__device__ __forceinline__ int xrt_node_of(const int* __restrict__ seg,
                                           int n_nodes, int p) {
  int lo = 0, hi = n_nodes;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (seg[mid] <= p) lo = mid; else hi = mid;
  }
  return lo;
}

template <typename BinT>
__device__ __forceinline__ bool xrt_goes_right(
    const BinT* __restrict__ bins, int n_features, int row, int node,
    const int* __restrict__ feature, const int* __restrict__ split_bin,
    const uint8_t* __restrict__ default_left,
    const uint8_t* __restrict__ state, int missing_bin) {
  if (state[node] != XRT_SPLIT) return false;
  const int b = (int)bins[(size_t)row * n_features + feature[node]];
  if (b == missing_bin) return default_left[node] == 0;
  return b > split_bin[node];
}

template <typename BinT>
__global__ void __launch_bounds__(XRT_THREADS)
xrt_part_count_kernel(const int* __restrict__ order, const int* __restrict__ seg,
                      int n_nodes, int n, const BinT* __restrict__ bins,
                      int n_features, const int* __restrict__ feature,
                      const int* __restrict__ split_bin,
                      const uint8_t* __restrict__ default_left,
                      const uint8_t* __restrict__ state, int missing_bin,
                      int* __restrict__ tile_left,
                      int* __restrict__ bnd_left) {
  __shared__ int s_off[XRT_THREADS];
  __shared__ uint8_t s_left[XRT_TILE];
  const int t0 = blockIdx.x * XRT_TILE;
  const int q0 = threadIdx.x * XRT_ITEMS;
  int c = 0;
#pragma unroll
  for (int j = 0; j < XRT_ITEMS; ++j) {
    const int p = t0 + q0 + j;
    int left = 0;
    if (p < n) {
      const int node = xrt_node_of(seg, n_nodes, p);
      left = xrt_goes_right(bins, n_features, order[p], node, feature,
                            split_bin, default_left, state, missing_bin)
                 ? 0 : 1;
    }
    s_left[q0 + j] = (uint8_t)left;
    c += left;
  }
  int total;
  const int excl = xrt_block_excl_scan(c, &total);
  s_off[threadIdx.x] = excl;
  if (threadIdx.x == 0) tile_left[blockIdx.x] = total;
  __syncthreads();
  // left count before each node boundary inside this tile
  const int t1 = min(t0 + XRT_TILE, n);
  for (int b = threadIdx.x; b <= n_nodes; b += blockDim.x) {
    const int q = seg[b];
    if (q < t0 || q >= t1) continue;
    const int local = q - t0;
    const int th = local / XRT_ITEMS;
    int v = s_off[th];
    for (int j = th * XRT_ITEMS; j < local; ++j) v += s_left[j];
    bnd_left[b] = v;
  }
}

__global__ void __launch_bounds__(1024)
xrt_part_scan_kernel(int n_tiles, int n, const int* __restrict__ seg,
                     int n_nodes, const uint8_t* __restrict__ state,
                     int* __restrict__ tile_left,  // in: counts, out: offsets
                     const int* __restrict__ bnd_left,
                     int* __restrict__ node_left0, int* __restrict__ new_seg,
                     int* __restrict__ small_seg,
                     uint8_t* __restrict__ small_is_right) {
  __shared__ int warp_sums[32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  // exclusive scan of the tile counts, 1024 at a time with a carry
  for (int base = 0; base < n_tiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < n_tiles ? tile_left[i] : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[wid] = x;
    __syncthreads();
    if (wid == 0) {
      int s = lane < nw ? warp_sums[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    const int excl = carry + x - v + (wid > 0 ? warp_sums[wid - 1] : 0);
    if (i < n_tiles) tile_left[i] = excl;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sums[nw - 1];
    __syncthreads();
  }
  const int total_left = carry;
  // left count before each node's first position, children's segments
  for (int k = threadIdx.x; k <= n_nodes; k += blockDim.x) {
    const int q = seg[k];
    node_left0[k] = q >= n ? total_left
                           : tile_left[q / XRT_TILE] + bnd_left[k];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_nodes; k += blockDim.x) {
    const int lc = node_left0[k + 1] - node_left0[k];
    const int rc = (seg[k + 1] - seg[k]) - lc;
    new_seg[2 * k + 1] = seg[k] + lc;
    new_seg[2 * k + 2] = seg[k + 1];
    // non-splitting nodes send every row left: their (empty) right child
    // is the "smaller" one and nothing is compacted for them
    const bool sir = state[k] == XRT_SPLIT ? rc <= lc : true;
    small_is_right[k] = sir ? 1 : 0;
    small_seg[k + 1] = sir ? rc : lc;  // counts; prefix-summed below
  }
  if (threadIdx.x == 0) {
    new_seg[0] = 0;
    small_seg[0] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k <= n_nodes; ++k) small_seg[k] += small_seg[k - 1];
  }
}

template <typename BinT>
__global__ void __launch_bounds__(XRT_THREADS)
xrt_part_scatter_kernel(
    const int* __restrict__ order, const int* __restrict__ seg, int n_nodes,
    int n, const BinT* __restrict__ bins, int n_features,
    const int* __restrict__ feature, const int* __restrict__ split_bin,
    const uint8_t* __restrict__ default_left,
    const uint8_t* __restrict__ state, int missing_bin,
    const float* __restrict__ node_value, int write_small, const int* __restrict__ tile_off,
    const int* __restrict__ node_left0, const int* __restrict__ new_seg,
    const int* __restrict__ small_seg,
    const uint8_t* __restrict__ small_is_right, int* __restrict__ new_order,
    int* __restrict__ small_rows, float* __restrict__ row_value) {
  const int t0 = blockIdx.x * XRT_TILE;
  const int q0 = threadIdx.x * XRT_ITEMS;
  int rows[XRT_ITEMS], nodes[XRT_ITEMS];
  uint8_t rights[XRT_ITEMS];
  int c = 0;
#pragma unroll
  for (int j = 0; j < XRT_ITEMS; ++j) {
    const int p = t0 + q0 + j;
    rows[j] = -1;
    nodes[j] = 0;
    rights[j] = 0;
    if (p < n) {
      const int node = xrt_node_of(seg, n_nodes, p);
      const int row = order[p];
      const bool r = xrt_goes_right(bins, n_features, row, node, feature,
                                    split_bin, default_left, state,
                                    missing_bin);
      rows[j] = row;
      nodes[j] = node;
      rights[j] = r ? 1 : 0;
      c += r ? 0 : 1;
    }
  }
  int total;
  const int excl = xrt_block_excl_scan(c, &total);
  int lefts_before = tile_off[blockIdx.x] + excl;  // global L(p)
#pragma unroll
  for (int j = 0; j < XRT_ITEMS; ++j) {
    const int p = t0 + q0 + j;
    if (p >= n) break;
    const int node = nodes[j];
    const int row = rows[j];
    const int l0 = node_left0[node];
    int dest, rank;
    if (!rights[j]) {
      rank = lefts_before - l0;
      dest = seg[node] + rank;
      ++lefts_before;
    } else {
      // R(p) - R(seg[node]) with R(q) = q - L(q)
      rank = (p - lefts_before) - (seg[node] - l0);
      dest = new_seg[2 * node + 1] + rank;
    }
    new_order[dest] = row;
    const uint8_t st = state[node];
    if (write_small && st == XRT_SPLIT && rights[j] == small_is_right[node])
      small_rows[small_seg[node] + rank] = row;
    if (st == XRT_LEAF) row_value[row] = node_value[node];
  }
}

template <typename BinT>
static int launch_partition(
    const int* order, const int* seg, int n_nodes, int n, const void* bins,
    int n_features, const int* feature, const int* split_bin,
    const uint8_t* default_left, const uint8_t* state, int missing_bin,
    const float* node_value, int write_small, int* tile_left, int* bnd_left, int* node_left0, int* new_order,
    int* new_seg, int* small_rows, int* small_seg, uint8_t* small_is_right,
    float* row_value, cudaStream_t s) {
  const int n_tiles = (n + XRT_TILE - 1) / XRT_TILE;
  xrt_part_count_kernel<BinT><<<n_tiles, XRT_THREADS, 0, s>>>(
      order, seg, n_nodes, n, (const BinT*)bins, n_features, feature,
      split_bin, default_left, state, missing_bin, tile_left, bnd_left);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xrt_part_scan_kernel<<<1, 1024, 0, s>>>(n_tiles, n, seg, n_nodes, state,
                                          tile_left, bnd_left, node_left0,
                                          new_seg, small_seg, small_is_right);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xrt_part_scatter_kernel<BinT><<<n_tiles, XRT_THREADS, 0, s>>>(
      order, seg, n_nodes, n, (const BinT*)bins, n_features, feature,
      split_bin, default_left, state, missing_bin, node_value, write_small,
      tile_left, node_left0, new_seg, small_seg, small_is_right,
      new_order, small_rows, row_value);
  return (int)cudaGetLastError();
}

// Scratch: tile_left [ceil(n / tile)], bnd_left [n_nodes + 1],
// node_left0 [n_nodes + 1]. Outputs: new_order [n], new_seg [2 n_nodes + 1],
// small_rows [>= n / 2] (only the first small_seg[n_nodes] are written),
// small_seg [n_nodes + 1], small_is_right [n_nodes], row_value [n] (only the
// rows of nodes that become leaves on this level are written).
extern "C" int xrt_partition(const int* order, const int* seg, int n_nodes,
                             int n, const void* bins, int bin_bytes,
                             int n_features, const int* feature,
                             const int* split_bin,
                             const uint8_t* default_left, const uint8_t* state,
                             int missing_bin, const float* node_value,
                             int write_small,
                             int* tile_left, int* bnd_left, int* node_left0,
                             int* new_order, int* new_seg, int* small_rows,
                             int* small_seg, uint8_t* small_is_right,
                             float* row_value, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bin_bytes == 1)
    return launch_partition<uint8_t>(
        order, seg, n_nodes, n, bins, n_features, feature, split_bin,
        default_left, state, missing_bin, node_value, write_small, tile_left, bnd_left, node_left0, new_order, new_seg,
        small_rows, small_seg, small_is_right, row_value, s);
  return launch_partition<int16_t>(
      order, seg, n_nodes, n, bins, n_features, feature, split_bin,
      default_left, state, missing_bin, node_value, write_small, tile_left, bnd_left, node_left0, new_order, new_seg, small_rows,
      small_seg, small_is_right, row_value, s);
}

extern "C" int xrt_partition_tile() { return XRT_TILE; }
