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
// writes each row's leaf value when its node becomes a leaf now (state 2).
//
// Three phases, no sort and no library scan:
//   1. route: per tile of TILE positions, each row's go-right flag from
//      bins[row, feature[node]] — the level's only bins gather — stored as
//      a bit mask by position (one byte per thread of 8 positions), the
//      tile's left count, and the left count before every node boundary
//      that falls in the tile;
//   2. one CTA: scan of the tile counts, children's counts and segment
//      starts, the smaller child of each parent (right on ties, from the
//      exact row counts, as grow.py:526) and the compacted segment starts;
//   3. scatter: per tile again, the flags from the mask (no gather), a
//      block scan of the left and right counts, then a stable scatter of
//      every row to its child segment and of the smaller child's rows to
//      the compacted list, staged in shared memory (lefts, then rights)
//      so the writes are coalesced; and the leaf values.
// A thread owns XRT_ITEMS consecutive positions: it binary-searches the
// node of its first position once and steps forward across boundaries.
// Above one rank the smaller child must be the same on every rank, so it is
// chosen from the children's counts summed over the ranks (grow.py:509-526):
// the caller runs phases 1-2 without the choice (xrt_partition_route),
// all-reduces the counts, and phase 3 (xrt_partition_scatter) first makes
// the choice from them in one CTA (xrt_part_choose_kernel, the same code as
// phase 2's) and then compacts as at one rank, into a list of n slots (a
// child that is the smaller one over all ranks may hold most of this
// rank's rows).
// The grower's last call, where every node is a leaf or inactive and no row
// moves, takes the leaf-value pass alone (xrt_leaf_values): one light pass
// that writes row_value[order[p]] = node_value[node(p)] for leaf nodes.
// Categorical features (the reference's route_right_binned with is_cat,
// grow.py:65-75) take the route kernel's categorical instantiation: the
// [F] flags `cat`, read beside default_left for the node's split feature,
// send a present bin right unless it equals split_bin (one-vs-rest); the
// missing bin follows default_left as before. The main path (cat null)
// takes the numeric instantiation as it was.
// What bounds it: the routing gather. It needs 2 bytes per row, but the
// memory system moves at least one 32-byte sector per row, so with 56-byte
// rows (28 int16 features) the pass reads about all of bins at every
// level, in id order at the root as much as 32 rows apart at level 5; the
// route pass is most of K3's time. The rest: order read twice,
// the new order and the compacted list written, the mask written and read
// back (N / 4 bytes), leaf values scattered by row id; the scan is over
// N / TILE tile counts.
#include "common.cuh"

#define XRT_ITEMS 8  // positions per thread: one byte of the go-right mask
#define XRT_TILE (XRT_THREADS * XRT_ITEMS)
static_assert(XRT_ITEMS == 8, "mask byte p / 8 holds positions p .. p + 7");

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

// step node forward to the node of position p (p non-decreasing per call)
__device__ __forceinline__ int xrt_node_step(const int* __restrict__ seg,
                                             int n_nodes, int node, int p) {
  while (node + 1 < n_nodes && __ldg(seg + node + 1) <= p) ++node;
  return node;
}

// The XRT_ITEMS row ids at positions p0 .. p0 + XRT_ITEMS - 1 (p0 is a
// multiple of XRT_ITEMS; order is 16-byte aligned, the wrapper checks);
// positions at or past n read as -1. LAST: this is the pass's last read of
// order, so it streams (evict-first) and leaves L2 to the row-indexed
// writes, which then merge into whole sectors there.
template <bool LAST>
__device__ __forceinline__ void xrt_load_rows(const int* __restrict__ order,
                                              int n, int p0,
                                              int (&rows)[XRT_ITEMS]) {
  if (p0 + XRT_ITEMS <= n) {
    const int4* v = reinterpret_cast<const int4*>(order + p0);
#pragma unroll
    for (int j = 0; j < XRT_ITEMS / 4; ++j) {
      const int4 x = LAST ? __ldcs(v + j) : __ldg(v + j);
      rows[4 * j] = x.x;
      rows[4 * j + 1] = x.y;
      rows[4 * j + 2] = x.z;
      rows[4 * j + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < XRT_ITEMS; ++j)
      rows[j] = p0 + j < n ? (LAST ? __ldcs(order + p0 + j)
                                   : __ldg(order + p0 + j)) : -1;
  }
}

template <typename BinT, bool CAT>
__global__ void __launch_bounds__(XRT_THREADS)
xrt_part_route_kernel(const int* __restrict__ order, const int* __restrict__ seg,
                      int n_nodes, int n, const BinT* __restrict__ bins,
                      int n_features, const int* __restrict__ feature,
                      const int* __restrict__ split_bin,
                      const uint8_t* __restrict__ default_left,
                      const uint8_t* __restrict__ state, int missing_bin,
                      const uint8_t* __restrict__ cat,
                      uint8_t* __restrict__ mask, int* __restrict__ tile_left,
                      int* __restrict__ bnd_left) {
  __shared__ int s_off[XRT_THREADS];
  __shared__ uint8_t s_lbits[XRT_THREADS];
  const int t0 = blockIdx.x * XRT_TILE;
  const int p0 = t0 + threadIdx.x * XRT_ITEMS;
  int rows[XRT_ITEMS];
  xrt_load_rows<false>(order, n, p0, rows);
  int node = p0 < n ? xrt_node_of(seg, n_nodes, p0) : 0;
  // gather the routing bins of all positions first (independent loads)
  int b[XRT_ITEMS], sb[XRT_ITEMS];
  uint32_t valid = 0, split_bits = 0, dl_bits = 0, cat_bits = 0;
#pragma unroll
  for (int j = 0; j < XRT_ITEMS; ++j) {
    b[j] = 0;
    sb[j] = 0;
    if (rows[j] < 0) continue;
    valid |= 1u << j;
    node = xrt_node_step(seg, n_nodes, node, p0 + j);
    if (__ldg(state + node) != XRT_SPLIT) continue;
    split_bits |= 1u << j;
    dl_bits |= (uint32_t)(__ldg(default_left + node) != 0) << j;
    sb[j] = __ldg(split_bin + node);
    const int fe = __ldg(feature + node);
    if (CAT) cat_bits |= (uint32_t)(__ldg(cat + fe) != 0) << j;
    b[j] = (int)bins[(size_t)rows[j] * n_features + fe];
  }
  uint32_t right = 0;
#pragma unroll
  for (int j = 0; j < XRT_ITEMS; ++j) {
    if (!(split_bits >> j & 1u)) continue;
    const bool present_right =
        CAT && (cat_bits >> j & 1u) ? b[j] != sb[j] : b[j] > sb[j];
    const bool r = b[j] == missing_bin ? !(dl_bits >> j & 1u) : present_right;
    right |= (uint32_t)r << j;
  }
  if (p0 < n) mask[p0 / XRT_ITEMS] = (uint8_t)right;
  const uint32_t lbits = valid & ~right;
  int total;
  const int excl = xrt_block_excl_scan(__popc(lbits), &total);
  s_off[threadIdx.x] = excl;
  s_lbits[threadIdx.x] = (uint8_t)lbits;
  if (threadIdx.x == 0) tile_left[blockIdx.x] = total;
  __syncthreads();
  // left count before each node boundary inside this tile
  const int t1 = min(t0 + XRT_TILE, n);
  for (int k = threadIdx.x; k <= n_nodes; k += blockDim.x) {
    const int q = seg[k];
    if (q < t0 || q >= t1) continue;
    const int local = q - t0;
    const int th = local / XRT_ITEMS;
    const int j = local % XRT_ITEMS;
    bnd_left[k] = s_off[th] + __popc(s_lbits[th] & ((1u << j) - 1u));
  }
}

// The smaller child of every parent and the compacted segment starts, by
// the whole CTA: from `child_counts` [2 n_nodes] (the counts summed over
// the ranks) or, when it is null, from this rank's children's segments
// `new_seg`. Right on ties (grow.py:526); non-splitting nodes send every
// row left: their (empty) right child is the "smaller" one and nothing is
// compacted for them. small_seg counts this rank's rows of the chosen
// child, prefix-summed.
__device__ void xrt_choose_small(int n_nodes, const uint8_t* __restrict__ state,
                                 const int* __restrict__ new_seg,
                                 const long long* __restrict__ child_counts,
                                 int* __restrict__ small_seg,
                                 uint8_t* __restrict__ small_is_right) {
  for (int k = threadIdx.x; k < n_nodes; k += blockDim.x) {
    const int lc = new_seg[2 * k + 1] - new_seg[2 * k];
    const int rc = new_seg[2 * k + 2] - new_seg[2 * k + 1];
    const long long glc = child_counts ? child_counts[2 * k] : lc;
    const long long grc = child_counts ? child_counts[2 * k + 1] : rc;
    const bool sir = state[k] == XRT_SPLIT ? grc <= glc : true;
    small_is_right[k] = sir ? 1 : 0;
    small_seg[k + 1] = sir ? rc : lc;  // counts; prefix-summed below
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    small_seg[0] = 0;
    for (int k = 1; k <= n_nodes; ++k) small_seg[k] += small_seg[k - 1];
  }
}

__global__ void __launch_bounds__(1024)
xrt_part_scan_kernel(int n_tiles, int n, const int* __restrict__ seg,
                     int n_nodes, const uint8_t* __restrict__ state,
                     int* __restrict__ tile_left,  // in: counts, out: offsets
                     const int* __restrict__ bnd_left,
                     int* __restrict__ node_left0, int* __restrict__ new_seg,
                     int choose, int* __restrict__ small_seg,
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
    new_seg[2 * k + 1] = seg[k] + lc;
    new_seg[2 * k + 2] = seg[k + 1];
  }
  if (threadIdx.x == 0) new_seg[0] = 0;
  __syncthreads();
  if (choose)
    xrt_choose_small(n_nodes, state, new_seg, nullptr, small_seg,
                     small_is_right);
}

// Phase 3's choice from the counts summed over the ranks (one CTA).
__global__ void __launch_bounds__(1024)
xrt_part_choose_kernel(int n_nodes, const uint8_t* __restrict__ state,
                       const int* __restrict__ new_seg,
                       const long long* __restrict__ child_counts,
                       int* __restrict__ small_seg,
                       uint8_t* __restrict__ small_is_right) {
  xrt_choose_small(n_nodes, state, new_seg, child_counts, small_seg,
                   small_is_right);
}

__global__ void __launch_bounds__(XRT_THREADS)
xrt_part_scatter_kernel(
    const int* __restrict__ order, const int* __restrict__ seg, int n_nodes,
    int n, const uint8_t* __restrict__ state,
    const float* __restrict__ node_value, int write_small,
    const uint8_t* __restrict__ mask, const int* __restrict__ tile_off,
    const int* __restrict__ node_left0, const int* __restrict__ new_seg,
    const int* __restrict__ small_seg,
    const uint8_t* __restrict__ small_is_right, int* __restrict__ new_order,
    int* __restrict__ small_rows, float* __restrict__ row_value) {
  // the tile's rows staged lefts first, then rights, each in position
  // order: consecutive slots then have consecutive destinations (within a
  // child), so the global writes below are coalesced
  __shared__ int s_row[XRT_TILE];
  __shared__ int s_dest[XRT_TILE];
  __shared__ int s_small[XRT_TILE];  // slot in small_rows, or -1
  const int t0 = blockIdx.x * XRT_TILE;
  const int p0 = t0 + threadIdx.x * XRT_ITEMS;
  int rows[XRT_ITEMS];
  xrt_load_rows<true>(order, n, p0, rows);
  uint32_t right = 0, valid = 0;
  if (p0 < n) {
    right = mask[p0 / XRT_ITEMS];
    valid = p0 + XRT_ITEMS <= n ? (1u << XRT_ITEMS) - 1u
                                : (1u << (n - p0)) - 1u;
  }
  // one scan of both counts: lefts in the low 16 bits, rights above
  int total;
  const int ex = xrt_block_excl_scan(
      __popc(valid & ~right) | (__popc(valid & right) << 16), &total);
  int left_slot = ex & 0xffff;
  int right_slot = (total & 0xffff) + (ex >> 16);
  if (p0 < n) {
    int lefts_before = tile_off[blockIdx.x] + (ex & 0xffff);  // global L(p)
    int node = xrt_node_of(seg, n_nodes, p0);
    int cur = -1, s0 = 0, l0 = 0, r0 = 0, ss = 0;
    uint8_t st = 0, sir = 0;
    float nv = 0.f;
#pragma unroll
    for (int j = 0; j < XRT_ITEMS; ++j) {
      const int p = p0 + j;
      if (p >= n) break;
      node = xrt_node_step(seg, n_nodes, node, p);
      if (node != cur) {
        cur = node;
        s0 = __ldg(seg + node);
        l0 = __ldg(node_left0 + node);
        r0 = __ldg(new_seg + 2 * node + 1);
        st = __ldg(state + node);
        sir = __ldg(small_is_right + node);
        ss = __ldg(small_seg + node);
        nv = __ldg(node_value + node);
      }
      const int row = rows[j];
      const uint32_t rt = right >> j & 1u;
      int dest, rank, slot;
      if (!rt) {
        rank = lefts_before - l0;
        dest = s0 + rank;
        ++lefts_before;
        slot = left_slot++;
      } else {
        // R(p) - R(seg[node]) with R(q) = q - L(q)
        rank = (p - lefts_before) - (s0 - l0);
        dest = r0 + rank;
        slot = right_slot++;
      }
      s_row[slot] = row;
      s_dest[slot] = dest;
      s_small[slot] =
          write_small && st == XRT_SPLIT && rt == sir ? ss + rank : -1;
      if (st == XRT_LEAF) row_value[row] = nv;
    }
  }
  __syncthreads();
  const int count = min(XRT_TILE, n - t0);
  for (int i = threadIdx.x; i < count; i += XRT_THREADS) {
    const int row = s_row[i];
    new_order[s_dest[i]] = row;
    const int slot = s_small[i];
    if (slot >= 0) small_rows[slot] = row;
  }
}

// The leaf-value pass alone: row_value[order[p]] = node_value[node(p)] for
// every position p of a LEAF node; nothing else is read or written.
__global__ void __launch_bounds__(XRT_THREADS)
xrt_leaf_values_kernel(const int* __restrict__ order,
                       const int* __restrict__ seg, int n_nodes, int n,
                       const uint8_t* __restrict__ state,
                       const float* __restrict__ node_value,
                       float* __restrict__ row_value) {
  const int p0 = (blockIdx.x * XRT_THREADS + threadIdx.x) * XRT_ITEMS;
  if (p0 >= n) return;
  int rows[XRT_ITEMS];
  xrt_load_rows<true>(order, n, p0, rows);
  int node = xrt_node_of(seg, n_nodes, p0);
#pragma unroll
  for (int j = 0; j < XRT_ITEMS; ++j) {
    if (rows[j] < 0) break;
    node = xrt_node_step(seg, n_nodes, node, p0 + j);
    if (__ldg(state + node) == XRT_LEAF)
      row_value[rows[j]] = __ldg(node_value + node);
  }
}

template <typename BinT>
static int launch_route(const int* order, const int* seg, int n_nodes, int n,
                        const void* bins, int n_features, const int* feature,
                        const int* split_bin, const uint8_t* default_left,
                        const uint8_t* state, int missing_bin,
                        const uint8_t* cat, uint8_t* mask,
                        int* tile_left, int* bnd_left, int* node_left0,
                        int* new_seg, int choose, int* small_seg,
                        uint8_t* small_is_right, cudaStream_t s) {
  const int n_tiles = (n + XRT_TILE - 1) / XRT_TILE;
  if (cat != nullptr)
    xrt_part_route_kernel<BinT, true><<<n_tiles, XRT_THREADS, 0, s>>>(
        order, seg, n_nodes, n, (const BinT*)bins, n_features, feature,
        split_bin, default_left, state, missing_bin, cat, mask, tile_left,
        bnd_left);
  else
    xrt_part_route_kernel<BinT, false><<<n_tiles, XRT_THREADS, 0, s>>>(
        order, seg, n_nodes, n, (const BinT*)bins, n_features, feature,
        split_bin, default_left, state, missing_bin, nullptr, mask,
        tile_left, bnd_left);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xrt_part_scan_kernel<<<1, 1024, 0, s>>>(n_tiles, n, seg, n_nodes, state,
                                          tile_left, bnd_left, node_left0,
                                          new_seg, choose, small_seg,
                                          small_is_right);
  return (int)cudaGetLastError();
}

// Phases 1-2. order [n] int32 (16-byte aligned), seg [n_nodes + 1] with
// seg[n_nodes] == n. Scratch: mask [ceil(n / 8)] bytes, tile_left
// [n_tiles], bnd_left [n_nodes + 1], node_left0 [n_nodes + 1] (n_tiles =
// ceil(n / tile)); phase 3 reads them. Outputs: new_seg [2 n_nodes + 1]
// and, with `choose` (one rank), small_seg [n_nodes + 1] and
// small_is_right [n_nodes] from this rank's counts. cat: the [F]
// categorical flags, or null (no categorical feature).
extern "C" int xrt_partition_route(const int* order, const int* seg,
                                   int n_nodes, int n, const void* bins,
                                   int bin_bytes, int n_features,
                                   const int* feature, const int* split_bin,
                                   const uint8_t* default_left,
                                   const uint8_t* state, int missing_bin,
                                   const uint8_t* cat,
                                   uint8_t* mask, int* tile_left,
                                   int* bnd_left, int* node_left0,
                                   int* new_seg, int choose, int* small_seg,
                                   uint8_t* small_is_right, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bin_bytes == 1)
    return launch_route<uint8_t>(
        order, seg, n_nodes, n, bins, n_features, feature, split_bin,
        default_left, state, missing_bin, cat, mask, tile_left, bnd_left,
        node_left0, new_seg, choose, small_seg, small_is_right, s);
  return launch_route<int16_t>(
      order, seg, n_nodes, n, bins, n_features, feature, split_bin,
      default_left, state, missing_bin, cat, mask, tile_left, bnd_left,
      node_left0, new_seg, choose, small_seg, small_is_right, s);
}

// Phase 3, after xrt_partition_route on the same scratch. child_counts:
// null when the route phase chose the smaller children, else [2 n_nodes]
// int64 children's counts summed over the ranks, from which they are
// chosen here first. Outputs: new_order [n], small_rows (only the first
// small_seg[n_nodes] are written: at most n / 2 with this rank's choice,
// at most n with the ranks'), small_seg, small_is_right, row_value [n]
// (only the rows of nodes that become leaves on this level are written).
extern "C" int xrt_partition_scatter(
    const int* order, const int* seg, int n_nodes, int n,
    const uint8_t* state, const float* node_value, int write_small,
    const uint8_t* mask, const int* tile_left, const int* node_left0,
    const int* new_seg, const long long* child_counts, int* small_seg,
    uint8_t* small_is_right, int* new_order, int* small_rows,
    float* row_value, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (child_counts) {
    xrt_part_choose_kernel<<<1, 1024, 0, s>>>(n_nodes, state, new_seg,
                                              child_counts, small_seg,
                                              small_is_right);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int n_tiles = (n + XRT_TILE - 1) / XRT_TILE;
  xrt_part_scatter_kernel<<<n_tiles, XRT_THREADS, 0, s>>>(
      order, seg, n_nodes, n, state, node_value, write_small, mask, tile_left,
      node_left0, new_seg, small_seg, small_is_right, new_order, small_rows,
      row_value);
  return (int)cudaGetLastError();
}

// Leaf-value mode: order [n] (16-byte aligned), seg [n_nodes + 1],
// state [n_nodes], node_value [n_nodes]; writes row_value [n] in place.
extern "C" int xrt_leaf_values(const int* order, const int* seg, int n_nodes,
                               int n, const uint8_t* state,
                               const float* node_value, float* row_value,
                               void* stream) {
  const int n_tiles = (n + XRT_TILE - 1) / XRT_TILE;
  xrt_leaf_values_kernel<<<n_tiles, XRT_THREADS, 0, (cudaStream_t)stream>>>(
      order, seg, n_nodes, n, state, node_value, row_value);
  return (int)cudaGetLastError();
}

extern "C" int xrt_partition_tile() { return XRT_TILE; }
