// B4: the binned tree walk. T trees of equal depth over pre-binned rows;
// every row's leaf value in each tree, which the engine adds to an eval
// set's margins each round (ops/objectives.round_update's eval mode for
// one tree, the softmax pass's eval mode for a round's K class trees).
//
// Replaces xgboost_ray_tpu/ops/grow.py:786 predict_tree_binned with the rule
// of route_right_binned (:65): a numeric bin > split_bin goes right, the
// missing bin (max_bin) follows the learned default, a categorical bin goes
// left only where it equals split_bin (one-vs-rest: the node record's
// categorical flag, set from the [F] flags `cat` as B8 sets
// XRT_F_CATEGORICAL, csrc/predict.cu:94; a kCat instantiation of its own,
// so the numeric walk compiles as it was); a leaf keeps its index
// for the remaining steps (jnp.where(is_leaf[idx], idx, nxt)). The result
// is integer routing plus one read of value[leaf]: bitwise the plain
// version (ops/grow.predict_tree_binned_plain).
//
// What bounds it on an H100: bytes. A walk needs one bin a visit, mostly in
// the sectors of its own row (28-108 bytes at the main paths' widths), and
// writes 4 bytes a row and tree. The first version (one thread a row, one
// dependent device-memory gather a visit, three shared arrays read a visit)
// was latency-bound at 17-42 % of that bound. Design (ops/grow.walk_plan
// picks the mapping, the rows a tile R and the trees a group G):
//   - persistent CTAs (as many as the SMs hold) walk tiles of R rows in
//     turn. In the tiled mapping a tile's bins, R x F x 1|2 contiguous
//     bytes, are copied into shared memory with 16-byte cp.async through a
//     ring of kStages buffers: the next tiles are in flight while the CTA
//     walks the current one (the first ones while it stages the forest),
//     and every visit then reads shared memory. Rows too wide for a
//     tile of 32 (or bins not 16-byte aligned) take the gather mapping:
//     the same walk reading each visit's bin from device memory;
//   - the forest is staged once a CTA as packed 8-byte node records (the
//     feature clamped to [0, F - 1] in 24 bits, the leaf and default-left
//     flags above it; split_bin), one shared load a visit, with the values
//     apart (read once a walk). A forest too large to stay beside the tiles
//     is staged in groups of G trees, each group walked over the resident
//     tile; one deeper than a CTA's shared memory is read from device
//     memory (K rows of 13 bytes a node);
//   - a thread walks kChains (row, tree) items in lock step, items ordered
//     row-fastest, so a warp's items are 32 consecutive rows of one tree
//     and its writes of [T][n_rows] are coalesced;
//   - every walk takes max_depth steps; a leaf's step selects its own index.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kChains = 2;  // (row, tree) items a thread walks in lock step
// tile buffers a CTA cycles (ops/grow.py's _WALK_STAGES: edit both together)
constexpr int kStages = 2;
constexpr unsigned kFeatureMask = 0x00FFFFFFu;
constexpr unsigned kLeaf = 1u << 24;
constexpr unsigned kDefaultLeft = 1u << 25;
constexpr unsigned kCategorical = 1u << 26;

enum { XRT_WALK_TILED = 0, XRT_WALK_GATHER = 1 };

// Mirrors ops/_build.WalkArgs field by field: edit both together.
struct XrtWalkArgs {
  const int* feature;          // [T][heap] int32
  const int* split_bin;        // [T][heap] int32
  const uint8_t* default_left; // [T][heap] bool
  const uint8_t* is_leaf;      // [T][heap] bool
  const float* value;          // [T][heap] f32
  const void* bins;            // [n_rows][n_features] uint8 or int16
  float* out;                  // [T][n_rows]
  long long n_rows;
  int n_features, bin_bytes, n_trees, max_depth, missing_bin;
  int mapping;          // XRT_WALK_TILED or XRT_WALK_GATHER
  int rows_per_tile;    // R: a power of two
  int trees_per_group;  // G: trees staged at once; 0: the forest unstaged
  int shared_bytes;     // dynamic shared memory a CTA
  int grid;             // CTAs all SMs hold at shared_bytes (xrt_walk_ctas)
  const uint8_t* cat;   // [n_features] categorical flags (a launch) or null
  int categorical;      // 1: the categorical instantiation (cat non-null)
};

__device__ __forceinline__ long long xrt_round16(long long b) {
  return (b + 15) & ~15LL;
}

// the packed record of node i of the forest arrays (its categorical bit
// only in the categorical instantiation) of a launch's args (XrtWalkArgs,
// XrtWalkWeightedArgs)
template <bool kCat, typename Args>
__device__ __forceinline__ uint2 xrt_record(const Args& a, long long i) {
  const int f = min(max(__ldg(a.feature + i), 0), a.n_features - 1);
  return make_uint2((unsigned)f | (__ldg(a.is_leaf + i) ? kLeaf : 0u) |
                        (__ldg(a.default_left + i) ? kDefaultLeft : 0u) |
                        (kCat && __ldg(a.cat + f) ? kCategorical : 0u),
                    (unsigned)__ldg(a.split_bin + i));
}

// the routing rule on a packed record: the missing bin follows the default,
// a numeric bin goes right above split_bin, and in the categorical
// instantiation (kCat) a categorical one unless it is split_bin
template <bool kCat>
__device__ __forceinline__ bool xrt_right(uint2 nd, int b, int missing_bin) {
  if (b == missing_bin) return !(nd.x & kDefaultLeft);
  return kCat && (nd.x & kCategorical) ? b != (int)nd.y : b > (int)nd.y;
}

// trees [t0, t0 + nt) into recs / vals ([nt][heap] each)
template <bool kCat>
__device__ __forceinline__ void xrt_stage_forest(const XrtWalkArgs& a,
                                                 uint2* recs, float* vals,
                                                 int t0, int nt, int heap) {
  const long long base = (long long)t0 * heap;
#pragma unroll 4
  for (int i = threadIdx.x; i < nt * heap; i += kThreads) {
    recs[i] = xrt_record<kCat>(a, base + i);
    vals[i] = __ldg(a.value + base + i);
  }
}

// tile `tile`'s bins into dst: 16-byte cp.async for the whole 16-byte
// chunks (the tile starts 16-byte aligned), plain copies for the last
// tile's tail; one commit group (empty past the last tile, so that every
// thread counts the same groups)
__device__ __forceinline__ void xrt_stage_tile(const XrtWalkArgs& a,
                                               unsigned char* dst,
                                               long long tile) {
  const int R = a.rows_per_tile;
  if (tile >= (a.n_rows + R - 1) / R) {
    asm volatile("cp.async.commit_group;\n" ::);
    return;
  }
  const long long row_bytes = (long long)a.n_features * a.bin_bytes;
  const long long b0 = tile * R * row_bytes;
  const long long b1 = min(b0 + R * row_bytes, a.n_rows * row_bytes);
  const int nbytes = (int)(b1 - b0);
  const unsigned char* src = static_cast<const unsigned char*>(a.bins) + b0;
  const int n16 = nbytes >> 4;
  for (int i = threadIdx.x; i < n16; i += kThreads) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + 16 * i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src + 16 * i));
  }
  for (int i = n16 * 16 + threadIdx.x; i < nbytes; i += kThreads)
    dst[i] = src[i];
  asm volatile("cp.async.commit_group;\n" ::);
}

// Walk the items of one (tile, group): item e is row e % R of the tile in
// tree e / R of the group (R a power of two, lg_r its log). With the rows
// and the forest in shared memory the walk runs on byte offsets into it,
// as B8's does (csrc/predict.cu xrt_walk_shared): a node at heap index h
// of a tree at byte tb sits at tb + 8h, its child 2h + 1 + right at
// 2 (tb + 8h) + 8 - tb + 8 right: a select and a shift-add a step.
template <typename BinT, bool kTiled, bool kForestShared, bool kCat>
__device__ __forceinline__ void xrt_walk_items(
    const XrtWalkArgs& a, const unsigned char* smem, const uint2* recs,
    const float* vals, const BinT* tile_bins, long long row0, int n_valid,
    int t0, int nt, int heap, int lg_r) {
  const int R = a.rows_per_tile, F = a.n_features;
  const int n_items = R * nt;
  const BinT* gbins = static_cast<const BinT*>(a.bins);
  for (int e0 = threadIdx.x; e0 < n_items; e0 += kThreads * kChains) {
    int r[kChains], t[kChains], idx[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const int e = min(e0 + c * kThreads, n_items - 1);
      r[c] = e & (R - 1);
      t[c] = e >> lg_r;
    }
    if constexpr (kTiled && kForestShared) {
      unsigned at[kChains], tb[kChains], row_at[kChains];
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        tb[c] = (unsigned)((const unsigned char*)(recs + t[c] * heap) - smem);
        at[c] = tb[c];
        row_at[c] = (unsigned)((const unsigned char*)(
                        tile_bins + min(r[c], n_valid - 1) * F) - smem);
      }
      for (int d = 0; d < a.max_depth; ++d) {
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          const uint2 nd = *reinterpret_cast<const uint2*>(smem + at[c]);
          const int b = (int)*reinterpret_cast<const BinT*>(
              smem + row_at[c] + (nd.x & kFeatureMask) * sizeof(BinT));
          const bool right = xrt_right<kCat>(nd, b, a.missing_bin);
          const unsigned nxt = 2u * at[c] + 8u - tb[c] + (right ? 8u : 0u);
          at[c] = (nd.x & kLeaf) ? at[c] : nxt;
        }
      }
#pragma unroll
      for (int c = 0; c < kChains; ++c) idx[c] = (int)((at[c] - tb[c]) >> 3);
    } else {
      const BinT* rb[kChains];
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        idx[c] = 0;
        const int rr = min(r[c], n_valid - 1);
        rb[c] = kTiled ? tile_bins + (long long)rr * F
                       : gbins + (row0 + rr) * (long long)F;
      }
      for (int d = 0; d < a.max_depth; ++d) {
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          const uint2 nd =
              kForestShared
                  ? recs[t[c] * heap + idx[c]]
                  : xrt_record<kCat>(a, (long long)(t0 + t[c]) * heap +
                                           idx[c]);
          const unsigned f = nd.x & kFeatureMask;
          const int b = kTiled ? (int)rb[c][f] : (int)__ldg(rb[c] + f);
          const bool right = xrt_right<kCat>(nd, b, a.missing_bin);
          const int nxt = 2 * idx[c] + 1 + (right ? 1 : 0);
          idx[c] = (nd.x & kLeaf) ? idx[c] : nxt;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      if (e0 + c * kThreads < n_items && r[c] < n_valid) {
        const float v =
            kForestShared
                ? vals[t[c] * heap + idx[c]]
                : __ldg(a.value + (long long)(t0 + t[c]) * heap + idx[c]);
        a.out[(long long)(t0 + t[c]) * a.n_rows + row0 + r[c]] = v;
      }
    }
  }
}

template <typename BinT, bool kTiled, bool kForestShared, bool kCat>
__global__ void __launch_bounds__(kThreads)
    xrt_walk_kernel(const XrtWalkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int heap = (2 << a.max_depth) - 1;
  const int R = a.rows_per_tile, lg_r = __ffs(R) - 1;
  const int G = kForestShared ? a.trees_per_group : a.n_trees;
  const int n_groups = (a.n_trees + G - 1) / G;
  uint2* recs = reinterpret_cast<uint2*>(smem);
  float* vals =
      reinterpret_cast<float*>(recs + (kForestShared ? G * heap : 0));
  const long long forest_bytes = kForestShared ? xrt_round16(12LL * G * heap)
                                               : 0;
  const long long tile_bytes =
      xrt_round16((long long)R * a.n_features * a.bin_bytes);
  unsigned char* tiles = smem + forest_bytes;  // [kStages][tile_bytes]
  const long long n_tiles = (a.n_rows + R - 1) / R;

  // the first tiles' copies go out before the forest is staged
  if (kTiled)
    for (int j = 0; j < kStages - 1; ++j)
      xrt_stage_tile(a, tiles + j * tile_bytes,
                     blockIdx.x + (long long)j * gridDim.x);
  if (kForestShared && n_groups == 1)
    xrt_stage_forest<kCat>(a, recs, vals, 0, a.n_trees, heap);
  int buf = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    if (kTiled) {
      // the copy kStages - 1 tiles ahead, then this tile's is complete
      xrt_stage_tile(a, tiles + ((buf + kStages - 1) % kStages) * tile_bytes,
                     tile + (long long)(kStages - 1) * gridDim.x);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
    }
    __syncthreads();
    const long long row0 = tile * R;
    const int n_valid = (int)min((long long)R, a.n_rows - row0);
    const BinT* tb = reinterpret_cast<const BinT*>(tiles + buf * tile_bytes);
    for (int g = 0; g < n_groups; ++g) {
      const int t0 = g * G, nt = min(G, a.n_trees - t0);
      if (kForestShared && n_groups > 1) {
        xrt_stage_forest<kCat>(a, recs, vals, t0, nt, heap);
        __syncthreads();
      }
      xrt_walk_items<BinT, kTiled, kForestShared, kCat>(
          a, smem, recs, vals, tb, row0, n_valid, t0, nt, heap, lg_r);
      if (kForestShared && n_groups > 1) __syncthreads();
    }
    __syncthreads();  // the buffer is free for a later tile's copy
    buf = (buf + 1) % kStages;
  }
}

typedef void (*XrtWalkKernel)(const XrtWalkArgs);

template <typename BinT, bool kCat>
static XrtWalkKernel walk_kernel(bool tiled, bool forest_shared) {
  if (tiled)
    return forest_shared ? xrt_walk_kernel<BinT, true, true, kCat>
                         : xrt_walk_kernel<BinT, true, false, kCat>;
  return forest_shared ? xrt_walk_kernel<BinT, false, true, kCat>
                       : xrt_walk_kernel<BinT, false, false, kCat>;
}

// the instantiation of a launch: bins' width, mapping, forest staging, and
// the categorical one where a->categorical is set (the numeric walk is
// compiled as it was without categorical features)
static XrtWalkKernel pick_kernel(const XrtWalkArgs* a) {
  const bool tiled = a->mapping == XRT_WALK_TILED;
  const bool forest_shared = a->trees_per_group > 0;
  if (a->categorical)
    return a->bin_bytes == 1 ? walk_kernel<uint8_t, true>(tiled, forest_shared)
                             : walk_kernel<int16_t, true>(tiled,
                                                          forest_shared);
  return a->bin_bytes == 1 ? walk_kernel<uint8_t, false>(tiled, forest_shared)
                           : walk_kernel<int16_t, false>(tiled, forest_shared);
}

// The persistent grid's most for a->shared_bytes into *ctas: the CTAs
// all SMs hold at that shared memory. It also sets the kernel's opt-in
// shared memory to the device's most and its carveout to the most shared
// memory, for every later launch: the wrapper calls it once a device and
// plan (ops/grow._walk_ctas), not a launch.
extern "C" int xrt_walk_ctas(const XrtWalkArgs* a, int* ctas) {
  const XrtWalkKernel kernel = pick_kernel(a);
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaFuncAttributes fa;
  cudaError_t err;
  // the most dynamic shared memory: the opt-in limit less the static
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           optin - (int)fa.sharedSizeBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
           (int)cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, a->shared_bytes)) != cudaSuccess)
    return (int)err;
  *ctas = sms * per_sm;
  return 0;
}

// out[t * n_rows + r] = value[t][leaf of row r in tree t] for n_rows rows
// of bins [n_rows, n_features] (bin_bytes 1: uint8, 2: int16) and n_trees
// trees, each a padded heap of 2^(max_depth + 1) - 1 nodes, the trees'
// arrays back to back. One launch: a->grid CTAs (xrt_walk_ctas, which
// also set the kernel's attributes), at most a tile each, each walking
// tiles in turn.
extern "C" int xrt_walk_binned(const XrtWalkArgs* a, void* stream) {
  if (a->n_rows <= 0) return 0;
  if ((a->cat != nullptr) != (a->categorical != 0))
    return (int)cudaErrorInvalidValue;
  const int R = a->rows_per_tile;
  if (a->n_features < 1 || a->n_trees < 1 || a->max_depth < 1 ||
      (a->bin_bytes != 1 && a->bin_bytes != 2) || R < 1 || (R & (R - 1)) ||
      a->trees_per_group < 0 || a->n_features > (int)kFeatureMask + 1 ||
      a->grid < 1 ||
      (a->mapping == XRT_WALK_TILED && ((uintptr_t)a->bins & 15)))
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (a->n_rows + R - 1) / R;
  pick_kernel(a)<<<(unsigned)min(n_tiles, (long long)a->grid), kThreads,
                   a->shared_bytes, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B4w, the weighted-forest mode (dart): per row and output k,
//   out[r][k] = base[r][k] + sum over t < n_trees, t mod n_out = k, in
//               order, of w_t * value_t[leaf_t(r)]
// (the sum from +0; each term fused into it, fma(v, w_t, acc), with one
// output, else rounded and added; a forest of one slot and one output is
// fma(v, w_0, base), the order XLA gives that einsum). Replaces the forest_margin of
// xgboost_ray_tpu/engine.py:2880-2892 (a vmap of predict_tree_binned and
// an einsum over the [t_cap] weights); the order is XLA's CPU order there
// (ops/grow.predict_forest_weighted_plain). It writes [n_rows][n_out], not
// B4's [T][n_rows]: at 11M rows and 100 trees that would be 4.4 GB.
//
// What bounds it: bytes, in principle (a row's bins, its base and its out,
// 28 + 8 bytes a HIGGS row); the first version is a thread a row walking
// the trees in turn (the sum's order is a row's own, so no atomics and no
// cross-thread reduction), the forest staged in shared memory as packed
// records where it fits in 48 KB, else read through L1; each visit gathers
// its bin from device memory (the row's sector stays in L1): a dependent
// load a visit, so the walk's latency rather than the bytes sets its time
// (about a quarter of the bytes bound at the HIGGS split, PERF.md §6).
// ---------------------------------------------------------------------------

// Mirrors ops/_build.WalkWeightedArgs field by field: edit both together.
struct XrtWalkWeightedArgs {
  const int* feature;           // [t_cap][heap] int32 (the first n_trees)
  const int* split_bin;         // [t_cap][heap] int32
  const uint8_t* default_left;  // [t_cap][heap] bool
  const uint8_t* is_leaf;       // [t_cap][heap] bool
  const float* value;           // [t_cap][heap] f32
  const void* bins;             // [n_rows][n_features] uint8 or int16
  const float* weights;         // [n_trees] f32
  const float* base;            // [n_rows][n_out] f32
  float* out;                   // [n_rows][n_out] f32
  const uint8_t* cat;           // [n_features] categorical flags or null
  long long n_rows;
  int n_features, bin_bytes, n_trees, heap, max_depth, missing_bin;
  int n_out;   // K: tree t adds to output t mod K
  int fused;   // 0: acc + round(v w); 1: fma(v, w, acc); 2: fma from base
  int staged;  // 1: the forest in shared memory (12 bytes a node)
  int grid;
};

template <typename BinT, bool kStaged, bool kCat>
__global__ void __launch_bounds__(kThreads)
    xrt_walk_weighted_kernel(const XrtWalkWeightedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* recs = reinterpret_cast<uint2*>(smem);
  float* vals = reinterpret_cast<float*>(recs + (kStaged ? a.n_trees * a.heap
                                                         : 0));
  if (kStaged) {
    for (int i = threadIdx.x; i < a.n_trees * a.heap; i += kThreads) {
      recs[i] = xrt_record<kCat>(a, i);
      vals[i] = __ldg(a.value + i);
    }
    __syncthreads();
  }
  const BinT* bins = static_cast<const BinT*>(a.bins);
  const int K = a.n_out;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
       r < a.n_rows; r += (long long)gridDim.x * kThreads) {
    const BinT* rb = bins + r * a.n_features;
    for (int k = 0; k < K; ++k) {
      const float base = __ldg(a.base + r * K + k);
      float acc = a.fused == 2 ? base : 0.0f;
      for (int t = k; t < a.n_trees; t += K) {
        const long long t0 = (long long)t * a.heap;
        int idx = 0;
        for (int d = 0; d < a.max_depth; ++d) {
          const uint2 nd = kStaged ? recs[t0 + idx]
                                   : xrt_record<kCat>(a, t0 + idx);
          const int b = (int)__ldg(rb + (nd.x & kFeatureMask));
          const bool right = xrt_right<kCat>(nd, b, a.missing_bin);
          const int nxt = 2 * idx + 1 + (right ? 1 : 0);
          idx = (nd.x & kLeaf) ? idx : nxt;
        }
        const float v = kStaged ? vals[t0 + idx] : __ldg(a.value + t0 + idx);
        const float wt = __ldg(a.weights + t);
        acc = a.fused ? __fmaf_rn(v, wt, acc) : __fadd_rn(acc, __fmul_rn(v, wt));
      }
      a.out[r * K + k] = a.fused == 2 ? acc : __fadd_rn(base, acc);
    }
  }
}

typedef void (*XrtWalkWeightedKernel)(const XrtWalkWeightedArgs);

template <typename BinT>
static XrtWalkWeightedKernel weighted_kernel(bool staged, bool cat) {
  if (cat)
    return staged ? xrt_walk_weighted_kernel<BinT, true, true>
                  : xrt_walk_weighted_kernel<BinT, false, true>;
  return staged ? xrt_walk_weighted_kernel<BinT, true, false>
                : xrt_walk_weighted_kernel<BinT, false, false>;
}

extern "C" int xrt_walk_weighted(const XrtWalkWeightedArgs* a, void* stream) {
  if (a->n_rows <= 0 || a->n_trees <= 0) return 0;
  if (a->n_features < 1 || a->n_out < 1 || a->max_depth < 1 ||
      a->heap != (2 << a->max_depth) - 1 || a->grid < 1 ||
      (a->bin_bytes != 1 && a->bin_bytes != 2) ||
      a->n_features > (int)kFeatureMask + 1 || a->weights == nullptr ||
      a->base == nullptr || a->out == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      a->staged ? (size_t)12 * a->n_trees * a->heap : (size_t)0;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const bool cat = a->cat != nullptr;
  const XrtWalkWeightedKernel kernel =
      a->bin_bytes == 1 ? weighted_kernel<uint8_t>(a->staged != 0, cat)
                        : weighted_kernel<int16_t>(a->staged != 0, cat);
  kernel<<<a->grid, kThreads, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
