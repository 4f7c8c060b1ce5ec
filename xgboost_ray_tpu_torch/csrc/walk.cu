// B4: the binned tree walk. T trees of equal depth over pre-binned rows;
// every row's leaf value in each tree, which the engine adds to an eval
// set's margins each round (ops/objectives.round_update's eval mode for
// one tree, the softmax pass's eval mode for a round's K class trees).
//
// Replaces xgboost_ray_tpu/ops/grow.py:786 predict_tree_binned with the rule
// of route_right_binned (:65): a numeric bin > split_bin goes right, the
// missing bin (max_bin) follows the learned default; a leaf keeps its index
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
};

__device__ __forceinline__ long long xrt_round16(long long b) {
  return (b + 15) & ~15LL;
}

// the packed record of node i of the forest arrays
__device__ __forceinline__ uint2 xrt_record(const XrtWalkArgs& a,
                                            long long i) {
  const int f = min(max(__ldg(a.feature + i), 0), a.n_features - 1);
  return make_uint2((unsigned)f | (__ldg(a.is_leaf + i) ? kLeaf : 0u) |
                        (__ldg(a.default_left + i) ? kDefaultLeft : 0u),
                    (unsigned)__ldg(a.split_bin + i));
}

// trees [t0, t0 + nt) into recs / vals ([nt][heap] each)
__device__ __forceinline__ void xrt_stage_forest(const XrtWalkArgs& a,
                                                 uint2* recs, float* vals,
                                                 int t0, int nt, int heap) {
  const long long base = (long long)t0 * heap;
#pragma unroll 4
  for (int i = threadIdx.x; i < nt * heap; i += kThreads) {
    recs[i] = xrt_record(a, base + i);
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
template <typename BinT, bool kTiled, bool kForestShared>
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
          const bool right = b == a.missing_bin ? !(nd.x & kDefaultLeft)
                                                : b > (int)nd.y;
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
                  : xrt_record(a, (long long)(t0 + t[c]) * heap + idx[c]);
          const unsigned f = nd.x & kFeatureMask;
          const int b = kTiled ? (int)rb[c][f] : (int)__ldg(rb[c] + f);
          const bool right = b == a.missing_bin ? !(nd.x & kDefaultLeft)
                                                : b > (int)nd.y;
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

template <typename BinT, bool kTiled, bool kForestShared>
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
    xrt_stage_forest(a, recs, vals, 0, a.n_trees, heap);
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
        xrt_stage_forest(a, recs, vals, t0, nt, heap);
        __syncthreads();
      }
      xrt_walk_items<BinT, kTiled, kForestShared>(
          a, smem, recs, vals, tb, row0, n_valid, t0, nt, heap, lg_r);
      if (kForestShared && n_groups > 1) __syncthreads();
    }
    __syncthreads();  // the buffer is free for a later tile's copy
    buf = (buf + 1) % kStages;
  }
}

typedef void (*XrtWalkKernel)(const XrtWalkArgs);

template <typename BinT>
static XrtWalkKernel walk_kernel(bool tiled, bool forest_shared) {
  if (tiled)
    return forest_shared ? xrt_walk_kernel<BinT, true, true>
                         : xrt_walk_kernel<BinT, true, false>;
  return forest_shared ? xrt_walk_kernel<BinT, false, true>
                       : xrt_walk_kernel<BinT, false, false>;
}

static XrtWalkKernel pick_kernel(const XrtWalkArgs* a) {
  const bool tiled = a->mapping == XRT_WALK_TILED;
  const bool forest_shared = a->trees_per_group > 0;
  return a->bin_bytes == 1 ? walk_kernel<uint8_t>(tiled, forest_shared)
                           : walk_kernel<int16_t>(tiled, forest_shared);
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
