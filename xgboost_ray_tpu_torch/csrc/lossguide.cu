// The lossguide frontier step: one step of leaf-wise growth's bookkeeping
// in one CTA. CUDA C++ for sm_90a.
//
// Replaces the bookkeeping of the JAX package's lossguide scan body
// (xgboost_ray_tpu/ops/grow_lossguide.py:200-289), which has no Pallas
// kernel of its own (it is XLA there): the first maximum of the active
// frontier entries' gains (:202-204), the split leaf's records (:214-224),
// its entry retired and the two children appended at 1 + 2t, 2 + 2t with
// their records, values and covers (:246-289). Added so that a lossguide
// tree runs on the card without reading a device value on the host: each
// launch takes in the last step's children (K2's split_nodes outputs and
// K3's children segments), chooses the next leaf, and writes what the next
// launches of K3 (the three-node level: the rows before the leaf, the
// leaf, the rows after it), K1 and K2 (the leaf's formed histogram) read.
// The last launch of a tree writes the leaves' segments in row order for
// K3's leaf-value mode. The plain version is
// ops/grow_lossguide.frontier_step_plain; the library is built with
// --fmad=false, so lr * leaf_weight rounds as its separate ops do (as K2's
// xrt_node_value, csrc/split.cu).
//
// What bounds it: latency. The entries are at most 2 max_leaves - 1 (511
// at 256 leaves), a few KB read once; the one bulk transfer is the split
// leaf's formed histogram copied to the parent buffer K2 reads (F x nbt x
// 8 bytes, 57 KB at F = 28 and 256 bins), by every thread of the CTA in
// 8-byte words. The leaves' row order (the last launch) ranks each active
// entry against every other (O(entries^2) comparisons, spread over the
// CTA).
#include "common.cuh"
#include <math.h>

#define XRT_LG_THREADS 512

enum { XRT_LG_INACTIVE = 0, XRT_LG_SPLIT = 1, XRT_LG_LEAF = 2 };

// Mirrors ops/_build.LossguideArgs field by field: edit both together.
struct XrtLossguideArgs {
  // the tree's heap arrays [heap]
  int* feature;
  int* split_bin;
  float* threshold;
  uint8_t* default_left;
  uint8_t* is_leaf;
  float* value;
  float* gain;
  float* cover;
  float* base_weight;
  const float* cuts;  // [F, nbt - 2]
  // the frontier entries [n_ent]
  int* ent_slot;
  uint8_t* ent_active;
  float* ent_gain;
  int* ent_feat;
  int* ent_bin;
  uint8_t* ent_dl;
  int* ent_start;
  int* ent_end;
  int* last;  // [2]: the last step's do_split and split slot
  // the searched nodes taken in: the root (t 0) or the last children
  const float* sp_gain;
  const int* sp_feat;
  const int* sp_bin;
  const uint8_t* sp_dl;
  const uint8_t* sp_valid;
  const float* sp_gh;   // [n, 2]
  const int* new_seg;   // [7]: K3's children segments (t > 0)
  // K3's three nodes of the next step
  int* seg3;  // [4]: 0, the leaf's start, its end, n_rows
  int* feature3;
  int* split_bin3;
  uint8_t* dl3;
  uint8_t* state3;
  // the formed histograms of every entry [n_ent][pairs] and the parent's
  const float2* store;
  float2* parent;
  // the leaves in row order (finish)
  int* leaf_seg;  // [n_ent + 1]
  uint8_t* leaf_state;
  float* leaf_value;
  long long hist_pairs;  // F * nbt
  int n_ent, heap, n_features, nbt, t, select, finish;
  float reg_lambda, reg_alpha, max_delta_step, learning_rate;
};

// lr * leaf_weight(g, h), as K2's xrt_node_value (csrc/split.cu)
__device__ __forceinline__ float xrt_lg_value(float g, float h,
                                              const XrtLossguideArgs& a) {
  return a.learning_rate * xrt_leaf_weight_of(g, h, a.reg_lambda,
                                              a.reg_alpha, a.max_delta_step);
}

__device__ __forceinline__ bool xrt_lg_better(float ga, int ia, float gb,
                                              int ib) {
  return ga > gb || (ga == gb && ia < ib);
}

__global__ void __launch_bounds__(XRT_LG_THREADS)
xrt_lossguide_step_kernel(const XrtLossguideArgs a) {
  __shared__ float s_gain[XRT_LG_THREADS / 32];
  __shared__ int s_idx[XRT_LG_THREADS / 32];
  __shared__ int s_pick[2];  // the chosen entry and do_split
  const int tid = threadIdx.x;
  // 1. take in the searched nodes: the root into entry 0, or the last
  // step's two children into 2t - 1, 2t
  if (tid < (a.t == 0 ? 1 : 2)) {
    const int c = tid;
    int k, slot, start, end;
    bool split;
    if (a.t == 0) {
      k = 0;
      slot = 0;
      split = true;
      start = 0;
      end = a.seg3[3];
    } else {
      k = 2 * a.t - 1 + c;
      slot = 2 * a.last[1] + 1 + c;
      split = a.last[0] != 0;
      start = a.new_seg[2 + c];
      end = a.new_seg[3 + c];
    }
    const bool can = split && a.sp_valid[c] != 0 && 2 * slot + 2 < a.heap;
    a.ent_slot[k] = split ? slot : -1;
    a.ent_active[k] = split ? 1 : 0;
    a.ent_gain[k] = can ? a.sp_gain[c] : -INFINITY;
    a.ent_feat[k] = split ? a.sp_feat[c] : 0;
    a.ent_bin[k] = split ? a.sp_bin[c] : 0;
    a.ent_dl[k] = split && a.sp_dl[c] != 0 ? 1 : 0;
    a.ent_start[k] = split ? start : 0;
    a.ent_end[k] = split ? end : 0;
    if (split) {
      const float v = xrt_lg_value(a.sp_gh[2 * c], a.sp_gh[2 * c + 1], a);
      a.is_leaf[slot] = 1;
      a.value[slot] = v;
      a.cover[slot] = a.sp_gh[2 * c + 1];
      a.base_weight[slot] = v;
    }
  }
  __syncthreads();
  // 2. the first maximum of the active entries' gains
  if (a.select) {
    float best = -INFINITY;
    int bidx = 0x7fffffff;
    for (int e = tid; e < a.n_ent; e += XRT_LG_THREADS) {
      const float g = a.ent_active[e] ? a.ent_gain[e] : -INFINITY;
      if (xrt_lg_better(g, e, best, bidx)) {
        best = g;
        bidx = e;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float og = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, o);
      if (xrt_lg_better(og, oi, best, bidx)) {
        best = og;
        bidx = oi;
      }
    }
    if ((tid & 31) == 0) {
      s_gain[tid >> 5] = best;
      s_idx[tid >> 5] = bidx;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < XRT_LG_THREADS / 32; ++w) {
        if (xrt_lg_better(s_gain[w], s_idx[w], best, bidx)) {
          best = s_gain[w];
          bidx = s_idx[w];
        }
      }
      const int i = bidx;  // every entry scores: a real index
      const bool do_split = isfinite(best);
      const int slot = a.ent_slot[i];
      const int feat = min(max(a.ent_feat[i], 0), a.n_features - 1);
      const int sbin = a.ent_bin[i];
      a.last[0] = do_split ? 1 : 0;
      a.last[1] = max(slot, 0);
      a.seg3[1] = a.ent_start[i];
      a.seg3[2] = a.ent_end[i];
      a.feature3[1] = feat;
      a.split_bin3[1] = sbin;
      a.dl3[1] = a.ent_dl[i];
      a.state3[1] = do_split ? XRT_LG_SPLIT : XRT_LG_INACTIVE;
      if (do_split) {
        a.feature[slot] = feat;
        a.split_bin[slot] = sbin;
        a.threshold[slot] =
            a.cuts[(size_t)feat * (a.nbt - 2) + min(max(sbin, 0), a.nbt - 3)];
        a.default_left[slot] = a.ent_dl[i];
        a.is_leaf[slot] = 0;
        a.value[slot] = 0.f;
        a.gain[slot] = a.ent_gain[i];
        a.ent_active[i] = 0;
      }
      s_pick[0] = i;
      s_pick[1] = do_split ? 1 : 0;
    }
    __syncthreads();
    if (s_pick[1]) {  // the split leaf's formed histogram, for K2
      const float2* src = a.store + (size_t)s_pick[0] * a.hist_pairs;
      for (long long q = tid; q < a.hist_pairs; q += XRT_LG_THREADS)
        a.parent[q] = src[q];
    }
  }
  // 3. the leaves in row order: rank each active entry by (start, end,
  // index), so an empty segment (a rank may hold no row of a leaf) comes
  // before the leaf that starts where it sits
  if (a.finish) {
    __shared__ int s_count;
    if (tid == 0) s_count = 0;
    __syncthreads();
    for (int e = tid; e < a.n_ent; e += XRT_LG_THREADS) {
      if (!a.ent_active[e]) continue;
      const int s = a.ent_start[e];
      const int en = a.ent_end[e];
      int rank = 0;
      for (int q = 0; q < a.n_ent; ++q) {
        if (!a.ent_active[q]) continue;
        const int sq = a.ent_start[q];
        const int eq = a.ent_end[q];
        rank += sq < s || (sq == s && (eq < en || (eq == en && q < e))) ? 1
                                                                        : 0;
      }
      a.leaf_seg[rank] = s;
      a.leaf_state[rank] = XRT_LG_LEAF;
      a.leaf_value[rank] = a.value[a.ent_slot[e]];
      atomicAdd(&s_count, 1);
    }
    __syncthreads();
    const int m = s_count;
    for (int r = m + tid; r < a.n_ent; r += XRT_LG_THREADS) {
      a.leaf_seg[r] = a.seg3[3];
      a.leaf_state[r] = XRT_LG_INACTIVE;
      a.leaf_value[r] = 0.f;
    }
    if (tid == 0) a.leaf_seg[a.n_ent] = a.seg3[3];
  }
}

// One frontier step: one CTA of XRT_LG_THREADS threads.
extern "C" int xrt_lossguide_step(const XrtLossguideArgs* a, void* stream) {
  if (a->n_ent < 1 || a->heap < 3 || a->n_features < 1 || a->nbt < 3 ||
      (a->t > 0 && a->new_seg == nullptr))
    return (int)cudaErrorInvalidValue;
  xrt_lossguide_step_kernel<<<1, XRT_LG_THREADS, 0, (cudaStream_t)stream>>>(
      *a);
  return (int)cudaGetLastError();
}
