// K2 — one tree level's per-node work in one launch: sibling formation,
// node-total readout, best split, and the level's tree records. CUDA C++
// for sm_90a.
//
// Replaces, for one level of the JAX package's build_tree
// (xgboost_ray_tpu/ops/grow.py:565-690): the sibling histogram
// prev - small (:570-575), zero_phantom_missing (ops/histogram.py:817), the
// node-total readout hist[:, 0].sum (:594), find_splits (ops/split.py:79-166,
// unconstrained numeric branch), leaf_weight (ops/split.py:56) and the
// records of :661-684; and the final level's records (:765-780, here
// xrt_leaf_records). find_splits alone (no prologue, no records) is the same
// kernel (xrt_find_splits).
//
// The float sums are associated exactly as the compiled JAX program
// associates them, so the kernel, its plain version and the JAX package
// agree bitwise on the same histogram:
//   * the readout is a tree reduction in windows of 32 (the buckets padded
//     with zeros, half the padding in front), each window and then the
//     window sums added in order;
//   * the prefix scan works in blocks of 16 bins: in order within a block,
//     then each block adds the (recursively blocked) scan of the earlier
//     blocks' totals;
//   * the argmax keeps the first maximum over the flat (feature, bin) index
//     feature * (n_bins - 1) + bin.
// The library is built with --fmad=false, so score(), the gain and
// lr * leaf_weight round as the plain PyTorch version's separate ops do.
//
// Design. A node's features are split over a thread-block cluster of up to
// 8 CTAs (more CTAs per node where the level has few nodes: 7 CTAs for the
// root at F = 28, 4 per node at 32 nodes), one warp per feature. A warp
// stages its feature's (g, h) row in shared memory with coalesced 8-byte
// loads, a batch of them in flight before any store, forming the sibling
// (prev - small, or small, by the parent's small_is_right) and zeroing the
// phantom missing bucket on the way, and writes the formed row out as the
// next level's prev_hist. The g and h planes are padded by one word per 16
// bins, so lane b reading bin 16 b + j hits bank (17 b + j) mod 32: no
// conflict. Warp 0 of CTA 0 holds feature 0 and reads the node totals off
// it (lane k sums window k); a split cluster barrier publishes them to the
// other CTAs, which sum their block totals meanwhile. The scan: each lane
// scores 8 candidates (half a 16-bin block, re-summing the block's first
// half in order where it takes the second), adding the blocked scan of the
// earlier block totals; all lanes score in the same loop steps. Warp
// shuffles elect the warp's best (gain, flat index), shared memory the
// CTA's; each CTA writes its best into CTA 0's shared memory (distributed
// shared memory), and CTA 0 elects the node's split and writes it, its
// leaf value, the nine tree records, the state code K3 reads and the next
// level's active flags.
// What bounds it: bytes are tiny (the level's histogram read once, the
// formed one written once: 3.7 MB at level 5 of the main path, about a
// microsecond); the scoring is a few dozen float ops per candidate with
// two IEEE divisions per gain, so a launch is latency-bound: a staged row,
// the readout, two cluster barriers and eight scored candidates per lane.
#include "common.cuh"
#include <cooperative_groups.h>
#include <math.h>

namespace cg = cooperative_groups;

#define XRT_SCAN_BLOCK 16
#define XRT_MAX_SCAN_BLOCKS 64  // 64 blocks of 16 bins: max_bin <= 1024
#define XRT_SPLIT_MAX_WARPS 16
#define XRT_MAX_CLUSTER 8

enum { XRT_INACTIVE = 0, XRT_SPLIT = 1, XRT_LEAF = 2 };

// What every level of one tree shares: the tree's heap arrays, the cuts,
// feat_has_missing and the parameters. Built once per tree on the host
// (the wrapper's ctypes.Structure mirrors it field by field). Null record
// pointers (find_splits) skip the records.
struct XrtTreeArgs {
  int* feature;
  int* split_bin;
  float* threshold;
  uint8_t* default_left;
  uint8_t* is_leaf;
  float* value;
  float* gain;
  float* cover;
  float* base_weight;
  const float* cuts;                 // [F, nbt - 2]
  const uint8_t* feat_has_missing;   // [F] or null
  int n_features;
  int nbt;
  float reg_lambda;
  float reg_alpha;
  float gamma;
  float min_child_weight;
  float max_delta_step;  // 0: no clamp
  float learning_rate;
};

struct XrtLevelIn {
  const float* hist;              // [n_nodes or n_nodes / 2, F, nbt, 2]
  const float* prev_hist;         // [n_nodes / 2, F, nbt, 2] or null
  const uint8_t* small_is_right;  // [n_nodes / 2] with prev_hist
  const uint8_t* active;          // [n_nodes]; null: no records
  int n_nodes;
  int base;     // heap offset of the level: n_nodes - 1
  int cluster;  // CTAs per node
  int fpc;      // features per CTA
};

struct XrtLevelOut {
  float* gain;
  int* feature;
  int* split_bin;
  uint8_t* default_left;
  uint8_t* valid;
  float* node_gh;      // [n_nodes, 2]
  float* node_value;   // null without records
  uint8_t* state;
  uint8_t* active_next;  // [2 n_nodes]
  float* hist_out;     // [n_nodes, F, nbt, 2] or null
};

__device__ __forceinline__ float xrt_soft_threshold(float g, float alpha) {
  const float s = g > 0.f ? 1.f : (g < 0.f ? -1.f : g);  // jnp.sign: keeps -0
  return s * fmaxf(fabsf(g) - alpha, 0.f);
}

__device__ __forceinline__ float xrt_score(float g, float h,
                                           const XrtTreeArgs& p) {
  const float t = xrt_soft_threshold(g, p.reg_alpha);
  const float den = h + p.reg_lambda;
  return den > 0.f ? (t * t) / fmaxf(den, 1e-38f) : 0.f;
}

// lr * leaf_weight(g, h), max_delta_step clamp included
__device__ __forceinline__ float xrt_node_value(float g, float h,
                                                const XrtTreeArgs& p) {
  const float den = h + p.reg_lambda;
  float w = den > 0.f ? -xrt_soft_threshold(g, p.reg_alpha) / fmaxf(den, 1e-38f)
                      : 0.f;
  if (p.max_delta_step > 0.f)
    w = fminf(fmaxf(w, -p.max_delta_step), p.max_delta_step);
  return p.learning_rate * w;
}

__device__ __forceinline__ float xrt_gain(float gl, float hl, float gp,
                                          float hp, float parent_score,
                                          const XrtTreeArgs& p) {
  const float gr = gp - gl;
  const float hr = hp - hl;
  const bool ok = (hl >= p.min_child_weight) && (hr >= p.min_child_weight);
  const float gain =
      (xrt_score(gl, hl, p) + xrt_score(gr, hr, p)) - parent_score;
  return ok ? gain : -INFINITY;
}

// better(a, b): a beats b under the first-max rule on (gain, index)
__device__ __forceinline__ bool xrt_better(float ga, int ia, float gb, int ib) {
  return ga > gb || (ga == gb && ia < ib);
}

// bucket k of a padded plane: one spare word after every 16 buckets
__device__ __forceinline__ int xrt_pad(int k) { return k + (k >> 4); }

// In-place sum of the m floats w[0 .. m) in the tree-of-32-windows order
// (one thread): while more than 32 remain, window k of 32 (zero padding,
// half in front) is summed in order into w[k] (window k reads indices
// >= 32 k - front > k - 1, so no window reads a sum already written);
// then the rest in order.
__device__ float xrt_window_sum(float* w, int m) {
  while (m > 32) {
    const int nwin = (m + 31) / 32;
    const int front = (nwin * 32 - m) / 2;
    for (int k = 0; k < nwin; ++k) {
      float acc = 0.f;
      for (int j = 0; j < 32; ++j) {
        const int i = k * 32 + j - front;
        acc += (i >= 0 && i < m) ? w[i] : 0.f;
      }
      w[k] = acc;
    }
    m = nwin;
  }
  float acc = 0.f;
  for (int i = 0; i < m; ++i) acc += w[i];
  return acc;
}

// loads in flight per lane: a 257-bucket row in one batch
#define XRT_STAGE_BATCH 9

// One warp: feature f's (g, h) row of this node into the padded planes
// sg / sh, formed as the sibling where prev_hist is given, the missing
// bucket multiplied by feat_has_missing[f]; also written to `out` (the
// node's formed row) unless null. Loads are issued a batch at a time
// before any store, so they are in flight together.
__device__ __forceinline__ void xrt_stage(const XrtTreeArgs& t,
                                          const XrtLevelIn& in, int node,
                                          int f, float* sg, float* sh,
                                          float2* out) {
  const int lane = threadIdx.x & 31;
  const int nbt = t.nbt;
  const size_t F = t.n_features;
  // with prev_hist, both rows are loaded while small_is_right is: the
  // smaller child's row is used as it is, the sibling's is prev - small
  const bool sib = in.prev_hist != nullptr;
  const size_t row = ((size_t)(sib ? node >> 1 : node) * F + f) * nbt;
  const float2* src = (const float2*)in.hist + row;
  const float2* prv = sib ? (const float2*)in.prev_hist + row : nullptr;
  const bool small =
      !sib || (node & 1) == (__ldg(in.small_is_right + (node >> 1)) ? 1 : 0);
  const bool phantom = t.feat_has_missing != nullptr;
  const float keep = phantom && __ldg(t.feat_has_missing + f) == 0 ? 0.f : 1.f;
  for (int k0 = lane; k0 < nbt; k0 += 32 * XRT_STAGE_BATCH) {
    float2 v[XRT_STAGE_BATCH], pv[XRT_STAGE_BATCH];
#pragma unroll
    for (int u = 0; u < XRT_STAGE_BATCH; ++u) {
      const int k = k0 + 32 * u;
      if (k < nbt) {
        v[u] = __ldg(src + k);
        if (sib) pv[u] = __ldg(prv + k);
      }
    }
#pragma unroll
    for (int u = 0; u < XRT_STAGE_BATCH; ++u) {
      const int k = k0 + 32 * u;
      if (k < nbt) {
        float2 x = v[u];
        if (!small) {
          x.x = pv[u].x - x.x;
          x.y = pv[u].y - x.y;
        }
        if (phantom && k == nbt - 1) {
          x.x *= keep;  // a multiply, as the plain version: x * 0 may be -0
          x.y *= keep;
        }
        sg[xrt_pad(k)] = x.x;
        sh[xrt_pad(k)] = x.y;
        if (out != nullptr) out[k] = x;
      }
    }
  }
}

// One warp: node totals from the staged feature 0 (all nbt buckets) into
// tot[0..1]; wg / wh (>= 33 floats each) hold the window sums.
__device__ __forceinline__ void xrt_readout(int nbt, const float* sg,
                                            const float* sh, float* wg,
                                            float* wh, float* tot) {
  const int lane = threadIdx.x & 31;
  const int nw = nbt > 32 ? (nbt + 31) / 32 : 0;
  const int front = (nw * 32 - nbt) / 2;
  for (int k = lane; k < nw; k += 32) {
    float ag = 0.f, ah = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = k * 32 + j - front;
      const bool in = i >= 0 && i < nbt;
      ag += in ? sg[xrt_pad(in ? i : 0)] : 0.f;
      ah += in ? sh[xrt_pad(in ? i : 0)] : 0.f;
    }
    wg[k] = ag;
    wh[k] = ah;
  }
  __syncwarp();
  if (lane < 2) {  // lane 0 sums g, lane 1 h
    const float* x = lane == 0 ? sg : sh;
    if (nw == 0) {  // 32 buckets or fewer: one in-order sum
      float a = 0.f;
      for (int i = 0; i < nbt; ++i) a += x[xrt_pad(i)];
      tot[lane] = a;
    } else {
      tot[lane] = xrt_window_sum(lane == 0 ? wg : wh, nw);
    }
  }
}

// One warp: the in-order total of every 16-bin block of the staged
// feature into tg / th.
__device__ __forceinline__ void xrt_block_totals(int nbt, const float* sg,
                                                 const float* sh, float* tg,
                                                 float* th) {
  const int lane = threadIdx.x & 31;
  const int nb = nbt - 1;  // present bins; bucket nb is "missing"
  const int nblk = (nb + XRT_SCAN_BLOCK - 1) / XRT_SCAN_BLOCK;
  for (int b = lane; b < nblk; b += 32) {
    const int b0 = b * XRT_SCAN_BLOCK;
    float ag = sg[xrt_pad(b0)], ah = sh[xrt_pad(b0)];
#pragma unroll
    for (int j = 1; j < XRT_SCAN_BLOCK; ++j) {
      if (b0 + j < nb) {
        ag += sg[xrt_pad(b0 + j)];
        ah += sh[xrt_pad(b0 + j)];
      }
    }
    tg[b] = ag;
    th[b] = ah;
  }
}

// The scan of the totals of blocks 0 .. last (inclusive) as the blocked
// scan associates it: in order up to 16 blocks, else in groups of 16 plus
// the in-order scan of the group totals.
__device__ __forceinline__ void xrt_block_prefix(const float* tg,
                                                 const float* th, int nblk,
                                                 int last, float* pg,
                                                 float* ph) {
  const int grp = last / XRT_SCAN_BLOCK;
  if (nblk <= XRT_SCAN_BLOCK) {
    float a = tg[0], d = th[0];
#pragma unroll
    for (int k = 1; k < XRT_SCAN_BLOCK; ++k) {
      if (k <= last) {
        a += tg[k];
        d += th[k];
      }
    }
    *pg = a;
    *ph = d;
    return;
  }
  float gg = 0.f, gh = 0.f;  // in-order scan of the earlier group totals
  for (int q = 0; q < grp; ++q) {
    float a = tg[q * XRT_SCAN_BLOCK], d = th[q * XRT_SCAN_BLOCK];
#pragma unroll
    for (int k = 1; k < XRT_SCAN_BLOCK; ++k) {
      a += tg[q * XRT_SCAN_BLOCK + k];
      d += th[q * XRT_SCAN_BLOCK + k];
    }
    if (q == 0) {
      gg = a;
      gh = d;
    } else {
      gg += a;
      gh += d;
    }
  }
  float wg = tg[grp * XRT_SCAN_BLOCK], wh = th[grp * XRT_SCAN_BLOCK];
#pragma unroll
  for (int k = 1; k < XRT_SCAN_BLOCK; ++k) {
    if (grp * XRT_SCAN_BLOCK + k <= last) {
      wg += tg[grp * XRT_SCAN_BLOCK + k];
      wh += th[grp * XRT_SCAN_BLOCK + k];
    }
  }
  *pg = grp > 0 ? wg + gg : wg;
  *ph = grp > 0 ? wh + gh : wh;
}

// One warp, after xrt_block_totals: the best candidate of the staged
// feature f, as (gain, flat index, default_left), the same in every lane.
// Lane c scores half-block c: bins [8 (c % 2), 8 (c % 2) + 8) of block
// c / 2, so every lane scores its candidates in the same loop steps.
__device__ __forceinline__ void xrt_score_feature(
    const XrtTreeArgs& t, int f, const float* sg, const float* sh,
    const float* tg, const float* th, float gp, float hp, float parent,
    float* out_gain, int* out_idx, int* out_dl) {
  const int lane = threadIdx.x & 31;
  const int nb = t.nbt - 1;
  const int ncand = nb - 1;  // candidate s: bins <= s go left
  const int nblk = (nb + XRT_SCAN_BLOCK - 1) / XRT_SCAN_BLOCK;
  const int half = XRT_SCAN_BLOCK / 2;
  const float gm = sg[xrt_pad(nb)];
  const float hm = sh[xrt_pad(nb)];
  float best = -INFINITY;
  int bidx = 0x7fffffff;
  int bdl = 1;
  const int base_idx = f * ncand;
  for (int c = lane; c < 2 * nblk; c += 32) {
    const int b = c >> 1;
    const int b0 = b * XRT_SCAN_BLOCK;
    const int j0 = (c & 1) * half;
    const bool has_pre = b > 0;
    float pg = 0.f, ph = 0.f;
    if (has_pre) xrt_block_prefix(tg, th, nblk, b - 1, &pg, &ph);
    // the block's in-order running sum through bin j0 - 1
    float lg = sg[xrt_pad(b0)], lh = sh[xrt_pad(b0)];
    if (j0 > 0) {
#pragma unroll
      for (int j = 1; j < half; ++j) {
        if (b0 + j < nb) {
          lg += sg[xrt_pad(b0 + j)];
          lh += sh[xrt_pad(b0 + j)];
        }
      }
    }
    // no early exit: the eight candidates' gains are independent, so the
    // compiler interleaves them; past the last candidate they are ignored
#pragma unroll
    for (int jj = 0; jj < half; ++jj) {
      const int i = b0 + j0 + jj;
      const bool cand = i < ncand;
      if (j0 + jj > 0) {
        lg += sg[xrt_pad(min(i, nb))];
        lh += sh[xrt_pad(min(i, nb))];
      }
      const float GL = has_pre ? lg + pg : lg;
      const float HL = has_pre ? lh + ph : lh;
      const float gml = xrt_gain(GL + gm, HL + hm, gp, hp, parent, t);
      const float gmr = xrt_gain(GL, HL, gp, hp, parent, t);
      const float gain = fmaxf(gml, gmr);
      if (cand && xrt_better(gain, base_idx + i, best, bidx)) {
        best = gain;
        bidx = base_idx + i;
        bdl = gml >= gmr ? 1 : 0;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float og = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, o);
    const int od = __shfl_xor_sync(0xffffffffu, bdl, o);
    if (xrt_better(og, oi, best, bidx)) {
      best = og;
      bidx = oi;
      bdl = od;
    }
  }
  *out_gain = best;
  *out_idx = bidx;
  *out_dl = bdl;
}

__device__ __forceinline__ void xrt_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void xrt_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(XRT_SPLIT_MAX_WARPS * 32)
xrt_split_level_kernel(XrtTreeArgs t, XrtLevelIn in, XrtLevelOut out) {
  extern __shared__ float smem[];
  __shared__ float s_tot[2];  // the node's (G, H): CTA 0 of the cluster
  __shared__ float w_gain[XRT_SPLIT_MAX_WARPS];
  __shared__ int w_idx[XRT_SPLIT_MAX_WARPS];
  __shared__ int w_dl[XRT_SPLIT_MAX_WARPS];
  __shared__ float c_gain[XRT_MAX_CLUSTER];  // every CTA's best: CTA 0
  __shared__ int c_idx[XRT_MAX_CLUSTER];
  __shared__ int c_dl[XRT_MAX_CLUSTER];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int node = blockIdx.x / in.cluster;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int F = t.n_features;
  const int nbt = t.nbt;
  const int plane = xrt_pad(nbt - 1) + 1;
  float* sg = smem + (size_t)warp * (2 * plane + 2 * XRT_MAX_SCAN_BLOCKS);
  float* sh = sg + plane;
  float* tg = sh + plane;
  float* th = tg + XRT_MAX_SCAN_BLOCKS;
  float2* hout = out.hist_out != nullptr
                     ? (float2*)out.hist_out + (size_t)node * F * nbt : nullptr;
  const int f0 = rank * in.fpc;  // this CTA's features [f0, f1)
  const int f1 = min(F, f0 + in.fpc);
  const int first = f0 + warp;   // this warp's first feature
  // read early: the records at the end need it
  const bool act = in.active != nullptr && rank == 0 && threadIdx.x == 0 &&
                   __ldg(in.active + node) != 0;
  // every warp stages its first feature; warp 0 of CTA 0 holds feature 0
  // and reads the node totals off it, which the cluster barrier publishes
  // to the other CTAs; the block totals are summed meanwhile
  if (first < f1)
    xrt_stage(t, in, node, first, sg, sh,
              hout != nullptr ? hout + (size_t)first * nbt : nullptr);
  __syncwarp();
  if (rank == 0 && warp == 0) {
    xrt_readout(nbt, sg, sh, tg, th, s_tot);
    __syncwarp();
  }
  xrt_cluster_arrive();
  if (first < f1) xrt_block_totals(nbt, sg, sh, tg, th);
  xrt_cluster_wait();
  const float gp = *cluster.map_shared_rank(&s_tot[0], 0);
  const float hp = *cluster.map_shared_rank(&s_tot[1], 0);
  const float parent = xrt_score(gp, hp, t);
  float best = -INFINITY;
  int bidx = 0x7fffffff;
  int bdl = 1;
  for (int f = first; f < f1; f += nwarps) {
    if (f != first) {
      __syncwarp();
      xrt_stage(t, in, node, f, sg, sh,
                hout != nullptr ? hout + (size_t)f * nbt : nullptr);
      __syncwarp();
      xrt_block_totals(nbt, sg, sh, tg, th);
    }
    __syncwarp();
    float g;
    int idx, dl;
    xrt_score_feature(t, f, sg, sh, tg, th, gp, hp, parent, &g, &idx, &dl);
    if (xrt_better(g, idx, best, bidx)) {
      best = g;
      bidx = idx;
      bdl = dl;
    }
  }
  if (lane == 0) {
    w_gain[warp] = best;
    w_idx[warp] = bidx;
    w_dl[warp] = bdl;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // this CTA's best, into CTA 0's shared memory
    for (int w = 1; w < nwarps; ++w) {
      if (xrt_better(w_gain[w], w_idx[w], best, bidx)) {
        best = w_gain[w];
        bidx = w_idx[w];
        bdl = w_dl[w];
      }
    }
    *cluster.map_shared_rank(&c_gain[rank], 0) = best;
    *cluster.map_shared_rank(&c_idx[rank], 0) = bidx;
    *cluster.map_shared_rank(&c_dl[rank], 0) = bdl;
  }
  cluster.sync();  // CTA 0 holds every CTA's best; the others may leave
  if (rank != 0 || threadIdx.x != 0) return;
  best = c_gain[0];
  bidx = c_idx[0];
  bdl = c_dl[0];
  for (int r = 1; r < in.cluster; ++r) {
    if (xrt_better(c_gain[r], c_idx[r], best, bidx)) {
      best = c_gain[r];
      bidx = c_idx[r];
      bdl = c_dl[r];
    }
  }
  const int ncand = nbt - 2;
  // a node always has a candidate (nbt >= 3): bidx is a real index
  const int feat = bidx / ncand;
  const int sbin = bidx % ncand;
  const bool valid = isfinite(best) && best > t.gamma;
  out.gain[node] = best;
  out.feature[node] = feat;
  out.split_bin[node] = sbin;
  out.default_left[node] = (uint8_t)bdl;
  out.valid[node] = valid ? 1 : 0;
  out.node_gh[2 * node] = gp;
  out.node_gh[2 * node + 1] = hp;
  if (in.active == nullptr) return;
  const bool vs = valid && act;
  const bool new_leaf = act && !vs;
  const float nv = xrt_node_value(gp, hp, t);
  const int fs = min(max(feat, 0), F - 1);
  const int bs = min(max(sbin, 0), nbt - 3);
  const float thr = t.cuts[(size_t)fs * (nbt - 2) + bs];
  const int i = in.base + node;
  t.feature[i] = vs ? feat : -1;
  t.split_bin[i] = vs ? sbin : 0;
  t.threshold[i] = vs ? thr : 0.f;
  t.default_left[i] = (bdl && vs) ? 1 : 0;
  t.is_leaf[i] = new_leaf ? 1 : 0;
  t.value[i] = new_leaf ? nv : 0.f;
  t.gain[i] = vs ? best : 0.f;
  t.cover[i] = act ? hp : 0.f;
  t.base_weight[i] = act ? nv : 0.f;
  out.node_value[node] = nv;
  out.state[node] = vs ? XRT_SPLIT : (new_leaf ? XRT_LEAF : XRT_INACTIVE);
  out.active_next[2 * node] = vs ? 1 : 0;
  out.active_next[2 * node + 1] = vs ? 1 : 0;
}

__global__ void xrt_leaf_records_kernel(XrtTreeArgs t,
                                        const float* __restrict__ node_gh,
                                        const uint8_t* __restrict__ active,
                                        int n_nodes, int base,
                                        float* __restrict__ node_value,
                                        uint8_t* __restrict__ state) {
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n_nodes) return;
  const bool act = active[node] != 0;
  const float h = node_gh[2 * node + 1];
  const float nv = act ? xrt_node_value(node_gh[2 * node], h, t) : 0.f;
  const int i = base + node;
  t.is_leaf[i] = act ? 1 : 0;
  t.value[i] = nv;
  t.cover[i] = act ? h : 0.f;
  t.base_weight[i] = nv;
  node_value[node] = nv;
  state[node] = act ? XRT_LEAF : XRT_INACTIVE;
}

static int xrt_launch_level(const XrtTreeArgs& t, XrtLevelIn in,
                            const XrtLevelOut& out, cudaStream_t s) {
  if (t.nbt < 3 || t.nbt - 1 > XRT_MAX_SCAN_BLOCKS * XRT_SCAN_BLOCK ||
      t.n_features < 1 || in.n_nodes < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // CTAs per node: as many as fill the card, at most 8 (a portable
  // cluster) and one feature each; then the fewest that keep that split
  int cl = max(1, min(min(XRT_MAX_CLUSTER, t.n_features), sms / in.n_nodes));
  in.fpc = (t.n_features + cl - 1) / cl;
  in.cluster = (t.n_features + in.fpc - 1) / in.fpc;
  const int nwarps = min(XRT_SPLIT_MAX_WARPS, in.fpc);
  const int plane = (t.nbt - 1) + ((t.nbt - 1) >> 4) + 1;
  const size_t smem =
      (size_t)nwarps * (2 * plane + 2 * XRT_MAX_SCAN_BLOCKS) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(xrt_split_level_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(in.n_nodes * in.cluster);
  cfg.blockDim = dim3(nwarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = in.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, xrt_split_level_kernel, t, in, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One level: hist is K1's full histogram [n_nodes, F, nbt, 2] (prev_hist
// null), or the smaller children's [n_nodes / 2, ...] with prev_hist and
// small_is_right. active [n_nodes]; outputs [n_nodes] (node_gh [n_nodes, 2],
// active_next [2 n_nodes]); hist_out [n_nodes, F, nbt, 2] or null.
extern "C" int xrt_split_level(const XrtTreeArgs* t, const float* hist,
                               const float* prev_hist,
                               const uint8_t* small_is_right,
                               const uint8_t* active, int n_nodes,
                               float* gain, int* feature, int* split_bin,
                               uint8_t* default_left, uint8_t* valid,
                               float* node_gh, float* node_value,
                               uint8_t* state, uint8_t* active_next,
                               float* hist_out, void* stream) {
  XrtLevelIn in = {hist, prev_hist, small_is_right, active, n_nodes,
                   n_nodes - 1, 1, 1};
  XrtLevelOut out = {gain, feature, split_bin, default_left, valid,
                     node_gh, node_value, state, active_next, hist_out};
  return xrt_launch_level(*t, in, out, (cudaStream_t)stream);
}

// find_splits alone: hist [n_nodes, F, nbt, 2]; outputs node_gh [n_nodes, 2]
// and [n_nodes] split records; no prologue, no tree records.
extern "C" int xrt_find_splits(const float* hist, int n_nodes, int n_features,
                               int nbt, float reg_lambda, float reg_alpha,
                               float gamma, float min_child_weight,
                               float* node_gh, float* gain, int* feature,
                               int* split_bin, uint8_t* default_left,
                               uint8_t* valid, void* stream) {
  XrtTreeArgs t = {};
  t.n_features = n_features;
  t.nbt = nbt;
  t.reg_lambda = reg_lambda;
  t.reg_alpha = reg_alpha;
  t.gamma = gamma;
  t.min_child_weight = min_child_weight;
  XrtLevelIn in = {hist, nullptr, nullptr, nullptr, n_nodes, n_nodes - 1, 1, 1};
  XrtLevelOut out = {gain, feature, split_bin, default_left, valid,
                     node_gh, nullptr, nullptr, nullptr, nullptr};
  return xrt_launch_level(t, in, out, (cudaStream_t)stream);
}

// The final level: node_gh [n_nodes, 2] (K1's totals), active [n_nodes];
// writes node_value and state [n_nodes] and the level's records.
extern "C" int xrt_leaf_records(const XrtTreeArgs* t, const float* node_gh,
                                const uint8_t* active, int n_nodes,
                                float* node_value, uint8_t* state,
                                void* stream) {
  const int threads = 128;
  xrt_leaf_records_kernel<<<(n_nodes + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(
      *t, node_gh, active, n_nodes, n_nodes - 1, node_value, state);
  return (int)cudaGetLastError();
}
