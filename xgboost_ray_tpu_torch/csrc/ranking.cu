// B13, the pairwise lambda gradients of learning to rank, and B9r, the
// per-group ndcg@k / map@k, CUDA C++ for sm_90a.
//
// B13 replaces xgboost_ray_tpu/ops/ranking.py:46 (_pairwise_lambdas) and
// :81 (make_rank_grad_hess): a round's (g, h) of every row of a set whose
// rows form query groups (runs of rows, offsets[k] .. offsets[k + 1]).
// rank:pairwise weights a pair by 1, rank:ndcg and rank:map by |delta
// NDCG| of swapping the two at the current ranking (XRT_RANK_NDCG).
// B9r replaces ops/metrics.py:183 (rank_metric_contrib): the set's (sum
// over groups of ndcg@k or map@k, groups), one launch a set a round.
//
// Both are bitwise their plain versions (ops/ranking.rank_grad_hess_plain,
// ops/metrics.rank_metric_plain), which follow the reference's compiled
// CPU program:
//   - a sum over a group's padded axis of G slots (G the world's largest
//     group) takes the window-32 tree of ops/split.tree_sum (common.cuh's
//     XrtTreeAcc), its padding zeros included;
//   - the order of a group is jnp.argsort's stable one, counted: the rank
//     of i is the number of valid j with a larger score, or an equal one
//     and j < i; the ideal order the same count over gains (labels), the
//     padding's zeros before any negative gain;
//   - exp2(y) is exp(ln2 y), log2(x) is log(x) * (1 / ln2), with XLA's exp
//     and log (common.cuh), sigmoid(-d) = 1 / (1 + exp(d)) flushed below
//     2^-126, no fused multiply-add anywhere (--fmad=false), divisions
//     correctly rounded (__fdiv_rn).
// g_i is -(the sum of lam_ij over the j that i beats) + (the sum of lam_ji
// over the j that beat i), h_i the same two sums of the pair hessians
// added, then both times the row's weight (h after max(h, 1e-16)).
//
// Mapping: a CTA a group (128 threads). Its documents' scores, labels,
// gains, discounts and ideal-order terms are staged in shared memory (20 B
// a document up to kStageDocs documents, else in a global scratch indexed
// by row); a thread takes documents i, i + 128, ... and loops over the
// group's j, each pair evaluated once from i's side: every document lies
// in one group, so its two sums are computed in its thread, no scatter.
// The ideal DCG and the metrics' position sums are a serial tree over the
// group's positions by thread 0. B9r's last CTA (a ticket) sums the groups'
// values in f64 in a fixed order: 128 contiguous runs, each in order, then
// the runs in order.
//
// What bounds it on an H100: operations. Each ordered pair of a group is
// one exp (a dozen FMA-unit operations), a division and the products and
// window adds of two sums (about 40 operations); MSLR-WEB30K's 30,000
// queries of about 120 documents are 4.6e8 pairs, 1.9e10 operations, 0.3
// ms at 67 TFLOP/s. The bytes (the margins, labels and weights read, the
// (g, h) pairs written, 20 B a row) are far below: the kernel is a simple
// one, right first; its pair loop is scalar.

#include "common.cuh"

constexpr int kRankThreads = 128;  // ops/metrics.RANK_SUM_THREADS
constexpr int kStageDocs = 2048;   // ops/ranking.STAGE_DOCS
constexpr float kLn2 = 0.693147182464599609375f;   // 0x3f317218
constexpr float kInvLn2 = 1.44269502162933349609375f;  // 0x3fb8aa3b

enum { XRT_RANK_PAIRWISE = 0, XRT_RANK_NDCG = 1 };   // B13 modes
enum { XRT_METRIC_NDCG = 0, XRT_METRIC_MAP = 1 };    // B9r modes

// Mirrors ops/ranking.RankArgs field by field: edit both together.
struct XrtRankArgs {
  const float* margin;         // [n]
  const float* label;          // [n]
  const float* weight;         // [n] (B13)
  const long long* offsets;    // [n_groups + 1]
  float* gh;                   // [n, 2] (B13)
  float* scratch;              // [5, n] for groups above the staging, or null
  float* vals;                 // [n_groups] (B9r)
  int* ticket;                 // zero before the launch (B9r)
  double* out;                 // [2] (B9r)
  long long n;
  int n_groups, width, mode;
  int k;                       // B9r: the positions read (kk)
  int stage;                   // documents staged in shared memory
  int threads;                 // B9r's summing runs (kRankThreads)
};

// 1 / log2(x) as the reference evaluates it
__device__ __forceinline__ float xrt_log2_recip(float x) {
  return __fdiv_rn(1.0f, __fmul_rn(xrt_log_f32(x), kInvLn2));
}

// 2^y - 1 as the reference evaluates it
__device__ __forceinline__ float xrt_gain(float y) {
  return __fsub_rn(xrt_ftz(xrt_exp_f32(__fmul_rn(y, kLn2))), 1.0f);
}

// sigmoid(-d) (ops/objectives.sigmoid of -d)
__device__ __forceinline__ float xrt_rho(float d) {
  const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, xrt_exp_f32(d)));
  return p < kXrtTiny ? 0.0f : p;
}

// the group's staging: shared memory, or the global scratch at its rows
struct XrtStage {
  float* s;      // scores
  float* y;      // labels
  float* gain;   // gains (B13) / DCG or AP terms by position (B9r)
  float* disc;   // 1 / log2(2 + rank) (B13) / ideal DCG terms or relevance
                 // by position (B9r)
  float* ideal;  // ideal DCG terms by position (B13) / positions (B9r)
};

__device__ __forceinline__ XrtStage xrt_stage(const XrtRankArgs& a,
                                              float* sh, long long r0,
                                              int size) {
  XrtStage st;
  if (size <= a.stage) {
    st.s = sh;
    st.y = sh + a.stage;
    st.gain = sh + 2 * a.stage;
    st.disc = sh + 3 * a.stage;
    st.ideal = sh + 4 * a.stage;
  } else {
    st.s = a.scratch + r0;
    st.y = a.scratch + a.n + r0;
    st.gain = a.scratch + 2 * a.n + r0;
    st.disc = a.scratch + 3 * a.n + r0;
    st.ideal = a.scratch + 4 * a.n + r0;
  }
  return st;
}

// descending position of value v[i] among v[0..size): larger ones first,
// ties in index order (a stable descending sort)
__device__ __forceinline__ int xrt_desc_pos(const float* v, int size, int i) {
  const float vi = v[i];
  int c = 0;
  for (int j = 0; j < size; ++j) {
    const float vj = v[j];
    c += (vj > vi) || (vj == vi && j < i);
  }
  return c;
}

// sum of terms[0..cnt) laid out at positions 0..cnt-1 of a padded axis of
// `width` slots, except that the positions from `gap_at` on are shifted by
// `gap` zeros (the padding before negative gains); zeros elsewhere
__device__ float xrt_position_sum(const float* terms, int cnt, int gap_at,
                                  int gap, int width) {
  const XrtTreeShape shape = xrt_tree_shape(width);
  XrtTreeAcc acc;
  xrt_tree_init(acc, shape);
  for (int p = 0; p < cnt; ++p) {
    if (p == gap_at)
      for (int z = 0; z < gap; ++z) xrt_tree_push(acc, shape, 0, 0.0f);
    xrt_tree_push(acc, shape, 0, terms[p]);
  }
  return xrt_tree_finish(acc, shape);
}

// ideal position of gain[i]: descending by value, the padding's zeros
// (width - size of them) before the negative gains; its compressed index
// (without the padding) in *slot
__device__ __forceinline__ int xrt_ideal_pos(const float* gain, int size,
                                             int width, int i, int* slot) {
  const int c = xrt_desc_pos(gain, size, i);
  *slot = c;
  return gain[i] < 0.0f ? c + (width - size) : c;
}

__device__ __forceinline__ int xrt_count_nonneg(const float* v, int size) {
  int c = 0;
  for (int j = 0; j < size; ++j) c += !(v[j] < 0.0f);
  return c;
}

__global__ void __launch_bounds__(kRankThreads)
    xrt_rank_gh_kernel(const XrtRankArgs a) {
  extern __shared__ float sh[];
  __shared__ float s_idcg;
  const long long r0 = a.offsets[blockIdx.x];
  const int size = (int)(a.offsets[blockIdx.x + 1] - r0);
  const XrtStage st = xrt_stage(a, sh, r0, size);
  const bool ndcg = a.mode == XRT_RANK_NDCG;
  for (int i = threadIdx.x; i < size; i += kRankThreads) {
    st.s[i] = a.margin[r0 + i];
    st.y[i] = a.label[r0 + i];
    if (ndcg) st.gain[i] = xrt_gain(st.y[i]);
  }
  __syncthreads();
  if (ndcg) {
    for (int i = threadIdx.x; i < size; i += kRankThreads) {
      // rank among the valid documents by descending score (argsort of
      // -s, the padding's +inf last)
      const float ni = -st.s[i];
      int rank = 0;
      for (int j = 0; j < size; ++j) {
        const float nj = -st.s[j];
        rank += (nj < ni) || (nj == ni && j < i);
      }
      st.disc[i] = xrt_log2_recip(__fadd_rn(2.0f, (float)rank));
      int slot;
      const int p = xrt_ideal_pos(st.gain, size, a.width, i, &slot);
      st.ideal[slot] = __fmul_rn(
          st.gain[i], xrt_log2_recip(__fadd_rn(2.0f, (float)p)));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int nonneg = xrt_count_nonneg(st.gain, size);
      const float idcg = xrt_position_sum(st.ideal, size, nonneg,
                                          a.width - size, a.width);
      s_idcg = xrt_max_nan(idcg, 1e-12f);
    }
    __syncthreads();
  }
  const XrtTreeShape shape = xrt_tree_shape(a.width);
  for (int i = threadIdx.x; i < size; i += kRankThreads) {
    const float si = st.s[i], yi = st.y[i];
    float gi = 0.0f, di = 0.0f;
    if (ndcg) {
      gi = st.gain[i];
      di = st.disc[i];
    }
    XrtTreeAcc win_g, lose_g, win_h, lose_h;
    xrt_tree_init(win_g, shape);
    xrt_tree_init(lose_g, shape);
    xrt_tree_init(win_h, shape);
    xrt_tree_init(lose_h, shape);
    for (int j = 0; j < size; ++j) {
      const float yj = st.y[j];
      const bool wins = yi > yj, loses = yj > yi;
      float lam = 0.0f, hs = 0.0f;
      if (wins || loses) {
        const float d = wins ? __fsub_rn(si, st.s[j]) : __fsub_rn(st.s[j], si);
        const float rho = xrt_rho(d);
        const float pr = xrt_max_nan(
            __fmul_rn(rho, __fsub_rn(1.0f, rho)), 1e-16f);
        if (ndcg) {
          const float dg = fabsf(__fsub_rn(gi, st.gain[j]));
          const float dd = fabsf(__fsub_rn(di, st.disc[j]));
          const float delta = __fdiv_rn(__fmul_rn(dg, dd), s_idcg);
          lam = __fmul_rn(rho, delta);
          hs = __fmul_rn(pr, delta);
        } else {
          lam = rho;
          hs = pr;
        }
      }
      xrt_tree_push(win_g, shape, 0, wins ? lam : 0.0f);
      xrt_tree_push(lose_g, shape, 0, loses ? lam : 0.0f);
      xrt_tree_push(win_h, shape, 0, wins ? hs : 0.0f);
      xrt_tree_push(lose_h, shape, 0, loses ? hs : 0.0f);
    }
    const float g = __fadd_rn(-xrt_tree_finish(win_g, shape),
                              xrt_tree_finish(lose_g, shape));
    const float h = __fadd_rn(xrt_tree_finish(win_h, shape),
                              xrt_tree_finish(lose_h, shape));
    // the reference scatters into zeros (0 + g), then weighs
    const float w = a.weight[r0 + i];
    a.gh[2 * (r0 + i)] = __fmul_rn(__fadd_rn(0.0f, g), w);
    a.gh[2 * (r0 + i) + 1] =
        __fmul_rn(xrt_max_nan(__fadd_rn(0.0f, h), 1e-16f), w);
  }
}

__global__ void __launch_bounds__(kRankThreads)
    xrt_rank_metric_kernel(const XrtRankArgs a) {
  extern __shared__ float sh[];
  __shared__ bool s_last;
  __shared__ double s_runs[kRankThreads];
  const long long r0 = a.offsets[blockIdx.x];
  const int size = (int)(a.offsets[blockIdx.x + 1] - r0);
  const XrtStage st = xrt_stage(a, sh, r0, size);
  const int kk = a.k;
  for (int i = threadIdx.x; i < size; i += kRankThreads) {
    st.s[i] = a.margin[r0 + i];
    st.y[i] = a.label[r0 + i];
  }
  __syncthreads();
  // position of each document by descending score (stable; the padding's
  // -inf after the valid documents), kept as int bits in `ideal`
  for (int i = threadIdx.x; i < size; i += kRankThreads)
    st.ideal[i] = __int_as_float(xrt_desc_pos(st.s, size, i));
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += kRankThreads) {
    const int p = __float_as_int(st.ideal[i]);
    const float pf = (float)p;
    const float disc = p < kk ? xrt_log2_recip(__fadd_rn(2.0f, pf)) : 0.0f;
    if (a.mode == XRT_METRIC_NDCG) {
      st.gain[p] = __fmul_rn(xrt_gain(st.y[i]), disc);
      int slot;
      const int q = xrt_ideal_pos(st.y, size, a.width, i, &slot);
      const float qdisc =
          q < kk ? xrt_log2_recip(__fadd_rn(2.0f, (float)q)) : 0.0f;
      st.disc[slot] = __fmul_rn(xrt_gain(st.y[i]), qdisc);
    } else {
      // the relevant documents at positions up to p (within k), / (p + 1)
      const bool rel = st.y[i] > 0.0f && p < kk;
      int c = 0;
      for (int j = 0; j < size; ++j) {
        const int pj = __float_as_int(st.ideal[j]);
        c += (st.y[j] > 0.0f && pj <= p && pj < kk);
      }
      st.gain[p] = rel ? __fdiv_rn((float)c, __fadd_rn(pf, 1.0f)) : 0.0f;
      st.disc[p] = rel ? 1.0f : 0.0f;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float val;
    if (a.mode == XRT_METRIC_NDCG) {
      const float dcg = xrt_position_sum(st.gain, size, size, 0, a.width);
      const int nonneg = xrt_count_nonneg(st.y, size);
      const float idcg = xrt_position_sum(st.disc, size, nonneg,
                                          a.width - size, a.width);
      val = idcg > 0.0f ? __fdiv_rn(dcg, xrt_max_nan(idcg, 1e-12f)) : 1.0f;
    } else {
      const float num = xrt_position_sum(st.gain, size, size, 0, a.width);
      const float den = xrt_position_sum(st.disc, size, size, 0, a.width);
      val = den > 0.0f ? __fdiv_rn(num, xrt_max_nan(den, 1e-12f)) : 0.0f;
    }
    a.vals[blockIdx.x] = val;
    __threadfence();
    s_last = atomicAdd(a.ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last CTA: the groups' values in f64, kRankThreads contiguous runs
  const int ng = a.n_groups;
  const int per = (ng + kRankThreads - 1) / kRankThreads;
  double run = 0.0;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, ng);
  const volatile float* vals = a.vals;
  for (int k = lo; k < hi; ++k) run += (double)vals[k];
  s_runs[threadIdx.x] = run;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int t = 0; t < kRankThreads; ++t) total += s_runs[t];
    a.out[0] = total;
    a.out[1] = (double)ng;
    *a.ticket = 0;
  }
}

static int xrt_rank_check(const XrtRankArgs* a) {
  if (a->n < 0 || a->n_groups < 1 || a->width < 1 || a->stage < 1 ||
      a->stage > kStageDocs || a->stage > a->width ||
      a->margin == nullptr || a->label == nullptr || a->offsets == nullptr ||
      (a->width > a->stage && a->scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// One B13 launch on `stream`: a CTA a group, a->gh written for every row
// of a group.
extern "C" int xrt_rank_gh(const XrtRankArgs* a, void* stream) {
  int e = xrt_rank_check(a);
  if (e != 0) return e;
  if (a->weight == nullptr || a->gh == nullptr ||
      (a->mode != XRT_RANK_PAIRWISE && a->mode != XRT_RANK_NDCG))
    return (int)cudaErrorInvalidValue;
  const int smem = 5 * a->stage * (int)sizeof(float);
  xrt_rank_gh_kernel<<<(unsigned)a->n_groups, kRankThreads, smem,
                       (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// One B9r launch on `stream`: a CTA a group writes its value; the last
// writes out[0] (the sum in f64) and out[1] (the groups) and zeroes the
// ticket.
extern "C" int xrt_rank_metric(const XrtRankArgs* a, void* stream) {
  int e = xrt_rank_check(a);
  if (e != 0) return e;
  if (a->vals == nullptr || a->ticket == nullptr || a->out == nullptr ||
      a->threads != kRankThreads || a->k < 1 || a->k > a->width ||
      (a->mode != XRT_METRIC_NDCG && a->mode != XRT_METRIC_MAP))
    return (int)cudaErrorInvalidValue;
  const int smem = 5 * a->stage * (int)sizeof(float);
  xrt_rank_metric_kernel<<<(unsigned)a->n_groups, kRankThreads, smem,
                           (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
