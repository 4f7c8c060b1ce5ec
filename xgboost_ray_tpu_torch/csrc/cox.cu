// B14, one round of survival:cox's Breslow pass, CUDA C++ for sm_90a.
//
// Replaces xgboost_ray_tpu/ops/objectives.py:399-444 (cox_risk_terms) and
// :447-471 (_make_cox's gradients), and ops/metrics.py:263-280
// (cox_nloglik_global). Over the world's rows (gathered at world > 1), in
// the time order that ops/cox.cox_setup fixed once from the labels
// (order, cnt_ge, cnt_gt):
//   M = the largest margin of a row with w > 0 (NaN-propagating; 0 where
//     it is not finite);
//   r = w exp(m - M) (the shift, the exp and r flushed), in time
//     order, and its inclusive scan cum;
//   D = cum[max(cnt_ge - 1, 0)] clamped at 0 (the reference's clamp at
//     1e-38, a subnormal its CPU program flushes), per time-ordered row;
//   the scans of ev / D and ev / D^2 (ev = w where the label is an event);
//   S1, S2 = the scan's total less its prefix at cnt_gt, per row;
//   g = fma(r, S1, -ev), h = max(fma(r, S1, -(r r) S2), 1e-16) for this
//     rank's rows (offset .. offset + n_local);
//   with the metric, sum ev (log D + M - m) and sum ev over every row.
// Every value is bitwise the plain version's (ops/cox.cox_round_plain),
// which is bitwise the reference's compiled CPU program: each scan takes
// XLA's CPU cumsum order (ops/split.blocked_cumsum): in order within blocks
// of 16 (a thread a block, the tail padded with zeros), the block totals
// scanned the same way, a level a launch, then each block adds the scan of
// the blocks before it, a level a launch down again; fused multiply-adds
// only where __fmaf_rn stands (--fmad=false). The metric's sums are f64 in
// a fixed order: thread t of kSumCtas x kThreads adds rows t, t + T, ...,
// the last CTA (a ticket) adds its threads' runs of T / kThreads partials,
// then the runs in order.
//
// What bounds it on an H100: bytes. A round reads each row's margin, label
// and weight and the three int64 set-up arrays once (36 B a row) and
// writes this rank's (g, h) pairs (8 B a row): at 10.5M rows 0.46 GB,
// 0.14 ms at 3.35 TB/s. The kernels re-read the margins and weights through the time
// order (gathers) and move each scan's levels again: a simple design, a
// thread a block of 16 as the order demands, right first.

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kSumCtas = 256;   // ops/cox.COX_SUM_CTAS
constexpr int kBlock = 16;      // ops/cox.SCAN_BLOCK
constexpr int kMaxLevels = 16;

// Mirrors ops/cox.CoxArgs field by field: edit both together.
struct XrtCoxArgs {
  const float* margin;          // [n] the world's
  const float* label;           // [n]
  const float* weight;          // [n]
  const long long* order;       // [n] rows by descending time, stable
  const long long* cnt_ge;      // [n] rows with a time >= the row's
  const long long* cnt_gt;      // [n] rows with a time > the row's
  float* gh;                    // [n_local, 2]
  float* cum;                   // scan workspace (ops/cox.scan_levels(n))
  float* t1;                    // scan workspace
  float* t2;                    // scan workspace
  float* stat;                  // [2]: M
  double* part;                 // [kSumCtas * kThreads, 2] scratch
  int* ticket;                  // zero before the call
  double* out;                  // [2] metric sums
  long long n, offset, n_local;
  int with_metric;
};

// the flushed r of one row: w exp(m - M)
__device__ __forceinline__ float xrt_cox_r(float m, float w, float mm) {
  return xrt_ftz(
      __fmul_rn(w, xrt_ftz(xrt_exp_f32(xrt_ftz(__fsub_rn(m, mm))))));
}

// ops/cox.risk_denominator: the reference's max(D, 1e-38) with its
// subnormal constant flushed to 0
__device__ __forceinline__ float xrt_cox_d(float cum) {
  const float d = xrt_ftz(cum);
  return d < 0.0f ? 0.0f : d;
}

__device__ __forceinline__ float xrt_cox_ev(float y, float w) {
  return __fmul_rn(w, y > 0.0f ? 1.0f : 0.0f);
}

// M over the rows: CTA maxima in `part`, the last CTA's max in stat[0]
__global__ void __launch_bounds__(kThreads) xrt_cox_max(const XrtCoxArgs a) {
  __shared__ float s_max[kThreads];
  __shared__ bool s_last;
  float mx = -INFINITY;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < a.n;
       i += (long long)gridDim.x * kThreads)
    mx = xrt_max_nan(mx, a.weight[i] > 0.0f ? a.margin[i] : -INFINITY);
  s_max[threadIdx.x] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int t = 1; t < kThreads; ++t) mx = xrt_max_nan(mx, s_max[t]);
    a.part[blockIdx.x] = (double)mx;
    __threadfence();
    s_last = atomicAdd(a.ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last || threadIdx.x != 0) return;
  __threadfence();
  const volatile double* part = a.part;
  float m = -INFINITY;
  for (unsigned b = 0; b < gridDim.x; ++b) m = xrt_max_nan(m, (float)part[b]);
  a.stat[0] = isfinite(m) ? m : 0.0f;
  *a.ticket = 0;
}

// the level-0 blocks of the first scan: r in time order, scanned within
// blocks of 16 in place, each block's total into the next level
__global__ void __launch_bounds__(kThreads)
    xrt_cox_r_blocks(const XrtCoxArgs a, long long next) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b * kBlock >= a.n) return;
  const float mm = a.stat[0];
  float acc = 0.0f;
  for (int j = 0; j < kBlock; ++j) {
    const long long k = b * kBlock + j;
    float v = 0.0f;
    if (k < a.n) {
      const long long o = a.order[k];
      v = xrt_cox_r(a.margin[o], a.weight[o], mm);
    }
    acc = j == 0 ? v : __fadd_rn(acc, v);
    if (k < a.n) a.cum[k] = acc;
  }
  if (next >= 0) a.cum[next + b] = acc;
}

// the level-0 blocks of the second scans: ev / D and ev / D^2 in time
// order, each scanned within blocks of 16 in place, totals up a level
__global__ void __launch_bounds__(kThreads)
    xrt_cox_term_blocks(const XrtCoxArgs a, long long next) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b * kBlock >= a.n) return;
  float acc1 = 0.0f, acc2 = 0.0f;
  for (int j = 0; j < kBlock; ++j) {
    const long long k = b * kBlock + j;
    float v1 = 0.0f, v2 = 0.0f;
    if (k < a.n) {
      const long long o = a.order[k];
      const long long c = a.cnt_ge[o] - 1;
      const float d = xrt_cox_d(a.cum[c > 0 ? c : 0]);
      const float ev = xrt_cox_ev(a.label[o], a.weight[o]);
      v1 = __fdiv_rn(ev, d);
      v2 = __fdiv_rn(ev, __fmul_rn(d, d));
    }
    acc1 = j == 0 ? v1 : __fadd_rn(acc1, v1);
    acc2 = j == 0 ? v2 : __fadd_rn(acc2, v2);
    if (k < a.n) {
      a.t1[k] = acc1;
      a.t2[k] = acc2;
    }
  }
  if (next >= 0) {
    a.t1[next + b] = acc1;
    a.t2[next + b] = acc2;
  }
}

// one level up of a blocked scan over buf[off .. off + len) (and buf2's,
// where given): blocks of 16 scanned in place, totals to buf[next + b];
// with next < 0 (len <= 16) one thread scans the level in order
__global__ void __launch_bounds__(kThreads)
    xrt_scan_up(float* buf, float* buf2, long long off, long long len,
                long long next) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b * kBlock >= len) return;
  for (int q = 0; q < 2; ++q) {
    float* x = q == 0 ? buf : buf2;
    if (x == nullptr) continue;
    float acc = 0.0f;
    for (int j = 0; j < kBlock; ++j) {
      const long long k = b * kBlock + j;
      const float v = k < len ? x[off + k] : 0.0f;
      acc = j == 0 ? v : __fadd_rn(acc, v);
      if (k < len) x[off + k] = acc;
    }
    if (next >= 0) x[next + b] = acc;
  }
}

// one level down: element k of block b >= 1 adds the final scan of the
// blocks before it (level above, at `up`)
__global__ void __launch_bounds__(kThreads)
    xrt_scan_down(float* buf, float* buf2, long long off, long long len,
                  long long up) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x + kBlock;
  if (k >= len) return;
  const long long b = k / kBlock;
  buf[off + k] = __fadd_rn(buf[off + k], buf[up + b - 1]);
  if (buf2 != nullptr)
    buf2[off + k] = __fadd_rn(buf2[off + k], buf2[up + b - 1]);
}

// this rank's rows' (g, h)
__global__ void __launch_bounds__(kThreads) xrt_cox_gh(const XrtCoxArgs a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n_local) return;
  const long long gi = a.offset + i;
  const float mm = a.stat[0];
  const float w = a.weight[gi];
  const float r = xrt_cox_r(a.margin[gi], w, mm);
  const float ev = xrt_cox_ev(a.label[gi], w);
  const long long c = a.cnt_gt[gi];
  const float p1 = c == 0 ? 0.0f : a.t1[c - 1];
  const float p2 = c == 0 ? 0.0f : a.t2[c - 1];
  const float s1 = __fsub_rn(a.t1[a.n - 1], p1);
  const float s2 = __fsub_rn(a.t2[a.n - 1], p2);
  a.gh[2 * i] = __fmaf_rn(r, s1, -ev);
  a.gh[2 * i + 1] = xrt_max_nan(
      __fmaf_rn(r, s1, -__fmul_rn(__fmul_rn(r, r), s2)), 1e-16f);
}

// cox-nloglik's sums over every row, f64 in a fixed order
__global__ void __launch_bounds__(kThreads)
    xrt_cox_metric(const XrtCoxArgs a) {
  __shared__ double s_num[kThreads], s_den[kThreads];
  __shared__ bool s_last;
  const long long t_all = (long long)kSumCtas * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const float mm = a.stat[0];
  double num = 0.0, den = 0.0;
  for (long long i = t; i < a.n; i += t_all) {
    const long long c = a.cnt_ge[i] - 1;
    const float d = xrt_cox_d(a.cum[c > 0 ? c : 0]);
    const float log_d = __fadd_rn(xrt_log_f32(d), mm);
    const float ev = xrt_cox_ev(a.label[i], a.weight[i]);
    num += (double)__fmul_rn(ev, __fsub_rn(log_d, a.margin[i]));
    den += (double)ev;
  }
  a.part[2 * t] = num;
  a.part[2 * t + 1] = den;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(a.ticket, 1) == kSumCtas - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const volatile double* part = a.part;
  const long long per = t_all / kThreads;
  double rn = 0.0, rd = 0.0;
  for (long long k = threadIdx.x * per; k < (threadIdx.x + 1) * per; ++k) {
    rn += part[2 * k];
    rd += part[2 * k + 1];
  }
  s_num[threadIdx.x] = rn;
  s_den[threadIdx.x] = rd;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tn = 0.0, td = 0.0;
    for (int j = 0; j < kThreads; ++j) {
      tn += s_num[j];
      td += s_den[j];
    }
    a.out[0] = tn;
    a.out[1] = td;
    *a.ticket = 0;
  }
}

static unsigned xrt_grid(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

// the blocked scan's levels over n values: offsets and lengths, the last
// one 16 values or fewer
static int xrt_scan_plan(long long n, long long* off, long long* len) {
  int levels = 0;
  off[0] = 0;
  len[0] = n;
  while (len[levels] > kBlock) {
    if (levels + 1 >= kMaxLevels) return -1;
    off[levels + 1] = off[levels] + len[levels];
    len[levels + 1] = (len[levels] + kBlock - 1) / kBlock;
    ++levels;
  }
  return levels;
}

// the levels above level 0 of a blocked scan up, the top one in order,
// then down to level 0
static void xrt_scan_rest(float* buf, float* buf2, const long long* off,
                          const long long* len, int levels, cudaStream_t s) {
  for (int l = 1; l <= levels; ++l) {
    const long long next = l < levels ? off[l + 1] : -1;
    const long long blocks = (len[l] + kBlock - 1) / kBlock;
    xrt_scan_up<<<xrt_grid(blocks), kThreads, 0, s>>>(buf, buf2, off[l],
                                                      len[l], next);
  }
  for (int l = levels - 1; l >= 0; --l) {
    if (len[l] <= kBlock) continue;
    xrt_scan_down<<<xrt_grid(len[l] - kBlock), kThreads, 0, s>>>(
        buf, buf2, off[l], len[l], off[l + 1]);
  }
}

// One B14 call on `stream`: a round's (g, h) of this rank's rows and, with
// a->with_metric, the metric's sums in a->out.
extern "C" int xrt_cox_round(const XrtCoxArgs* a, void* stream) {
  if (a->n < 1 || a->offset < 0 || a->n_local < 0 ||
      a->offset + a->n_local > a->n || a->margin == nullptr ||
      a->label == nullptr || a->weight == nullptr || a->order == nullptr ||
      a->cnt_ge == nullptr || a->cnt_gt == nullptr || a->cum == nullptr ||
      a->t1 == nullptr ||
      a->t2 == nullptr || a->stat == nullptr || a->part == nullptr ||
      a->ticket == nullptr || (a->n_local > 0 && a->gh == nullptr) ||
      (a->with_metric && a->out == nullptr))
    return (int)cudaErrorInvalidValue;
  long long off[kMaxLevels], len[kMaxLevels];
  const int levels = xrt_scan_plan(a->n, off, len);
  if (levels < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long blocks0 = (a->n + kBlock - 1) / kBlock;
  const long long next0 = levels > 0 ? off[1] : -1;
  const long long row_ctas = (a->n + kThreads - 1) / kThreads;
  const unsigned max_ctas =
      (unsigned)(row_ctas < kSumCtas ? row_ctas : kSumCtas);
  xrt_cox_max<<<max_ctas, kThreads, 0, s>>>(*a);
  xrt_cox_r_blocks<<<xrt_grid(blocks0), kThreads, 0, s>>>(*a, next0);
  xrt_scan_rest(a->cum, nullptr, off, len, levels, s);
  xrt_cox_term_blocks<<<xrt_grid(blocks0), kThreads, 0, s>>>(*a, next0);
  xrt_scan_rest(a->t1, a->t2, off, len, levels, s);
  if (a->n_local > 0)
    xrt_cox_gh<<<xrt_grid(a->n_local), kThreads, 0, s>>>(*a);
  if (a->with_metric) xrt_cox_metric<<<kSumCtas, kThreads, 0, s>>>(*a);
  return (int)cudaGetLastError();
}
