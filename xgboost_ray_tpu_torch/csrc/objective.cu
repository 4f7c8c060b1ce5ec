// K4, the fused per-round elementwise pass of every row-elementwise
// objective, CUDA C++ for sm_90a. One pass over [N] f32 margins, in two
// modes:
//   gh (one XRT_K4_* objective mode each): margin += row_value, written
//     back; the metric partial sums of the new margins; the next round's
//     gradients gh [N, 2] (g, h interleaved, what K1 reads);
//   eval (XRT_K4_EVAL): the same without gradients (a held-out set).
// and a K-output kernel (multi = 1: reg:quantileerror's K alphas): [N, K]
// margins += row_value [K, N]^T, gh as [K, N, 2] planes (output k's [N, 2]
// contiguous for K1-K3), the row metrics of output 0 and the pinball loss's
// mean over the K outputs.
//
// Replaces xgboost_ray_tpu/ops/objectives.py:72-278 (the objectives'
// closures: _make_squarederror, _make_absoluteerror, _make_logistic with
// scale_pos_weight, _make_quantile, _make_poisson, _make_gamma,
// _make_tweedie, _make_hinge, _make_squaredlogerror, _make_pseudohuber),
// ops/survival.py:49-140 (the AFT pass: survival:aft's gradients over the
// label bounds, normal and logistic, and aft-nloglik) and the elementwise
// metrics the round reads, ops/metrics.py:27-105, as fifteen sums (PARTIALS
// of ops/objectives.py): sum(w logloss), sum(w wrong), sum(w d^2), sum(w)
// always, then where the caller's mask names them sum(w |d|), sum(w
// (log1p m - log1p y)^2), sum(w pseudo-Huber), sum(w |d / y|), sum(w
// Poisson nll), sum(w wrong at error@t), sum(w AFT nll), sum(w pinball),
// and sum(w wrong) at a run's second, third and fourth error@t threshold.
//
// With T parallel trees a round (num_parallel_tree, XrtK4Args.n_trees > 1)
// the one-output kernel adds the round's T row values [T, N] to each
// margin in turn, m = fma(v_t, 1 / T, m) (XLA's program for the
// reference's margins.at[:, k].add(row_value / t_par): the division folded
// into a multiply by the float32 1 / T, which fuses with the add), in
// registers; that path takes the scalar instantiation (a branch there on
// the launch's T). T = 1 is the launch as before.
// The margins and the gradients are bitwise the plain version
// (ops/objectives.round_update_plain, ops/survival.aft_grad_hess), which
// is bitwise the reference's compiled CPU program:
//   - the transcendentals are XLA's: Cephes' exp (ops/objectives.exp_f32,
//     clamped, with its final NaN-propagating max), Cephes' log (log_f32),
//     the rational log1p (log1p_f32), the rational erf (erf_f32), each
//     fused multiply-add __fmaf_rn exactly where the plain version has
//     _fma and nowhere else (--fmad=false, ops/_build.py); sqrt correctly
//     rounded (__fsqrt_rn); divisions __fdiv_rn;
//   - XLA's CPU program reads subnormal operands as zero and flushes
//     subnormal results to a zero of their sign: margin, label, weight and
//     bounds are read that way for the gradients, and every product and
//     difference is flushed where the plain version flushes it (no -ftz,
//     no fast math);
//   - the constants as XLA's simplifier folds them (x / c as x * (1 / c),
//     tweedie's equal coefficients factored, AFT's products of constants
//     merged) come from the caller (XrtK4Args.c, ops/objectives.ObjConsts),
//     the same floats the plain version uses.
// The partial sums are not bitwise the plain version's torch.sum (another
// order; the logloss's log1p(exp(-|z|)) from the fast __expf / __logf, as
// log(u) e / (u - 1) with u = 1 + e; the other terms from CUDA's logf,
// erff, lgammaf): they are held within 1e-5 relative. The error term's
// sigmoid(m) > 0.5 is m >= kHalfMargin, the least float32 margin whose
// plain sigmoid exceeds 0.5 (tests/test_torch_objective_kernel holds the
// two tests equal), so the eval mode evaluates no exp_f32. The sums are
// bitwise from launch to launch and between the two modes: each CTA sums
// its rows in a fixed order into one f32 partial a slot (each thread its
// rows in order, an xor tree of warp shuffles, the warps in order; no float
// atomics), and the last CTA to finish (a ticket counter taken with
// acquire-release semantics, which resets itself) adds the partials in f64
// in a fixed order that keeps CTA order (a run of CTAs a thread, then an
// order-preserving pairwise tree) into a fresh [12] f64 output: one launch
// a call. The logistic and squared-error instantiations compute their
// margins, gradients and first four sums exactly as before the other
// objectives joined.
//
// What bounds it on an H100: bytes. Each row reads margin, row_value,
// label and weight (16 B) and writes its margin (4 B), and in gh mode its
// (g, h) pair (8 B): 20 B a row in eval mode (500,000 HIGGS test rows:
// 10 MB, 2.985 us at 3.35 TB/s), 28 B in gh mode (11M rows: 0.0919 ms);
// the AFT modes read the two bounds besides (36 B a row in gh mode). The
// transcendentals of the AFT pass (two logs, two exps, two erfs or two
// sigmoids a row) and of the Poisson / Tweedie / squared-log modes are a
// few dozen FMAs a row, far below the card's FP32 rate at these byte
// counts. Design: a persistent grid of at most 2 CTAs of 512 threads an SM
// (ops/objectives.k4_plan: the grid depends on N and the card only, so
// both modes sum the same rows in the same CTAs) walks tiles of 2,048 rows,
// 4 a thread: a thread loads its rows of the inputs as 16-byte vectors,
// the next tile's loads issued before the current tile is computed
// (registers double-buffered); the margins go back as one float4 a thread,
// and each warp's (g, h) pairs are staged through shared memory so that a
// store instruction writes 512 contiguous bytes. The loads and stores carry
// no cache hint: evict-first ones lowered neither mode's time
// (chip_smoke.py --k4-variants prices them). Where a pointer is not 16-byte
// aligned the whole launch takes the scalar path (the same rows for the
// same threads, so the same sums), and the vector that holds the last row
// takes it inside the vector path. The instantiations that read the
// bounds or sum past the first four (EXT) take one CTA an SM (up to 128
// registers: the bounds double-buffered, twelve sums), so the plan's
// second CTA of an SM runs as a second wave. The K-output kernel keeps the
// plan and the reduction but loads a row's K margins and values one at a
// time (a simple first version: quantile models have a handful of alphas). What is
// left above the bound at 500,000 rows is the last CTA's serial tail (the
// ticket's and the partials' round trips to L2) and the launch's ramp:
// PERF.md.

#include "common.cuh"

constexpr int kThreads = 512;
constexpr int kTileRows = kThreads * 4;  // ops/objectives.K4_TILE_ROWS
constexpr int kCtasPerSm = 2;            // ops/objectives.K4_CTAS_PER_SM
constexpr int kParts = 15;               // ops/objectives.PARTIALS
constexpr int kMaxOutputs = 16;          // ops/objectives.K4_MAX_OUTPUTS

// ops/objectives._K4_MODES
enum {
  XRT_K4_EVAL = 0,
  XRT_K4_LOGISTIC = 1,
  XRT_K4_SQUARED = 2,
  XRT_K4_ABSOLUTE = 3,
  XRT_K4_PSEUDOHUBER = 4,
  XRT_K4_SQUAREDLOG = 5,
  XRT_K4_POISSON = 6,
  XRT_K4_GAMMA = 7,
  XRT_K4_TWEEDIE = 8,
  XRT_K4_HINGE = 9,
  XRT_K4_AFT_NORMAL = 10,
  XRT_K4_AFT_LOGISTIC = 11,
  XRT_K4_QUANTILE = 12
};

// the partial sums (ops/objectives.PARTIALS)
enum {
  P_LOGLOSS = 0, P_ERROR, P_SQERR, P_WEIGHT, P_ABSERR, P_SQLOGERR, P_PHE,
  P_APE, P_POISSON, P_ERROR_T, P_AFT, P_PINBALL, P_ERROR_T2, P_ERROR_T3,
  P_ERROR_T4
};

// the objective's folded constants (ops/objectives.K4_CONSTS)
enum {
  C_HUBER_RECIP = 0, C_HUBER_SLOPE, C_TW_E1, C_TW_E2, C_TW_H1, C_TW_H2,
  C_TW_FACTORED, C_AFT_R, C_AFT_RC, C_AFT_HR, C_AFT_S, C_AFT_S2, C_AFT_HU,
  C_AFT_LOG_SIGMA, C_THRESHOLD, C_AFT_LOGISTIC, C_ALPHA0, C_SPW,
  C_THRESHOLD2, C_THRESHOLD3, C_THRESHOLD4, C_COUNT
};

// Mirrors ops/_build.K4Args field by field: edit both together.
struct XrtK4Args {
  float* margin;           // [n] ([n, k] for the K-output kernel), in place
  const float* row_value;  // [n] ([k, n])
  const float* label;      // [n]
  const float* weight;     // [n]
  float* gh;               // [n, 2] ([k, n, 2]) (gh modes)
  float* part;             // [grid, kParts] scratch: the CTAs' f32 partials
  unsigned* ticket;        // 0 between launches (the last CTA resets it)
  double* out;             // [kParts]
  long long n;
  int grid;                // ops/objectives.k4_plan(n, SMs).grid
  int mode;
  float scale_pos_weight;  // as float32
  const float* lower;      // [n] label bounds, or null
  const float* upper;      // [n]
  const float* alpha;      // [k] the quantile alphas (K-output kernel)
  int k;                   // outputs
  int metrics;             // bit i: the partial sum i (i >= 4) is wanted
  int multi;               // 1: the K-output kernel
  float c[C_COUNT];
  int n_trees;             // T: row_value holds [T, n] or [k T, n]
  float inv_trees;         // float32 1 / T
};

constexpr float kTiny = 1.17549435e-38f;  // smallest normal float
// the least float32 margin m with sigmoid(m) > 0.5 (0x33c00001)
constexpr float kHalfMargin = 8.9406974e-08f;

__device__ __forceinline__ float xrt_min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// ops/objectives.sigmoid: 1 / (1 + exp_f32(-m)), flushed below 2^-126.
__device__ __forceinline__ float xrt_sigmoid(float m) {
  const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, xrt_exp_f32(-m)));
  return p < kTiny ? 0.0f : p;
}

// ops/objectives.log1p_f32: XLA's float32 log1p, DAZ.
__device__ __forceinline__ float xrt_log1p_f32(float v) {
  const float x = xrt_ftz(v);
  if (!(fabsf(x) < 0.4142135679721832f)) return xrt_log_f32(__fadd_rn(x, 1.0f));
  const float x2 = __fmul_rn(x, x);
  float den = __fmaf_rn(x, 0.0f, 1.0f);
  den = __fmaf_rn(den, x, 15.062909126281738f);
  den = __fmaf_rn(den, x, 83.04756927490234f);
  den = __fmaf_rn(den, x, 221.7624053955078f);
  den = __fmaf_rn(den, x, 309.0987243652344f);
  den = __fmaf_rn(den, x, 216.42788696289062f);
  den = __fmaf_rn(den, x, 60.11865997314453f);
  float num = __fmaf_rn(x, 0.0f, 4.527000055531971e-05f);
  num = __fmaf_rn(num, x, 0.4985410273075104f);
  num = __fmaf_rn(num, x, 6.578732490539551f);
  num = __fmaf_rn(num, x, 29.91191864013672f);
  num = __fmaf_rn(num, x, 60.949668884277344f);
  num = __fmaf_rn(num, x, 57.11296463012695f);
  num = __fmaf_rn(num, x, 20.039552688598633f);
  const float s = __fmaf_rn(
      x2, -0.5f, __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den)));
  return __fadd_rn(x, s);
}

// ops/objectives.erf_f32: XLA's float32 erf on [-3.744, 3.744], DAZ.
__device__ __forceinline__ float xrt_erf_f32(float v) {
  constexpr float kClamp = 3.7439212799072266f;
  float x = fminf(fmaxf(xrt_ftz(v), -kClamp), kClamp);
  x = v != v ? v : x;
  const float x2 = __fmul_rn(x, x);
  float p = __fmaf_rn(x2, 0.00022905065270606428f, 0.0034082909114658833f);
  p = __fmaf_rn(p, x2, 0.050955694168806076f);
  p = __fmaf_rn(p, x2, 0.18520832061767578f);
  p = __fmaf_rn(p, x2, 1.1283791065216064f);
  float q = __fmaf_rn(x2, -1.1791603071742429e-07f, 2.354796561121475e-05f);
  q = __fmaf_rn(q, x2, 0.0010179625824093819f);
  q = __fmaf_rn(q, x2, 0.01407046988606453f);
  q = __fmaf_rn(q, x2, 0.11098504811525345f);
  q = __fmaf_rn(q, x2, 0.4974692463874817f);
  q = __fmaf_rn(q, x2, 1.0f);
  return __fdiv_rn(__fmul_rn(x, p), q);
}

// jax.nn.softplus(x) = log(1 + exp(x)), for the metrics
__device__ __forceinline__ float xrt_softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// The AFT pass's (g, h) of one row: ops/survival.aft_grad_hess. m, lo,
// hi and w are read with DAZ by the caller.
template <bool LOGISTIC>
__device__ __forceinline__ float2 xrt_aft_gh(float m, float lo, float hi,
                                             float w, const XrtK4Args& a) {
  constexpr float kEps = 1e-12f;
  constexpr float kNormalK = 0.3989422917366028f;  // f32(1 / sqrt(2 pi))
  constexpr float kInvSqrt2 = 0.7071067690849304f;
  const float r = a.c[C_AFT_R];
  const bool fin = isfinite(hi);
  const bool unc = fin && fabsf(xrt_ftz(__fsub_rn(hi, lo))) < 1e-10f;
  const float dlo = xrt_ftz(__fsub_rn(xrt_log_f32(xrt_max_nan(lo, kEps)), m));
  const float zl = xrt_ftz(__fmul_rn(dlo, r));
  const float zh =
      fin ? xrt_ftz(__fmul_rn(
                xrt_ftz(__fsub_rn(xrt_log_f32(xrt_max_nan(hi, kEps)), m)), r))
          : 0.0f;
  float a_lo, a_hi, b_lo, b_hi, den, gu, hu;
  if (LOGISTIC) {
    a_lo = xrt_sigmoid(zl);
    a_hi = xrt_sigmoid(zh);
    b_lo = xrt_ftz(__fsub_rn(1.0f, a_lo));
    b_hi = xrt_ftz(__fsub_rn(1.0f, a_hi));
    const float cdf_hi = fin ? a_hi : 1.0f;
    den = xrt_max_nan(xrt_ftz(__fsub_rn(cdf_hi, a_lo)), kEps);
    gu = xrt_ftz(__fmul_rn(-xrt_ftz(__fmaf_rn(a_lo, 2.0f, -1.0f)), r));
    hu = xrt_ftz(__fmul_rn(xrt_ftz(__fmul_rn(xrt_ftz(__fmul_rn(a_lo, 2.0f)),
                                             b_lo)),
                           a.c[C_AFT_HU]));
  } else {
    a_lo = xrt_exp_f32(xrt_ftz(__fmul_rn(xrt_ftz(__fmul_rn(dlo, a.c[C_AFT_HR])),
                                         zl)));
    a_hi = xrt_exp_f32(xrt_ftz(__fmul_rn(xrt_ftz(__fmul_rn(zh, -0.5f)), zh)));
    b_lo = b_hi = kNormalK;
    const float erf_lo = xrt_erf_f32(xrt_ftz(__fmul_rn(dlo, a.c[C_AFT_RC])));
    const float erf_hi = xrt_erf_f32(xrt_ftz(__fmul_rn(zh, kInvSqrt2)));
    const float cdf_hi =
        fin ? xrt_ftz(__fmul_rn(__fadd_rn(erf_hi, 1.0f), 0.5f)) : 1.0f;
    den = xrt_max_nan(
        xrt_ftz(__fmaf_rn(-__fadd_rn(erf_lo, 1.0f), 0.5f, cdf_hi)), kEps);
    gu = xrt_ftz(__fmul_rn(-zl, r));
    hu = a.c[C_AFT_HU];
  }
  const float pdf_hi = fin ? xrt_ftz(__fmul_rn(a_hi, b_hi)) : 0.0f;
  const float dh = xrt_ftz(__fmaf_rn(-a_lo, b_lo, pdf_hi));
  const float pdf_lo = xrt_ftz(__fmul_rn(a_lo, b_lo));
  const float dl = fin ? xrt_ftz(__fmaf_rn(-a_hi, b_hi, pdf_lo)) : pdf_lo;
  const float gc =
      xrt_ftz(__fdiv_rn(dh, xrt_ftz(__fmul_rn(den, a.c[C_AFT_S]))));
  const float hc = xrt_max_nan(
      xrt_ftz(__fdiv_rn(xrt_ftz(__fmul_rn(dl, dl)),
                        xrt_ftz(__fmul_rn(
                            xrt_ftz(__fmul_rn(den, a.c[C_AFT_S2])), den)))),
      1e-6f);
  const float g = xrt_ftz(__fmul_rn(unc ? gu : gc, w));
  const float h = xrt_ftz(__fmul_rn(xrt_max_nan(unc ? hu : hc, 1e-6f), w));
  return make_float2(g, h);
}

// One row's (g, h) in objective MODE (ops/objectives.grad_hess), from the
// operands read as the reference reads them: subnormal margin, label,
// weight and bounds as zero; m, y, w, lo, hi raw.
template <int MODE>
__device__ __forceinline__ float2 xrt_gh(float m, float y, float w, float lo,
                                         float hi, const XrtK4Args& a) {
  const float md = xrt_ftz(m), yd = xrt_ftz(y), wd = xrt_ftz(w);
  if (MODE == XRT_K4_LOGISTIC) {
    float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, xrt_exp_f32(-md)));
    p = p < kTiny ? 0.0f : p;
    const float ws =
        xrt_ftz(__fmul_rn(wd, yd > 0.5f ? a.scale_pos_weight : 1.0f));
    const float g = xrt_ftz(__fmul_rn(xrt_ftz(__fsub_rn(p, yd)), ws));
    float t = __fmul_rn(p, __fsub_rn(1.0f, p));
    t = t != t ? t : fmaxf(t, 1e-16f);
    return make_float2(g, xrt_ftz(__fmul_rn(t, ws)));
  }
  if (MODE == XRT_K4_SQUARED) {
    // the squared error's h is the weight itself, as the reference passes it
    return make_float2(xrt_ftz(__fmul_rn(xrt_ftz(__fsub_rn(md, yd)), wd)), w);
  }
  if (MODE == XRT_K4_ABSOLUTE) {
    const float d = xrt_ftz(__fsub_rn(md, yd));
    const float s = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : d);  // jnp.sign
    return make_float2(xrt_ftz(__fmul_rn(s, wd)), w);
  }
  if (MODE == XRT_K4_HINGE) {
    const float s = yd > 0.5f ? 1.0f : -1.0f;
    const bool viol = xrt_ftz(__fmul_rn(s, md)) < 1.0f;
    return make_float2(xrt_ftz(__fmul_rn(viol ? -s : 0.0f, wd)), w);
  }
  if (MODE == XRT_K4_PSEUDOHUBER) {
    const float r = xrt_ftz(__fsub_rn(md, yd));
    const float q = a.c[C_HUBER_RECIP] == 1.0f
                        ? r
                        : xrt_ftz(__fmul_rn(r, a.c[C_HUBER_RECIP]));
    const float scale = xrt_ftz(__fmaf_rn(q, q, 1.0f));
    const float ss = xrt_ftz(__fsqrt_rn(xrt_ftz(scale)));
    const float g = xrt_ftz(__fmul_rn(xrt_ftz(__fdiv_rn(r, ss)), wd));
    const float h = xrt_ftz(__fmul_rn(
        xrt_max_nan(xrt_ftz(__fdiv_rn(1.0f, xrt_ftz(__fmul_rn(scale, ss)))),
                    1e-16f),
        wd));
    return make_float2(g, h);
  }
  if (MODE == XRT_K4_SQUAREDLOG) {
    const float p = xrt_max_nan(md, -0.9999989867210388f);  // f32(-1 + 1e-6)
    const float d = xrt_ftz(__fsub_rn(xrt_log1p_f32(p), xrt_log1p_f32(yd)));
    const float p1 = __fadd_rn(p, 1.0f);
    const float g = xrt_ftz(__fmul_rn(xrt_ftz(__fdiv_rn(d, p1)), wd));
    const float h = xrt_ftz(__fmul_rn(
        xrt_max_nan(xrt_ftz(__fdiv_rn(xrt_ftz(__fsub_rn(1.0f, d)),
                                      xrt_ftz(__fmul_rn(p1, p1)))),
                    1e-6f),
        wd));
    return make_float2(g, h);
  }
  if (MODE == XRT_K4_AFT_NORMAL || MODE == XRT_K4_AFT_LOGISTIC) {
    return xrt_aft_gh<MODE == XRT_K4_AFT_LOGISTIC>(md, xrt_ftz(lo),
                                                   xrt_ftz(hi), wd, a);
  }
  // the log-link objectives: the margin clipped to [-30, 30]
  const float mc = xrt_min_nan(xrt_max_nan(md, -30.0f), 30.0f);
  if (MODE == XRT_K4_POISSON) {
    const float mu = xrt_ftz(xrt_exp_f32(mc));
    return make_float2(xrt_ftz(__fmul_rn(xrt_ftz(__fsub_rn(mu, yd)), wd)),
                       xrt_ftz(__fmul_rn(xrt_max_nan(mu, 1e-16f), wd)));
  }
  if (MODE == XRT_K4_GAMMA) {
    const float e = xrt_ftz(xrt_exp_f32(-mc));
    const float ym = xrt_ftz(__fmul_rn(yd, e));
    return make_float2(
        xrt_ftz(__fmul_rn(xrt_ftz(__fmaf_rn(-yd, e, 1.0f)), wd)),
        xrt_ftz(__fmul_rn(xrt_max_nan(ym, 1e-6f), wd)));
  }
  // XRT_K4_TWEEDIE: a = y e^{(1-rho) m} once for g and h, unfused (the
  // reference's round); h factored where its two coefficients are equal
  const float e1 = xrt_ftz(xrt_exp_f32(xrt_ftz(__fmul_rn(mc, a.c[C_TW_E1]))));
  const float b = xrt_ftz(xrt_exp_f32(xrt_ftz(__fmul_rn(mc, a.c[C_TW_E2]))));
  const float av = xrt_ftz(__fmul_rn(yd, e1));
  const float g = xrt_ftz(__fsub_rn(b, av));
  const float hs =
      a.c[C_TW_FACTORED] != 0.0f
          ? xrt_ftz(__fmul_rn(xrt_ftz(__fadd_rn(av, b)), a.c[C_TW_H1]))
          : xrt_ftz(__fmaf_rn(b, a.c[C_TW_H2],
                              xrt_ftz(__fmul_rn(av, a.c[C_TW_H1]))));
  return make_float2(xrt_ftz(__fmul_rn(g, wd)),
                     xrt_ftz(__fmul_rn(xrt_max_nan(hs, 1e-6f), wd)));
}

// aft-nloglik of one row (ops/survival.aft_nloglik_terms), raw operands.
__device__ __forceinline__ float xrt_aft_nll(float m, float lo, float hi,
                                             const XrtK4Args& a) {
  const float sigma = a.c[C_AFT_S];
  const bool logistic = a.c[C_AFT_LOGISTIC] != 0.0f;
  const float log_lo = logf(xrt_max_nan(lo, 1e-12f));
  const float z_lo = (log_lo - m) / sigma;
  const bool fin = isfinite(hi);
  const bool unc = fin && fabsf(hi - lo) < 1e-10f;
  if (unc) {
    const float logpdf =
        logistic ? -(xrt_softplus(z_lo) + xrt_softplus(-z_lo))
                 : -0.5f * z_lo * z_lo - 0.91893853320467274f;
    return -(logpdf - a.c[C_AFT_LOG_SIGMA] - log_lo);
  }
  const float z_hi = (logf(xrt_max_nan(fin ? hi : 1.0f, 1e-12f)) - m) / sigma;
  float cdf_lo, cdf_hi;
  if (logistic) {
    cdf_lo = 1.0f / (1.0f + expf(-z_lo));
    cdf_hi = fin ? 1.0f / (1.0f + expf(-z_hi)) : 1.0f;
  } else {
    cdf_lo = 0.5f * (1.0f + erff(z_lo * 0.70710678118654752f));
    cdf_hi = fin ? 0.5f * (1.0f + erff(z_hi * 0.70710678118654752f)) : 1.0f;
  }
  return -logf(xrt_max_nan(cdf_hi - cdf_lo, 1e-12f));
}

// The terms of the partial sums past the first four that the mask names
// (ops/metrics.metric_partials), on raw margin m (output 0's), label y,
// weight w and bounds.
__device__ __forceinline__ void xrt_metrics_ext(float m, float y, float w,
                                                float lo, float hi,
                                                const XrtK4Args& a,
                                                float (&acc)[kParts]) {
  const int mask = a.metrics;
  const float d = m - y;
  if (mask & (1 << P_ABSERR)) acc[P_ABSERR] += w * fabsf(d);
  if (mask & (1 << P_SQLOGERR)) {
    const float ls = xrt_log1p_f32(xrt_max_nan(m, -0.9999989867210388f)) -
                     xrt_log1p_f32(y);
    acc[P_SQLOGERR] += w * ls * ls;
  }
  if (mask & (1 << P_PHE)) {
    const float s = a.c[C_HUBER_SLOPE];
    const float q = d / s;
    acc[P_PHE] += w * (s * s * (sqrtf(1.0f + q * q) - 1.0f));
  }
  if (mask & (1 << P_APE))
    acc[P_APE] += w * fabsf(d / xrt_max_nan(fabsf(y), 1e-10f));
  if (mask & (1 << P_POISSON)) {
    const float mc = xrt_min_nan(xrt_max_nan(m, -30.0f), 30.0f);
    acc[P_POISSON] += w * (expf(mc) - y * mc + lgammaf(y + 1.0f));
  }
  if (mask & (1 << P_ERROR_T)) {
    const bool up = xrt_sigmoid(m) > a.c[C_THRESHOLD];
    acc[P_ERROR_T] += w * (up != (y > 0.5f) ? 1.0f : 0.0f);
  }
  constexpr int kMoreT =
      (1 << P_ERROR_T2) | (1 << P_ERROR_T3) | (1 << P_ERROR_T4);
  if (mask & kMoreT) {
    const float p = xrt_sigmoid(m);
    const bool pos = y > 0.5f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (mask & (1 << (P_ERROR_T2 + j))) {
        const bool up = p > a.c[C_THRESHOLD2 + j];
        acc[P_ERROR_T2 + j] += w * (up != pos ? 1.0f : 0.0f);
      }
    }
  }
  if (mask & (1 << P_AFT)) acc[P_AFT] += w * xrt_aft_nll(m, lo, hi, a);
  if ((mask & (1 << P_PINBALL)) && !a.multi) {
    const float al = a.c[C_ALPHA0];
    const float dd = y - m;
    acc[P_PINBALL] += w * xrt_max_nan(al * dd, (al - 1.0f) * dd);
  }
}

// One row: its metric terms added to the thread's sums (raw margin, label
// and weight, as ops/metrics.metric_partials takes them) and, in gh mode,
// its (g, h) from the operands read as the reference reads them.
template <int MODE, bool EXT>
__device__ __forceinline__ float2 xrt_row(float m, float y, float w, float lo,
                                          float hi, const XrtK4Args& a,
                                          float (&acc)[kParts]) {
  const bool pos = y > 0.5f;
  // logloss: softplus(-m) for y = 1, softplus(m) for y = 0
  const float z = pos ? -m : m;
  const float e = __expf(-fabsf(z));
  const float u = __fadd_rn(1.0f, e);
  const float l1p =
      u == 1.0f ? e : __fmul_rn(__logf(u), __fdividef(e, __fsub_rn(u, 1.0f)));
  acc[P_LOGLOSS] =
      __fadd_rn(acc[P_LOGLOSS], __fmul_rn(w, __fadd_rn(fmaxf(z, 0.0f), l1p)));
  // error: sigmoid(m) > 0.5 against label > 0.5
  const bool up = m >= kHalfMargin;
  acc[P_ERROR] = __fadd_rn(acc[P_ERROR], __fmul_rn(w, up != pos ? 1.0f : 0.0f));
  const float d = __fsub_rn(m, y);
  acc[P_SQERR] = __fadd_rn(acc[P_SQERR], __fmul_rn(__fmul_rn(w, d), d));
  acc[P_WEIGHT] = __fadd_rn(acc[P_WEIGHT], w);
  if (EXT && a.metrics) xrt_metrics_ext(m, y, w, lo, hi, a, acc);
  if (MODE == XRT_K4_EVAL) return make_float2(0.0f, 0.0f);
  return xrt_gh<MODE>(m, y, w, lo, hi, a);
}

// A thread's four rows of one tile: margin, row_value, label, weight and
// the bounds (where the launch has them).
struct XrtRows {
  float4 m, r, y, w, lo, hi;
};

__device__ __forceinline__ float xrt_lane(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

__device__ __forceinline__ void xrt_set(float4& v, int j, float x) {
  if (j == 0) v.x = x;
  else if (j == 1) v.y = x;
  else if (j == 2) v.z = x;
  else v.w = x;
}

// The rows 4q .. 4q + 3 (q: the thread's vector), by one 16-byte load of
// each input where all four rows exist and the pointers are aligned (VEC),
// else row by row; rows past n read as 0. The margins are written by this
// kernel, so only the other inputs take the read-only path. With T > 1
// trees (the scalar instantiation only) r.m is the margin with the T row
// values added in turn, r.r unused.
template <bool VEC, bool EXT>
__device__ __forceinline__ void xrt_load(const XrtK4Args& a, long long q,
                                         XrtRows& r) {
  const bool bounds = EXT && a.lower != nullptr;
  if (VEC && 4 * q + 3 < a.n) {
    r.m = reinterpret_cast<const float4*>(a.margin)[q];
    r.r = __ldg(reinterpret_cast<const float4*>(a.row_value) + q);
    r.y = __ldg(reinterpret_cast<const float4*>(a.label) + q);
    r.w = __ldg(reinterpret_cast<const float4*>(a.weight) + q);
    if (bounds) {
      r.lo = __ldg(reinterpret_cast<const float4*>(a.lower) + q);
      r.hi = __ldg(reinterpret_cast<const float4*>(a.upper) + q);
    }
    return;
  }
  r.m = r.r = r.y = r.w = make_float4(0.f, 0.f, 0.f, 0.f);
  if (EXT) r.lo = r.hi = r.m;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long row = 4 * q + j;
    if (row < a.n) {
      if (!VEC && a.n_trees > 1) {
        float m = a.margin[row];
        for (int t = 0; t < a.n_trees; ++t)
          m = __fmaf_rn(__ldg(a.row_value + (long long)t * a.n + row),
                        a.inv_trees, m);
        xrt_set(r.m, j, m);
      } else {
        xrt_set(r.m, j, a.margin[row]);
        xrt_set(r.r, j, __ldg(a.row_value + row));
      }
      xrt_set(r.y, j, __ldg(a.label + row));
      xrt_set(r.w, j, __ldg(a.weight + row));
      if (bounds) {
        xrt_set(r.lo, j, __ldg(a.lower + row));
        xrt_set(r.hi, j, __ldg(a.upper + row));
      }
    }
  }
}

// The thread's rows of a tile: margins updated and stored, sums, gradients.
// A warp whose 32 vectors are all whole writes its (g, h) pairs through
// `stage` (its 64 float4 of shared memory): two store instructions of 512
// contiguous bytes, where each thread's own 32 bytes would take two
// instructions that each cover half of 32 sectors.
template <int MODE, bool VEC, bool EXT>
__device__ __forceinline__ void xrt_rows(const XrtK4Args& a, long long q,
                                         const XrtRows& r,
                                         float (&acc)[kParts],
                                         float4* stage) {
  float4 mo = make_float4(0.f, 0.f, 0.f, 0.f), g01 = mo, g23 = mo;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long row = 4 * q + j;
    if (row < a.n) {
      const float m = !VEC && a.n_trees > 1
                          ? xrt_lane(r.m, j)
                          : __fadd_rn(xrt_lane(r.m, j), xrt_lane(r.r, j));
      xrt_set(mo, j, m);
      const float2 gh = xrt_row<MODE, EXT>(
          m, xrt_lane(r.y, j), xrt_lane(r.w, j),
          EXT ? xrt_lane(r.lo, j) : 0.0f, EXT ? xrt_lane(r.hi, j) : 0.0f, a,
          acc);
      float4& out = j < 2 ? g01 : g23;
      xrt_set(out, 2 * (j & 1), gh.x);
      xrt_set(out, 2 * (j & 1) + 1, gh.y);
    }
  }
  if (VEC && 4 * q + 3 < a.n) {
    reinterpret_cast<float4*>(a.margin)[q] = mo;
    if (MODE == XRT_K4_EVAL) return;
    float4* gh = reinterpret_cast<float4*>(a.gh);
    if (__activemask() == 0xffffffffu) {
      const int l = threadIdx.x & 31;
      stage[2 * l] = g01;
      stage[2 * l + 1] = g23;
      __syncwarp();
      gh += 2 * (q - l);  // the warp's first vector's pairs
      gh[l] = stage[l];
      gh[32 + l] = stage[32 + l];
      __syncwarp();
    } else {
      gh[2 * q] = g01;
      gh[2 * q + 1] = g23;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long row = 4 * q + j;
    if (row < a.n) {
      a.margin[row] = xrt_lane(mo, j);
      if (MODE != XRT_K4_EVAL) {
        const float4& out = j < 2 ? g01 : g23;
        a.gh[2 * row] = xrt_lane(out, 2 * (j & 1));
        a.gh[2 * row + 1] = xrt_lane(out, 2 * (j & 1) + 1);
      }
    }
  }
}

// The last CTA: the grid's partials added in f64, a run of CTAs a thread
// in CTA order, then an order-preserving pairwise tree over the threads.
__device__ __forceinline__ void xrt_final(const XrtK4Args& a) {
  __shared__ double ws[kParts][kThreads / 32];
  const int per = (gridDim.x + kThreads - 1) / kThreads;
  const int c0 = threadIdx.x * per;
  const int c1 = min((int)gridDim.x, c0 + per);
  double s[kParts];
#pragma unroll
  for (int k = 0; k < kParts; ++k) s[k] = 0.0;
  for (int c = c0; c < c1; ++c) {
#pragma unroll
    for (int k = 0; k < kParts; ++k)
      s[k] = __dadd_rn(s[k], (double)__ldcg(a.part + (long long)c * kParts + k));
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < kParts; ++k) {
      const double v = __shfl_down_sync(0xffffffffu, s[k], o);
      if ((threadIdx.x & (2 * o - 1)) == 0) s[k] = __dadd_rn(s[k], v);
    }
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kParts; ++k) ws[k][wid] = s[k];
  }
  __syncthreads();
  if (threadIdx.x < kParts) {
    double t = ws[threadIdx.x][0];
    for (int i = 1; i < kThreads / 32; ++i)
      t = __dadd_rn(t, ws[threadIdx.x][i]);
    a.out[threadIdx.x] = t;
  }
}

// atomicInc with acquire-release semantics at device scope: it makes the
// thread's partials visible before its ticket, and the last CTA's reads
// of the others' after it, without a separate fence on either side.
__device__ __forceinline__ unsigned xrt_ticket(unsigned* p, unsigned wrap) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(wrap)
               : "memory");
  return old;
}

// The CTA's partials (an xor tree in each warp, then the warps in order)
// into a.part, its ticket, and the grid's sums if it is the last CTA.
// Without EXT only the first four sums are live; the others are written
// as zeros.
template <bool EXT>
__device__ __forceinline__ void xrt_epilogue(const XrtK4Args& a,
                                             float (&acc)[kParts]) {
  constexpr int kLive = EXT ? kParts : 4;
  __shared__ float wsum[kParts][kThreads / 32];
  __shared__ bool last;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < kLive; ++k)
      acc[k] = __fadd_rn(acc[k], __shfl_xor_sync(0xffffffffu, acc[k], o));
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kLive; ++k) wsum[k][wid] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < kParts) {
    float t = 0.0f;
    if (threadIdx.x < kLive) {
      t = wsum[threadIdx.x][0];
      for (int i = 1; i < kThreads / 32; ++i)
        t = __fadd_rn(t, wsum[threadIdx.x][i]);
    }
    a.part[(long long)blockIdx.x * kParts + threadIdx.x] = t;
    __threadfence();  // the partial before thread 0's ticket
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // wraps to 0 at gridDim.x - 1: the last CTA resets the ticket
    last = xrt_ticket(a.ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) xrt_final(a);
}

template <int MODE, bool VEC, bool EXT>
__global__ void __launch_bounds__(kThreads, EXT ? 1 : kCtasPerSm)
    xrt_k4_kernel(const XrtK4Args a) {
  __shared__ float4 stage[MODE == XRT_K4_EVAL ? 1 : 2 * kThreads];
  float4* mine = MODE == XRT_K4_EVAL ? stage : stage + 2 * (threadIdx.x & ~31);
  const long long tiles = (a.n + kTileRows - 1) / kTileRows;
  float acc[kParts];
#pragma unroll
  for (int k = 0; k < kParts; ++k) acc[k] = 0.f;
  long long tile = blockIdx.x;
  XrtRows cur, nxt;
  if (tile < tiles) xrt_load<VEC, EXT>(a, tile * kThreads + threadIdx.x, cur);
  for (; tile < tiles; tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < tiles)
      xrt_load<VEC, EXT>(a, next * kThreads + threadIdx.x, nxt);
    xrt_rows<MODE, VEC, EXT>(a, tile * kThreads + threadIdx.x, cur, acc,
                             mine);
    cur = nxt;
  }
  xrt_epilogue<EXT>(a, acc);
}

// K4's K-output kernel (reg:quantileerror): row r's K margins at
// margin[r * K + k], its K row values at row_value[k * n + r] (with T
// parallel trees an output, n_trees > 1: output k's T values at
// row_value[(k T + t) n + r], added in order as the one-output T-tree
// add adds them), its (g, h)
// for output k at gh[2 (k * n + r)]: g = (1{m_k >= y} - alpha_k) w, h = w
// (ops/objectives.quantile_grad_hess), the pinball loss's mean over K
// besides the row metrics of output 0. The same plan and reduction as
// the one-output kernel; rows one at a time.
template <bool GH>
__global__ void __launch_bounds__(kThreads, 1)
    xrt_k4_multi_kernel(const XrtK4Args a) {
  __shared__ float alpha[kMaxOutputs];
  if (threadIdx.x < a.k) alpha[threadIdx.x] = a.alpha[threadIdx.x];
  __syncthreads();
  const long long tiles = (a.n + kTileRows - 1) / kTileRows;
  const int K = a.k;
  float acc[kParts];
#pragma unroll
  for (int k = 0; k < kParts; ++k) acc[k] = 0.f;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long q = tile * kThreads + threadIdx.x;
    for (int j = 0; j < 4; ++j) {
      const long long row = 4 * q + j;
      if (row >= a.n) break;
      const float y = __ldg(a.label + row), w = __ldg(a.weight + row);
      const float yd = xrt_ftz(y), wd = xrt_ftz(w);
      float m0 = 0.0f, pin = 0.0f;
      for (int k = 0; k < K; ++k) {
        const long long o = row * K + k;
        float m = a.margin[o];
        if (a.n_trees == 1) {
          m = __fadd_rn(m, __ldg(a.row_value + (long long)k * a.n + row));
        } else {  // output k's T trees in order: fma(v, 1 / T, m)
          const float* v = a.row_value + (long long)k * a.n_trees * a.n + row;
          for (int t = 0; t < a.n_trees; ++t)
            m = __fmaf_rn(__ldg(v + (long long)t * a.n), a.inv_trees, m);
        }
        a.margin[o] = m;
        if (k == 0) m0 = m;
        const float al = alpha[k];
        const float dd = __fsub_rn(y, m);
        pin = __fadd_rn(pin, xrt_max_nan(__fmul_rn(al, dd),
                                         __fmul_rn(__fsub_rn(al, 1.0f), dd)));
        if (GH) {
          const float ge = xrt_ftz(m) >= yd ? 1.0f : 0.0f;
          const long long p = 2 * ((long long)k * a.n + row);
          a.gh[p] = xrt_ftz(__fmul_rn(xrt_ftz(__fsub_rn(ge, al)), wd));
          a.gh[p + 1] = w;
        }
      }
      xrt_row<XRT_K4_EVAL, true>(m0, y, w, 0.0f, 0.0f, a, acc);
      if (a.metrics & (1 << P_PINBALL))
        acc[P_PINBALL] = __fadd_rn(acc[P_PINBALL],
                                   __fmul_rn(w, __fdiv_rn(pin, (float)K)));
    }
  }
  xrt_epilogue<true>(a, acc);
}

typedef void (*XrtK4Kernel)(const XrtK4Args);

template <bool VEC, bool EXT>
static XrtK4Kernel k4_kernel(int mode) {
  switch (mode) {
    case XRT_K4_EVAL: return xrt_k4_kernel<XRT_K4_EVAL, VEC, EXT>;
    case XRT_K4_LOGISTIC: return xrt_k4_kernel<XRT_K4_LOGISTIC, VEC, EXT>;
    case XRT_K4_SQUARED: return xrt_k4_kernel<XRT_K4_SQUARED, VEC, EXT>;
    case XRT_K4_ABSOLUTE: return xrt_k4_kernel<XRT_K4_ABSOLUTE, VEC, EXT>;
    case XRT_K4_PSEUDOHUBER:
      return xrt_k4_kernel<XRT_K4_PSEUDOHUBER, VEC, EXT>;
    case XRT_K4_SQUAREDLOG: return xrt_k4_kernel<XRT_K4_SQUAREDLOG, VEC, EXT>;
    case XRT_K4_POISSON: return xrt_k4_kernel<XRT_K4_POISSON, VEC, EXT>;
    case XRT_K4_GAMMA: return xrt_k4_kernel<XRT_K4_GAMMA, VEC, EXT>;
    case XRT_K4_TWEEDIE: return xrt_k4_kernel<XRT_K4_TWEEDIE, VEC, EXT>;
    case XRT_K4_HINGE: return xrt_k4_kernel<XRT_K4_HINGE, VEC, EXT>;
    // the AFT modes read the bounds: only their EXT instantiation exists
    case XRT_K4_AFT_NORMAL: return xrt_k4_kernel<XRT_K4_AFT_NORMAL, VEC, true>;
    case XRT_K4_AFT_LOGISTIC:
      return xrt_k4_kernel<XRT_K4_AFT_LOGISTIC, VEC, true>;
    default: return nullptr;
  }
}

static bool aligned16(const void* p) {
  return p == nullptr || ((uintptr_t)p & 15) == 0;
}

// One launch of K4 over a->n rows on `stream`: a->grid CTAs (a->part
// holds that many partial rows), the sums into a->out. The one-output
// kernel takes the vector path where every row pointer is 16-byte
// aligned, else the scalar path; multi = 1 takes the K-output kernel.
extern "C" int xrt_k4(const XrtK4Args* a, void* stream) {
  const bool aft = a->mode == XRT_K4_AFT_NORMAL ||
                   a->mode == XRT_K4_AFT_LOGISTIC ||
                   (a->metrics & (1 << P_AFT));
  if (a->n < 0 || a->grid < 1 || a->mode < XRT_K4_EVAL ||
      a->mode > XRT_K4_QUANTILE || a->part == nullptr ||
      a->ticket == nullptr || a->out == nullptr ||
      (a->mode != XRT_K4_EVAL && a->n > 0 && a->gh == nullptr) ||
      (aft && a->n > 0 && (a->lower == nullptr || a->upper == nullptr)) ||
      ((a->lower == nullptr) != (a->upper == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (a->multi) {
    if ((a->mode != XRT_K4_EVAL && a->mode != XRT_K4_QUANTILE) || a->k < 1 ||
        a->k > kMaxOutputs || a->alpha == nullptr || a->n_trees < 1)
      return (int)cudaErrorInvalidValue;
    if (a->mode == XRT_K4_EVAL)
      xrt_k4_multi_kernel<false><<<(unsigned)a->grid, kThreads, 0, s>>>(*a);
    else
      xrt_k4_multi_kernel<true><<<(unsigned)a->grid, kThreads, 0, s>>>(*a);
    return (int)cudaGetLastError();
  }
  if (a->mode == XRT_K4_QUANTILE || a->n_trees < 1)
    return (int)cudaErrorInvalidValue;
  const bool ext = a->metrics != 0 || a->lower != nullptr;
  if (a->n_trees > 1) {  // T parallel trees: the scalar instantiation
    const XrtK4Kernel kernel = ext ? k4_kernel<false, true>(a->mode)
                                   : k4_kernel<false, false>(a->mode);
    kernel<<<(unsigned)a->grid, kThreads, 0, s>>>(*a);
    return (int)cudaGetLastError();
  }
  const bool vec = aligned16(a->margin) && aligned16(a->row_value) &&
                   aligned16(a->label) && aligned16(a->weight) &&
                   aligned16(a->lower) && aligned16(a->upper) &&
                   (a->mode == XRT_K4_EVAL || aligned16(a->gh));
  // EXT: the sums past the first four, or the bounds (aft-nloglik, AFT)
  const XrtK4Kernel kernel =
      vec ? (ext ? k4_kernel<true, true>(a->mode)
                 : k4_kernel<true, false>(a->mode))
          : (ext ? k4_kernel<false, true>(a->mode)
                 : k4_kernel<false, false>(a->mode));
  kernel<<<(unsigned)a->grid, kThreads, 0, s>>>(*a);
  return (int)cudaGetLastError();
}
