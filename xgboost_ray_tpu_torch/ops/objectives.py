"""Objectives of the port and K4, the fused per-round elementwise pass.

Port of ``xgboost_ray_tpu/ops/objectives.py``: every objective whose
gradients are a function of a row alone — ``binary:logistic`` and its
aliases ``reg:logistic`` / ``binary:logitraw`` (``_make_logistic``,
``:88``), ``reg:squarederror`` / ``reg:linear`` (``:57``),
``reg:absoluteerror`` (``:72``), ``reg:pseudohubererror`` (``:262``),
``reg:squaredlogerror`` (``:242``), ``count:poisson`` (``:162``),
``reg:gamma`` (``:180``), ``reg:tweedie`` (``:198``), ``binary:hinge``
(``:218``), ``reg:quantileerror`` with K alphas and K outputs (``:131``)
and ``survival:aft`` (its plain gradients and metric in ``ops/survival.py``)
— with the base_score -> margin maps, the
prediction transforms and ``get_objective`` (``:485``). Ranking and
``survival:cox`` are in the table too (their gradients are B13's,
``ops/ranking.py``, and B14's, ``ops/cox.py``; K4 runs for them in its
eval mode only: the margin add and the elementwise metric sums).

K4 (CUDA C++, ``csrc/objective.cu``) fuses the end of boosting round i
with the start of round i+1 in one pass over the rows: ``margin +=
row_value`` (the new tree's leaf value per row), the metric partial sums on
the new margin (``PARTIALS``: the first four always, the others where the
caller names their metrics, ``ops/metrics.py``), and the next round's (g,
h) of the objective (``K4_MODES``: one instantiation of the kernel's
row functor each). Round 0 runs it with ``row_value = 0``. Its eval mode
(``with_gh=False``) serves a held-out eval set: the same margin add and
partials over that set's rows (its ``row_value`` from B4,
``ops/grow.predict_tree_binned``), no (g, h) written. ``survival:aft``
reads the rows' label bounds besides (the AFT pass: K4's two AFT modes);
``reg:quantileerror`` takes K4's K-output kernel (``round_update_multi``:
[N, K] margins, [K, N, 2] gradient planes, the pinball sum over K). What
bounds it: bytes — margin, row_value, label and weight read and the
margin written per row, plus the (g, h) pair (28 B a row; 36 B with the
two bounds); ``k4_plan`` sizes its persistent grid from the row count and
the SMs, and one launch gives the partial sums in f64 (the last CTA adds
the CTAs' f32 partials). The port has no Triton kernel.

Bitwise parity. XLA's CPU program is not the formula as written: its
algebraic simplifier folds constants (``x / c`` becomes ``x * (1 / c)``,
``0.5 a + 0.5 b`` becomes ``(a + b) 0.5`` where the two constants are
equal, products of constants merge), LLVM contracts every ``a * b + c`` it
can into a fused multiply-add (``_fma``), operands are read with DAZ and
results flushed to zero (``_ftz``), and the transcendentals are XLA's own
polynomials: ``exp_f32`` (Cephes), ``log_f32`` (Cephes' log, its last
product folded into an FMA), ``log1p_f32`` (a rational approximation below
sqrt(2) - 1, ``log(1 + x)`` above) and ``erf_f32`` (a rational
approximation on [-3.744, 3.744]); its sqrt is correctly rounded, where
torch's CPU sqrt is not (``sqrt_rn``). The plain gradients below follow
the compiled program step by step, each fused multiply-add where LLVM
fuses it (read off the JAX package's optimized HLO and its LLVM IR, and
held by the tests), so on the CPU they equal the JAX package's bit for
bit, and the kernel's (``__fmaf_rn`` exactly where ``_fma`` stands,
``--fmad=false`` elsewhere) equal the plain version's.

Quantized gradients (``gh_precision``, B10: ``quantize_gh``, kernel in
``csrc/quant.cu``): each tree's (g, h) rounded stochastically onto an int8
/ int16 grid at the source, the reference's ``quantize_gh`` bit for bit.

``multi:softprob`` / ``multi:softmax`` with K = ``num_class`` outputs
(``_make_softmax``, ``:107-128``): ``p = softmax(m)``, ``g = (p -
onehot(y)) w``, ``h = max(2 p (1 - p), 1e-16) w``, a zero base margin, the
probabilities or the first argmax as the prediction. Their pass over the
rows is the softmax pass (CUDA C++, ``csrc/softmax.cu``; ``softmax_plan``
picks its path), K4's counterpart for K outputs,
in three modes: training (``softmax_update``: the K trees' row values
added to the [N, K] margins, the ``mlogloss``/``merror``/weight partials,
the next round's gradients as [K, N, 2] planes, class k's [N, 2]
contiguous for K1-K3), eval (the same without gradients) and transform
(``softmax_transform``: probabilities or classes from margins, for predict
and serve). The plain versions follow the reference's compiled CPU
program bit for bit: the max over classes in class order, the sum as XLA's
CPU reduce takes it (in class order up to 32 classes, a window-32 tree
above: ``ops/split.tree_sum``), the Cephes exp (``exp_f32``), a subnormal
result flushed to zero as XLA's CPU flushes it, labels cast to int32 as
XLA casts them (truncated, saturated, NaN to 0).
"""

import ctypes
import dataclasses
import functools
import struct
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from xgboost_ray_tpu_torch.ops import _build
from xgboost_ray_tpu_torch.ops.split import tree_sum

LOGISTIC = "binary:logistic"
SQUARED = "reg:squarederror"
SOFTPROB = "multi:softprob"
SOFTMAX = "multi:softmax"
QUANTILE = "reg:quantileerror"
AFT = "survival:aft"
COX = "survival:cox"

#: metric partial sums written by K4, in this order: the first four always,
#: the others where a metric needs them (``ops/metrics.K4_METRIC_SLOT``)
PARTIALS = ("logloss", "error", "sqerr", "weight", "abserr", "sqlogerr",
            "phe", "ape", "poisson", "error_t", "aft", "pinball",
            "error_t2", "error_t3", "error_t4")
#: metric partial sums written by the softmax pass, in this order (the last
#: only where the run's metrics name ``logloss``: column 0's binary logloss,
#: as the reference's metric reads a softmax model's margins)
SOFTMAX_PARTIALS = ("mlogloss", "merror", "weight", "logloss")

#: objective -> (K4 mode, default metric, transform, output kind). The
#: transforms: ``sigmoid``, ``identity``, ``exp`` (log-link objectives and
#: AFT), ``hinge`` (m > 0 as 0/1), ``softmax``
_TABLE = {
    LOGISTIC: ("logistic", "logloss", "sigmoid", "prob"),
    "reg:logistic": ("logistic", "logloss", "sigmoid", "prob"),
    "binary:logitraw": ("logistic", "logloss", "identity", "value"),
    SQUARED: ("squared", "rmse", "identity", "value"),
    "reg:linear": ("squared", "rmse", "identity", "value"),
    "reg:absoluteerror": ("absolute", "mae", "identity", "value"),
    "reg:pseudohubererror": ("pseudohuber", "mphe", "identity", "value"),
    "reg:squaredlogerror": ("squaredlog", "rmsle", "identity", "value"),
    "count:poisson": ("poisson", "poisson-nloglik", "exp", "value"),
    "reg:gamma": ("gamma", "rmse", "exp", "value"),
    "reg:tweedie": ("tweedie", "rmse", "exp", "value"),
    "binary:hinge": ("hinge", "error", "hinge", "class"),
    QUANTILE: ("quantile", "quantile", "identity", "value"),
    AFT: ("aft", "aft-nloglik", "exp", "value"),
    SOFTPROB: ("softmax", "mlogloss", "softmax", "prob"),
    SOFTMAX: ("softmax", "merror", "softmax", "class"),
    # the gradients need the query groups (B13, ops/ranking.py)
    "rank:pairwise": ("rank", "ndcg", "identity", "value"),
    "rank:ndcg": ("rank", "ndcg", "identity", "value"),
    "rank:map": ("rank", "map", "identity", "value"),
    # the gradients need every row of the world (B14, ops/cox.py)
    COX: ("cox", "cox-nloglik", "exp", "value"),
}

#: the objectives the port trains
OBJECTIVES = tuple(_TABLE)


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def _f32_mul(a: float, b: float) -> float:
    """The float32 product of two float32 constants (XLA's constant
    folding)."""
    return float(np.float32(a) * np.float32(b))


def _f32_div(a: float, b: float) -> float:
    return float(np.float32(a) / np.float32(b))


#: K4's folded constants of one objective (``XrtK4Args.c``), in this order
K4_CONSTS = (
    "huber_recip", "huber_slope", "tw_e1", "tw_e2", "tw_h1", "tw_h2",
    "tw_factored", "aft_r", "aft_rc", "aft_hr", "aft_s", "aft_s2", "aft_hu",
    "aft_log_sigma", "threshold", "aft_logistic", "alpha0", "spw",
    "threshold2", "threshold3", "threshold4")


class ObjConsts(NamedTuple):
    """The constants an objective's compiled reference program uses, each
    as float32 the way XLA's simplifier folds it, shared by the plain
    version and the kernel's arguments."""

    huber_recip: float = 1.0   # 1 / slope (x / c -> x * (1 / c))
    huber_slope: float = 1.0
    tw_e1: float = -0.5        # 1 - rho
    tw_e2: float = 0.5         # 2 - rho
    tw_h1: float = 0.5         # -(1 - rho)
    tw_h2: float = 0.5         # 2 - rho
    tw_factored: float = 1.0   # 1 where tw_h1 == tw_h2: (a + b) * c
    aft_r: float = 1.0         # 1 / sigma
    aft_rc: float = 0.70710677  # (1 / sigma) (1 / sqrt 2)
    aft_hr: float = -0.5       # -0.5 / sigma
    aft_s: float = 1.0         # sigma
    aft_s2: float = 1.0        # sigma * sigma
    aft_hu: float = 1.0        # 1 / (sigma * sigma)
    aft_log_sigma: float = 0.0
    threshold: float = 0.5     # error@t
    aft_logistic: float = 0.0  # 1: the logistic distribution
    alpha0: float = 0.5        # the quantile metric's alpha, one output
    spw: float = 1.0           # scale_pos_weight
    threshold2: float = 0.5    # error@t's second, third and fourth
    threshold3: float = 0.5    # thresholds of a run
    threshold4: float = 0.5


def objective_consts(huber_slope: float = 1.0, rho: float = 1.5,
                     sigma: float = 1.0, aft_distribution: str = "normal",
                     threshold: float = 0.5, alpha0: float = 0.5,
                     scale_pos_weight: float = 1.0) -> ObjConsts:
    slope = _f32(huber_slope)
    h1, h2 = _f32(-(1.0 - rho)), _f32(2.0 - rho)
    r = _f32_div(1.0, sigma)
    s2 = _f32(sigma * sigma)
    return ObjConsts(
        huber_recip=1.0 if slope == 1.0 else _f32_div(1.0, slope),
        huber_slope=slope, tw_e1=_f32(1.0 - rho), tw_e2=_f32(2.0 - rho),
        tw_h1=h1, tw_h2=h2, tw_factored=float(h1 == h2), aft_r=r,
        aft_rc=_f32_mul(r, _f32(1.0 / np.sqrt(2.0))),
        aft_hr=_f32_mul(-0.5, r), aft_s=_f32(sigma), aft_s2=s2,
        aft_hu=_f32_div(1.0, s2),
        aft_log_sigma=float(log_f32(torch.tensor(sigma, dtype=torch.float32))),
        threshold=_f32(threshold),
        aft_logistic=float(aft_distribution == "logistic"),
        alpha0=_f32(alpha0), spw=_f32(scale_pos_weight))


def as_alphas(quantile_alpha) -> Tuple[float, ...]:
    if isinstance(quantile_alpha, (list, tuple, np.ndarray)):
        return tuple(float(a) for a in quantile_alpha)
    return (float(quantile_alpha),)


@dataclasses.dataclass(frozen=True)
class Objective:
    name: str
    default_metric: str
    default_base_score: float = 0.5
    #: outputs per row: 1, num_class for the softmax objectives, the number
    #: of alphas for reg:quantileerror
    num_outputs: int = 1
    #: K4's row functor (``K4_MODES``), ``softmax`` for the softmax pass
    kind: str = "squared"
    #: ``sigmoid`` | ``identity`` | ``exp`` | ``hinge`` | ``softmax``
    transform_kind: str = "identity"
    #: ``value`` | ``prob`` | ``class``: what the transform returns
    output_kind: str = "value"
    consts: ObjConsts = ObjConsts()
    #: reg:quantileerror's alphas (one per output)
    alphas: Tuple[float, ...] = ()
    aft_distribution: str = "normal"
    aft_sigma: float = 1.0

    @property
    def logistic(self) -> bool:
        return self.kind == "logistic"

    @property
    def softmax(self) -> bool:
        return self.kind == "softmax"

    @property
    def survival(self) -> bool:
        """The gradients read the label bounds (``survival:aft``)."""
        return self.kind == "aft"

    @property
    def ranking(self) -> bool:
        """The gradients need the query groups (``rank:*``: B13)."""
        return self.kind == "rank"

    @property
    def cox(self) -> bool:
        """The gradients need every row of the world (``survival:cox``:
        B14)."""
        return self.kind == "cox"

    @property
    def k4_mode(self) -> str:
        """The K4 mode of its gradients (``K4_MODES``; K4 computes no
        gradients of ranking or Cox: its eval mode)."""
        if self.kind in ("rank", "cox"):
            return "eval"
        if self.kind == "aft":
            return ("aft_logistic" if self.aft_distribution == "logistic"
                    else "aft_normal")
        return self.kind

    @property
    def partials(self) -> Tuple[str, ...]:
        """The names of the metric partial sums its round pass writes."""
        return SOFTMAX_PARTIALS if self.softmax else PARTIALS

    def base_score_to_margin(self, s: float) -> float:
        if self.softmax:
            return 0.0
        if self.logistic:
            if not 0 < s < 1:
                return 0.0
            # float32 log of the python ratio, as the JAX package computes it
            return float(log_f32(torch.tensor(s / (1.0 - s),
                                              dtype=torch.float32)))
        if self.kind in ("poisson", "gamma", "tweedie"):
            # float(jnp.log(jnp.maximum(s, 1e-16))): a float32 log
            return float(log_f32(torch.tensor(max(s, 1e-16),
                                              dtype=torch.float32)))
        if self.kind in ("aft", "cox"):
            return float(np.log(max(s, 1e-16)))  # np.log in float64
        if self.kind == "rank":
            return 0.0
        return float(s)

    def transform(self, margin: torch.Tensor) -> torch.Tensor:
        """[N, K] margins -> predictions on the margins' device, bitwise the
        reference's ``transform`` on the CPU: [N] values (the sigmoid, the
        margin itself, ``exp`` of it, hinge's 0/1), [N, K] quantiles for
        K alphas, [N, K] probabilities (``multi:softprob``) or [N] classes
        (f32, ``multi:softmax``)."""
        if self.softmax:
            return softmax_transform_plain(margin, self.name == SOFTPROB)
        if self.num_outputs > 1:
            return margin
        return value_transform(margin[:, 0], self.transform_kind)


def value_transform(m: torch.Tensor, kind: str) -> torch.Tensor:
    """One output's transform (B8's value mode computes the same in its
    epilogue): ``sigmoid``, ``exp`` (the reference's exp, a subnormal
    result flushed: bitwise ``jnp.exp``, finite up to 88.72), ``hinge``
    (1.0 where m > 0, else 0.0) or ``identity``."""
    if kind == "sigmoid":
        return sigmoid(m)
    if kind == "exp":
        return _ftz(exp_f32(m))
    if kind == "hinge":
        return (_ftz(m) > 0).to(torch.float32)
    return m


#: the one-output transforms of B8's value mode, in ``value_fn`` order
#: (``XRT_FN_*`` of ``csrc/predict.cu``)
VALUE_FNS = ("sigmoid", "exp", "hinge")


def transform_kind(name: str) -> str:
    """The transform of objective ``name`` (``_TABLE``): raises for one the
    port does not predict values of."""
    if name not in _TABLE:
        raise NotImplementedError(
            f"objective={name!r}: xgboost_ray_tpu_torch has no transform "
            f"for it")
    return _TABLE[name][2]


def get_objective(name: str, num_class: int = 0, scale_pos_weight: float = 1.0,
                  tweedie_variance_power: float = 1.5,
                  aft_loss_distribution: str = "normal",
                  aft_loss_distribution_scale: float = 1.0,
                  huber_slope: float = 1.0, quantile_alpha=0.5) -> Objective:
    """The objective ``name`` with its parameters, as the JAX package's
    ``get_objective`` resolves it (and with its checks); the softmax
    objectives take ``num_class`` (>= 2) outputs, ``reg:quantileerror`` one
    output per alpha."""
    if name not in _TABLE:
        raise NotImplementedError(
            f"objective={name!r} is not supported by xgboost_ray_tpu_torch "
            f"(it trains {' | '.join(OBJECTIVES)}).")
    kind, metric, transform, output_kind = _TABLE[name]
    k = 1
    alphas: Tuple[float, ...] = ()
    if kind == "softmax":
        if num_class < 2:
            raise ValueError("multi:* objectives require num_class >= 2")
        k = int(num_class)
    if kind == "quantile":
        alphas = as_alphas(quantile_alpha)
        if not alphas or not all(0.0 < a < 1.0 for a in alphas):
            raise ValueError(
                f"quantile_alpha must be in (0, 1), got {alphas!r}")
        k = len(alphas)
    if kind == "aft" and aft_loss_distribution not in ("normal", "logistic"):
        raise ValueError(
            f"aft_loss_distribution must be one of ['logistic', 'normal'], "
            f"got {aft_loss_distribution!r}")
    consts = objective_consts(
        huber_slope=huber_slope, rho=tweedie_variance_power,
        sigma=aft_loss_distribution_scale,
        aft_distribution=aft_loss_distribution,
        scale_pos_weight=scale_pos_weight)
    return Objective(name, default_metric=metric, num_outputs=k, kind=kind,
                     transform_kind=transform, output_kind=output_kind,
                     consts=consts, alphas=alphas,
                     aft_distribution=aft_loss_distribution,
                     aft_sigma=float(aft_loss_distribution_scale))


def objective_from_params(params) -> Objective:
    """``get_objective`` of a ``TrainParams``."""
    return get_objective(
        params.objective, params.num_class, params.scale_pos_weight,
        params.tweedie_variance_power, params.aft_loss_distribution,
        params.aft_loss_distribution_scale, params.huber_slope,
        params.quantile_alpha)


def base_score_margin(name: str, base_score: float) -> float:
    """The margin a model starts from (``Objective.base_score_to_margin``;
    ranking: 0; ``survival:cox``: a float64 log)."""
    return get_objective(name, num_class=2).base_score_to_margin(base_score)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add: the product of two float32 values is exact
    in float64, so a*b + c rounds once there and once to float32."""
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a.double() * b + c).to(torch.float32)


_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
          1.6666665459e-1, 5.0000001201e-1)


def exp_f32(v: torch.Tensor) -> torch.Tensor:
    """float32 exp as the JAX package's compiled CPU program evaluates it:
    the operand clamped to [-87.8, 88.8] (NaN kept), Cephes' range
    reduction with the exponent clamped to [-127, 127], the degree-5
    polynomial with every multiply-add fused, the scale 2^fx from the
    exponent bits. Bitwise equal to it wherever its result is normal (a
    subnormal result the reference flushes, as ``_ftz`` does): finite up to
    88.72, inf above, 0 at -inf."""
    xc = torch.clamp(v, _f32(-87.8), _f32(88.8))
    fx = torch.floor(_fma(xc, _f32(1.44269504088896341), 0.5))
    fx = torch.clamp(fx, -127.0, 127.0)
    x = _fma(fx, -_f32(0.693359375), xc)
    x = _fma(fx, _f32(2.12194440e-4), x)
    z = x * x
    y = _fma(x, _f32(_EXP_P[0]), _f32(_EXP_P[1]))
    for c in _EXP_P[2:]:
        y = _fma(y, x, _f32(c))
    y = 1.0 + _fma(y, z, x)
    fxi = torch.nan_to_num(fx, nan=0.0).to(torch.int32)
    scale = ((fxi + 127) << 23).view(torch.float32)
    return torch.where(torch.isnan(v), v, y * scale)


_F32_TINY = 2.0 ** -126  # smallest normal float32


def sigmoid(m: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid's compiled form: 1 / (1 + exp(-m)), with a subnormal
    result flushed to zero as the reference's CPU program flushes it."""
    p = 1.0 / (1.0 + exp_f32(-m))
    return torch.where(p < _F32_TINY, torch.zeros((), dtype=p.dtype,
                                                  device=p.device), p)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """A subnormal float32 flushed to a zero of its sign, as the
    reference's CPU program flushes every result and reads every operand."""
    return torch.where(x.abs() < _F32_TINY, x * 0.0, x)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 sqrt (XLA's ``vsqrtps``): torch's CPU
    sqrt of float32 is not, its float64 sqrt rounded once more is; DAZ."""
    return torch.sqrt(_ftz(x).double()).to(torch.float32)


def _hex_f32(words: str) -> Tuple[float, ...]:
    """float32 constants written as the float64 hex words of LLVM IR."""
    return tuple(struct.unpack(">d", bytes.fromhex(w))[0]
                 for w in words.split())


#: XLA's float32 log (Cephes): the degree-8 polynomial, in Horner triples
_LOG_P = (0.07037683576345444, -0.11514610052108765, 0.11676998436450958,
          -0.12420140951871872, 0.14249323308467865, -0.16668057441711426,
          0.2000071406364441, -0.24999994039535522, 0.3333333134651184)
_LOG_Q1, _LOG_Q2 = -0.00021219444170128554, 0.693359375
_SQRTHF = 0.7071067690849304


def log_f32(v: torch.Tensor) -> torch.Tensor:
    """float32 log as XLA's CPU program evaluates it: DAZ, the exponent and
    a mantissa in [sqrt(1/2), sqrt(2)), Cephes' polynomial in three Horner
    chains joined by FMAs, the exponent's two parts added by FMAs; 0 gives
    -inf, +inf itself, a negative or NaN operand NaN."""
    v = _ftz(v)
    xm = torch.where(v > _F32_TINY, v, torch.full_like(v, _F32_TINY))
    b = xm.view(torch.int32)
    e = ((b >> 23) - 127).to(torch.float32) + 1.0
    mant = ((b & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = mant < _SQRTHF
    x = (mant - 1.0) + torch.where(small, mant, torch.zeros_like(mant))
    e = e - small.to(torch.float32)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(x, p[0], p[1])
    y1 = _fma(x, p[3], p[4])
    y2 = _fma(x, p[6], p[7])
    y = _fma(y, x, p[2])
    y1 = _fma(y1, x, p[5])
    y2 = _fma(y2, x, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    x = _fma(x2, -0.5, x) + y
    r = _fma(e, _LOG_Q2, x)
    r = torch.where(v > 0, r, torch.full_like(r, float("nan")))
    r = torch.where(v == 0, torch.full_like(r, -float("inf")), r)
    return torch.where(v == float("inf"), v, r)


_LOG1P_Q = _hex_f32("402E2035A0000000 4054C30B60000000 406BB865A0000000 "
                    "4073519460000000 406B0DB140000000 404E0F3040000000")
_LOG1P_P = _hex_f32("3F07BC0960000000 3FDFE818A0000000 401A509F40000000 "
                    "403DE97380000000 404E798EC0000000 404C8E75A0000000 "
                    "40340A2020000000")
_LOG1P_SMALL = 0.4142135679721832


def log1p_f32(v: torch.Tensor) -> torch.Tensor:
    """float32 log1p as XLA's CPU program evaluates it: below sqrt(2) - 1 in
    magnitude x - x^2 / 2 + x^3 P(x) / Q(x) (the Horner chains start from
    x * 0 + c, the -x^2 / 2 term fused), else ``log_f32(1 + x)``."""
    x = _ftz(v)
    big = log_f32(x + 1.0)
    x2 = x * x
    den = _fma(x, 0.0, 1.0)
    for c in _LOG1P_Q:
        den = _fma(den, x, c)
    num = _fma(x, 0.0, _LOG1P_P[0])
    for c in _LOG1P_P[1:]:
        num = _fma(num, x, c)
    s = _fma(x2, -0.5, (x * x2) * (num / den))
    return torch.where(x.abs() < _LOG1P_SMALL, x + s, big)


_ERF_P = _hex_f32("3F2E05AA20000000 3F6BEBB440000000 3FAA16DD60000000 "
                  "3FC7B4E800000000 3FF20DD740000000")
_ERF_Q = _hex_f32("BE7FA720C0000000 3EF8B11BE0000000 3F50ADA500000000 "
                  "3F8CD0FA80000000 3FBC698420000000 3FDFD68940000000")
_ERF_CLAMP = _hex_f32("400DF38D00000000")[0]


def erf_f32(v: torch.Tensor) -> torch.Tensor:
    """float32 erf as XLA's CPU program evaluates it: the operand clamped to
    [-3.744, 3.744] (NaN kept), x P(x^2) / Q(x^2) with FMA Horner chains."""
    x = torch.clamp(_ftz(v), -_ERF_CLAMP, _ERF_CLAMP)
    x = torch.where(torch.isnan(v), v, x)
    x2 = x * x
    p = _fma(x2, _ERF_P[0], _ERF_P[1])
    for c in _ERF_P[2:]:
        p = _fma(p, x2, c)
    q = _fma(x2, _ERF_Q[0], _ERF_Q[1])
    for c in _ERF_Q[2:]:
        q = _fma(q, x2, c)
    q = _fma(q, x2, 1.0)
    return (x * p) / q


def _sign(d: torch.Tensor) -> torch.Tensor:
    """jnp.sign: -0.0, +0.0 and NaN map to themselves."""
    return torch.where(d > 0, 1.0, torch.where(d < 0, -1.0, d))


def grad_hess(margin: torch.Tensor, label: torch.Tensor, weight: torch.Tensor,
              logistic, scale_pos_weight: float = 1.0,
              lower: Optional[torch.Tensor] = None,
              upper: Optional[torch.Tensor] = None):
    """(g, h), each [N] f32 — the JAX closures' formulas as the reference's
    CPU program evaluates them: subnormal margins, labels and weights read
    as zero and every subnormal difference or product flushed (``_ftz``);
    the h of the squared, absolute, hinge and quantile errors is the weight
    itself, as there. ``logistic``: an ``Objective`` (one output), or True /
    False for ``binary:logistic`` / ``reg:squarederror``; ``survival:aft``
    reads ``lower`` and ``upper``."""
    if isinstance(logistic, Objective):
        obj = logistic
        kind, c = obj.kind, obj.consts
    else:
        kind = "logistic" if logistic else "squared"
        c = objective_consts(scale_pos_weight=scale_pos_weight)
    if kind == "aft":
        from xgboost_ray_tpu_torch.ops.survival import aft_grad_hess

        return aft_grad_hess(margin, lower, upper, weight, c)
    m, y, w = _ftz(margin), _ftz(label), _ftz(weight)
    if kind == "logistic":
        p = sigmoid(m)
        w = _ftz(w * torch.where(y > 0.5, c.spw, 1.0))
        g = _ftz(_ftz(p - y) * w)
        h = _ftz(torch.clamp(p * (1.0 - p), min=1e-16) * w)
        return g, h
    if kind == "squared":
        return _ftz(_ftz(m - y) * w), weight
    if kind == "absolute":
        return _ftz(_sign(_ftz(m - y)) * w), weight
    if kind == "hinge":
        s = torch.where(y > 0.5, 1.0, -1.0)
        viol = _ftz(s * m) < 1.0
        return _ftz(torch.where(viol, -s, 0.0) * w), weight
    if kind == "pseudohuber":
        r = _ftz(m - y)
        q = r if c.huber_recip == 1.0 else _ftz(r * c.huber_recip)
        scale = _ftz(_fma(q, q, 1.0))
        ss = _ftz(sqrt_rn(scale))
        g = _ftz(_ftz(r / ss) * w)
        h = _ftz(torch.clamp(_ftz(1.0 / _ftz(scale * ss)), min=1e-16) * w)
        return g, h
    if kind == "squaredlog":
        p = torch.clamp(m, min=_f32(-1.0 + 1e-6))
        d = _ftz(log1p_f32(p) - log1p_f32(y))
        p1 = p + 1.0
        g = _ftz(_ftz(d / p1) * w)
        h = _ftz(torch.clamp(_ftz(_ftz(1.0 - d) / _ftz(p1 * p1)), min=1e-6)
                 * w)
        return g, h
    mc = torch.clamp(m, -30.0, 30.0)
    if kind == "poisson":
        mu = _ftz(exp_f32(mc))
        return (_ftz(_ftz(mu - y) * w),
                _ftz(torch.clamp(mu, min=1e-16) * w))
    if kind == "gamma":
        e = _ftz(exp_f32(-mc))
        ym = _ftz(y * e)
        return (_ftz(_ftz(_fma(-y, e, 1.0)) * w),
                _ftz(torch.clamp(ym, min=1e-6) * w))
    if kind == "tweedie":
        # the round computes a = y e^{(1-rho) m} once for g and h, so LLVM
        # fuses neither use of it there (a standalone closure's g and h,
        # two fusions, fuse both); where -(1-rho) == 2-rho the simplifier
        # factors h to (a + b) c
        e1 = _ftz(exp_f32(_ftz(mc * c.tw_e1)))
        b = _ftz(exp_f32(_ftz(mc * c.tw_e2)))
        a = _ftz(y * e1)
        g = _ftz(b - a)
        if c.tw_factored:
            hs = _ftz(_ftz(a + b) * c.tw_h1)
        else:
            hs = _ftz(_fma(b, c.tw_h2, _ftz(a * c.tw_h1)))
        return _ftz(g * w), _ftz(torch.clamp(hs, min=1e-6) * w)
    raise ValueError(f"grad_hess: no one-output gradients for {kind!r}")


def quantile_grad_hess(margin: torch.Tensor, label: torch.Tensor,
                       weight: torch.Tensor, alphas: Sequence[float]):
    """(g, h), each [N, K] f32: ``_make_quantile``'s closure, ``g = (1{m >=
    y} - alpha_k) w`` and h the weight itself."""
    a = torch.tensor([_f32(x) for x in alphas], dtype=torch.float32,
                     device=margin.device)
    m, y, w = _ftz(margin), _ftz(label), _ftz(weight)
    ge = (m >= y[:, None]).to(torch.float32)
    g = _ftz(_ftz(ge - a[None, :]) * w[:, None])
    return g, weight[:, None].expand_as(g)


def round_update_plain(margin: torch.Tensor, row_value: torch.Tensor,
                       label: torch.Tensor, weight: torch.Tensor,
                       logistic, scale_pos_weight: float = 1.0,
                       with_gh: bool = True, metrics: Sequence[str] = (),
                       lower: Optional[torch.Tensor] = None,
                       upper: Optional[torch.Tensor] = None
                       ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain PyTorch K4: updates ``margin`` in place; returns (gh [N, 2], or
    None without ``with_gh``, partial sums [15] f64 in ``PARTIALS``
    order). ``row_value`` [N], or [T, N] for T parallel trees
    (``add_tree_values``)."""
    from xgboost_ray_tpu_torch.ops.metrics import metric_partials

    obj, c = _k4_objective(logistic, scale_pos_weight)
    add_tree_values(margin, row_value)
    sums = metric_partials(margin, label, weight, metrics, c, lower, upper)
    if not with_gh:
        return None, sums
    g, h = grad_hess(margin, label, weight, obj, lower=lower, upper=upper)
    return torch.stack([g, h], dim=1), sums


def add_tree_values(margin: torch.Tensor, row_value: torch.Tensor) -> None:
    """``margin`` [N] += a round's tree values in place: ``row_value`` [N]
    (or [1, N]) as one add; [T, N] (``num_parallel_tree`` T > 1) as the
    reference's program adds ``row_value / T`` tree by tree, the division
    folded into the float32 1 / T and fused with the add: ``margin =
    fma(v_t, 1 / T, margin)`` for t in order."""
    rv = row_value if row_value.dim() == 2 else row_value[None]
    if rv.shape[0] == 1:
        margin.add_(rv[0])
        return
    inv = _f32_div(1.0, rv.shape[0])
    for t in range(rv.shape[0]):
        margin.copy_(_fma(rv[t], inv, margin))


def add_class_values(margin: torch.Tensor, row_value: torch.Tensor) -> None:
    """``margin`` [N, K] += a round's K-output tree values in place:
    ``row_value`` [K, N] as one add; [K T, N] (``num_parallel_tree`` T >
    1, output k's trees at rows k T .. k T + T - 1) output by output, each
    output's T values in order as ``add_tree_values`` adds them
    (``margin[:, k] = fma(v_t, 1 / T, margin[:, k])``, the reference's
    ``engine.py:1413``)."""
    k = margin.shape[1]
    t_par = row_value.shape[0] // k
    if t_par == 1:
        margin.add_(row_value.T)
        return
    for c in range(k):
        add_tree_values(margin[:, c], row_value[c * t_par:(c + 1) * t_par])


def round_update_multi_plain(margin: torch.Tensor, row_value: torch.Tensor,
                             label: torch.Tensor, weight: torch.Tensor,
                             objective: Objective, with_gh: bool = True,
                             metrics: Sequence[str] = ()
                             ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain K4 over K outputs (``reg:quantileerror``): ``margin`` [N, K]
    += ``row_value`` [K, N].T in place (or [K T, N] of T parallel trees an
    output: ``add_class_values``); returns (gh [K, N, 2] or None, partial
    sums [12] f64: the row metrics of output 0, the pinball loss's mean
    over the K outputs)."""
    from xgboost_ray_tpu_torch.ops.metrics import metric_partials

    add_class_values(margin, row_value)
    sums = metric_partials(margin[:, 0], label, weight, metrics,
                           objective.consts, alphas=objective.alphas,
                           margins=margin)
    if not with_gh:
        return None, sums
    g, h = quantile_grad_hess(margin, label, weight, objective.alphas)
    return torch.stack([g.T, h.T], dim=2).contiguous(), sums


#: rows a tile of K4 (``kTileRows`` of ``csrc/objective.cu``: 512 threads
#: of 4 rows) and the most CTAs an SM its persistent grid takes
K4_TILE_ROWS = 2048
K4_CTAS_PER_SM = 2
#: K4's modes: the eval mode (no gradients) and one a row functor
_K4_MODES = {"eval": 0, "logistic": 1, "squared": 2, "absolute": 3,
             "pseudohuber": 4, "squaredlog": 5, "poisson": 6, "gamma": 7,
             "tweedie": 8, "hinge": 9, "aft_normal": 10, "aft_logistic": 11,
             "quantile": 12}
K4_MODES = tuple(_K4_MODES)
#: the most outputs K4's K-output kernel takes (alphas of a quantile model)
K4_MAX_OUTPUTS = 16


def _k4_objective(logistic, scale_pos_weight: float):
    """(Objective, its ObjConsts) of a K4 call: ``logistic`` is an
    ``Objective`` or True / False for binary:logistic / reg:squarederror
    (with ``scale_pos_weight``)."""
    if isinstance(logistic, Objective):
        return logistic, logistic.consts
    obj = _builtin_objective(bool(logistic), float(scale_pos_weight))
    return obj, obj.consts


@functools.lru_cache(maxsize=None)
def _builtin_objective(logistic: bool, scale_pos_weight: float) -> Objective:
    return get_objective(LOGISTIC if logistic else SQUARED,
                         scale_pos_weight=scale_pos_weight)


@functools.lru_cache(maxsize=256)
def _k4_static(obj: Objective, metrics: Tuple[str, ...]):
    """What every K4 launch of ``obj`` with ``metrics`` passes besides its
    tensors: (gh mode, outputs, K-output kernel, metric mask, the folded
    constants in ``K4_CONSTS`` order, scale_pos_weight), made once."""
    return (_K4_MODES[obj.k4_mode], obj.num_outputs,
            int(obj.kind == "quantile"), metric_mask(metrics),
            tuple(getattr(obj.consts, name) for name in K4_CONSTS),
            obj.consts.spw)


def metric_mask(metrics: Sequence[str]) -> int:
    """K4's mask of the partial sums past the first four that ``metrics``
    need (bit i: ``PARTIALS[i]``)."""
    from xgboost_ray_tpu_torch.ops.metrics import k4_slot

    mask = 0
    for name in metrics:
        slot = k4_slot(name, metrics)
        if slot is not None and slot >= 4:
            mask |= 1 << slot
    return mask


class K4Plan(NamedTuple):
    """How one K4 launch maps N rows: ``tiles`` tiles of ``K4_TILE_ROWS``
    rows, CTA c taking tiles c, c + grid, c + 2 grid, ... in order."""

    tiles: int
    grid: int


@functools.lru_cache(maxsize=None)
def k4_plan(n: int, sm_count: int) -> K4Plan:
    """K4's persistent grid for N rows on a card of ``sm_count`` SMs: a CTA
    a tile up to ``K4_CTAS_PER_SM`` CTAs an SM (at least one CTA, which
    writes zero sums for N = 0). It depends on N and the card only, never
    on the mode, so the eval mode sums the same rows in the same CTAs as
    the gh mode: their partials are bitwise equal."""
    tiles = -(-n // K4_TILE_ROWS)
    return K4Plan(tiles, max(1, min(tiles, sm_count * K4_CTAS_PER_SM)))


@functools.lru_cache(maxsize=None)
def _k4_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _k4_workspace(device_index: int, stream: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ticket [1] int32, zero between launches; partials [grid, 12] f32 for
    the largest grid) of the launches on one stream of one card: launches
    on one stream run in order, so they share them."""
    dev = torch.device("cuda", device_index)
    rows = _k4_sms(device_index) * K4_CTAS_PER_SM
    return (torch.zeros(1, dtype=torch.int32, device=dev),
            torch.empty((rows, len(PARTIALS)), dtype=torch.float32,
                        device=dev))


def _k4_args(plan: K4Plan, margin: torch.Tensor, row_value: torch.Tensor,
             label: torch.Tensor, weight: torch.Tensor,
             gh: Optional[torch.Tensor], part: torch.Tensor,
             ticket: torch.Tensor, out: torch.Tensor, logistic,
             scale_pos_weight: float, metrics: Sequence[str] = (),
             lower: Optional[torch.Tensor] = None,
             upper: Optional[torch.Tensor] = None,
             alphas: Optional[torch.Tensor] = None) -> "_build.K4Args":
    """One launch's ``XrtK4Args``: the eval mode where ``gh`` is None;
    ``logistic`` an ``Objective`` or True / False (binary:logistic /
    reg:squarederror)."""
    obj, _ = _k4_objective(logistic, scale_pos_weight)
    mode, k, multi, mask, consts, spw = _k4_static(obj, tuple(metrics))
    a = _build.K4Args()
    a.margin, a.row_value, a.label, a.weight, a.gh, a.part, a.ticket, a.out = (
        _build.ptr(t) for t in (margin, row_value, label, weight, gh, part,
                                ticket, out))
    a.lower, a.upper, a.alpha = (_build.ptr(t) for t in (lower, upper, alphas))
    a.n, a.grid = margin.shape[0], plan.grid
    a.n_trees = (1 if not margin.shape[0]
                 else row_value.numel() // margin.numel())
    a.inv_trees = _f32_div(1.0, max(a.n_trees, 1))
    a.mode = _K4_MODES["eval"] if gh is None else mode
    a.scale_pos_weight, a.k, a.multi, a.metrics = spw, k, multi, mask
    a.c[:] = consts
    return a


def _check_rows(what: str, n: int, dev, *tensors) -> None:
    for t in tensors:
        if t is None:
            continue
        if (t.device != dev or t.dtype != torch.float32 or t.shape != (n,)
                or not t.is_contiguous()):
            raise ValueError(
                f"{what}: margin, row_value, label, weight and the label "
                f"bounds must be contiguous float32 [N] tensors on one CUDA "
                f"device")


def _k4_launch(a, dev, stream: int, with_gh: bool, what: str) -> None:
    with torch.cuda.device(dev):
        code = _build.library("objective").xrt_k4(ctypes.byref(a), stream)
    _build.check(code, what)
    round_update.launches += 1
    if not with_gh:
        round_update.eval_launches += 1
    if a.n_trees > 1:
        round_update.tree_launches += 1


def round_update(margin: torch.Tensor, row_value: torch.Tensor,
                 label: torch.Tensor, weight: torch.Tensor, logistic,
                 scale_pos_weight: float = 1.0, with_gh: bool = True,
                 metrics: Sequence[str] = (),
                 lower: Optional[torch.Tensor] = None,
                 upper: Optional[torch.Tensor] = None
                 ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """K4 wrapper: updates ``margin`` in place; returns (gh [N, 2], or None
    without ``with_gh``, partial sums [15] f64 in ``PARTIALS`` order: the
    first four always, the others of ``metrics``, zero elsewhere).
    ``row_value``: [N], or a round's [T, N] values of T parallel trees,
    added tree by tree as ``add_tree_values`` adds them (the kernel's T-tree
    path; T = 1 is the launch as before).
    ``logistic``: an ``Objective`` of one output, or True / False for
    binary:logistic / reg:squarederror; ``lower`` / ``upper``: the label
    bounds (``survival:aft``'s gradients, the ``aft-nloglik`` metric). CPU
    tensors take the plain version; CUDA tensors launch the kernel of
    ``csrc/objective.cu`` once (``round_update.launches`` counts every
    launch, ``round_update.eval_launches`` those of the eval mode)."""
    if not margin.is_cuda:
        return round_update_plain(margin, row_value, label, weight, logistic,
                                  scale_pos_weight, with_gh, metrics, lower,
                                  upper)
    obj, _ = _k4_objective(logistic, scale_pos_weight)
    n = margin.shape[0]
    if row_value.dim() == 2 and row_value.shape[0] == 1:
        row_value = row_value[0]
    _check_rows("round_update", n, margin.device, margin, label, weight,
                lower, upper)
    if not (row_value.device == margin.device
            and row_value.dtype == torch.float32
            and row_value.is_contiguous()
            and (row_value.shape == (n,) or (row_value.dim() == 2
                                             and row_value.shape[1] == n))):
        raise ValueError("round_update: row_value must be contiguous "
                         "float32 [N] or [T, N] on the margins' device")
    if (obj.survival and with_gh) and (lower is None or upper is None):
        raise ValueError("round_update: survival:aft needs lower and upper")
    if obj.num_outputs != 1 or obj.softmax:
        raise ValueError(f"round_update: {obj.name} has K outputs")
    dev = margin.device
    stream = _build.stream_ptr(dev)
    ticket, part = _k4_workspace(dev.index, stream)
    gh = (torch.empty((n, 2), dtype=torch.float32, device=dev)
          if with_gh else None)
    out = torch.empty(len(PARTIALS), dtype=torch.float64, device=dev)
    a = _k4_args(k4_plan(n, _k4_sms(dev.index)), margin, row_value, label,
                 weight, gh, part, ticket, out, obj, scale_pos_weight,
                 metrics, lower, upper)
    _k4_launch(a, dev, stream, with_gh, "K4 (round_update)")
    return gh, out


round_update.launches = 0
round_update.eval_launches = 0
round_update.tree_launches = 0  # the T-tree add's (num_parallel_tree > 1)


@functools.lru_cache(maxsize=None)
def _alpha_tensor(alphas: Tuple[float, ...], device_index: int
                  ) -> torch.Tensor:
    return torch.tensor([_f32(x) for x in alphas], dtype=torch.float32,
                        device=torch.device("cuda", device_index))


def round_update_multi(margin: torch.Tensor, row_value: torch.Tensor,
                       label: torch.Tensor, weight: torch.Tensor,
                       objective: Objective, with_gh: bool = True,
                       metrics: Sequence[str] = ()
                       ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """K4 over K outputs (``reg:quantileerror``, K alphas): ``margin`` [N,
    K] += ``row_value`` [K, N].T in place, or with T parallel trees an
    output [K T, N] (``add_class_values``' order); returns (gh [K, N, 2] or
    None, partial sums [12] f64). CPU tensors take
    ``round_update_multi_plain``; CUDA tensors launch K4's K-output kernel
    once (counted in ``round_update.launches`` like K4's other modes, its
    T-tree mode also in ``round_update.tree_launches``)."""
    if not margin.is_cuda:
        return round_update_multi_plain(margin, row_value, label, weight,
                                        objective, with_gh, metrics)
    if objective.kind != "quantile":
        raise ValueError(f"round_update_multi: {objective.name} is not "
                         f"reg:quantileerror")
    n, k = margin.shape
    if not (1 <= k <= K4_MAX_OUTPUTS and k == len(objective.alphas)):
        raise ValueError(f"round_update_multi: K = {k} outputs (1 to "
                         f"{K4_MAX_OUTPUTS}, one per alpha)")
    dev = margin.device
    if (margin.dtype != torch.float32 or not margin.is_contiguous()
            or row_value.dim() != 2 or row_value.shape[1] != n
            or row_value.shape[0] % k or not row_value.shape[0]
            or not row_value.is_contiguous()
            or row_value.dtype != torch.float32 or row_value.device != dev):
        raise ValueError("round_update_multi: margin [N, K] and row_value "
                         "[K T, N] must be contiguous float32 on one device")
    _check_rows("round_update_multi", n, dev, label, weight)
    stream = _build.stream_ptr(dev)
    ticket, part = _k4_workspace(dev.index, stream)
    gh = (torch.empty((k, n, 2), dtype=torch.float32, device=dev)
          if with_gh else None)
    out = torch.empty(len(PARTIALS), dtype=torch.float64, device=dev)
    a = _k4_args(k4_plan(n, _k4_sms(dev.index)), margin, row_value, label,
                 weight, gh, part, ticket, out, objective, 1.0, metrics,
                 alphas=_alpha_tensor(objective.alphas, dev.index))
    _k4_launch(a, dev, stream, with_gh, "K4 (round_update_multi)")
    return gh, out




# --------------------------------------------------------------------------
# multi:softprob / multi:softmax and the softmax pass
# --------------------------------------------------------------------------


def label_class(label: torch.Tensor) -> torch.Tensor:
    """[N] int64 class index of f32 labels, cast as XLA casts float32 to
    int32 (``label.astype(jnp.int32)``): truncated toward zero, saturated,
    NaN to 0. No range check, as in the reference: a label outside [0, K)
    has no one-hot entry and its ``mlogloss`` term is NaN (below -K) or
    wraps (in [-K, 0))."""
    v = torch.nan_to_num(label.double(), nan=0.0)
    return v.clamp(-2.0 ** 31, 2.0 ** 31 - 1).trunc().long()


def first_argmax(v: torch.Tensor) -> torch.Tensor:
    """[N] int64 index of each row's first maximum of ``v`` [N, K]
    (``jnp.argmax``: a NaN counts as the maximum, the first one wins)."""
    best = v[:, 0]
    arg = torch.zeros(v.shape[0], dtype=torch.int64, device=v.device)
    for k in range(1, v.shape[1]):
        vk = v[:, k]
        better = (vk > best) | (torch.isnan(vk) & ~torch.isnan(best))
        best = torch.where(better, vk, best)
        arg = torch.where(better, k, arg)
    return arg


def softmax_parts(m: torch.Tensor):
    """The reference's softmax of [N, K] margins: (row max [N], shifted
    ``m - max`` [N, K], ``exp(shifted)`` [N, K], their sum [N]), each step
    flushed as the reference's CPU program flushes it. The sum is XLA's
    CPU reduce over the class axis (``ops/split.tree_sum``): in class order
    up to 32 classes, above that windows of 32 over the zero-padded axis
    (half the padding in front), each window and then the window sums added
    in order."""
    mx = m[:, 0]
    for k in range(1, m.shape[1]):
        mx = torch.maximum(mx, m[:, k])
    d = _ftz(m - mx[:, None])
    e = _ftz(exp_f32(d))
    return mx, d, e, tree_sum(e)


def softmax_probs(m: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(m, axis=-1)`` of [N, K] f32 margins, bitwise its
    compiled CPU form."""
    _, _, e, s = softmax_parts(m)
    return _ftz(e / s[:, None])


def softmax_grad_hess(margin: torch.Tensor, label: torch.Tensor,
                      weight: torch.Tensor):
    """(g, h), each [N, K] f32: ``_make_softmax``'s closure."""
    k = margin.shape[1]
    p = softmax_probs(margin)
    y = (label_class(label)[:, None]
         == torch.arange(k, device=margin.device)[None, :]).to(p.dtype)
    w = weight[:, None]
    g = _ftz((p - y) * w)
    h = _ftz(torch.clamp(2.0 * p * (1.0 - p), min=1e-16) * w)
    return g, h


def softmax_transform_plain(margin: torch.Tensor, prob: bool) -> torch.Tensor:
    """Plain softmax pass, transform mode: [N, K] probabilities
    (``multi:softprob``) or [N] f32 first-argmax classes of the
    probabilities (``multi:softmax``) from [N, K] margins."""
    p = softmax_probs(margin)
    return p if prob else first_argmax(p).to(torch.float32)


def softmax_update_plain(margin: torch.Tensor, row_value: torch.Tensor,
                         label: torch.Tensor, weight: torch.Tensor,
                         with_gh: bool = True, logloss0: bool = False
                         ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain softmax pass, training and eval modes: adds ``row_value``
    [K, N] to ``margin`` [N, K] in place (or [K T, N], T parallel trees a
    class: ``add_class_values``); returns (gh [K, N, 2], or None without
    ``with_gh``, partial sums f64 in ``SOFTMAX_PARTIALS`` order: [4] with
    ``logloss0``, else the first [3])."""
    from xgboost_ray_tpu_torch.ops.metrics import softmax_partials

    add_class_values(margin, row_value)
    sums = softmax_partials(margin, label, weight, logloss0)
    if not with_gh:
        return None, sums
    g, h = softmax_grad_hess(margin, label, weight)
    return torch.stack([g.T, h.T], dim=2).contiguous(), sums


#: rows a CTA of the softmax pass takes, one a thread (kThreads of
#: ``csrc/softmax.cu``)
SMX_ROWS_PER_CTA = 256
#: the register path's compile-time bounds on K (KMAX of the kernel)
SMX_KMAX = (4, 8, 16, 32)
_SMX_LEVELS = 6  # kLevels of the kernel: the wide path takes K <= 32^6
_SMX_MODES = {"train": 0, "eval": 1, "prob": 2, "class": 3}


class SoftmaxPlan(NamedTuple):
    """How one launch of the softmax pass maps its work
    (``csrc/softmax.cu``): ``kmax`` 4-32 is the register path (persistent
    CTAs, their rows staged at ``pitch`` floats a row in two stage buffers,
    ``shared_bytes`` of shared memory, which the launch takes), 0 the wide
    path (K > 32: the class sum's window tree ``front0``, ``top``,
    ``front``)."""

    kmax: int
    pitch: int
    shared_bytes: int
    front0: int
    top: int
    front: Tuple[int, ...]


@functools.lru_cache(maxsize=None)
def softmax_plan(k: int, mode: str = "train") -> SoftmaxPlan:
    """The softmax pass's path for K classes in ``mode`` (``train``,
    ``eval``, ``prob``, ``class``): up to 32 the register path of the
    least bound of ``SMX_KMAX`` at or above K, its rows staged at a pitch
    of K floats (K odd) or K + 1 (K even: thread r's reads of its row fall
    in distinct banks), two stage buffers of 256 rows (in training and eval
    mode with their K row values, labels and weights: ``shared_bytes``);
    above 32 the wide path with the window tree of ``ops/split.tree_sum``
    over K classes."""
    if k < 2:
        raise ValueError(f"softmax pass: K = {k} < 2 classes")
    if k <= SMX_KMAX[-1]:
        kmax = next(b for b in SMX_KMAX if b >= k)
        pitch = k + 1 - k % 2
        labels = k + 2 if _SMX_MODES[mode] <= _SMX_MODES["eval"] else 0
        return SoftmaxPlan(kmax, pitch,
                           2 * 4 * SMX_ROWS_PER_CTA * (pitch + labels), 0, 0,
                           (0,) * _SMX_LEVELS)
    from xgboost_ray_tpu_torch.ops.predict import tree_windows

    front0, _, top, _, front = tree_windows(k)
    if top >= _SMX_LEVELS:
        raise ValueError(f"softmax pass: K = {k} classes exceed the kernel's "
                         f"{_SMX_LEVELS - 1} window levels")
    return SoftmaxPlan(0, 0, 0, front0, top,
                       tuple(front[:_SMX_LEVELS])
                       + (0,) * (_SMX_LEVELS - len(front)))


def _smx_args(mode: str, margin: torch.Tensor, row_value=None, label=None,
              weight=None, gh=None, part=None, out=None):
    n, k = margin.shape
    plan = softmax_plan(k, mode)
    a = _build.SoftmaxArgs()
    a.n_trees = (row_value.shape[0] // k if row_value is not None and n
                 else 1)
    a.inv_trees = _f32_div(1.0, a.n_trees)
    a.margin = margin.data_ptr()
    a.row_value, a.label, a.weight, a.gh, a.part, a.out = (
        _build.ptr(t) for t in (row_value, label, weight, gh, part, out))
    a.n, a.k, a.mode = n, k, _SMX_MODES[mode]
    a.kmax, a.pitch, a.shared_bytes = plan.kmax, plan.pitch, plan.shared_bytes
    a.kmagic = -(-(1 << 32) // k) & 0xFFFFFFFF
    a.front0, a.top = plan.front0, plan.top
    for i, f in enumerate(plan.front):
        a.front[i] = f
    return a


@functools.lru_cache(maxsize=None)
def _smx_ctas(device_index: int, k: int, mode: str) -> int:
    """The register path's persistent grid on this device: the CTAs its
    SMs hold at the shared memory K and the mode take. The C call also
    sets the kernel's attributes for every later launch, so it is made
    once a device, K and mode."""
    a = _smx_args(mode, torch.empty((0, k)))
    ctas = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        code = _build.library("softmax").xrt_softmax_ctas(
            ctypes.byref(a), ctypes.byref(ctas))
    _build.check(code, f"softmax pass's grid ({mode}, K = {k})")
    if ctas.value < 1:
        raise RuntimeError(f"softmax pass: no CTA fits ({mode}, K = {k})")
    return ctas.value


def _smx_grid(margin: torch.Tensor, mode: str) -> int:
    """CTAs of one launch (the partials' rows): the register path's
    persistent grid, at most a CTA a tile of 256 rows; the wide path a CTA
    a tile."""
    n, k = margin.shape
    tiles = -(-n // SMX_ROWS_PER_CTA)
    if k > SMX_KMAX[-1]:
        return tiles
    return min(tiles, _smx_ctas(margin.device.index or 0, k, mode))


def _smx_launch(mode: str, margin: torch.Tensor, grid: int,
                logloss0: bool = False, **tensors) -> None:
    a = _smx_args(mode, margin, **tensors)
    a.grid = grid
    a.logloss0 = int(logloss0)
    dev = margin.device
    with torch.cuda.device(dev):
        code = _build.library("softmax").xrt_softmax(
            ctypes.byref(a), _build.stream_ptr(dev))
    _build.check(code, f"softmax pass ({mode})")


def _check_margin(margin: torch.Tensor, what: str) -> None:
    if not (margin.dtype == torch.float32 and margin.dim() == 2
            and margin.shape[1] >= 2 and margin.is_contiguous()):
        raise ValueError(f"{what}: margin must be contiguous float32 [N, K] "
                         f"with K >= 2")


def softmax_update(margin: torch.Tensor, row_value: torch.Tensor,
                   label: torch.Tensor, weight: torch.Tensor,
                   with_gh: bool = True, logloss0: bool = False
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Softmax pass wrapper, training mode (eval mode with
    ``with_gh=False``): ``margin`` [N, K] += ``row_value`` [K, N].T in
    place (or [K T, N], T parallel trees a class, added as
    ``add_class_values`` adds them: the kernel's T-tree mode, counted in
    ``softmax_update.tree_launches``); returns (gh [K, N, 2] or None, partial sums f64 in
    ``SOFTMAX_PARTIALS`` order: [4] with ``logloss0`` (column 0's
    logloss), else the first [3]). CPU tensors take ``softmax_update_plain``; CUDA tensors
    launch the kernel of ``csrc/softmax.cu`` (``softmax_update.launches``
    counts every launch, ``softmax_update.eval_launches`` those of the
    eval mode)."""
    if not margin.is_cuda:
        return softmax_update_plain(margin, row_value, label, weight, with_gh,
                                    logloss0)
    _check_margin(margin, "softmax_update")
    n, k = margin.shape
    t_par = row_value.shape[0] // k if row_value.dim() == 2 else 0
    for t, shape in ((row_value, (k * max(t_par, 1), n)), (label, (n,)),
                     (weight, (n,))):
        if (t.device != margin.device or t.dtype != torch.float32
                or t.shape != shape or not t.is_contiguous()):
            raise ValueError(
                "softmax_update: row_value [K T, N], label [N] and weight "
                "[N] must be contiguous float32 on the margins' CUDA device")
    gh = (torch.empty((k, n, 2), dtype=torch.float32, device=margin.device)
          if with_gh else None)
    n_parts = len(SOFTMAX_PARTIALS) - (0 if logloss0 else 1)
    if n == 0:
        return gh, torch.zeros(n_parts, dtype=torch.float64,
                               device=margin.device)
    mode = "train" if with_gh else "eval"
    grid = _smx_grid(margin, mode)
    part = torch.empty((grid, len(SOFTMAX_PARTIALS)), dtype=torch.float32,
                       device=margin.device)
    _smx_launch(mode, margin, grid, logloss0, row_value=row_value,
                label=label, weight=weight, gh=gh, part=part)
    softmax_update.launches += 1
    if not with_gh:
        softmax_update.eval_launches += 1
    if t_par > 1:
        softmax_update.tree_launches += 1
    return gh, part[:, :n_parts].sum(0, dtype=torch.float64)


softmax_update.launches = 0
softmax_update.eval_launches = 0
softmax_update.tree_launches = 0  # the T-tree add's (num_parallel_tree > 1)


def softmax_transform(margin: torch.Tensor, prob: bool,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax pass wrapper, transform mode: [N, K] probabilities (``prob``)
    or [N] f32 classes from [N, K] margins, into ``out`` if given. CPU
    tensors take ``softmax_transform_plain``; CUDA tensors launch the
    kernel of ``csrc/softmax.cu`` (``softmax_transform.launches``)."""
    if not margin.is_cuda:
        res = softmax_transform_plain(margin, prob)
        return res if out is None else out.copy_(res)
    _check_margin(margin, "softmax_transform")
    shape = tuple(margin.shape) if prob else (margin.shape[0],)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=margin.device)
    if (out.device != margin.device or out.dtype != torch.float32
            or tuple(out.shape) != shape or not out.is_contiguous()):
        raise ValueError(f"softmax_transform: out must be contiguous float32 "
                         f"{list(shape)} on the margins' device")
    if margin.shape[0]:
        mode = "prob" if prob else "class"
        _smx_launch(mode, margin, _smx_grid(margin, mode), out=out)
        softmax_transform.launches += 1
    return out


softmax_transform.launches = 0


# --------------------------------------------------------------------------
# Quantized gradients at the source (``gh_precision``; B10)
# --------------------------------------------------------------------------
#
# The reference's ``quantize_gh`` (``ops/objectives.py:316-381``): each
# tree's (g, h) goes onto a symmetric int8 / int16 grid with one scale a
# channel from the world's absmax, ``s = amax / qmax`` (1 where amax is 0),
# and stochastic rounding ``clip(floor(g / s + u), -qmax, qmax)``, u the
# draw of the tree's key folded with ``SALT_SR`` and the device block, over
# the block's [slots, 2] (``jax.random.uniform``: element (r, c) takes the
# bits of flat index 2 r + c). Histograms and node totals of the quantized
# values are then exact int32 sums, dequantized once
# (``dequantize_gh_sums``). As the reference's jitted round computes it:
# ``amax / qmax`` is ``amax * f32(1 / qmax)`` (XLA folds the constant
# divisor), ``g / s`` a true division, operands and results flushed to zero.

GH_PRECISION_MODES = ("float32", "int16", "int8")
_GH_QMAX = {"int16": 32767, "int8": 127}
_GH_QDTYPE = {"int16": torch.int16, "int8": torch.int8}


def gh_plane_itemsize(mode: str) -> int:
    """Bytes per stored g (or h) value under a ``gh_precision`` mode: the
    per-shard gh plane is ``rows * 2 * this``."""
    return {"float32": 4, "int16": 2, "int8": 1}[mode]


def gh_qmax(mode: str, max_rows: Optional[int] = None) -> int:
    """The grid's qmax of ``mode``, capped so that ``max_rows`` rows of it
    sum below 2^31: ``max(1, min(qmax, (2^31 - 1) // max_rows))``."""
    if mode not in _GH_QMAX:
        raise ValueError(
            f"unknown gh_precision mode {mode!r}; use one of "
            f"{GH_PRECISION_MODES}")
    qmax = _GH_QMAX[mode]
    if max_rows:
        qmax = max(1, min(qmax, (2 ** 31 - 1) // int(max_rows)))
    return qmax


def gh_scale(amax: torch.Tensor, qmax: int) -> torch.Tensor:
    """The per-channel scales [..., 2] f32 of an absmax [..., 2]:
    ``amax * f32(1 / qmax)`` where amax > 0, else 1."""
    r = float(np.float32(1.0) / np.float32(qmax))
    return torch.where(amax > 0, _ftz(amax * r),
                       torch.ones((), dtype=torch.float32,
                                  device=amax.device))


def quantize_gh_plain(gh: torch.Tensor, qmax: int, scale: torch.Tensor,
                      key, dtype: torch.dtype) -> torch.Tensor:
    """The rounding of ``quantize_gh`` over the first ``n`` rows of a block
    (``gh`` [n, 2] f32; the block's padding rows would round to 0):
    ``clip(floor(g / s + u), -qmax, qmax)`` as ``dtype``."""
    from xgboost_ray_tpu_torch.ops.random import bits_to_unit, random_bits

    n = gh.shape[0]
    u = bits_to_unit(random_bits(key, (n, 2), device=gh.device))
    x = _ftz(_ftz(gh) / scale)
    q = torch.floor(_ftz(x + u)).clamp(-qmax, qmax)
    return q.to(dtype)


def quantize_gh(gh: torch.Tensor, mode: str, key, amax: Optional[torch.Tensor]
                = None, max_rows: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B10 wrapper: ``(gh_q [n, 2] int8 / int16, scale [2] f32)`` with
    ``gh ~= gh_q * scale``. ``gh`` [n, 2] f32 holds the first n rows of one
    device block of the reference's layout and ``key`` (a (k0, k1) pair) is
    the tree's key folded with ``SALT_SR`` and the block; ``amax`` [2] is
    the world's per-channel absmax (this block's where None); ``max_rows``
    the reference's padded global row count (the cap of ``gh_qmax``). CPU
    tensors take ``quantize_gh_plain``; CUDA tensors launch
    ``xrt_quantize_gh`` (``csrc/quant.cu``) or raise.
    ``quantize_gh.launches`` counts the launches."""
    qmax = gh_qmax(mode, max_rows)
    if amax is None:
        amax = (gh.abs().amax(dim=0) if gh.shape[0]
                else torch.zeros(2, dtype=torch.float32, device=gh.device))
    scale = gh_scale(amax, qmax)
    dtype = _GH_QDTYPE[mode]
    if not gh.is_cuda:
        return quantize_gh_plain(gh, qmax, scale, key, dtype), scale
    from xgboost_ray_tpu_torch.ops import _build

    dev = gh.device
    if not (gh.dtype == torch.float32 and gh.dim() == 2 and gh.shape[1] == 2
            and gh.is_contiguous() and gh.data_ptr() % 8 == 0):
        raise ValueError("quantize_gh: gh must be 8-byte aligned contiguous "
                         "f32 [n, 2]")
    scale = scale.contiguous()
    if scale.device != dev or scale.shape != (2,):
        raise ValueError("quantize_gh: amax must be [2] on gh's device")
    n = gh.shape[0]
    out = torch.empty((n, 2), dtype=dtype, device=dev)
    if n:
        with torch.cuda.device(dev):
            code = _build.library("quant").xrt_quantize_gh(
                gh.data_ptr(), out.data_ptr(), n, out.element_size(),
                scale.data_ptr(), qmax, key[0], key[1],
                _build.stream_ptr(dev))
        _build.check(code, "B10 quantize gh")
        quantize_gh.launches += 1
    return out, scale


quantize_gh.launches = 0


def dequantize_gh_sums(sums: torch.Tensor, scale: torch.Tensor
                       ) -> torch.Tensor:
    """Integer (or integer-domain f32) (g, h) sums [..., 2] -> f32, times
    the per-channel ``scale``: the one dequantization point of the
    quantized-gradient path."""
    return sums.to(torch.float32) * scale
