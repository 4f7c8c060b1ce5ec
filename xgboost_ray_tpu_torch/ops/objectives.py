"""Objectives of this slice and K4, the fused per-round elementwise pass.

Port of ``xgboost_ray_tpu/ops/objectives.py`` for ``binary:logistic``
(``_make_logistic``, ``:88``) and ``reg:squarederror``
(``_make_squarederror``, ``:57``), with the base_score -> margin maps,
the prediction transforms (``:99``, ``:66``) and ``get_objective``
(``:485``). The transform of ``binary:logistic`` is ``jax.nn.sigmoid`` in
the reference; ``sigmoid`` below is bitwise equal to it on the CPU.

K4 (Triton) fuses the end of boosting round i with the start of round i+1
in one pass over the rows: ``margin += row_value`` (the new tree's leaf
value per row), the metric partial sums on the new margin (logloss, error,
squared error, weight: ``ops/metrics.py`` ``_logloss``/``_error``/
``_rmse``), and the next round's (g, h). Round 0 runs it with
``row_value = 0``. Its eval mode (``with_gh=False``) serves a held-out
eval set: the same margin add and partials over that set's rows (its
``row_value`` from B4, ``ops/grow.predict_tree_binned``), no (g, h)
written; the partials replace the eval metrics of the reference's round
(``engine.py:1427-1462``). What bounds it: bytes — five f32 reads/writes per row
plus the (g, h) pair; one block reduction per CTA writes the partials, which
the wrapper sums. ``max(p (1 - p), 1e-16)`` and the softplus form of the
logloss are kept as the JAX functions write them. The plain version
evaluates the sigmoid with the reference's own float32 exp (``exp_f32``),
so on the CPU the gradients equal the JAX package's bit for bit; the
kernel evaluates the same exp with ``tl.fma``. For the logloss the kernel
uses Triton's ``exp``/``log`` and ``log1p(e)`` as ``log(u) * e / (u - 1)``
with ``u = 1 + e``, within a few ulps of the plain ``logaddexp``.
"""

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from xgboost_ray_tpu_torch.ops import _build

LOGISTIC = "binary:logistic"
SQUARED = "reg:squarederror"

#: metric partial sums written by K4, in this order
PARTIALS = ("logloss", "error", "sqerr", "weight")


@dataclasses.dataclass(frozen=True)
class Objective:
    name: str
    default_metric: str
    default_base_score: float = 0.5

    @property
    def logistic(self) -> bool:
        return self.name == LOGISTIC

    def base_score_to_margin(self, s: float) -> float:
        if not self.logistic:
            return float(s)
        if not 0 < s < 1:
            return 0.0
        # float32 log of the python ratio, as the JAX package computes it
        return float(torch.log(torch.tensor(s / (1.0 - s), dtype=torch.float32)))

    def transform(self, margin: torch.Tensor) -> torch.Tensor:
        """[N, 1] margins -> [N] predictions (probabilities for
        ``binary:logistic``, the margin itself for ``reg:squarederror``),
        on the margins' device."""
        return sigmoid(margin[:, 0]) if self.logistic else margin[:, 0]


def get_objective(name: str) -> Objective:
    if name == LOGISTIC:
        return Objective(name, default_metric="logloss")
    if name == SQUARED:
        return Objective(name, default_metric="rmse")
    raise NotImplementedError(
        f"objective={name!r} is not supported by xgboost_ray_tpu_torch yet "
        f"({LOGISTIC} | {SQUARED}; the others are ROADMAP queue A10)."
    )


#: objectives whose base_score maps to a zero margin (``:125``)
_ZERO_BASE = ("multi:softprob", "multi:softmax")


def base_score_margin(name: str, base_score: float) -> float:
    """The margin a model starts from (``Objective.base_score_to_margin``):
    also for the multiclass models the port predicts margins of but does
    not train yet, whose start is 0.0."""
    if name in _ZERO_BASE:
        return 0.0
    return get_objective(name).base_score_to_margin(base_score)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add: the product of two float32 values is exact
    in float64, so a*b + c rounds once there and once to float32."""
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a.double() * b + c).to(torch.float32)


_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
          1.6666665459e-1, 5.0000001201e-1)


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def exp_f32(v: torch.Tensor) -> torch.Tensor:
    """float32 exp as the JAX package's compiled CPU program evaluates it:
    Cephes' range reduction and degree-5 polynomial, every multiply-add
    fused. Bitwise equal to it for |v| <= 87 (beyond, the reference flushes
    subnormal results and clamps later; ``sigmoid`` is equal either way), so
    the plain path's gradients are the reference's."""
    xc = torch.clamp(v, _f32(-88.3762626647949), _f32(88.3762626647950))
    fx = torch.floor(_fma(xc, _f32(1.44269504088896341), 0.5))
    x = _fma(fx, -_f32(0.693359375), xc)
    x = _fma(fx, _f32(2.12194440e-4), x)
    z = x * x
    y = _fma(x, _f32(_EXP_P[0]), _f32(_EXP_P[1]))
    for c in _EXP_P[2:]:
        y = _fma(y, x, _f32(c))
    y = 1.0 + _fma(y, z, x)
    scale = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.maximum(y * scale, v)


_F32_TINY = 2.0 ** -126  # smallest normal float32


def sigmoid(m: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid's compiled form: 1 / (1 + exp(-m)), with a subnormal
    result flushed to zero as the reference's CPU program flushes it."""
    p = 1.0 / (1.0 + exp_f32(-m))
    return torch.where(p < _F32_TINY, torch.zeros((), dtype=p.dtype,
                                                  device=p.device), p)


def grad_hess(margin: torch.Tensor, label: torch.Tensor, weight: torch.Tensor,
              logistic: bool, scale_pos_weight: float = 1.0):
    """(g, h), each [N] f32 — the JAX closures' formulas."""
    if logistic:
        p = sigmoid(margin)
        w = weight * torch.where(label > 0.5, scale_pos_weight, 1.0)
        g = (p - label) * w
        h = torch.clamp(p * (1.0 - p), min=1e-16) * w
        return g, h
    return (margin - label) * weight, weight


def round_update_plain(margin: torch.Tensor, row_value: torch.Tensor,
                       label: torch.Tensor, weight: torch.Tensor,
                       logistic: bool, scale_pos_weight: float = 1.0,
                       with_gh: bool = True
                       ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain PyTorch K4: updates ``margin`` in place; returns (gh [N, 2], or
    None without ``with_gh``, partial sums [4] f64 in ``PARTIALS`` order)."""
    from xgboost_ray_tpu_torch.ops.metrics import metric_partials

    margin.add_(row_value)
    sums = metric_partials(margin, label, weight)
    if not with_gh:
        return None, sums
    g, h = grad_hess(margin, label, weight, logistic, scale_pos_weight)
    return torch.stack([g, h], dim=1), sums


@functools.lru_cache(maxsize=None)
def _k4_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def k4(margin_ptr, rv_ptr, label_ptr, weight_ptr, gh_ptr, part_ptr, n,
           spw, LOGISTIC_OBJ: tl.constexpr, WITH_GH: tl.constexpr,
           BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        m = tl.load(margin_ptr + offs, mask=mask, other=0.0)
        m = m + tl.load(rv_ptr + offs, mask=mask, other=0.0)
        tl.store(margin_ptr + offs, m, mask=mask)
        y = tl.load(label_ptr + offs, mask=mask, other=0.0)
        w = tl.load(weight_ptr + offs, mask=mask, other=0.0)
        pos = y > 0.5
        # logloss: softplus(-m) for y = 1, softplus(m) for y = 0
        z = tl.where(pos, -m, m)
        e = tl.exp(-tl.abs(z))
        u = 1.0 + e
        l1p = tl.where(u == 1.0, e, tl.log(u) * (e / (u - 1.0)))
        ll = tl.maximum(z, 0.0) + l1p
        # sigmoid through the plain version's float32 exp (Cephes, fused)
        xc = tl.minimum(tl.maximum(-m, -88.3762626647949), 88.3762626647950)
        fx = tl.floor(tl.fma(xc, 1.44269504088896341, 0.5))
        r = tl.fma(fx, -0.693359375, xc)
        r = tl.fma(fx, 2.12194440e-4, r)
        r2 = r * r
        q = tl.fma(r, 1.9875691500e-4, 1.3981999507e-3)
        q = tl.fma(q, r, 8.3334519073e-3)
        q = tl.fma(q, r, 4.1665795894e-2)
        q = tl.fma(q, r, 1.6666665459e-1)
        q = tl.fma(q, r, 5.0000001201e-1)
        q = 1.0 + tl.fma(q, r2, r)
        two_n = ((fx.to(tl.int32) + 127) << 23).to(tl.float32, bitcast=True)
        p = 1.0 / (1.0 + tl.maximum(q * two_n, -m))
        wrong = tl.where((p > 0.5) == pos, 0.0, 1.0)
        d = m - y
        tl.store(part_ptr + pid * 4 + 0, tl.sum(w * ll, axis=0))
        tl.store(part_ptr + pid * 4 + 1, tl.sum(w * wrong, axis=0))
        tl.store(part_ptr + pid * 4 + 2, tl.sum(w * d * d, axis=0))
        tl.store(part_ptr + pid * 4 + 3, tl.sum(w, axis=0))
        if WITH_GH:
            if LOGISTIC_OBJ:
                ww = w * tl.where(pos, spw, 1.0)
                g = (p - y) * ww
                h = tl.maximum(p * (1.0 - p), 1e-16) * ww
            else:
                g = d * w
                h = w
            tl.store(gh_ptr + offs * 2, g, mask=mask)
            tl.store(gh_ptr + offs * 2 + 1, h, mask=mask)

    _build.TRITON_KERNELS.append(k4)
    return k4


_K4_BLOCK = 1024


def round_update(margin: torch.Tensor, row_value: torch.Tensor,
                 label: torch.Tensor, weight: torch.Tensor, logistic: bool,
                 scale_pos_weight: float = 1.0, with_gh: bool = True
                 ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """K4 wrapper: CPU tensors take the plain version; CUDA tensors launch
    the Triton kernel (``round_update.launches`` counts every launch,
    ``round_update.eval_launches`` those of the eval mode, ``with_gh=False``:
    no gradients, gh is None)."""
    tensors = (margin, row_value, label, weight)
    if not margin.is_cuda:
        return round_update_plain(margin, row_value, label, weight, logistic,
                                  scale_pos_weight, with_gh)
    n = margin.shape[0]
    for t in tensors:
        if (t.device != margin.device or t.dtype != torch.float32
                or t.shape != (n,) or not t.is_contiguous()):
            raise ValueError(
                "round_update: margin, row_value, label and weight must be "
                "contiguous float32 [N] tensors on one CUDA device"
            )
    n_blocks = max(1, math.ceil(n / _K4_BLOCK))
    gh = (torch.empty((n, 2), dtype=torch.float32, device=margin.device)
          if with_gh else None)
    part = torch.empty((n_blocks, 4), dtype=torch.float32, device=margin.device)
    with torch.cuda.device(margin.device):
        _k4_kernel()[(n_blocks,)](
            margin, row_value, label, weight, margin if gh is None else gh,
            part, n, float(scale_pos_weight), LOGISTIC_OBJ=bool(logistic),
            WITH_GH=bool(with_gh), BLOCK=_K4_BLOCK, num_warps=4,
        )
    round_update.launches += 1
    if not with_gh:
        round_update.eval_launches += 1
    return gh, part.sum(0, dtype=torch.float64)


round_update.launches = 0
round_update.eval_launches = 0
