"""survival:aft, the accelerated failure time objective, on the port.

Port of ``xgboost_ray_tpu/ops/survival.py``: the gradients of
``make_aft_grad_hess`` (``:49-99``) for the normal and the logistic error
distribution over label bounds [lower, upper] (upper +inf: right-censored;
a finite upper within 1e-10 of lower: uncensored, the density; else the
mass between the bounds), and the ``aft-nloglik`` metric
(``aft_nloglik_contrib``, ``:101-140``). On the card both come out of K4's
two AFT modes (the AFT pass, ``csrc/objective.cu``), which read margin,
label, lower, upper and weight and write the margin, (g, h) and the
partial sums; these are its plain versions. The envelope (the ``exp``
transform, the float64 log base margin, the default metric) is
``ops/objectives.get_objective``'s.
"""

from typing import Tuple

import numpy as np
import torch

from xgboost_ray_tpu_torch.ops.objectives import (
    ObjConsts,
    _f32,
    _fma,
    _ftz,
    erf_f32,
    exp_f32,
    log1p_f32,
    log_f32,
    sigmoid,
)

_AFT_EPS = 1e-12
_NORMAL_K = _f32(1.0 / float(np.sqrt(2.0 * np.pi)))  # x / sqrt(2 pi)
_INV_SQRT2 = _f32(1.0 / np.sqrt(2.0))


def aft_grad_hess(margin: torch.Tensor, lower: torch.Tensor,
                  upper: torch.Tensor, weight: torch.Tensor,
                  c: ObjConsts) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g, h), each [N] f32: ``make_aft_grad_hess``'s closure
    (``xgboost_ray_tpu/ops/survival.py:49-99``) as the reference's compiled
    CPU program computes it: every division by sigma a product with 1 /
    sigma, the constants of ``-0.5 z z``, ``z / sqrt 2`` and ``sigma *
    sigma * d * d`` folded, the pdfs' difference and the cdf's fused. The
    normal pdf and cdf come from ``exp_f32`` and ``erf_f32``, the logistic
    ones from ``sigmoid``. ``c``: ``ObjConsts`` (sigma, the distribution)."""
    m, lo, hi, wd = _ftz(margin), _ftz(lower), _ftz(upper), _ftz(weight)
    r = c.aft_r
    zero = torch.zeros_like(m)
    fin = torch.isfinite(hi)
    unc = fin & (_ftz(hi - lo).abs() < _f32(1e-10))
    eps = _f32(_AFT_EPS)
    dlo = _ftz(log_f32(torch.clamp(lo, min=eps)) - m)
    zl = _ftz(dlo * r)
    zh = torch.where(fin, _ftz(_ftz(log_f32(torch.clamp(hi, min=eps)) - m) * r),
                     zero)
    if c.aft_logistic:
        a_lo, a_hi = sigmoid(zl), sigmoid(zh)
        b_lo, b_hi = _ftz(1.0 - a_lo), _ftz(1.0 - a_hi)   # pdf = s (1 - s)
        cdf_hi = torch.where(fin, a_hi, torch.ones_like(m))
        den = torch.clamp(_ftz(cdf_hi - a_lo), min=eps)
        gu = _ftz(-_ftz(_fma(a_lo, 2.0, -1.0)) * r)
        hu = _ftz(_ftz(_ftz(a_lo * 2.0) * b_lo) * c.aft_hu)
    else:
        a_lo = exp_f32(_ftz(_ftz(dlo * c.aft_hr) * zl))  # pdf = e k
        a_hi = exp_f32(_ftz(_ftz(zh * -0.5) * zh))
        b_lo = b_hi = torch.full_like(m, _NORMAL_K)
        erf_lo = erf_f32(_ftz(dlo * c.aft_rc))
        erf_hi = erf_f32(_ftz(zh * _INV_SQRT2))
        cdf_hi = torch.where(fin, _ftz((erf_hi + 1.0) * 0.5),
                             torch.ones_like(m))
        den = torch.clamp(_ftz(_fma(-(erf_lo + 1.0), 0.5, cdf_hi)), min=eps)
        gu = _ftz(-zl * r)
        hu = torch.full_like(m, c.aft_hu)
    pdf_hi = torch.where(fin, _ftz(a_hi * b_hi), zero)
    dh = _ftz(_fma(-a_lo, b_lo, pdf_hi))        # pdf_hi - pdf_lo
    pdf_lo = _ftz(a_lo * b_lo)
    dl = torch.where(fin, _ftz(_fma(-a_hi, b_hi, pdf_lo)), pdf_lo)
    gc = _ftz(dh / _ftz(den * c.aft_s))
    hc = torch.clamp(_ftz(_ftz(dl * dl) / _ftz(_ftz(den * c.aft_s2) * den)),
                     min=1e-6)
    g = _ftz(torch.where(unc, gu, gc) * wd)
    h = _ftz(torch.clamp(torch.where(unc, hu, hc), min=1e-6) * wd)
    return g, h



#: jnp.log(_SQRT2PI): a float32 log
_LOG_SQRT2PI = float(log_f32(torch.tensor(float(np.sqrt(2.0 * np.pi)),
                                          dtype=torch.float32)))


def _softplus_f32(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus (logaddexp(x, 0)) from the reference's own exp and
    log1p."""
    return torch.clamp(x, min=0.0) + log1p_f32(exp_f32(-x.abs()))


def aft_nloglik_terms(margin: torch.Tensor, lower: torch.Tensor,
                      upper: torch.Tensor, c: ObjConsts) -> torch.Tensor:
    """[N] negative log likelihood of ``aft_nloglik_contrib``
    (``xgboost_ray_tpu/ops/survival.py:101``): the density's for an
    uncensored row (finite upper within 1e-10 of lower), else the log of
    the cdf's mass between the bounds (upper +inf: right-censored). With
    the reference's log, erf, exp and log1p, so the terms of a mass that
    cancels between the bounds stay close to its."""
    log_lo = log_f32(torch.clamp(lower, min=_f32(_AFT_EPS)))
    z_lo = (log_lo - margin) * c.aft_r
    fin = torch.isfinite(upper)
    unc = fin & ((upper - lower).abs() < _f32(1e-10))
    if c.aft_logistic:
        logpdf = -(_softplus_f32(z_lo) + _softplus_f32(-z_lo))
        cdf = sigmoid
    else:
        logpdf = (-0.5 * z_lo) * z_lo - _LOG_SQRT2PI

        def cdf(z):
            return 0.5 * (1.0 + erf_f32(z * _INV_SQRT2))
    nll_unc = -(logpdf - c.aft_log_sigma - log_lo)
    z_hi = (log_f32(torch.clamp(torch.where(fin, upper, torch.ones_like(
        upper)), min=_f32(_AFT_EPS))) - margin) * c.aft_r
    cdf_hi = torch.where(fin, cdf(z_hi), torch.ones_like(z_hi))
    nll_cen = -log_f32(torch.clamp(cdf_hi - cdf(z_lo), min=_f32(_AFT_EPS)))
    return torch.where(unc, nll_unc, nll_cen)
