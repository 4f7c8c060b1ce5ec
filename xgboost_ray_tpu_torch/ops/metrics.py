"""Evaluation metrics of this slice: logloss, error, rmse, mlogloss, merror.

Port of ``xgboost_ray_tpu/ops/metrics.py`` ``_logloss`` (``:36``),
``_error`` (``:43``), ``_rmse`` (``:27``), ``_merror`` (``:49``) and
``_mlogloss`` (``:55``), and the direction early
stopping takes (``parse_metric_name``, ``:442``; ``is_maximize_metric``,
``:452``). Each metric reduces to a
(numerator, denominator) pair of weighted sums; the engine divides on the
host, as ``engine.TpuEngine.step`` does. On the card the sums come out of
K4 (``ops/objectives.round_update``: the kernel adds its CTAs' partials) or,
for K outputs, the softmax pass (``ops/objectives.softmax_update``: per-CTA
partials the wrapper adds).
"""

from typing import Dict, Optional, Sequence, Tuple

import torch

from xgboost_ray_tpu_torch.ops.objectives import (
    PARTIALS,
    first_argmax,
    label_class,
    softmax_parts,
)


def softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def logloss_terms(margin, label):
    return torch.where(label > 0.5, softplus(-margin), softplus(margin))


def error_terms(margin, label, threshold: float = 0.5):
    from xgboost_ray_tpu_torch.ops.objectives import sigmoid

    p = sigmoid(margin)
    return torch.where((p > threshold) != (label > 0.5), 1.0, 0.0)


def metric_partials(margin: torch.Tensor, label: torch.Tensor,
                    weight: torch.Tensor) -> torch.Tensor:
    """[4] float64: sum(w * logloss), sum(w * wrong), sum(w * d^2), sum(w)
    over [N] f32 margins (float32 sums, as the JAX metrics take them)."""
    d = margin - label
    return torch.stack([
        torch.sum(weight * logloss_terms(margin, label)),
        torch.sum(weight * error_terms(margin, label)),
        torch.sum(weight * d * d),
        torch.sum(weight),
    ]).to(torch.float64)


def mlogloss_terms(margin: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """[N] ``-log_softmax(margin)[y]`` of [N, K] margins: the label cast as
    the reference casts it, a negative class in [-K, 0) wrapping and one
    outside [-K, K) NaN, as ``take_along_axis`` gives."""
    k = margin.shape[1]
    _, d, _, s = softmax_parts(margin)
    logp = d - torch.log(s)[:, None]
    c = label_class(label)
    c = torch.where(c < 0, c + k, c)
    ok = (c >= 0) & (c < k)
    ll = -logp.gather(1, c.clamp(0, k - 1)[:, None])[:, 0]
    return torch.where(ok, ll, torch.full_like(ll, float("nan")))


def merror_terms(margin: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """[N] 1.0 where the first argmax of the margins is not the label's
    class, else 0.0."""
    return torch.where(first_argmax(margin) != label_class(label), 1.0, 0.0)


def softmax_partials(margin: torch.Tensor, label: torch.Tensor,
                     weight: torch.Tensor) -> torch.Tensor:
    """[3] float64: sum(w * mlogloss), sum(w * wrong), sum(w) over [N, K]
    f32 margins (float32 sums, as the JAX metrics take them)."""
    return torch.stack([
        torch.sum(weight * mlogloss_terms(margin, label)),
        torch.sum(weight * merror_terms(margin, label)),
        torch.sum(weight),
    ]).to(torch.float64)


#: the partial sum each metric divides by the weight sum
_NUMERATOR = {"logloss": "logloss", "error": "error", "rmse": "sqerr",
              "mlogloss": "mlogloss", "merror": "merror"}


def metric_values(sums: torch.Tensor, names: Sequence[str],
                  partials: Sequence[str] = PARTIALS) -> Dict[str, float]:
    """Host values of the named metrics from partial sums named by
    ``partials`` (``metric_partials``' order, or the softmax pass's
    ``SOFTMAX_PARTIALS``; one device -> host read)."""
    s = dict(zip(partials, sums.cpu().tolist()))
    den = max(s["weight"], 1e-12)
    out = {}
    for name in names:
        num = _NUMERATOR.get(name)
        if num not in s:
            raise NotImplementedError(f"eval_metric={name!r}")
        out[name] = s[num] / den
        if name == "rmse":
            out[name] = float(out[name]) ** 0.5
    return out


def parse_metric_name(name: str) -> Tuple[str, Optional[float]]:
    """Split 'ndcg@10' / 'error@0.7' style names into (base, arg)."""
    if "@" in name:
        base, arg = name.split("@", 1)
        # xgboost's "ndcg@10-" means "minus" convention; strip trailing '-'
        return base, float(arg.rstrip("-"))
    return name, None


def is_maximize_metric(name: str) -> bool:
    """Whether a larger value of the metric is better (early stopping)."""
    base, _ = parse_metric_name(name)
    return base in ("auc", "ndcg", "map", "aucpr", "auc_exact")
