"""Evaluation metrics of this slice: logloss, error, rmse.

Port of ``xgboost_ray_tpu/ops/metrics.py`` ``_logloss`` (``:36``),
``_error`` (``:43``) and ``_rmse`` (``:27``), and the direction early
stopping takes (``parse_metric_name``, ``:442``; ``is_maximize_metric``,
``:452``). Each metric reduces to a
(numerator, denominator) pair of weighted sums; the engine divides on the
host, as ``engine.TpuEngine.step`` does. On the card the sums come out of
K4 (``ops/objectives.round_update``) as per-block partials.
"""

from typing import Dict, Optional, Sequence, Tuple

import torch

from xgboost_ray_tpu_torch.ops.objectives import PARTIALS


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


def metric_values(sums: torch.Tensor, names: Sequence[str]) -> Dict[str, float]:
    """Host values of the named metrics from ``metric_partials`` sums (one
    device -> host read)."""
    s = dict(zip(PARTIALS, sums.cpu().tolist()))
    den = max(s["weight"], 1e-12)
    out = {}
    for name in names:
        if name == "logloss":
            out[name] = s["logloss"] / den
        elif name == "error":
            out[name] = s["error"] / den
        elif name == "rmse":
            out[name] = float(s["sqerr"] / den) ** 0.5
        else:
            raise NotImplementedError(f"eval_metric={name!r}")
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
