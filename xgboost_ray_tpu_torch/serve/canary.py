"""The train -> refresh -> serve loop: warm-start refresh, shadow and canary
publish, automatic rollback.

Port of ``xgboost_ray_tpu/serve/canary.py`` (``:42-177``):

* :func:`refresh` boosts more rounds on fresh data, warm-started from the
  live booster (the port's ``train(xgb_model=live)``, on the card unless
  ``device="cpu"``);
* :class:`CanaryController` gates a publish in front of the registry's
  drain-then-flip hot swap. The candidate is judged before the flip:
  shadow traffic (the candidate and the live model predict the same
  mirrored rows; their mean divergence is a ``serve.shadow`` event), then
  the canary gate (candidate against live metric, binary logloss by
  default, on a labelled canary set through each model's predictor). A
  regression past the gate emits ``serve.rollback`` and leaves the
  registry untouched: the old version serves on, bit for bit. A pass runs
  ``registry.load`` (warm, drain, flip) and emits ``serve.promote``. Both
  verdicts count in ``serve/metrics.py`` (``canary_promotions``,
  ``canary_rollbacks``).
"""

from typing import Any, Callable, Dict, Optional

import numpy as np

from xgboost_ray_tpu_torch import obs
from xgboost_ray_tpu_torch.models.booster import coerce_model
from xgboost_ray_tpu_torch.serve.predictor import CompiledPredictor
from xgboost_ray_tpu_torch.serve.registry import ModelRegistry


def binary_logloss(y_true: np.ndarray, y_prob: np.ndarray) -> float:
    """Mean negative log-likelihood of binary labels under predicted
    probabilities (the default canary metric; lower is better)."""
    y = np.asarray(y_true, np.float64).reshape(-1)
    p = np.clip(np.asarray(y_prob, np.float64).reshape(-1), 1e-7, 1 - 1e-7)
    return float(-np.mean(y * np.log(p) + (1.0 - y) * np.log(1.0 - p)))


def refresh(live_booster, params: Dict, dtrain, num_boost_round: int,
            ray_params=None, **train_kwargs):
    """Warm-start ``num_boost_round`` additional rounds from the live
    booster on fresh data (``train_kwargs`` go to ``train``, ``device``
    among them); returns the refreshed booster (publish it with
    :meth:`CanaryController.publish`)."""
    from xgboost_ray_tpu_torch.main import train  # lazy: main imports serve

    return train(
        params, dtrain, num_boost_round,
        ray_params=ray_params, xgb_model=live_booster, **train_kwargs,
    )


class CanaryController:
    """Shadow + canary gate in front of a registry's hot-swap."""

    def __init__(
        self,
        registry: ModelRegistry,
        metric_fn: Callable[[np.ndarray, np.ndarray], float] = binary_logloss,
        rel_tol: float = 0.02,
        abs_tol: float = 1e-6,
        metrics=None,
    ):
        self.registry = registry
        self.metric_fn = metric_fn
        # gate: candidate_metric <= live_metric * (1 + rel_tol) + abs_tol
        self.rel_tol = float(rel_tol)
        self.abs_tol = float(abs_tol)
        self.metrics = metrics

    def _candidate_predictor(self, booster) -> CompiledPredictor:
        return CompiledPredictor(
            booster,
            device=self.registry.device,
            min_bucket=self.registry.min_bucket,
            layout=getattr(self.registry, "layout", "heap"),
        )

    def publish(
        self,
        candidate: Any,
        canary_x: np.ndarray,
        canary_y: np.ndarray,
        shadow_x: Optional[np.ndarray] = None,
        name: str = "",
    ) -> Dict[str, Any]:
        """Evaluate ``candidate`` against the live model and flip only on a
        pass. Returns the verdict dict (``promoted``, both metric values,
        the serving version, and the shadow divergence when measured)."""
        booster = coerce_model(candidate)
        canary_x = np.asarray(canary_x, np.float32)
        canary_y = np.asarray(canary_y)
        if not self.registry.has_model:
            # cold start: nothing to canary against — publish directly
            version = self.registry.load(booster, name=name)
            obs.get_tracer().event(
                "serve.promote", version=version, reason="cold_start",
            )
            if self.metrics is not None:
                self.metrics.observe_canary(promoted=True)
            return {"promoted": True, "version": version,
                    "reason": "cold_start"}

        cand_pred = self._candidate_predictor(booster)
        with self.registry.lease() as live:
            live_version = live.version
            shadow_delta = None
            if shadow_x is not None:
                shadow_x = np.asarray(shadow_x, np.float32)
                live_out = live.predictor.predict(shadow_x, "value")
                cand_out = cand_pred.predict(shadow_x, "value")
                shadow_delta = float(
                    np.mean(np.abs(
                        np.asarray(cand_out, np.float64)
                        - np.asarray(live_out, np.float64)
                    ))
                )
                obs.get_tracer().event(
                    "serve.shadow",
                    live_version=live_version,
                    rows=int(shadow_x.shape[0]),
                    mean_abs_delta=round(shadow_delta, 6),
                )
            live_metric = self.metric_fn(
                canary_y, live.predictor.predict(canary_x, "value")
            )
        cand_metric = self.metric_fn(
            canary_y, cand_pred.predict(canary_x, "value")
        )
        gate = live_metric * (1.0 + self.rel_tol) + self.abs_tol
        verdict: Dict[str, Any] = {
            "live_version": live_version,
            "live_metric": live_metric,
            "candidate_metric": cand_metric,
            "gate": gate,
        }
        if shadow_delta is not None:
            verdict["shadow_mean_abs_delta"] = shadow_delta
        if cand_metric > gate:
            # regression: never flip — the live version keeps serving
            # bit-identically; this IS the automatic rollback
            obs.get_tracer().event(
                "serve.rollback",
                live_version=live_version,
                live_metric=round(live_metric, 6),
                candidate_metric=round(cand_metric, 6),
            )
            if self.metrics is not None:
                self.metrics.observe_canary(promoted=False)
            verdict.update(promoted=False, version=live_version,
                           reason="metric_regression")
            return verdict
        version = self.registry.load(booster, name=name)
        obs.get_tracer().event(
            "serve.promote",
            version=version,
            live_metric=round(live_metric, 6),
            candidate_metric=round(cand_metric, 6),
        )
        if self.metrics is not None:
            self.metrics.observe_canary(promoted=True)
        verdict.update(promoted=True, version=version, reason="gate_pass")
        return verdict
