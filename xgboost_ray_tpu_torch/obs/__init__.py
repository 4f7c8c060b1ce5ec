"""Observability of the port: the metrics plane (``obs.metrics``)."""

from xgboost_ray_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    LatencyHistogram,
    MetricsRegistry,
)

__all__ = ["Counter", "Gauge", "LatencyHistogram", "MetricsRegistry"]
