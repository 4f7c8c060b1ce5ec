"""Observability of the port: the metrics plane (``obs.metrics``) and the
span tracer (``obs.trace``), whose timeline the serve plane writes."""

from xgboost_ray_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    LatencyHistogram,
    MetricsRegistry,
)
from xgboost_ray_tpu_torch.obs.trace import (
    TRACE_NAMES,
    Tracer,
    get_tracer,
    recovery_time_s,
    set_default_tracer,
    use_tracer,
    validate_trace_records,
)

__all__ = [
    "Counter",
    "Gauge",
    "LatencyHistogram",
    "MetricsRegistry",
    "TRACE_NAMES",
    "Tracer",
    "get_tracer",
    "recovery_time_s",
    "set_default_tracer",
    "use_tracer",
    "validate_trace_records",
]
