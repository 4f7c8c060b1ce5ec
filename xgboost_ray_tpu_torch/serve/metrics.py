"""Serving-side observability, on the port's ``obs`` metrics plane.

Port of ``xgboost_ray_tpu/serve/metrics.py``: ``ServeMetrics`` with the same
``snapshot()`` schema (the payload of the HTTP ``/metrics`` JSON endpoint):
derived rates (qps, rows/s, padding waste, percentiles) are computed at
read time from counters of ``xgboost_ray_tpu_torch.obs.metrics``, and
``/metrics?format=prometheus`` exposes the same counters, live gauges and
latency histogram as Prometheus text. Each endpoint owns its own
:class:`~xgboost_ray_tpu_torch.obs.metrics.MetricsRegistry` by default, so
endpoints in one process never share counters. ``recompile_count`` reads
the predictor layer's kernel-build counter (``serve.compile_count``),
counted from when the endpoint came up.
"""

import threading
import time
from typing import Callable, Dict, List, Optional

from xgboost_ray_tpu_torch.obs.metrics import (
    LatencyHistogram,
    MetricsRegistry,
)

__all__ = ["LatencyHistogram", "ServeMetrics"]

_COUNTER_NAMES = (
    "requests",
    "rows",
    "errors",
    "shed",
    "batches",
    "batch_rows",
    "padded_rows",
    "model_swaps",
    "admission_rejects",
    "canary_promotions",
    "canary_rollbacks",
)


class ServeMetrics:
    """Thread-safe counters for one serving endpoint.

    ``queue_depth_fn`` is injected by the batcher so the gauge reads the
    live queue without a reverse dependency; ``recompile_count_fn`` reads
    the predictor layer's trace counter the same way; ``breaker_fn`` the
    front-end's degradation breaker. All three are also exported as live
    gauges in the Prometheus exposition.
    """

    def __init__(
        self,
        queue_depth_fn: Optional[Callable[[], int]] = None,
        recompile_count_fn: Optional[Callable[[], int]] = None,
        breaker_fn: Optional[Callable[[], Dict[str, int]]] = None,
        replica_count_fn: Optional[Callable[[], int]] = None,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.registry = registry if registry is not None else MetricsRegistry()
        # outer lock restoring the pre-obs single-lock guarantee for
        # MULTI-counter operations: observe_batch's three increments,
        # reset()'s zeroing sweep, and snapshot()'s cross-counter read are
        # each atomic relative to one another (individual counters keep
        # their own locks for the Prometheus export path)
        self._lock = threading.Lock()
        self._started = time.monotonic()
        self._c = {
            name: self.registry.counter(f"rxgb_serve_{name}_total")
            for name in _COUNTER_NAMES
        }
        self._hist = self.registry.histogram(
            "rxgb_serve_latency_ms", "request latency (ms)"
        )
        self.queue_depth_fn = queue_depth_fn
        self.recompile_count_fn = recompile_count_fn
        # injected by the front-end: live degradation-breaker state
        # {"breaker_open": 0|1, "consecutive_predictor_failures": n}
        self.breaker_fn = breaker_fn
        # injected by the router: live replica count (None = unreplicated)
        self.replica_count_fn = replica_count_fn
        # the compile counter is process-global (the program cache is shared
        # so hot-swaps reuse programs); report compiles SINCE this endpoint
        # came up (re-baselined by reset()), not the process total
        self._recompile_base = int(recompile_count_fn()) if recompile_count_fn else 0
        # live gauges for the Prometheus exposition (the JSON snapshot reads
        # the fns directly); closures read the CURRENT fn so late injection
        # (http.py assigns queue_depth_fn after construction) just works
        self.registry.gauge(
            "rxgb_serve_uptime_seconds",
            fn=lambda: round(time.monotonic() - self._started, 3),
        )
        self.registry.gauge(
            "rxgb_serve_queue_depth",
            fn=lambda: int(self.queue_depth_fn()) if self.queue_depth_fn else 0,
        )
        self.registry.gauge(
            "rxgb_serve_breaker_open",
            fn=lambda: int((self.breaker_fn() or {}).get("breaker_open", 0))
            if self.breaker_fn
            else 0,
        )
        self.registry.gauge(
            "rxgb_serve_replicas",
            fn=lambda: (
                int(self.replica_count_fn()) if self.replica_count_fn else 1
            ),
        )
        self.registry.gauge(
            "rxgb_serve_recompile_count",
            fn=lambda: (
                int(self.recompile_count_fn()) - self._recompile_base
                if self.recompile_count_fn
                else 0
            ),
        )

    # counter values as attributes
    @property
    def requests(self) -> int:
        return self._c["requests"].value

    @property
    def rows(self) -> int:
        return self._c["rows"].value

    @property
    def errors(self) -> int:
        return self._c["errors"].value

    @property
    def shed(self) -> int:
        return self._c["shed"].value

    @property
    def batches(self) -> int:
        return self._c["batches"].value

    @property
    def batch_rows(self) -> int:
        return self._c["batch_rows"].value

    @property
    def padded_rows(self) -> int:
        return self._c["padded_rows"].value

    @property
    def model_swaps(self) -> int:
        return self._c["model_swaps"].value

    @property
    def admission_rejects(self) -> int:
        return self._c["admission_rejects"].value

    @property
    def canary_promotions(self) -> int:
        return self._c["canary_promotions"].value

    @property
    def canary_rollbacks(self) -> int:
        return self._c["canary_rollbacks"].value

    def reset(self) -> None:
        """Zero every counter and restart the clock — used by the closed-loop
        bench to exclude its warmup traffic from the measured window."""
        with self._lock:
            self._started = time.monotonic()
            for c in self._c.values():
                c.reset()
            self._hist.reset()
            if self.recompile_count_fn is not None:
                self._recompile_base = int(self.recompile_count_fn())

    def observe_request(self, latency_s: float, n_rows: int) -> None:
        with self._lock:
            self._c["requests"].inc()
            self._c["rows"].inc(n_rows)
            self._hist.record(latency_s * 1000.0)

    def observe_error(self) -> None:
        self._c["errors"].inc()

    def observe_shed(self) -> None:
        self._c["shed"].inc()

    def observe_batch(self, n_rows: int, bucket: int) -> None:
        with self._lock:
            self._c["batches"].inc()
            self._c["batch_rows"].inc(n_rows)
            self._c["padded_rows"].inc(max(bucket - n_rows, 0))

    def observe_swap(self) -> None:
        self._c["model_swaps"].inc()

    def observe_admission_reject(self) -> None:
        """The router refused a request at the door (per-model admission
        control): the pool's queued rows would exceed the configured cap."""
        self._c["admission_rejects"].inc()

    def observe_canary(self, promoted: bool) -> None:
        """A canary publish concluded: the candidate was promoted (flip)
        or rolled back (old version kept serving)."""
        if promoted:
            self._c["canary_promotions"].inc()
        else:
            self._c["canary_rollbacks"].inc()

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            elapsed = max(time.monotonic() - self._started, 1e-9)
            hist = self._hist.snapshot()  # consistent cut under both locks
            requests = self.requests
            rows = self.rows
            batches = self.batches
            batch_rows = self.batch_rows
            padded = self.padded_rows
            # reset() rebaselines this under the same lock; reading it
            # outside the cut could pair a new baseline with old counters
            recompile_base = self._recompile_base
        issued = batch_rows + padded
        snap = {
            "uptime_s": round(elapsed, 3),
            "requests": requests,
            "rows": rows,
            "errors": self.errors,
            "shed": self.shed,
            "qps": round(requests / elapsed, 3),
            "rows_per_s": round(rows / elapsed, 3),
            "batches": batches,
            "mean_batch_rows": round(batch_rows / max(batches, 1), 3),
            "padding_waste": round(padded / max(issued, 1), 5),
            "latency_p50_ms": round(hist["p50_ms"], 4),
            "latency_p95_ms": round(hist["p95_ms"], 4),
            "latency_p99_ms": round(hist["p99_ms"], 4),
            "latency_mean_ms": round(hist["mean_ms"], 4),
            "model_swaps": self.model_swaps,
            "admission_rejects": self.admission_rejects,
            "canary_promotions": self.canary_promotions,
            "canary_rollbacks": self.canary_rollbacks,
        }
        if self.queue_depth_fn is not None:
            snap["queue_depth"] = int(self.queue_depth_fn())
        if self.replica_count_fn is not None:
            snap["replicas"] = int(self.replica_count_fn())
        if self.breaker_fn is not None:
            snap.update(self.breaker_fn())
        if self.recompile_count_fn is not None:
            snap["recompile_count"] = (
                int(self.recompile_count_fn()) - recompile_base
            )
        return snap

    def latency_buckets(self) -> List[int]:
        return list(self._hist.snapshot()["counts"])

    def prometheus_text(self) -> str:
        """Prometheus 0.0.4 text exposition of this endpoint's registry
        (counters, live gauges, and the latency histogram with cumulative
        ``le`` buckets) — the ``/metrics?format=prometheus`` payload."""
        return self.registry.prometheus_text()
