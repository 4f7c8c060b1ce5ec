"""Replica autoscaler: p99- and queue-driven scale decisions with hysteresis.

Port of ``xgboost_ray_tpu/serve/autoscale.py`` (``AutoScaler``,
``:34-146``). The serving metrics carry what a scaler needs (the latency
histogram's p99 and the router's queue depth), so the scaler is a thin
control loop over ``ServeMetrics.snapshot()`` and a ``Router``:

* **hot** when p99 exceeds ``p99_high_ms`` or the pool's queued requests
  reach ``queue_high``; after ``up_after`` consecutive hot evaluations, add
  one replica (up to ``max_replicas``);
* **cold** when p99 is under ``p99_low_ms`` and the queue is empty; after
  ``down_after`` consecutive cold evaluations, remove one replica (down to
  ``min_replicas``);
* anything else resets both streaks, so a noisy boundary never flaps.

Every decision emits a ``serve.scale`` trace event with the direction, the
replica counts and the evidence (p99, queue depth, reason): a scale-up ->
scale-down cycle can be read back from the timeline alone. Drive it by
hand (``tick()`` per evaluation) or in its thread (``start()`` /
``stop()``).
"""

import threading
from typing import Optional

from xgboost_ray_tpu_torch import obs


class AutoScaler:
    """Hysteresis scaler over a :class:`~xgboost_ray_tpu_torch.serve.pool.Router`
    and a :class:`~xgboost_ray_tpu_torch.serve.metrics.ServeMetrics`."""

    def __init__(
        self,
        router,
        metrics,
        min_replicas: int = 1,
        max_replicas: int = 4,
        p99_high_ms: float = 50.0,
        p99_low_ms: float = 5.0,
        queue_high: int = 0,
        up_after: int = 2,
        down_after: int = 3,
        interval_s: float = 1.0,
    ):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas; got "
                f"{min_replicas}..{max_replicas}"
            )
        self.router = router
        self.metrics = metrics
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.p99_high_ms = float(p99_high_ms)
        self.p99_low_ms = float(p99_low_ms)
        self.queue_high = int(queue_high)
        self.up_after = int(up_after)
        self.down_after = int(down_after)
        self.interval_s = float(interval_s)
        self._lock = threading.Lock()
        self._over = 0
        self._under = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def tick(self) -> int:
        """One evaluation of the control loop. Returns -1/0/+1 — the scale
        decision taken (and already applied to the router)."""
        snap = self.metrics.snapshot()
        p99 = float(snap.get("latency_p99_ms", 0.0))
        depth = int(self.router.queue_depth())
        live = int(self.router.live_replicas())
        queue_hot = self.queue_high > 0 and depth >= self.queue_high
        hot = p99 > self.p99_high_ms or queue_hot
        cold = p99 < self.p99_low_ms and depth == 0
        decision = 0
        reason = ""
        with self._lock:
            if hot:
                self._over += 1
                self._under = 0
            elif cold:
                self._under += 1
                self._over = 0
            else:
                self._over = 0
                self._under = 0
            if self._over >= self.up_after and live < self.max_replicas:
                decision = 1
                reason = "queue_depth" if queue_hot else "p99_high"
                self._over = 0
            elif self._under >= self.down_after and live > self.min_replicas:
                decision = -1
                reason = "idle"
                self._under = 0
        if decision:
            target = live + decision
            obs.get_tracer().event(
                "serve.scale",
                direction="up" if decision > 0 else "down",
                from_replicas=live,
                to_replicas=target,
                reason=reason,
                p99_ms=round(p99, 3),
                queue_depth=depth,
            )
            self.router.scale_to(
                target, reason="scale_up" if decision > 0 else "scale_down"
            )
        return decision

    # -- background loop ---------------------------------------------------

    def start(self) -> "AutoScaler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="serve-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout)
        self._thread = None

    def _loop(self) -> None:
        from xgboost_ray_tpu_torch.serve.batcher import ShuttingDownError

        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except ShuttingDownError:
                return  # a racing endpoint shutdown ends the loop
            except Exception:  # noqa: BLE001 - retry next interval
                continue
