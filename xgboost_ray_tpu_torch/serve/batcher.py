"""Microbatching queue: coalesce concurrent requests into padded batches.

Port of ``xgboost_ray_tpu/serve/batcher.py`` (``:31-305``): the two-knob
policy of a batched inference engine:

* ``max_batch`` — flush as soon as the pending rows for one output kind
  reach this many (throughput bound);
* ``max_delay_ms`` — flush when the oldest pending request has waited this
  long (latency bound), even if the batch is small.

Requests of different output kinds never share a batch; within a kind,
rows are concatenated in arrival order, executed against one leased model
snapshot, and sliced back per request, so every response is wholly from
one model version, which it reports.

The flusher thread launches the kernels. A new thread's CUDA device is
not the caller's, so the flusher sets the registry's device when it starts
and hands the predictor that device's current stream.
"""

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from xgboost_ray_tpu_torch.serve.predictor import KINDS
from xgboost_ray_tpu_torch.serve.registry import ModelRegistry, NoModelError


class OverloadedError(RuntimeError):
    """The queue is at its ``max_queue_rows`` cap: the request is shed
    (HTTP 429) instead of queueing unboundedly behind a slow predictor."""


class ShuttingDownError(RuntimeError):
    """The batcher is shut down / shutting down; no new requests (HTTP 503)."""


class _Pending:
    __slots__ = ("x", "kind", "event", "result", "version", "error", "t_in")

    def __init__(self, x: np.ndarray, kind: str):
        self.x = x
        self.kind = kind
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.version: int = 0
        self.error: Optional[BaseException] = None
        self.t_in = time.monotonic()


class MicroBatcher:
    """Request queue + background flusher over a ``ModelRegistry``."""

    def __init__(
        self,
        registry: ModelRegistry,
        max_batch: int = 256,
        max_delay_ms: float = 2.0,
        metrics=None,
        max_queue_rows: int = 0,
        breaker_threshold: int = 5,
    ):
        self.registry = registry
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self.metrics = metrics
        # load shedding: reject (429) once this many rows are queued
        # (0 = unbounded)
        self.max_queue_rows = int(max_queue_rows)
        # degradation breaker: this many consecutive failed batches flips
        # /healthz to "degraded" (a success closes it again)
        self.breaker_threshold = int(breaker_threshold)
        self._cond = threading.Condition(threading.Lock())
        self._queues: Dict[str, List[_Pending]] = {k: [] for k in KINDS}
        self._depth = 0  # pending requests across kinds (queue_depth gauge)
        self._queued_rows = 0  # pending ROWS across kinds (shedding cap)
        self._executing = 0  # batches currently running on the device
        self._consecutive_failures = 0
        self._closed = False
        self._thread = threading.Thread(
            target=self._flusher, name="serve-flusher", daemon=True
        )
        self._thread.start()

    # -- client side -------------------------------------------------------

    def submit(
        self, x: np.ndarray, kind: str = "value", timeout: float = 30.0
    ) -> Tuple[np.ndarray, int]:
        """Enqueue one [N, F] request; block until its batch executes.
        Returns ``(result, model_version)``."""
        if kind not in KINDS:
            raise ValueError(
                f"unknown serve output kind {kind!r}; one of {KINDS}"
            )
        req = _Pending(np.asarray(x, np.float32), kind)
        n_rows = int(req.x.shape[0])
        with self._cond:
            # the closed check and the append are one atomic block: a
            # request can never slip in between shutdown's closed-flip and
            # its straggler sweep and then sit out its full client timeout
            if self._closed:
                raise ShuttingDownError("batcher is shut down")
            if (
                self.max_queue_rows
                and self._queued_rows + n_rows > self.max_queue_rows
            ):
                if self.metrics is not None:
                    self.metrics.observe_shed()
                raise OverloadedError(
                    f"serve queue is full ({self._queued_rows} rows queued, "
                    f"cap {self.max_queue_rows}); request shed"
                )
            self._queues[kind].append(req)
            self._depth += 1
            self._queued_rows += n_rows
            self._cond.notify_all()
        if not req.event.wait(timeout):
            # shed the request if it is still queued, so an abandoned
            # client's rows don't occupy device time later and deepen the
            # overload (mid-execution requests can't be recalled)
            with self._cond:
                q = self._queues[kind]
                if req in q:
                    q.remove(req)
                    self._depth -= 1
                    self._queued_rows -= n_rows
                closed = self._closed
            if closed:
                # a shutdown racing this wait is a drain, not a timeout
                raise ShuttingDownError("batcher shut down while waiting")
            raise TimeoutError(
                f"serve request did not complete within {timeout}s"
            )
        if req.error is not None:
            raise req.error
        if self.metrics is not None:
            self.metrics.observe_request(
                time.monotonic() - req.t_in, int(req.x.shape[0])
            )
        return req.result, req.version

    def queue_depth(self) -> int:
        with self._cond:
            return self._depth

    def queued_rows(self) -> int:
        with self._cond:
            return self._queued_rows

    def executing_batches(self) -> int:
        """Batches currently running on the device (drain barometer)."""
        with self._cond:
            return self._executing

    def consecutive_failures(self) -> int:
        with self._cond:
            return self._consecutive_failures

    @property
    def breaker_open(self) -> bool:
        """True once ``breaker_threshold`` batches failed in a row — the
        endpoint reports itself ``degraded`` (requests still flow, so one
        success can close the breaker again)."""
        with self._cond:
            return (
                self.breaker_threshold > 0
                and self._consecutive_failures >= self.breaker_threshold
            )

    def drain(self, timeout: float = 5.0) -> bool:
        """Block until nothing is queued or executing (graceful-shutdown
        step 2); True when fully drained within ``timeout``."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cond:
                if self._depth == 0 and self._executing == 0:
                    return True
            time.sleep(0.005)
        with self._cond:
            return self._depth == 0 and self._executing == 0

    def shutdown(self, timeout: float = 5.0) -> None:
        # closed-flip and the straggler sweep are one atomic block, so a
        # queued request is failed promptly instead of waiting out its
        # client timeout (mid-execution batches still complete normally)
        with self._cond:
            self._closed = True
            for q in self._queues.values():
                for req in q:
                    req.error = ShuttingDownError("batcher shut down")
                    req.event.set()
                q.clear()
            self._depth = 0
            self._queued_rows = 0
            self._cond.notify_all()
        self._thread.join(timeout)

    # -- flusher side ------------------------------------------------------

    def _ready_kind(self) -> Tuple[Optional[str], float]:
        """(kind to flush now, seconds until the next deadline). Called
        under the lock. A kind is ready when it has ``max_batch`` rows
        pending or its oldest request is past the delay deadline; among
        ready kinds the one with the OLDEST waiter wins, so sustained
        max_batch traffic of one kind cannot starve another past its
        deadline."""
        now = time.monotonic()
        ready_kind, ready_oldest = None, float("inf")
        next_wait = float("inf")
        for kind, q in self._queues.items():
            if not q:
                continue
            rows = sum(r.x.shape[0] for r in q)
            deadline = q[0].t_in + self.max_delay_s
            if rows >= self.max_batch or now >= deadline:
                if q[0].t_in < ready_oldest:
                    ready_kind, ready_oldest = kind, q[0].t_in
            else:
                next_wait = min(next_wait, deadline - now)
        if ready_kind is not None:
            return ready_kind, 0.0
        return None, next_wait

    def _flusher(self) -> None:
        dev = self.registry.device
        stream = None
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            stream = torch.cuda.current_stream(dev)
        while True:
            with self._cond:
                kind, wait = self._ready_kind()
                while kind is None and not self._closed:
                    self._cond.wait(None if wait == float("inf") else wait)
                    kind, wait = self._ready_kind()
                if self._closed:
                    return
                batch: List[_Pending] = []
                rows = 0
                q = self._queues[kind]
                # take whole requests up to max_batch rows (never split a
                # request; a single oversized request flushes alone)
                while q and (not batch or rows + q[0].x.shape[0] <= self.max_batch):
                    r = q.pop(0)
                    batch.append(r)
                    rows += int(r.x.shape[0])
                self._depth -= len(batch)
                self._queued_rows -= rows
                self._executing += 1
            try:
                self._execute(kind, batch, stream)
            finally:
                with self._cond:
                    self._executing -= 1

    def _execute(self, kind: str, batch: List[_Pending], stream) -> None:
        try:
            with self.registry.lease() as entry:
                # per-request feature validation against the LEASED model:
                # a hot-swap between an HTTP-level check and batch
                # execution may change num_features; fail only the
                # mismatched requests, not the whole batch
                f = entry.booster.num_features
                bad = [r for r in batch if r.x.shape[1] != f]
                for r in bad:
                    r.error = ValueError(
                        f"feature shape mismatch: model v{entry.version} "
                        f"expects {f}, got {r.x.shape[1]}"
                    )
                    r.event.set()
                batch = [r for r in batch if r.x.shape[1] == f]
                if not batch:
                    return
                x = (
                    np.concatenate([r.x for r in batch], axis=0)
                    if len(batch) > 1 else batch[0].x
                )
                out, bucket = entry.predictor.predict_with_bucket(
                    x, kind, stream)
                version = entry.version
            if self.metrics is not None:
                self.metrics.observe_batch(int(x.shape[0]), bucket)
            lo = 0
            for r in batch:
                hi = lo + int(r.x.shape[0])
                r.result = out[lo:hi]
                r.version = version
                lo = hi
            with self._cond:
                self._consecutive_failures = 0  # breaker half-open -> closed
        except BaseException as exc:  # noqa: BLE001 - marshal to waiters
            # not counted here: the error surfaces from submit() and is
            # counted once per failed request by the front-end (a batch
            # observe here would double-count every failure)
            if not isinstance(exc, NoModelError):
                # NoModelError is an empty endpoint, not a broken predictor
                with self._cond:
                    self._consecutive_failures += 1
            for r in batch:
                r.error = exc
        finally:
            for r in batch:
                r.event.set()
