"""Replica pool and router: N predictors behind one front door.

Port of ``xgboost_ray_tpu/serve/pool.py`` (``:57-354``): ``NoReplicasError``,
``_ReplicaRegistryView``, ``Replica`` and ``Router``. One ``MicroBatcher``
runs every batch through one flusher thread; under concurrent load its
queue, not the device, sets the p99. The pool runs N replicas,
each its own batcher and predictor, behind a :class:`Router` that
admission-controls at the door and sends each request to the live replica
with the fewest queued rows.

* **Shared kernels and tables.** Replicas on one card share the kernel
  libraries (built once per process, ``ops/_build``) and the model's
  device forests where the booster keeps them (B15's SHAP tables): an
  added replica costs no kernel build after warmup, only its own packed
  forest and bucket buffers.
* **One registry, per-replica predictors.** Replicas share the
  :class:`~xgboost_ray_tpu_torch.serve.registry.ModelRegistry` (a hot swap
  drains and flips once) through a :class:`_ReplicaRegistryView` that
  gives each replica its own predictor per model version.
* **A failure sheds capacity, not availability.** ``kill()`` takes the
  replica out of the table and shuts its batcher down: its queued requests
  fail inside with ``ShuttingDownError`` and the router sends them again to
  the survivors; a batch already running finishes.
* **Observable.** Every dispatch emits a ``serve.route`` trace event and
  every change of the pool ``serve.replica_up`` / ``serve.replica_down``
  (``obs/trace.py``), so route, death, shed and rejoin can be read back
  from the timeline alone.

The router has the batcher's surface (``submit``, ``queue_depth``,
``drain``, ``shutdown``, ``breaker_open``, ...), so ``ServeHandle`` uses it
where a ``MicroBatcher`` went.
"""

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np

from xgboost_ray_tpu_torch import obs
from xgboost_ray_tpu_torch.device import resolve_device
from xgboost_ray_tpu_torch.serve.batcher import (
    MicroBatcher,
    OverloadedError,
    ShuttingDownError,
)
from xgboost_ray_tpu_torch.serve.predictor import CompiledPredictor
from xgboost_ray_tpu_torch.serve.registry import ModelEntry, ModelRegistry


class NoReplicasError(RuntimeError):
    """Every replica is gone (killed or scaled to zero); HTTP 503."""


class _ReplicaRegistryView:
    """Per-replica view of the shared registry: the same leases, drains and
    model versions, but batches run on this replica's own
    ``CompiledPredictor`` (built at the first batch of a version: a packed
    forest and buffers on the device, no kernel build)."""

    def __init__(self, registry: ModelRegistry, layout: str = "heap",
                 device=None, min_bucket: int = 8):
        self._registry = registry
        self._layout = layout
        self._min_bucket = min_bucket
        # the flusher thread reads it (its CUDA device and stream)
        self.device = (registry.device if device is None
                       else resolve_device(device))
        self._lock = threading.Lock()
        self._entry: Optional[ModelEntry] = None

    @contextmanager
    def lease(self):
        # the shared lease pins the version (and participates in the
        # registry's drain); the yielded entry swaps in this replica's
        # predictor for that exact version
        with self._registry.lease() as shared:
            yield self._entry_for(shared)

    def _entry_for(self, shared: ModelEntry) -> ModelEntry:
        with self._lock:
            entry = self._entry
        if entry is not None and entry.version == shared.version:
            return entry
        predictor = CompiledPredictor(
            shared.booster, device=self.device,
            min_bucket=self._min_bucket, layout=self._layout,
        )
        entry = ModelEntry(
            shared.version, shared.booster, predictor, name=shared.name
        )
        with self._lock:
            # two racing rebuilds of one version produce equivalent
            # entries; last writer wins and the loser's is garbage
            self._entry = entry
        return entry


class Replica:
    """One serving replica: a private batcher + predictor view over the
    shared registry. Shedding is centralized at the router, so the
    replica's own queue is uncapped."""

    def __init__(self, index: int, registry: ModelRegistry, metrics=None,
                 max_batch: int = 256, max_delay_ms: float = 2.0,
                 breaker_threshold: int = 5, layout: str = "heap",
                 device=None, min_bucket: int = 8):
        self.index = index
        self.view = _ReplicaRegistryView(
            registry, layout=layout, device=device, min_bucket=min_bucket
        )
        self.batcher = MicroBatcher(
            self.view,
            max_batch=max_batch,
            max_delay_ms=max_delay_ms,
            metrics=metrics,
            max_queue_rows=0,
            breaker_threshold=breaker_threshold,
        )


class Router:
    """Least-queue-depth dispatcher over a replica table, with per-model
    admission control at the front door. Duck-types the ``MicroBatcher``
    surface so it drops into ``ServeHandle``."""

    def __init__(self, registry: ModelRegistry, n_replicas: int = 2,
                 metrics=None, max_batch: int = 256,
                 max_delay_ms: float = 2.0, max_queue_rows: int = 0,
                 breaker_threshold: int = 5, layout: str = "heap",
                 device=None, min_bucket: int = 8):
        self.registry = registry
        self.metrics = metrics
        # admission control: reject (429) once this many rows are queued
        # across the whole pool (0 = unbounded)
        self.max_queue_rows = int(max_queue_rows)
        self._replica_kwargs = dict(
            registry=registry, metrics=metrics, max_batch=max_batch,
            max_delay_ms=max_delay_ms, breaker_threshold=breaker_threshold,
            layout=layout, device=device, min_bucket=min_bucket,
        )
        self._lock = threading.Lock()
        self._replicas: Dict[int, Replica] = {}
        self._next_slot = 0
        self._closed = False
        self.scale_to(max(int(n_replicas), 1), reason="startup")

    # -- pool membership ---------------------------------------------------

    def live_replicas(self) -> int:
        with self._lock:
            return len(self._replicas)

    def replica_slots(self) -> List[int]:
        with self._lock:
            return sorted(self._replicas)

    def _snapshot(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def scale_to(self, n: int, reason: str = "scale") -> int:
        """Grow or shrink the pool to ``n`` replicas; returns the live
        count. Shrinking drains the youngest replica before stopping it,
        so a scale-down drops no accepted request."""
        n = max(int(n), 0)
        added: List[Replica] = []
        removed: List[Replica] = []
        with self._lock:
            if self._closed:
                raise ShuttingDownError("router is shut down")
            while len(self._replicas) < n:
                slot = self._next_slot
                self._next_slot += 1
                replica = Replica(slot, **self._replica_kwargs)
                self._replicas[slot] = replica
                added.append(replica)
            while len(self._replicas) > n:
                slot = max(self._replicas)
                removed.append(self._replicas.pop(slot))
            live = len(self._replicas)
        tracer = obs.get_tracer()
        for replica in added:
            tracer.event(
                "serve.replica_up",
                replica=replica.index, reason=reason, live=live,
            )
        for replica in removed:
            tracer.event(
                "serve.replica_down",
                replica=replica.index, reason=reason, live=live,
            )
            # graceful: finish what it accepted, then stop; anything the
            # drain misses fails with ShuttingDownError and is re-dispatched
            replica.batcher.drain(timeout=5.0)
            replica.batcher.shutdown()
        return live

    def kill(self, slot: int) -> None:
        """Chaos hook: hard-stop one replica. Its queued requests fail
        internally and the router re-dispatches them to survivors; its
        mid-execution batch completes. Capacity drops, availability
        doesn't."""
        with self._lock:
            replica = self._replicas.pop(slot, None)
            live = len(self._replicas)
        if replica is None:
            raise KeyError(f"no live replica in slot {slot}")
        obs.get_tracer().event(
            "serve.replica_down", replica=slot, reason="killed", live=live,
        )
        replica.batcher.shutdown()

    def rejoin(self) -> int:
        """Bring one replica's worth of capacity back after a loss (the
        recover leg of the chaos story); returns the new slot."""
        with self._lock:
            if self._closed:
                raise ShuttingDownError("router is shut down")
            slot = self._next_slot
            self._next_slot += 1
            self._replicas[slot] = Replica(slot, **self._replica_kwargs)
            live = len(self._replicas)
        obs.get_tracer().event(
            "serve.replica_up", replica=slot, reason="rejoin", live=live,
        )
        return slot

    # -- request path ------------------------------------------------------

    def submit(
        self, x: np.ndarray, kind: str = "value",
        timeout: Optional[float] = 30.0,
    ) -> Tuple[np.ndarray, int]:
        """Admission-check, pick the least-loaded live replica, dispatch.
        A replica dying with this request queued sheds it back here and it
        is re-dispatched to a survivor — the caller never sees the death."""
        x = np.asarray(x, np.float32)
        n_rows = int(x.shape[0])
        if (
            self.max_queue_rows
            and self.queued_rows() + n_rows > self.max_queue_rows
        ):
            if self.metrics is not None:
                self.metrics.observe_admission_reject()
            raise OverloadedError(
                f"pool queue is full ({self.queued_rows()} rows queued, "
                f"cap {self.max_queue_rows}); request rejected at admission"
            )
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            replica = self._pick()
            if replica is None:
                with self._lock:
                    closed = self._closed
                if closed:
                    raise ShuttingDownError("router is shut down")
                raise NoReplicasError(
                    "no live replicas; scale_to()/rejoin() to restore "
                    "capacity"
                )
            obs.get_tracer().event(
                "serve.route", replica=replica.index, kind=kind, rows=n_rows,
            )
            if deadline is None:
                remaining = None
            else:
                remaining = max(deadline - time.monotonic(), 0.001)
            try:
                return replica.batcher.submit(x, kind, timeout=remaining)
            except ShuttingDownError:
                with self._lock:
                    closed = self._closed
                    still_live = replica.index in self._replicas
                if closed:
                    raise
                if still_live:
                    # the replica shut down without being removed (not a
                    # router action) — drop it from the table so the retry
                    # loop cannot spin on it
                    with self._lock:
                        self._replicas.pop(replica.index, None)
                        live = len(self._replicas)
                    obs.get_tracer().event(
                        "serve.replica_down",
                        replica=replica.index, reason="shutdown", live=live,
                    )
                continue  # re-dispatch to a survivor

    def _pick(self) -> Optional[Replica]:
        replicas = self._snapshot()
        if not replicas:
            return None
        # least queued ROWS (not requests): rows are what occupy the
        # device; ties break toward the lowest slot for determinism
        return min(
            replicas, key=lambda r: (r.batcher.queued_rows(), r.index)
        )

    # -- batcher-compatible surface ---------------------------------------

    def queue_depth(self) -> int:
        return sum(r.batcher.queue_depth() for r in self._snapshot())

    def queued_rows(self) -> int:
        return sum(r.batcher.queued_rows() for r in self._snapshot())

    def executing_batches(self) -> int:
        return sum(r.batcher.executing_batches() for r in self._snapshot())

    def consecutive_failures(self) -> int:
        return max(
            (r.batcher.consecutive_failures() for r in self._snapshot()),
            default=0,
        )

    @property
    def breaker_open(self) -> bool:
        """Degraded only when EVERY live replica's breaker is open — one
        healthy replica keeps the endpoint in rotation."""
        replicas = self._snapshot()
        return bool(replicas) and all(
            r.batcher.breaker_open for r in replicas
        )

    def drain(self, timeout: float = 5.0) -> bool:
        deadline = time.monotonic() + timeout
        ok = True
        for replica in self._snapshot():
            ok = replica.batcher.drain(
                max(deadline - time.monotonic(), 0.0)
            ) and ok
        return ok

    def shutdown(self, timeout: float = 5.0) -> None:
        with self._lock:
            self._closed = True
            replicas = list(self._replicas.values())
            self._replicas = {}
        tracer = obs.get_tracer()
        for replica in replicas:
            tracer.event(
                "serve.replica_down",
                replica=replica.index, reason="shutdown", live=0,
            )
            replica.batcher.shutdown(timeout)
