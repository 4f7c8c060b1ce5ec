"""Model registry: the serving layer's single mutable cell.

Port of ``xgboost_ray_tpu/serve/registry.py`` (``NoModelError`` ``:31``,
``ModelRegistry`` ``:80``). It holds the current
``(version, booster, CompiledPredictor)`` and swaps it atomically: a load
builds and warms the new model's predictor outside the lock (kernel builds
and buffers happen before the swap is visible), then blocks new leases,
drains in-flight batches and flips the pointer. Every batch runs against
the entry its ``lease()`` took, so a response is wholly from one model
version.

Models load through ``models.booster.coerce_model``: the port's
``RayXGBoostBooster``, pickled booster bytes, a saved-model path, or a
JSON document (text or dict) of the port's format or of xgboost's model
schema (``import_xgboost_json``).
"""

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from xgboost_ray_tpu_torch.device import resolve_device
from xgboost_ray_tpu_torch.models.booster import RayXGBoostBooster, coerce_model
from xgboost_ray_tpu_torch.serve.predictor import KINDS, CompiledPredictor


class NoModelError(RuntimeError):
    """A request arrived before any model was registered."""


@dataclass
class ModelEntry:
    version: int
    booster: RayXGBoostBooster
    predictor: CompiledPredictor
    name: str = ""


@dataclass
class ModelRegistry:
    """Thread-safe current-model cell with drain-before-swap semantics.
    ``device``: where predictors run (the card by default; ``"cpu"`` for
    the plain path)."""

    device: Optional[Any] = None
    min_bucket: int = 8
    #: forest layout of the predictor ("heap" or "node_array")
    layout: str = "heap"
    #: kinds warmed on load (before the swap becomes visible): all four, so
    #: the first request of any kind after a publish finds its buffers
    warm_kinds: tuple = KINDS
    #: largest batch the warmup covers; align with the batcher's max_batch
    warm_max_batch: int = 256
    metrics: Optional[Any] = None  # ServeMetrics, for the swap counter

    _cond: threading.Condition = field(
        default_factory=lambda: threading.Condition(threading.Lock()),
        repr=False,
    )
    #: serializes whole load() calls, not just the flip
    _load_lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False
    )
    _current: Optional[ModelEntry] = field(default=None, repr=False)
    _inflight: int = field(default=0, repr=False)
    _swapping: bool = field(default=False, repr=False)
    _version: int = field(default=0, repr=False)

    def __post_init__(self):
        # raises here, not at the first load, when there is no card
        self.device: torch.device = resolve_device(self.device)

    def load(self, model: Any, name: str = "", warm: bool = True) -> int:
        """Register ``model`` and atomically make it current; returns the
        new version. The warmup runs before the old model stops serving,
        and in-flight batches drain before the flip."""
        with self._load_lock:
            booster = coerce_model(model)
            predictor = CompiledPredictor(
                booster, device=self.device, min_bucket=self.min_bucket,
                layout=self.layout,
            )
            if warm and self.warm_kinds:
                kinds = [k for k in self.warm_kinds if k in KINDS]
                if not booster._has_node_stats:
                    # no SHAP without node statistics: contribs requests
                    # are refused, so there is nothing to warm
                    kinds = [k for k in kinds if k != "contribs"]
                predictor.warmup(kinds=kinds, max_batch=self.warm_max_batch)
            with self._cond:
                while self._swapping:
                    self._cond.wait()
                self._swapping = True
                while self._inflight:
                    self._cond.wait()
                self._version += 1
                entry = ModelEntry(self._version, booster, predictor,
                                   name=name)
                was_live = self._current is not None
                self._current = entry
                self._swapping = False
                self._cond.notify_all()
        if was_live and self.metrics is not None:
            self.metrics.observe_swap()
        return entry.version

    @contextmanager
    def lease(self):
        """Snapshot the current entry and hold it in flight for the scope.
        Blocks briefly while a swap drains, then yields an entry the swap
        cannot change."""
        with self._cond:
            while self._swapping:
                self._cond.wait()
            if self._current is None:
                raise NoModelError(
                    "no model registered; POST /models or call "
                    "ModelRegistry.load() first."
                )
            entry = self._current
            self._inflight += 1
        try:
            yield entry
        finally:
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()

    @property
    def version(self) -> int:
        with self._cond:
            return self._current.version if self._current else 0

    @property
    def has_model(self) -> bool:
        with self._cond:
            return self._current is not None
