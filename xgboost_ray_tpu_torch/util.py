"""Coordination primitives of the port's training call.

Copy of ``xgboost_ray_tpu/util.py`` (the reference's Event and Queue
actors and ``MultiActorTask``, ``xgboost_ray/util.py:16-77``): a rank's
records and the training call share a process, so these are thin wrappers
over ``threading`` and ``queue`` with the reference's interface.
``restart_backoff_s`` is the restart schedule the fault-tolerance slice
(ROADMAP A18) reads.
"""

import os
import queue
import random
import threading
from typing import Any, Callable, List, Optional


class Event:
    """The reference's Event actor API (``util.py:16-47``)."""

    def __init__(self):
        self._event = threading.Event()

    def set(self):
        self._event.set()

    def is_set(self) -> bool:
        return self._event.is_set()

    def clear(self):
        self._event.clear()

    def shutdown(self):
        self._event.set()


class Queue:
    """The Ray Queue actor of the reference."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()

    def put(self, item: Any):
        self._q.put(item)

    def empty(self) -> bool:
        return self._q.empty()

    def get(self, block: bool = False, timeout: Optional[float] = None) -> Any:
        return self._q.get(block=block, timeout=timeout)

    def shutdown(self):
        while not self._q.empty():
            try:
                self._q.get_nowait()
            except queue.Empty:
                break


class MultiActorTask:
    """Readiness poll over a set of checks (``util.py:52-77``)."""

    def __init__(self, checks: Optional[List[Callable[[], bool]]] = None):
        self._checks = checks or []

    def is_ready(self) -> bool:
        return all(check() for check in self._checks)


def restart_backoff_s(
    restart_index: int,
    base: Optional[float] = None,
    cap: Optional[float] = None,
    jitter: Optional[float] = None,
) -> float:
    """Delay before restart number ``restart_index`` (0-based, counted over
    consecutive failures): full jitter on an exponential schedule,
    ``base * 2^i`` capped at ``cap``, scaled by ``1 + U(0, jitter)``.
    Environment: ``RXGB_RESTART_BACKOFF_BASE_S`` (default 0.5; 0 disables),
    ``RXGB_RESTART_BACKOFF_MAX_S`` (default 30),
    ``RXGB_RESTART_BACKOFF_JITTER`` (fraction, default 0.1)."""
    if base is None:
        base = float(os.environ.get("RXGB_RESTART_BACKOFF_BASE_S", "0.5"))
    if base <= 0:
        return 0.0
    if cap is None:
        cap = float(os.environ.get("RXGB_RESTART_BACKOFF_MAX_S", "30"))
    if jitter is None:
        jitter = float(os.environ.get("RXGB_RESTART_BACKOFF_JITTER", "0.1"))
    delay = min(cap, base * (2.0 ** max(0, int(restart_index))))
    if jitter > 0:
        # restart-schedule jitter only; never touches model state
        delay *= 1.0 + random.random() * jitter
    return delay
