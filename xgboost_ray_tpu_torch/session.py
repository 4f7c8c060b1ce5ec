"""Per-rank session context for user callbacks.

Port of ``xgboost_ray_tpu/session.py`` (the API of ``xgboost_ray``):
code running inside training callbacks asks its rank and pushes items to
the training call's queue, which ``train()`` drains into
``additional_results["callback_returns"]`` (``{rank: [items]}``). The rank
is this process's rank in the ``torch.distributed`` world, 0 outside one.
The session is thread-local, so trainings in concurrent threads keep
their own queues.
"""

import threading
from typing import Any, Optional

from xgboost_ray_tpu_torch import distributed


class RayXGBoostSession:
    def __init__(self, rank: int, queue: Optional[Any] = None):
        self._rank = rank
        self._queue = queue

    def get_actor_rank(self) -> int:
        return self._rank

    def get_rabit_rank(self) -> int:
        # the port has no rabit world apart from torch.distributed's
        return self._rank

    def put_queue(self, item: Any):
        if self._queue is not None:
            self._queue.put((self._rank, item))


_session_tls = threading.local()


def init_session(rank: Optional[int] = None, queue: Optional[Any] = None):
    """Open this thread's session; ``rank`` defaults to the
    ``torch.distributed`` rank (0 outside a world)."""
    if rank is None:
        rank = distributed.process_index()
    _session_tls.value = RayXGBoostSession(rank, queue)


def get_session() -> RayXGBoostSession:
    session = getattr(_session_tls, "value", None)
    if session is None:
        raise ValueError(
            "`get_session()` was called outside an initialized session. "
            "Only call this from within xgboost_ray_tpu_torch training "
            "callbacks."
        )
    return session


def get_actor_rank() -> int:
    return get_session().get_actor_rank()


def get_rabit_rank() -> int:
    return get_session().get_rabit_rank()


def put_queue(item: Any):
    """Put an item from a training callback onto the training call's
    queue."""
    get_session().put_queue(item)
