"""Exception types for the driver/FT control flow.

Standalone analogs of the Ray exceptions the reference catches
(``ray.exceptions.RayActorError`` / ``RayTaskError`` at
``xgboost_ray/main.py:1644``) plus the reference's own control-flow
exceptions (``RayXGBoostActorAvailable``, elastic.py:139-142).
"""


class RayActorError(RuntimeError):
    """A (virtual) training actor died. Raised by fault-injection hooks or by
    unrecoverable per-worker errors; triggers the driver FT policy."""

    def __init__(self, message: str = "actor died", ranks=None):
        super().__init__(message)
        self.ranks = list(ranks) if ranks is not None else []


class RayTaskError(RuntimeError):
    """A remote task (e.g. data loading) failed."""


class RayXGBoostTrainingError(RuntimeError):
    """Unrecoverable training error (out of retries / non-actor failure)."""


class RayXGBoostTrainingStopped(RuntimeError):
    """Training was aborted via the stop event / stop callback."""


class RayXGBoostActorAvailable(RuntimeError):
    """Elastic training: a previously failed rank is ready to rejoin; the
    driver should restart from the latest checkpoint with the larger world
    (mirrors ``xgboost_ray/elastic.py:139-142``). Does not consume a retry."""
