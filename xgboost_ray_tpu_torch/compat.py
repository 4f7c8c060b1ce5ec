"""Compatibility shims (``xgboost_ray/compat/__init__.py``).

Port of ``xgboost_ray_tpu/compat.py:66-128``: an adapter that wraps
legacy function-style ``callback(env)`` callables (xgboost < 1.0) into the
``TrainingCallback`` protocol, with the classic ``CallbackEnv`` fields, and
``wrap_callbacks``, which ``train()`` applies to its ``callbacks``. The JAX
module's ``shard_map_compat`` (``:20``) papers over ``jax.shard_map``
versions and has no counterpart here: the port has no JAX mesh.
"""

from collections import namedtuple
from typing import Callable

from xgboost_ray_tpu_torch.callback import TrainingCallback

CallbackEnv = namedtuple(
    "CallbackEnv",
    [
        "model",
        "cvfolds",
        "iteration",
        "begin_iteration",
        "end_iteration",
        "rank",
        "evaluation_result_list",
    ],
)


class LegacyCallbackAdapter(TrainingCallback):
    """Wrap a function-style ``callback(env)`` into the class protocol."""

    def __init__(self, fn: Callable, end_iteration: int = 0):
        self.fn = fn
        self.end_iteration = end_iteration

    def _env(self, model, epoch: int, evals_log: dict) -> CallbackEnv:
        results = []
        for set_name, metric_dict in (evals_log or {}).items():
            for metric_name, values in metric_dict.items():
                if values:
                    results.append((f"{set_name}-{metric_name}", values[-1]))
        return CallbackEnv(
            model=model,
            cvfolds=None,
            iteration=epoch,
            begin_iteration=0,
            end_iteration=self.end_iteration,
            rank=0,
            evaluation_result_list=results,
        )

    def after_iteration(self, model, epoch: int, evals_log: dict) -> bool:
        try:
            self.fn(self._env(model, epoch, evals_log))
        except EarlyStopException:
            return True
        return False


class EarlyStopException(Exception):
    """Raised by legacy callbacks to stop training (xgboost<1.0 protocol)."""

    def __init__(self, best_iteration: int = 0):
        super().__init__()
        self.best_iteration = best_iteration


_HOOK_ATTRS = (
    "before_training",
    "after_training",
    "before_iteration",
    "after_iteration",
)


def wrap_callbacks(callbacks, num_boost_round: int):
    """Adapt any function-style entries to the TrainingCallback protocol.

    Objects with any of the four hook methods pass through unchanged;
    bare callables are taken as legacy ``callback(env)`` functions.
    """
    wrapped = []
    for cb in callbacks or []:
        if any(hasattr(cb, attr) for attr in _HOOK_ATTRS):
            wrapped.append(cb)
        elif callable(cb):
            wrapped.append(LegacyCallbackAdapter(cb, end_iteration=num_boost_round))
        else:
            raise TypeError(f"Unsupported callback type: {type(cb)}")
    return wrapped
