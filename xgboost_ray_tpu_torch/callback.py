"""Worker lifecycle and per-round callbacks of the port.

Copy of ``xgboost_ray_tpu/callback.py`` (the API of ``xgboost_ray``):
``DistributedCallback`` hooks fire on each rank's ``RayXGBoostActor``
record (``main.py``) around its creation, data loading, training, every
round and prediction, in the reference's order; ``TrainingCallback`` is the
xgboost per-iteration protocol ``train(callbacks=...)`` takes (any object
with some of its four hooks works: the round loop probes each with
``hasattr``).
"""

import os
from typing import List, Optional


class DistributedCallback:
    """Distributed callbacks for RayXGBoostActor lifecycle hooks."""

    def on_init(self, actor, *args, **kwargs):
        pass

    def before_data_loading(self, actor, data, *args, **kwargs):
        pass

    def after_data_loading(self, actor, data, *args, **kwargs):
        pass

    def before_train(self, actor, *args, **kwargs):
        pass

    def after_train(self, actor, result_dict, *args, **kwargs):
        pass

    def after_round(self, actor, round_record, *args, **kwargs):
        """Fired once per boosting round with the round record
        (``{"round", "iteration", "duration_s", "world", "metrics"}``)."""
        pass

    def before_predict(self, actor, *args, **kwargs):
        pass

    def after_predict(self, actor, predictions, *args, **kwargs):
        pass


class DistributedCallbackContainer:
    def __init__(self, callbacks: Optional[List[DistributedCallback]]):
        self.callbacks = callbacks or []

    def on_init(self, actor, *args, **kwargs):
        for callback in self.callbacks:
            callback.on_init(actor, *args, **kwargs)

    def before_data_loading(self, actor, data, *args, **kwargs):
        for callback in self.callbacks:
            callback.before_data_loading(actor, data, *args, **kwargs)

    def after_data_loading(self, actor, data, *args, **kwargs):
        for callback in self.callbacks:
            callback.after_data_loading(actor, data, *args, **kwargs)

    def before_train(self, actor, *args, **kwargs):
        for callback in self.callbacks:
            callback.before_train(actor, *args, **kwargs)

    def after_train(self, actor, result_dict, *args, **kwargs):
        for callback in self.callbacks:
            callback.after_train(actor, result_dict, *args, **kwargs)

    def after_round(self, actor, round_record, *args, **kwargs):
        for callback in self.callbacks:
            # callbacks written against the reference's hook set may not
            # define after_round
            hook = getattr(callback, "after_round", None)
            if hook is not None:
                hook(actor, round_record, *args, **kwargs)

    def before_predict(self, actor, *args, **kwargs):
        for callback in self.callbacks:
            callback.before_predict(actor, *args, **kwargs)

    def after_predict(self, actor, predictions, *args, **kwargs):
        for callback in self.callbacks:
            callback.after_predict(actor, predictions, *args, **kwargs)


class EnvironmentCallback(DistributedCallback):
    """Set environment variables when a rank's record is made."""

    def __init__(self, env_dict: dict):
        self.env_dict = env_dict

    def on_init(self, actor, *args, **kwargs):
        os.environ.update(self.env_dict)


class TrainingCallback:
    """xgboost-style per-iteration callback protocol:
    ``before_training``/``after_training`` return the model,
    ``before_iteration``/``after_iteration`` return a bool (True stops
    training)."""

    def before_training(self, model):
        return model

    def after_training(self, model):
        return model

    def before_iteration(self, model, epoch: int, evals_log: dict) -> bool:
        return False

    def after_iteration(self, model, epoch: int, evals_log: dict) -> bool:
        return False
