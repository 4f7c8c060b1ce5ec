"""A distributed callback that records its hooks, for the port's tests.

It imports neither package (its hooks are the reference's names, which
both packages call by name), so the rank processes of a
``torch.distributed`` world unpickle it without importing JAX.
"""


class RecordingCallback:
    """Appends ``(hook, rank)`` for every hook it receives; ``after_round``
    adds the round record's iteration."""

    def __init__(self):
        self.calls = []

    def on_init(self, actor, *args, **kwargs):
        self.calls.append(("on_init", actor.rank))

    def before_data_loading(self, actor, data, *args, **kwargs):
        self.calls.append(("before_data_loading", actor.rank))

    def after_data_loading(self, actor, data, *args, **kwargs):
        self.calls.append(("after_data_loading", actor.rank))

    def before_train(self, actor, *args, **kwargs):
        self.calls.append(("before_train", actor.rank))

    def after_round(self, actor, record, *args, **kwargs):
        self.calls.append(("after_round", actor.rank, record["iteration"]))

    def after_train(self, actor, result, *args, **kwargs):
        self.calls.append(("after_train", actor.rank))

    def before_predict(self, actor, *args, **kwargs):
        self.calls.append(("before_predict", actor.rank))

    def after_predict(self, actor, predictions, *args, **kwargs):
        self.calls.append(("after_predict", actor.rank, len(predictions)))


def logistic_objective(preds, dtrain):
    """The logistic loss's gradients in numpy (``train(obj=...)``)."""
    import numpy as np

    p = 1.0 / (1.0 + np.exp(-preds))
    y = dtrain.get_label()
    return (p - y).astype(np.float32), (p * (1.0 - p)).astype(np.float32)


def weighted_error(preds, dmat):
    """The weighted error rate in numpy (``train(feval=...)``): a mean
    weighted as the ranks' values are combined, so the 2-rank value is the
    1-rank one."""
    import numpy as np

    wrong = (preds > 0) != (dmat.get_label() > 0.5)
    return "werror", float(np.average(wrong, weights=dmat.get_weight()))
