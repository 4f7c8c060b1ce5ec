"""Constants shared by the port's data plane (a copy of what it needs from
``xgboost_ray_tpu/constants.py``; the port imports nothing of that package).
"""

#: synthesized per-row fill for an optional column absent on SOME shards
#: while present on others (``engine._concat_shards``)
SHARD_COLUMN_FILLS = {
    "label": 0.0,
    "weight": 1.0,
    "base_margin": 0.0,
}

#: the objectives, metrics and histogram-impl names of this slice
SUPPORTED_OBJECTIVES = ("binary:logistic", "reg:squarederror",
                        "multi:softprob", "multi:softmax")
SUPPORTED_METRICS = ("logloss", "error", "rmse", "mlogloss", "merror")
HIST_IMPLS = ("auto", "scatter", "onehot", "partition", "mixed")

__all__ = [
    "SHARD_COLUMN_FILLS",
    "SUPPORTED_OBJECTIVES",
    "SUPPORTED_METRICS",
    "HIST_IMPLS",
]
