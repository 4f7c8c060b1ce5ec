"""Constants shared by the port's data plane (a copy of what it needs from
``xgboost_ray_tpu/constants.py``; the port imports nothing of that package).
"""

#: synthesized per-row fill for an optional column absent on SOME shards
#: while present on others (``engine._concat_shards``)
SHARD_COLUMN_FILLS = {
    "label": 0.0,
    "weight": 1.0,
    "base_margin": 0.0,
    "label_lower_bound": 0.0,
    "label_upper_bound": float("inf"),
    "qid": 0,
}

#: the objectives the port trains (``ops/objectives.OBJECTIVES``), the
#: metrics it computes (``error@t`` too) and the histogram-impl names
SUPPORTED_OBJECTIVES = (
    "binary:logistic", "reg:logistic", "binary:logitraw",
    "reg:squarederror", "reg:linear", "reg:absoluteerror",
    "reg:pseudohubererror", "reg:squaredlogerror", "count:poisson",
    "reg:gamma", "reg:tweedie", "binary:hinge", "reg:quantileerror",
    "survival:aft", "multi:softprob", "multi:softmax", "rank:pairwise",
    "rank:ndcg", "rank:map", "survival:cox")
SUPPORTED_METRICS = ("logloss", "error", "rmse", "mae", "rmsle", "mphe",
                     "mape", "poisson-nloglik", "quantile", "aft-nloglik",
                     "auc", "aucpr", "auc_exact", "mlogloss", "merror",
                     "ndcg", "map", "cox-nloglik")
HIST_IMPLS = ("auto", "scatter", "onehot", "partition", "mixed")

__all__ = [
    "SHARD_COLUMN_FILLS",
    "SUPPORTED_OBJECTIVES",
    "SUPPORTED_METRICS",
    "HIST_IMPLS",
]
