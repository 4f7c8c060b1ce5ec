"""xgboost-style parameter dict parsing and validation for the port.

``TrainParams`` has exactly the fields of the JAX package's dataclass
(``xgboost_ray_tpu/params.py:44``): the model JSON stores
``dataclasses.asdict(params)``, so the two packages read each other's model
files. ``parse_params`` follows ``xgboost_ray_tpu/params.py:254`` for the
keys of this slice (aliases, type coercion, the tree_method and range
checks) and raises ``NotImplementedError`` naming the key for every setting
the port does not run yet: nothing is silently ignored.
"""

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence

from xgboost_ray_tpu_torch.constants import (
    HIST_IMPLS,
    SUPPORTED_METRICS,
    SUPPORTED_OBJECTIVES,
)

logger = logging.getLogger(__name__)

_ALIASES = {
    "eta": "learning_rate",
    "lambda": "reg_lambda",
    "alpha": "reg_alpha",
    "min_split_loss": "gamma",
}

# accepted-and-ignored keys (no meaning here, kept for drop-in compatibility)
_IGNORED = {
    "nthread",
    "n_jobs",
    "verbosity",
    "silent",
    "gpu_id",
    "predictor",
    "validate_parameters",
    "single_precision_histogram",
    "use_label_encoder",
    "enable_categorical",
    "disable_default_eval_metric",
    "num_pairsample",
    "device",
    "max_cat_to_onehot",
    "eval_at",
}


@dataclasses.dataclass
class TrainParams:
    objective: str = "reg:squarederror"
    num_class: int = 0
    learning_rate: float = 0.3
    max_depth: int = 6
    reg_lambda: float = 1.0
    reg_alpha: float = 0.0
    gamma: float = 0.0
    min_child_weight: float = 1.0
    max_delta_step: float = 0.0
    subsample: float = 1.0
    sampling_method: str = "uniform"
    top_rate: float = 0.2
    other_rate: float = 0.1
    colsample_bytree: float = 1.0
    colsample_bylevel: float = 1.0
    colsample_bynode: float = 1.0
    max_bin: int = 256
    base_score: Optional[float] = None
    seed: int = 0
    num_parallel_tree: int = 1
    scale_pos_weight: float = 1.0
    tree_method: str = "tpu_hist"
    eval_metric: List[str] = dataclasses.field(default_factory=list)
    booster: str = "gbtree"
    rate_drop: float = 0.0
    one_drop: int = 0
    skip_drop: float = 0.0
    sample_type: str = "uniform"
    normalize_type: str = "tree"
    aft_loss_distribution: str = "normal"
    aft_loss_distribution_scale: float = 1.0
    tweedie_variance_power: float = 1.5
    huber_slope: float = 1.0
    quantile_alpha: float = 0.5
    # every value resolves to the port's one histogram kernel on the card
    # and to its plain version on the CPU
    hist_impl: str = "auto"
    # parsed for compatibility; the port always accumulates in f32
    hist_precision: str = "auto"
    hist_quant: str = "none"
    hist_quant_min_bytes: int = 32768
    hist_quant_block: int = 512
    gh_precision: str = "float32"
    hist_chunk: int = 8192
    sibling_subtract: bool = True
    grow_policy: str = "depthwise"
    max_leaves: int = 0
    monotone_constraints: tuple = ()
    interaction_constraints: tuple = ()
    feature_parallel: int = 1


def cat_feature_indices(feature_types: Optional[Sequence[Any]]) -> tuple:
    """Indices marked categorical ('c') in an xgboost feature_types list
    (``xgboost_ray_tpu/params.py:195``)."""
    return tuple(
        i
        for i, t in enumerate(feature_types or [])
        if str(t).lower() in ("c", "categorical")
    )


def _not_in_slice(key: str, value: Any) -> NotImplementedError:
    return NotImplementedError(
        f"{key}={value!r} is not supported by xgboost_ray_tpu_torch yet "
        f"(this port runs gbtree depthwise growth with f32 gradients, no "
        f"sampling and objectives {' | '.join(SUPPORTED_OBJECTIVES)}); use "
        f"the JAX package xgboost_ray_tpu for it."
    )


def _is_empty(val, empty_strs) -> bool:
    if val is None:
        return True
    if isinstance(val, str):
        return val.strip() in empty_strs
    try:
        return len(val) == 0
    except TypeError:
        return False


def parse_params(params: Optional[Dict[str, Any]]) -> TrainParams:
    params = dict(params or {})
    out = TrainParams()

    tree_method = str(params.pop("tree_method", "tpu_hist") or "tpu_hist")
    if tree_method in ("exact",):
        raise ValueError(
            "`exact` tree_method doesn't support distributed training. Use "
            "`tree_method=\"hist\"` (or \"gpu_hist\"/\"approx\", which map "
            "to the histogram method)."
        )
    if tree_method in ("hist", "approx", "auto", "gpu_hist"):
        tree_method = "tpu_hist"
    if tree_method != "tpu_hist":
        raise ValueError(f"Unsupported tree_method: {tree_method!r}")
    out.tree_method = tree_method

    for key, empty in (("monotone_constraints", ("", "()")),
                       ("interaction_constraints", ("", "()", "[]"))):
        val = params.pop(key, None)
        if not _is_empty(val, empty):
            raise _not_in_slice(key, val)

    updater = params.pop("updater", None)
    if updater and "grow_colmaker" in str(updater):
        raise ValueError(
            "`grow_colmaker` updater doesn't support distributed training."
        )
    if updater is not None:
        raise _not_in_slice("updater", updater)
    feature_selector = params.pop("feature_selector", None)
    if feature_selector is not None:
        raise _not_in_slice("feature_selector", feature_selector)

    em = params.pop("eval_metric", None)
    if em is not None:
        out.eval_metric = [em] if isinstance(em, str) else list(em)

    for key, value in list(params.items()):
        name = _ALIASES.get(key, key)
        if name in _IGNORED:
            continue
        if name == "random_state":
            name = "seed"
        if not hasattr(out, name):
            logger.warning("Ignoring unknown xgboost parameter %r", key)
            continue
        field_type = type(getattr(TrainParams(), name))
        if value is not None:
            try:
                if name == "base_score":
                    value = float(value)
                elif field_type is bool:
                    value = (
                        value.strip().lower() in ("1", "true", "yes")
                        if isinstance(value, str)
                        else bool(value)
                    )
                elif field_type is float:
                    value = float(value)
                elif field_type is int:
                    value = int(value)
                elif field_type is str:
                    value = str(value)
            except (TypeError, ValueError):
                pass
        setattr(out, name, value)

    if out.hist_impl not in HIST_IMPLS:
        raise ValueError(
            f"Unknown hist_impl {out.hist_impl!r}; use one of "
            f"{' | '.join(HIST_IMPLS)}."
        )
    if out.hist_precision not in ("auto", "highest", "fast"):
        raise ValueError(
            f"Unknown hist_precision {out.hist_precision!r}; use auto | "
            f"highest | fast (the port accumulates in f32 for every value)."
        )
    if out.hist_quant not in (
        "none", "int16", "int8", "int16_block", "int8_block"
    ):
        raise ValueError(
            f"Unknown hist_quant {out.hist_quant!r}; use none | int16 | "
            f"int8 | int16_block | int8_block."
        )
    if out.gh_precision is None:
        out.gh_precision = "float32"
    if out.gh_precision not in ("float32", "int16", "int8"):
        raise ValueError(
            f"Unknown gh_precision {out.gh_precision!r}; use float32 | "
            f"int16 | int8."
        )
    if out.grow_policy not in ("depthwise", "lossguide"):
        raise ValueError(
            f"grow_policy must be 'depthwise' or 'lossguide'; got "
            f"{out.grow_policy!r}"
        )
    if out.booster not in ("gbtree", "dart", "gblinear"):
        raise ValueError(
            f"Unsupported booster: {out.booster!r} (gbtree, dart, or "
            f"gblinear)."
        )
    if out.subsample is None:
        out.subsample = 1.0
    if not 0.0 < out.subsample <= 1.0:
        raise ValueError(f"subsample must be in (0, 1]; got {out.subsample}")
    if out.max_leaves < 0:
        raise ValueError("max_leaves must be >= 0")
    if out.max_depth < 1:
        raise ValueError("max_depth must be >= 1")
    if out.max_depth > 14:
        raise ValueError(
            f"max_depth={out.max_depth} too large for the padded-heap "
            "learner (limit 14)."
        )
    if not 1 < out.max_bin <= 1024:
        raise ValueError("max_bin must be in (1, 1024]")
    if out.objective.startswith("multi:") and out.num_class < 2:
        raise ValueError("multi:* objectives require num_class >= 2")

    # --- outside this slice: raise, naming the key -------------------------
    for key, bad in (
        ("objective", out.objective not in SUPPORTED_OBJECTIVES),
        ("booster", out.booster != "gbtree"),
        ("grow_policy", out.grow_policy != "depthwise"),
        ("max_leaves", out.max_leaves > 0),
        ("gh_precision", out.gh_precision != "float32"),
        ("hist_quant", out.hist_quant != "none"),
        ("subsample", out.subsample < 1.0),
        ("sampling_method", out.sampling_method != "uniform"),
        ("colsample_bytree", out.colsample_bytree < 1.0),
        ("colsample_bylevel", out.colsample_bylevel < 1.0),
        ("colsample_bynode", out.colsample_bynode < 1.0),
        ("num_parallel_tree", out.num_parallel_tree != 1),
        ("num_class", out.num_class not in (0, 1)
         and not out.objective.startswith("multi:")),
        ("feature_parallel", int(out.feature_parallel or 1) != 1),
    ):
        if bad:
            raise _not_in_slice(key, getattr(out, key))
    multi = out.objective.startswith("multi:")
    for m in out.eval_metric:
        # the softmax metrics go with the softmax objectives, the others
        # with the one-output ones
        if m not in SUPPORTED_METRICS or (m in ("mlogloss", "merror")) != multi:
            raise _not_in_slice("eval_metric", m)
    return out
