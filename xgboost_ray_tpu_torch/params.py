"""xgboost-style parameter dict parsing and validation for the port.

``TrainParams`` has exactly the fields of the JAX package's dataclass
(``xgboost_ray_tpu/params.py:44``): the model JSON stores
``dataclasses.asdict(params)``, so the two packages read each other's model
files. ``parse_params`` follows ``xgboost_ray_tpu/params.py:254`` for the
keys of this slice (aliases, type coercion, the tree_method and range
checks) and raises ``NotImplementedError`` naming the key for every setting
the port does not run yet: nothing is silently ignored.
"""

import ast
import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence

from xgboost_ray_tpu_torch.constants import HIST_IMPLS, SUPPORTED_OBJECTIVES

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
    # parsed for compatibility; every value sums the same way: in f32 on
    # the CPU, in int64 fixed point on the card
    hist_precision: str = "auto"
    # the histogram merge's wire (ops/histogram.quantized_hist_allreduce)
    # and the gradients' precision at the source (ops/objectives.quantize_gh)
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


def _check_lossguide(out: TrainParams) -> None:
    """``max_leaves`` only with ``grow_policy='lossguide'``, and what the
    leaf-wise grower does not run, refused with the reference's messages
    (``xgboost_ray_tpu/params.py:522-545``)."""
    if out.grow_policy == "depthwise" and out.max_leaves > 0:
        raise NotImplementedError(
            "max_leaves with grow_policy='depthwise' (leaf-budget pruning of "
            "level-wise growth) is not supported; use "
            "grow_policy='lossguide' for a leaf budget, or drop max_leaves. "
            "Silently ignoring it would change model semantics."
        )
    if out.grow_policy != "lossguide":
        return
    for bad, name in (
        (out.colsample_bylevel < 1.0, "colsample_bylevel"),
        (out.colsample_bynode < 1.0, "colsample_bynode"),
        (bool(out.monotone_constraints) and any(out.monotone_constraints),
         "monotone_constraints"),
        (bool(out.interaction_constraints), "interaction_constraints"),
        (out.hist_impl not in ("auto", "onehot"),
         f"hist_impl={out.hist_impl!r}"),
    ):
        if bad:
            raise NotImplementedError(
                f"{name} is not supported with grow_policy='lossguide' "
                f"yet (level-wise only); silently ignoring it would "
                f"change model semantics."
            )


def leaf_budget(p: TrainParams) -> int:
    """The lossguide grower's leaf budget (``engine.py:314-322``):
    ``max_leaves`` (0: no budget) capped at 2^max_depth; 0 for depthwise
    growth."""
    if p.grow_policy != "lossguide":
        return 0
    full = 1 << p.max_depth
    return min(p.max_leaves or full, full)


def _not_in_slice(key: str, value: Any) -> NotImplementedError:
    return NotImplementedError(
        f"{key}={value!r} is not supported by xgboost_ray_tpu_torch yet "
        f"(this port runs gbtree with the objectives "
        f"{' | '.join(SUPPORTED_OBJECTIVES)}); use the JAX package "
        f"xgboost_ray_tpu for it."
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


def _parse_monotone_constraints(val: Any) -> tuple:
    """xgboost formats: "(1,-1,0)" string, or a sequence of -1/0/+1 ints
    (``xgboost_ray_tpu/params.py:204``). Length may be shorter than the
    feature count; the engine pads with 0 (unconstrained), matching
    xgboost."""
    if isinstance(val, str):
        items = [s for s in val.strip().strip("()").split(",") if s.strip()]
    elif isinstance(val, dict):
        raise ValueError(
            "dict-form monotone_constraints (by feature name) are not "
            "supported; pass a tuple/list indexed by feature position."
        )
    else:
        items = list(val)
    try:
        out = tuple(int(v) for v in items)
    except (TypeError, ValueError):
        raise ValueError(f"could not parse monotone_constraints: {val!r}")
    if any(c not in (-1, 0, 1) for c in out):
        raise ValueError(
            f"monotone_constraints entries must be -1, 0, or +1; got {out}"
        )
    return out


def _parse_interaction_constraints(val: Any) -> tuple:
    """xgboost format: "[[0, 1], [2, 3, 4]]" string or a nested sequence of
    feature indices (``xgboost_ray_tpu/params.py:228``). Feature names are
    not supported (index positions only)."""
    if isinstance(val, str):
        try:
            val = ast.literal_eval(val)
        except (SyntaxError, ValueError):
            raise ValueError(
                f"could not parse interaction_constraints string: {val!r}"
            )
    try:
        groups = tuple(
            tuple(sorted({int(i) for i in grp})) for grp in val
        )
    except (TypeError, ValueError):
        raise ValueError(
            f"interaction_constraints must be a sequence of index groups "
            f"(feature names are not supported); got {val!r}"
        )
    if any(i < 0 for grp in groups for i in grp):
        raise ValueError("interaction_constraints indices must be >= 0")
    return tuple(g for g in groups if g)


def _check_sampling(out: TrainParams, params: Dict[str, Any]) -> None:
    """Row and column sampling and parallel trees: the reference's defaults
    for None and its checks (``xgboost_ray_tpu/params.py:433-510``),
    ``gradient_based`` driven by ``subsample`` as xgboost drives it."""
    for key, default in (("subsample", 1.0), ("sampling_method", "uniform"),
                         ("top_rate", 0.2), ("other_rate", 0.1),
                         ("colsample_bytree", 1.0),
                         ("colsample_bylevel", 1.0),
                         ("colsample_bynode", 1.0),
                         ("num_parallel_tree", 1)):
        if getattr(out, key) is None:
            setattr(out, key, default)
    if not 0.0 < out.subsample <= 1.0:
        raise ValueError(f"subsample must be in (0, 1]; got {out.subsample}")
    if out.sampling_method not in ("uniform", "gradient_based"):
        raise ValueError(
            f"Unknown sampling_method {out.sampling_method!r}; use uniform "
            f"(subsample-rate row sampling) | gradient_based (GOSS: "
            f"top_rate/other_rate).")
    if not 0.0 <= out.top_rate <= 1.0 or not 0.0 <= out.other_rate <= 1.0:
        raise ValueError(
            f"top_rate/other_rate must be in [0, 1]; got "
            f"top_rate={out.top_rate} other_rate={out.other_rate}")
    had_rates = (params.get("top_rate") is not None
                 or params.get("other_rate") is not None)
    if out.sampling_method != "gradient_based" and had_rates:
        logger.warning(
            "top_rate/other_rate have no effect without "
            "sampling_method='gradient_based'; ignoring them.")
    if out.sampling_method == "gradient_based":
        if out.subsample < 1.0:
            if had_rates:
                raise ValueError(
                    "subsample < 1 is ambiguous with explicit "
                    "top_rate/other_rate under "
                    "sampling_method='gradient_based'; set either the "
                    "GOSS rates or subsample, not both.")
            out.top_rate = out.subsample / 2.0
            out.other_rate = out.subsample / 2.0
            out.subsample = 1.0
        elif not had_rates:
            logger.warning(
                "sampling_method='gradient_based' with subsample=1.0 and "
                "no top_rate/other_rate samples nothing (xgboost parity); "
                "set top_rate/other_rate (or subsample < 1) to enable "
                "GOSS.")
            out.sampling_method = "uniform"
    if out.sampling_method == "gradient_based":
        rate_sum = out.top_rate + out.other_rate
        if not 0.0 < rate_sum <= 1.0:
            raise ValueError(
                f"top_rate + other_rate must be in (0, 1] for "
                f"sampling_method='gradient_based'; got {rate_sum}")
    if int(out.num_parallel_tree) < 1:
        raise ValueError("num_parallel_tree must be >= 1")


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

    mono = params.pop("monotone_constraints", None)
    if not _is_empty(mono, ("", "()")):
        out.monotone_constraints = _parse_monotone_constraints(mono)
    ic = params.pop("interaction_constraints", None)
    if not _is_empty(ic, ("", "()", "[]")):
        out.interaction_constraints = _parse_interaction_constraints(ic)

    updater = params.pop("updater", None)
    if updater and "grow_colmaker" in str(updater):
        raise ValueError(
            "`grow_colmaker` updater doesn't support distributed training."
        )
    feature_selector = params.pop("feature_selector", None)
    had_lambda = any(k in params for k in ("lambda", "reg_lambda"))

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
            f"highest | fast (the port sums the same way for every value)."
        )
    # the reference's checks and messages (xgboost_ray_tpu/params.py:361-396)
    if out.hist_quant not in (
        "none", "int16", "int8", "int16_block", "int8_block"
    ):
        raise ValueError(
            f"Unknown hist_quant {out.hist_quant!r}; use none | int16 | "
            f"int8 | int16_block | int8_block (quantized histogram "
            f"allreduce wire format)."
        )
    if out.hist_quant_block is None:
        out.hist_quant_block = 512
    out.hist_quant_block = int(out.hist_quant_block)
    if (
        out.hist_quant_block < 64
        or out.hist_quant_block > (1 << 20)
        or out.hist_quant_block & (out.hist_quant_block - 1)
    ):
        raise ValueError(
            f"hist_quant_block must be a power of two in [64, 2^20], got "
            f"{out.hist_quant_block!r} (elements per in-band scale block "
            f"of the *_block wire modes)."
        )
    if out.gh_precision is None:
        out.gh_precision = "float32"
    if out.gh_precision not in ("float32", "int16", "int8"):
        raise ValueError(
            f"Unknown gh_precision {out.gh_precision!r}; use float32 | "
            f"int16 | int8 (on-chip quantized-gradient training)."
        )
    if out.gh_precision != "float32" and out.booster == "gblinear":
        raise NotImplementedError(
            "gh_precision quantizes the per-tree gradient/hessian plane; "
            "booster='gblinear' has no gh histogram plane to quantize. "
            "Use gh_precision='float32' (silently ignoring the knob would "
            "misreport the training precision)."
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
    if out.booster == "gblinear":
        if not had_lambda:
            out.reg_lambda = 0.0  # xgboost LinearTrainParam default
        if updater is not None and str(updater) not in ("shotgun",
                                                        "coord_descent"):
            raise ValueError(
                f"gblinear updater must be 'shotgun' or 'coord_descent'; "
                f"got {updater!r}"
            )
        if feature_selector is not None and str(feature_selector) != "cyclic":
            raise NotImplementedError(
                "gblinear feature_selector other than 'cyclic' is not "
                "supported (both updaters run the deterministic cyclic "
                "pass here)."
            )
        if out.grow_policy == "lossguide" or out.monotone_constraints or \
                out.interaction_constraints:
            raise NotImplementedError(
                "tree growth options (grow_policy/constraints) do not apply "
                "to booster='gblinear'."
            )
    if out.booster == "dart":
        if out.num_parallel_tree != 1:
            raise ValueError("dart does not support num_parallel_tree > 1")
        if out.normalize_type not in ("tree", "forest"):
            raise ValueError("normalize_type must be 'tree' or 'forest'")
        if out.sample_type not in ("uniform", "weighted"):
            raise ValueError("sample_type must be 'uniform' or 'weighted'")
    _check_sampling(out, params)
    if out.max_leaves < 0:
        raise ValueError("max_leaves must be >= 0")
    _check_lossguide(out)
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
    from xgboost_ray_tpu_torch.ops.metrics import check_metric, error_thresholds
    from xgboost_ray_tpu_torch.ops.objectives import objective_from_params

    for key, bad in (
        ("objective", out.objective not in SUPPORTED_OBJECTIVES),
        ("num_class", out.num_class not in (0, 1)
         and not out.objective.startswith("multi:")),
        ("feature_parallel", int(out.feature_parallel or 1) != 1),
    ):
        if bad:
            raise _not_in_slice(key, getattr(out, key))
    multi = out.objective.startswith("multi:")
    for m in out.eval_metric:
        # the softmax metrics go with the softmax objectives, the others
        # with the one-output and quantile ones
        check_metric(m, multi)
    error_thresholds(out.eval_metric)
    objective_from_params(out)  # the objective's own checks (alphas, AFT)
    return out
