"""xgboost-schema model interop: export and import xgboost's JSON format.

Port of ``xgboost_ray_tpu/models/xgb_export.py`` (``:27-401``):
``export_xgboost_json`` writes the xgboost >= 1.7 JSON model schema
(``learner.gradient_booster.model.trees[*]`` node arrays) and
``import_xgboost_json`` loads such a file, written by either package or by
xgboost itself, into a ``RayXGBoostBooster`` (the split rule is the same:
left iff ``x < split_condition``, missing follows ``default_left``; leaf
values are after the learning rate in both). ``objective_param_entry``
gives the schema's per-objective parameter block. Host code only (numpy):
the port keeps its own copy of the reference's schema code.
"""

import json
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_INT_MAX = 2147483647


def _tree_to_xgb(tree_np, t_id: int, num_feature: int,
                 learning_rate: float = 1.0,
                 leaf_scale: float = 1.0) -> Dict[str, Any]:
    """One padded-heap tree -> xgboost compact node-array dict (BFS ids).

    ``base_weights`` convention: xgboost stores PRE-learning-rate node
    weights (leaf value = eta * base_weight); this repo's Tree.base_weight is
    lr-scaled, so export divides by ``learning_rate``.

    ``leaf_scale`` folds the num_parallel_tree averaging into the stored
    values: xgboost core SUMS every tree's leaf, while this repo's predictor
    averages the ``num_parallel_tree`` trees of a round
    (``ops/predict.py``), so export writes ``value / npt`` (and import
    multiplies back). Scaling value and base_weight together keeps the
    leaf value/weight ratio — and hence the importer's eta recovery —
    intact."""
    feature = np.asarray(tree_np.feature)
    threshold = np.asarray(tree_np.threshold)
    default_left = np.asarray(tree_np.default_left)
    is_leaf = np.asarray(tree_np.is_leaf)
    value = np.asarray(tree_np.value)
    gain = np.asarray(tree_np.gain)
    cover = np.asarray(tree_np.cover)
    base_weight = np.asarray(tree_np.base_weight)

    heap = len(feature)

    def _internal(i):
        return (not bool(is_leaf[i])) and int(feature[i]) >= 0 and 2 * i + 2 < heap

    # BFS over reachable heap slots; compact ids in visit order (root = 0)
    ids: Dict[int, int] = {}
    order: List[int] = []
    queue = deque([0])
    while queue:
        h = queue.popleft()
        ids[h] = len(order)
        order.append(h)
        if _internal(h):
            queue.append(2 * h + 1)
            queue.append(2 * h + 2)

    n = len(order)
    left, right, parents = [], [], []
    split_idx, split_cond, dleft, losses, hess, bw = [], [], [], [], [], []
    for cid, h in enumerate(order):
        if _internal(h):
            left.append(ids[2 * h + 1])
            right.append(ids[2 * h + 2])
            split_idx.append(int(feature[h]))
            split_cond.append(float(threshold[h]))
            dleft.append(1 if bool(default_left[h]) else 0)
            losses.append(float(gain[h]))
        else:
            left.append(-1)
            right.append(-1)
            split_idx.append(0)
            split_cond.append(float(value[h]) * leaf_scale)  # leaf value lives here
            dleft.append(0)
            losses.append(0.0)
        hess.append(float(cover[h]))
        bw.append(float(base_weight[h]) * leaf_scale / max(learning_rate, 1e-12))
        if h == 0:
            parents.append(_INT_MAX)
        else:
            parents.append(ids[(h - 1) // 2])

    return {
        "base_weights": bw,
        "categories": [],
        "categories_nodes": [],
        "categories_segments": [],
        "categories_sizes": [],
        "default_left": dleft,
        "id": t_id,
        "left_children": left,
        "loss_changes": losses,
        "parents": parents,
        "right_children": right,
        "split_conditions": split_cond,
        "split_indices": split_idx,
        "split_type": [0] * n,
        "sum_hessian": hess,
        "tree_param": {
            "num_deleted": "0",
            "num_feature": str(num_feature),
            "num_nodes": str(n),
            "size_leaf_vector": "1",
        },
    }


_OBJECTIVE_PARAM_KEYS = {
    "reg:squarederror": ("reg_loss_param", {"scale_pos_weight": "1"}),
    "reg:squaredlogerror": ("reg_loss_param", {"scale_pos_weight": "1"}),
    "binary:logistic": ("reg_loss_param", {"scale_pos_weight": "1"}),
    "reg:logistic": ("reg_loss_param", {"scale_pos_weight": "1"}),
    "count:poisson": ("poisson_regression_param", {"max_delta_step": "0.7"}),
    "multi:softmax": ("softmax_multiclass_param", {"num_class": "0"}),
    "multi:softprob": ("softmax_multiclass_param", {"num_class": "0"}),
    "rank:pairwise": ("lambdarank_param", {}),
    "rank:ndcg": ("lambdarank_param", {}),
    "rank:map": ("lambdarank_param", {}),
    "survival:aft": ("aft_loss_param", {"aft_loss_distribution": "normal",
                                        "aft_loss_distribution_scale": "1"}),
    "reg:gamma": ("reg_loss_param", {"scale_pos_weight": "1"}),
    "reg:tweedie": ("tweedie_regression_param", {"tweedie_variance_power": "1.5"}),
}


def objective_param_entry(params) -> Tuple[str, str, Dict[str, str]]:
    """``(objective_name, param_key, param_dict)`` for the xgboost JSON
    schema's ``learner.objective`` block.

    Real xgboost's objective loader expects a DIFFERENT param key per
    objective family (``softmax_multiclass_param`` with ``num_class``,
    ``poisson_regression_param``, ...); hardcoding ``reg_loss_param``
    produces files that misload for anything beyond plain regression.
    """
    obj_name = str(params.objective)
    pkey, pdefault = _OBJECTIVE_PARAM_KEYS.get(
        obj_name, ("reg_loss_param", {"scale_pos_weight": "1"})
    )
    pval = dict(pdefault)
    if pkey == "softmax_multiclass_param":
        pval["num_class"] = str(int(params.num_class or 0))
    if pkey == "aft_loss_param":
        pval["aft_loss_distribution"] = str(params.aft_loss_distribution)
        pval["aft_loss_distribution_scale"] = str(
            params.aft_loss_distribution_scale
        )
    return obj_name, pkey, pval


def export_xgboost_json(booster, fname: Optional[str] = None) -> str:
    """Serialize ``booster`` in the xgboost JSON model schema. Returns the
    JSON string; also writes it to ``fname`` when given."""
    booster._assert_node_stats()
    forest = booster.forest
    num_feature = booster.num_features
    k = max(1, int(booster.params.num_class or 0)) if str(
        booster.params.objective).startswith("multi:") else 1
    npt = int(booster.params.num_parallel_tree or 1)
    per_round = k * npt

    n_trees = int(np.asarray(forest.feature).shape[0])
    lr = float(getattr(booster.params, "learning_rate", 1.0) or 1.0)
    trees = []
    tree_info = []
    for t in range(n_trees):
        tree_np = type(forest)(*[np.asarray(f)[t] for f in forest])
        trees.append(_tree_to_xgb(tree_np, t, num_feature, learning_rate=lr,
                                  leaf_scale=1.0 / npt))
        tree_info.append((t % per_round) // npt if k > 1 else 0)

    rounds = max(1, n_trees // per_round)
    iteration_indptr = [r * per_round for r in range(rounds + 1)]

    obj_name, pkey, pval = objective_param_entry(booster.params)

    gbtree_model = {
        "gbtree_model_param": {
            "num_parallel_tree": str(npt),
            "num_trees": str(n_trees),
        },
        "iteration_indptr": iteration_indptr,
        "tree_info": tree_info,
        "trees": trees,
    }
    if booster.tree_weights is not None:  # dart
        gradient_booster = {
            "name": "dart",
            "gbtree": {"model": gbtree_model},
            "weight_drop": [float(w) for w in np.asarray(booster.tree_weights)],
        }
    else:
        gradient_booster = {"name": "gbtree", "model": gbtree_model}

    doc = {
        "learner": {
            "attributes": {
                str(a): str(b) for a, b in booster.attributes().items()
            },
            "feature_names": list(booster.feature_names or []),
            "feature_types": [],
            "gradient_booster": gradient_booster,
            "learner_model_param": {
                "base_score": str(float(booster.base_score)),
                "boost_from_average": "1",
                "num_class": str(int(booster.params.num_class or 0)),
                "num_feature": str(num_feature),
                "num_target": "1",
            },
            "objective": {"name": obj_name, pkey: pval},
        },
        "version": [2, 0, 0],
    }
    out = json.dumps(doc)
    if fname:
        with open(fname, "w") as f:
            f.write(out)
    return out


def _xgb_tree_to_heap(t: Dict[str, Any],
                      leaf_scale: float = 1.0) -> Tuple[Dict[str, np.ndarray], int]:
    """One xgboost node-array tree -> padded-heap field dict + depth.

    ``leaf_scale`` is ``num_parallel_tree`` on import: xgboost files store
    sum-convention leaves (core sums all trees), while this repo's predictor
    divides each round's trees by npt — multiplying the stored values back
    up makes both conventions produce the same margin."""
    left = t["left_children"]
    right = t["right_children"]
    n = len(left)

    # depth of the compact tree: node order in xgboost dumps is not
    # guaranteed parent-before-child, so walk from the root
    max_depth = 0
    stack = [(0, 0)]
    while stack:
        nid, d = stack.pop()
        max_depth = max(max_depth, d)
        if left[nid] != -1:
            stack.append((left[nid], d + 1))
            stack.append((right[nid], d + 1))
    if max_depth > 16:
        # the padded heap is 2^(depth+1) slots per tree: a lossguide-grown
        # xgboost model with depth 25-60 would allocate GBs/TBs — fail with
        # the reason instead of a MemoryError deep in the allocator
        raise ValueError(
            f"imported tree has depth {max_depth}; the padded-heap layout "
            f"supports depth <= 16 (2^(d+1) slots/tree). Re-train with "
            f"bounded depth (e.g. grow_policy='depthwise', max_depth<=16)."
        )
    heap = (1 << (max_depth + 1)) - 1

    fields = {
        "feature": np.full(heap, -1, np.int32),
        "split_bin": np.zeros(heap, np.int32),
        "threshold": np.zeros(heap, np.float32),
        "default_left": np.zeros(heap, bool),
        "is_leaf": np.zeros(heap, bool),
        "value": np.zeros(heap, np.float32),
        "gain": np.zeros(heap, np.float32),
        "cover": np.zeros(heap, np.float32),
        "base_weight": np.zeros(heap, np.float32),
    }
    sc = t["split_conditions"]
    si = t["split_indices"]
    dl = t["default_left"]
    lc = t.get("loss_changes", [0.0] * n)
    sh = t.get("sum_hessian", [0.0] * n)
    bw = t.get("base_weights", [0.0] * n)

    # xgboost base_weights are PRE-learning-rate (leaf value = eta * weight);
    # this repo's convention is lr-scaled (base_weight == value at leaves).
    # The schema does not store eta, so recover the scale from the leaves'
    # value/weight ratios (median for robustness; 1.0 when degenerate, e.g.
    # our own exports round-tripped or an all-zero-weight tree).
    ratios = [
        sc[i] / bw[i]
        for i in range(n)
        if left[i] == -1 and abs(bw[i]) > 1e-12
    ]
    eta_scale = float(np.median(ratios)) if ratios else 1.0
    if not np.isfinite(eta_scale) or eta_scale <= 0:
        eta_scale = 1.0

    stack = [(0, 0)]  # (compact id, heap slot)
    while stack:
        nid, h = stack.pop()
        fields["cover"][h] = sh[nid]
        fields["base_weight"][h] = bw[nid] * eta_scale * leaf_scale
        if left[nid] == -1:
            fields["is_leaf"][h] = True
            fields["value"][h] = sc[nid] * leaf_scale
            # exact convention: base_weight equals the leaf value at leaves
            fields["base_weight"][h] = sc[nid] * leaf_scale
        else:
            fields["feature"][h] = si[nid]
            fields["threshold"][h] = sc[nid]
            fields["default_left"][h] = bool(dl[nid])
            fields["gain"][h] = lc[nid]
            stack.append((left[nid], 2 * h + 1))
            stack.append((right[nid], 2 * h + 2))
    return fields, max_depth


def import_xgboost_json(data) -> "RayXGBoostBooster":
    """Load an xgboost JSON model (path, JSON string, or parsed dict) into a
    RayXGBoostBooster. Works for models written by ``export_xgboost_json``
    AND by real xgboost (gbtree/dart, numeric splits)."""
    from xgboost_ray_tpu_torch.models.booster import RayXGBoostBooster
    from xgboost_ray_tpu_torch.ops.grow import Tree
    from xgboost_ray_tpu_torch.params import TrainParams

    if isinstance(data, dict):
        doc = data
    else:
        text = data
        if isinstance(data, str) and not data.lstrip().startswith("{"):
            with open(data) as f:
                text = f.read()
        doc = json.loads(text)

    learner = doc["learner"]
    gb = learner["gradient_booster"]
    weight_drop = None
    if gb.get("name") == "dart":
        weight_drop = np.asarray(gb["weight_drop"], np.float32)
        model = gb["gbtree"]["model"]
    else:
        model = gb["model"]
    trees_json = model["trees"]
    if any(any(t.get("split_type", [])) for t in trees_json):
        raise ValueError(
            "model contains categorical (partition) splits; only numeric "
            "splits are supported by the importer."
        )

    npt = max(1, int(
        model.get("gbtree_model_param", {}).get("num_parallel_tree", "1") or 1))
    per_tree = [_xgb_tree_to_heap(t, leaf_scale=float(npt)) for t in trees_json]
    max_depth = max((d for _, d in per_tree), default=1)
    max_depth = max(max_depth, 1)
    heap = (1 << (max_depth + 1)) - 1

    def _pad(fields):
        out = {}
        for k, v in fields.items():
            if len(v) < heap:
                pad_val = -1 if k == "feature" else 0
                padded = np.full(heap, pad_val, v.dtype)
                # heap layout is depth-contiguous: smaller heaps are prefixes
                padded[: len(v)] = v
                out[k] = padded
            else:
                out[k] = v
        return out

    padded = [_pad(f) for f, _ in per_tree]
    stacked = {
        k: np.stack([p[k] for p in padded])
        for k in per_tree[0][0]
    } if per_tree else {
        k: np.zeros((0, heap), np.float32) for k in (
            "feature", "split_bin", "threshold", "default_left", "is_leaf",
            "value", "gain", "cover", "base_weight")
    }
    forest = Tree(**{k: stacked[k] for k in Tree._fields})

    lmp = learner["learner_model_param"]
    obj = learner.get("objective", {}).get("name", "reg:squarederror")
    params = TrainParams()
    params.objective = obj
    params.num_class = int(lmp.get("num_class", "0") or 0)
    params.max_depth = max_depth
    params.num_parallel_tree = npt
    if weight_drop is not None:
        params.booster = "dart"
    num_feature = int(lmp.get("num_feature", "0") or 0)

    booster = RayXGBoostBooster(
        forest=forest,
        cuts=np.zeros((max(num_feature, 1), 1), np.float32),
        params=params,
        base_score=float(lmp.get("base_score", "0.5") or 0.5),
        feature_names=list(learner.get("feature_names") or []) or None,
        tree_weights=weight_drop,
    )
    for key, val in (learner.get("attributes") or {}).items():
        booster.set_attr(**{key: val})
    return booster
