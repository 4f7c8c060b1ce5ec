"""xgboost-JSON interop of the port (``models/xgb_export.py``) on the CPU.

The cases of ``tests/test_xgb_interop.py`` that need no ``xgboost``,
re-aimed at the port: the exported schema's shape, round trips (binary,
multiclass tree order, DART weights, ``num_parallel_tree``'s sum
convention), the hand-written external-style and golden models (their
expected margins from an independent walker of the file format), the
categorical-split refusal and the depth limit, and ``get_dump(dump_format=
"json")``. Then the cross-package round trips: a JAX export imported by the
port and a port export imported by the JAX package, each with equal trees
and predictions (bitwise where both walk the same forest), and a served
model hot-swapped to an xgboost-JSON file.
"""

import dataclasses
import json

import numpy as np
import pytest

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu_torch import serve
from xgboost_ray_tpu_torch.convert import booster_from_jax_state
from xgboost_ray_tpu_torch.models.booster import RayXGBoostBooster

CPU = "cpu"
TRP = tx.RayParams(num_actors=1)
JRP = jx.RayParams(num_actors=1)


def _binary_model(rounds=6):
    rng = np.random.RandomState(0)
    x = rng.randn(300, 5).astype(np.float32)
    y = (x[:, 0] + 0.4 * x[:, 1] > 0).astype(np.float32)
    bst = tx.train({"objective": "binary:logistic", "max_depth": 3,
                    "eta": 0.4}, tx.RayDMatrix(x, y), rounds, ray_params=TRP,
                   device=CPU)
    return bst, x


@pytest.fixture(scope="module")
def binary():
    return _binary_model()


def _jax_converted(params, x, y, rounds):
    jb = jx.train(params, jx.RayDMatrix(x, y), rounds, ray_params=JRP)
    tb = booster_from_jax_state(
        jb.forest._asdict(), jb.cuts, jb.base_score,
        dataclasses.asdict(jb.params), tree_weights=jb.tree_weights,
        feature_names=jb.feature_names)
    return jb, tb


def test_export_schema_shape(binary):
    bst, _ = binary
    doc = json.loads(bst.export_xgboost_json())
    assert doc["version"][0] >= 1
    learner = doc["learner"]
    model = learner["gradient_booster"]["model"]
    assert learner["gradient_booster"]["name"] == "gbtree"
    assert int(model["gbtree_model_param"]["num_trees"]) == len(model["trees"])
    assert len(model["tree_info"]) == len(model["trees"])
    assert int(learner["learner_model_param"]["num_feature"]) == 5
    assert learner["objective"]["name"] == "binary:logistic"
    for t in model["trees"]:
        n = int(t["tree_param"]["num_nodes"])
        for key in ("left_children", "right_children", "split_conditions",
                    "split_indices", "default_left", "parents",
                    "sum_hessian", "base_weights", "loss_changes"):
            assert len(t[key]) == n, key
        internal = [i for i in range(n) if t["left_children"][i] != -1]
        leaves = [i for i in range(n) if t["left_children"][i] == -1]
        assert len(leaves) == len(internal) + 1
        for i in internal:
            l, r = t["left_children"][i], t["right_children"][i]
            assert t["parents"][l] == i and t["parents"][r] == i
        assert t["parents"][0] == 2147483647
        assert all(0 <= t["split_indices"][i] < 5 for i in internal)
        assert t["sum_hessian"][0] > 0


def test_roundtrip_binary_prediction_parity(binary, tmp_path):
    bst, x = binary
    path = str(tmp_path / "m.xgb.json")
    bst.export_xgboost_json(path)
    back = RayXGBoostBooster.import_xgboost_json(path)
    assert np.array_equal(back.predict(x, output_margin=True, device=CPU),
                          bst.predict(x, output_margin=True, device=CPU))
    assert np.array_equal(back.predict(x, device=CPU),
                          bst.predict(x, device=CPU))
    # node statistics survive the learning-rate convention: contributions
    # of the imported model are the original's and sum to the margin
    contribs = back.predict(x[:16], pred_contribs=True, device=CPU)
    np.testing.assert_allclose(
        contribs, bst.predict(x[:16], pred_contribs=True, device=CPU),
        atol=1e-4)
    np.testing.assert_allclose(
        contribs.sum(axis=-1),
        back.predict(x[:16], output_margin=True, device=CPU), atol=1e-4)


def test_roundtrip_multiclass_tree_info():
    rng = np.random.RandomState(1)
    n = 150
    y = rng.randint(0, 3, n).astype(np.float32)
    x = (np.eye(3, dtype=np.float32)[y.astype(int)]
         + 0.05 * rng.randn(n, 3).astype(np.float32))
    bst = tx.train({"objective": "multi:softprob", "num_class": 3,
                    "max_depth": 3}, tx.RayDMatrix(x, y), 4, ray_params=TRP,
                   device=CPU)
    doc = json.loads(bst.export_xgboost_json())
    info = doc["learner"]["gradient_booster"]["model"]["tree_info"]
    assert info == [0, 1, 2] * 4
    back = RayXGBoostBooster.import_xgboost_json(doc)
    assert np.array_equal(back.predict(x, device=CPU),
                          bst.predict(x, device=CPU))
    assert back.predict(x, device=CPU).shape == (n, 3)


def _rows4():
    rng = np.random.RandomState(2)
    return rng.randn(200, 4).astype(np.float32)


def test_roundtrip_dart_weight_drop():
    x = _rows4()
    y = (x[:, 0] > 0).astype(np.float32)
    _, dart = _jax_converted({"objective": "binary:logistic",
                              "booster": "dart", "rate_drop": 0.2,
                              "max_depth": 3, "seed": 0}, x, y, 3)
    doc = json.loads(dart.export_xgboost_json())
    gb = doc["learner"]["gradient_booster"]
    assert gb["name"] == "dart" and len(gb["weight_drop"]) == 3
    back = RayXGBoostBooster.import_xgboost_json(doc)
    assert back.tree_weights is not None
    np.testing.assert_allclose(
        back.predict(x, output_margin=True, device=CPU),
        dart.predict(x, output_margin=True, device=CPU), atol=1e-5)


def test_num_parallel_tree_sum_convention_parity():
    """npt > 1: the port averages a round's trees, xgboost sums every
    tree, so the export folds 1/npt into the leaves and the import
    multiplies it back; checked against a sum-convention walker of the
    file."""
    x = _rows4()
    _, npt = _jax_converted({"objective": "reg:squarederror",
                             "max_depth": 3, "num_parallel_tree": 3,
                             "subsample": 0.8, "seed": 0}, x,
                            x[:, 0] - 0.5 * x[:, 2], 4)
    doc = json.loads(npt.export_xgboost_json())
    model = doc["learner"]["gradient_booster"]["model"]
    assert int(model["gbtree_model_param"]["num_parallel_tree"]) == 3
    assert len(model["trees"]) == 12
    ours = npt.predict(x, output_margin=True, device=CPU)
    theirs = _xgb_core_margin(doc, x) + npt.base_score_margin_np()
    np.testing.assert_allclose(theirs, ours, atol=1e-4)
    back = RayXGBoostBooster.import_xgboost_json(doc)
    assert back.params.num_parallel_tree == 3
    np.testing.assert_allclose(
        back.predict(x, output_margin=True, device=CPU), ours, atol=1e-4)


def test_import_external_asymmetric_tree():
    """Hand-written external-style model: a depth-2 ASYMMETRIC tree (left
    child is a leaf, right child splits again) — the shape real xgboost
    emits and our padded heap must absorb. Predictions checked by hand."""
    #        n0: x1 < 0.5 ? (missing -> left)
    #       /                \
    #   n1: leaf +1.0     n2: x0 < 2.0 ?
    #                     /            \
    #                 n3: leaf -1.0  n4: leaf +3.0
    tree = {
        "base_weights": [0.1, 1.0, 0.2, -1.0, 3.0],
        "categories": [], "categories_nodes": [],
        "categories_segments": [], "categories_sizes": [],
        "default_left": [1, 0, 0, 0, 0],
        "id": 0,
        "left_children": [1, -1, 3, -1, -1],
        "right_children": [2, -1, 4, -1, -1],
        "loss_changes": [5.0, 0.0, 2.0, 0.0, 0.0],
        "parents": [2147483647, 0, 0, 2, 2],
        "split_conditions": [0.5, 1.0, 2.0, -1.0, 3.0],
        "split_indices": [1, 0, 0, 0, 0],
        "split_type": [0, 0, 0, 0, 0],
        "sum_hessian": [10.0, 6.0, 4.0, 3.0, 1.0],
        "tree_param": {"num_deleted": "0", "num_feature": "2",
                       "num_nodes": "5", "size_leaf_vector": "1"},
    }
    doc = {
        "learner": {
            "attributes": {},
            "feature_names": ["a", "b"],
            "feature_types": [],
            "gradient_booster": {
                "name": "gbtree",
                "model": {
                    "gbtree_model_param": {"num_parallel_tree": "1",
                                           "num_trees": "1"},
                    "iteration_indptr": [0, 1],
                    "tree_info": [0],
                    "trees": [tree],
                },
            },
            "learner_model_param": {"base_score": "0.0",
                                    "boost_from_average": "1",
                                    "num_class": "0", "num_feature": "2",
                                    "num_target": "1"},
            "objective": {"name": "reg:squarederror",
                          "reg_loss_param": {"scale_pos_weight": "1"}},
        },
        "version": [2, 0, 0],
    }
    back = RayXGBoostBooster.import_xgboost_json(json.dumps(doc))
    assert back.feature_names == ["a", "b"]
    x = np.array([
        [0.0, 0.0],   # x1<0.5 -> leaf +1
        [1.0, 1.0],   # x1>=0.5, x0<2 -> leaf -1
        [5.0, 1.0],   # x1>=0.5, x0>=2 -> leaf +3
        [np.nan, np.nan],  # missing x1 -> default left -> +1
    ], np.float32)
    np.testing.assert_allclose(
        back.predict(x, output_margin=True, device=CPU), [1.0, -1.0, 3.0, 1.0],
        atol=1e-6
    )


def test_import_rejects_categorical_splits():
    doc = {"learner": {"attributes": {}, "feature_names": [],
                       "feature_types": [],
                       "gradient_booster": {"name": "gbtree", "model": {
                           "gbtree_model_param": {"num_parallel_tree": "1",
                                                  "num_trees": "1"},
                           "tree_info": [0],
                           "trees": [{"left_children": [-1],
                                      "right_children": [-1],
                                      "split_conditions": [1.0],
                                      "split_indices": [0],
                                      "default_left": [0],
                                      "parents": [2147483647],
                                      "split_type": [1],
                                      "sum_hessian": [1.0],
                                      "base_weights": [1.0],
                                      "loss_changes": [0.0],
                                      "tree_param": {"num_nodes": "1"}}]}},
                       "learner_model_param": {"base_score": "0.5",
                                               "num_class": "0",
                                               "num_feature": "1"},
                       "objective": {"name": "reg:squarederror"}},
           "version": [2, 0, 0]}
    with pytest.raises(ValueError, match="categorical"):
        RayXGBoostBooster.import_xgboost_json(doc)


def test_get_dump_json_format(binary):
    """get_dump(dump_format='json') emits xgboost's nested node dicts."""
    bst, _ = binary
    dumps = bst.get_dump(with_stats=True, dump_format="json")
    assert len(dumps) == bst.num_trees
    for d in dumps:
        root = json.loads(d)
        assert root["nodeid"] == 0
        if "leaf" not in root:
            assert root["split"].startswith("f")
            assert {"split_condition", "yes", "no", "missing",
                    "children", "gain", "cover"} <= set(root)
            # leaves reachable, each with a value
            stack = [root]
            leaves = 0
            while stack:
                n = stack.pop()
                if "leaf" in n:
                    leaves += 1
                else:
                    stack.extend(n["children"])
            assert leaves >= 2
    with pytest.raises(ValueError, match="dump_format"):
        bst.get_dump(dump_format="dot")


def _xgb_core_margin(doc, x):
    """Emulate real xgboost core prediction on an exported JSON doc: walk
    every tree (go left iff x < split_condition, missing -> default_left)
    and SUM all leaf values — the sum convention of xgboost's predictor,
    which does not divide by num_parallel_tree. Used to pin the interop
    leaf-scaling convention without xgboost in the image."""
    model = doc["learner"]["gradient_booster"]["model"]
    out = np.zeros(len(x), np.float64)
    for t in model["trees"]:
        left, right = t["left_children"], t["right_children"]
        cond, feat = t["split_conditions"], t["split_indices"]
        dleft = t["default_left"]
        for r, row in enumerate(x):
            nid = 0
            while left[nid] != -1:
                v = row[feat[nid]]
                if np.isnan(v):
                    nid = left[nid] if dleft[nid] else right[nid]
                else:
                    nid = left[nid] if v < cond[nid] else right[nid]
            out[r] += cond[nid]
    return out


def _mk_tree(t_id, left, right, cond, feat, dleft, bw=None, nf=3):
    n = len(left)
    return {
        "base_weights": bw or [0.0] * n,
        "categories": [], "categories_nodes": [],
        "categories_segments": [], "categories_sizes": [],
        "default_left": dleft, "id": t_id,
        "left_children": left, "right_children": right,
        "loss_changes": [1.0] * n,
        "parents": [2147483647] + [0] * (n - 1),  # parents unused on import
        "split_conditions": cond, "split_indices": feat,
        "split_type": [0] * n, "sum_hessian": [1.0] * n,
        "tree_param": {"num_deleted": "0", "num_feature": str(nf),
                       "num_nodes": str(n), "size_leaf_vector": "1"},
    }


def _mk_doc(trees, tree_info, objective="reg:squarederror", base_score="0.0",
            num_class="0", npt="1", booster="gbtree", weight_drop=None, nf=3,
            per_round=1):
    # iteration_indptr strides by trees-per-round (k * npt), the layout real
    # xgboost emits — e.g. [0, 3, 6] for 2 rounds of 3 class trees
    rounds = max(1, len(trees) // per_round)
    model = {
        "gbtree_model_param": {"num_parallel_tree": npt,
                               "num_trees": str(len(trees))},
        "iteration_indptr": [r * per_round for r in range(rounds + 1)],
        "tree_info": tree_info,
        "trees": trees,
    }
    if booster == "dart":
        gb = {"name": "dart", "gbtree": {"model": model},
              "weight_drop": weight_drop}
    else:
        gb = {"name": "gbtree", "model": model}
    return {
        "learner": {
            "attributes": {}, "feature_names": [], "feature_types": [],
            "gradient_booster": gb,
            "learner_model_param": {"base_score": base_score,
                                    "boost_from_average": "1",
                                    "num_class": num_class,
                                    "num_feature": str(nf),
                                    "num_target": "1"},
            "objective": {"name": objective,
                          "reg_loss_param": {"scale_pos_weight": "1"}},
        },
        "version": [2, 0, 0],
    }


def test_import_golden_deep_asymmetric_chain():
    """Depth-5 right-spine chain (every left child a leaf) — the extreme
    lossguide shape; node ids deliberately NOT in heap order."""
    #  n0: x0<1 ? leaf(0.1) : n2: x0<2 ? leaf(0.2) : n4: x0<3 ? ... depth 5
    left = [1, -1, 3, -1, 5, -1, 7, -1, 9, -1, -1]
    right = [2, -1, 4, -1, 6, -1, 8, -1, 10, -1, -1]
    cond = [1.0, 0.1, 2.0, 0.2, 3.0, 0.3, 4.0, 0.4, 5.0, 0.5, 0.6]
    feat = [0] * 11
    dleft = [1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0]
    doc = _mk_doc([_mk_tree(0, left, right, cond, feat, dleft)], [0])
    back = RayXGBoostBooster.import_xgboost_json(doc)
    x = np.array([[0.5, 0, 0], [1.5, 0, 0], [2.5, 0, 0], [3.5, 0, 0],
                  [4.5, 0, 0], [9.0, 0, 0], [np.nan, 0, 0]], np.float32)
    got = back.predict(x, output_margin=True, device=CPU)
    want = _xgb_core_margin(doc, x)  # base_score 0 margin
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(
        got, [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.1], atol=1e-6
    )


def _xgb_core_margin_multi(doc, x, num_class):
    """Per-class sum-convention walker (tree_info routes trees to classes)."""
    model = doc["learner"]["gradient_booster"]["model"]
    info = model["tree_info"]
    out = np.zeros((len(x), num_class), np.float64)
    for t, tree in enumerate(model["trees"]):
        one = _xgb_core_margin(
            {"learner": {"gradient_booster": {"model": {"trees": [tree]}}}}, x
        )
        out[:, info[t]] += one
    return out


def test_import_golden_multiclass_tree_info_order():
    """3-class softprob, 2 rounds: tree_info [0,1,2,0,1,2] must route each
    tree's leaves into its class margin in round-major order."""
    trees, info = [], []
    for r in range(2):
        for k in range(3):
            v = 0.1 * (r + 1) + k  # distinct leaf per (round, class)
            trees.append(_mk_tree(len(trees), [1, -1, -1], [2, -1, -1],
                                  [0.0, -v, v], [0, 0, 0], [0, 0, 0]))
            info.append(k)
    doc = _mk_doc(trees, info, objective="multi:softprob", num_class="3",
                  per_round=3)
    back = RayXGBoostBooster.import_xgboost_json(doc)
    assert back.params.num_class == 3
    x = np.array([[1.0, 0, 0], [-1.0, 0, 0]], np.float32)
    want = _xgb_core_margin_multi(doc, x, 3)
    got = back.predict(x, output_margin=True, device=CPU)
    np.testing.assert_allclose(got, want, atol=1e-6)
    probs = back.predict(x, device=CPU)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-6)


def test_import_golden_dart_weight_drop_scaling():
    """dart: prediction must scale each tree by its weight_drop entry."""
    t0 = _mk_tree(0, [1, -1, -1], [2, -1, -1], [0.0, -1.0, 1.0],
                  [0, 0, 0], [0, 0, 0])
    t1 = _mk_tree(1, [1, -1, -1], [2, -1, -1], [0.0, -10.0, 10.0],
                  [1, 0, 0], [0, 0, 0])
    doc = _mk_doc([t0, t1], [0, 0], booster="dart", weight_drop=[0.5, 0.25])
    back = RayXGBoostBooster.import_xgboost_json(doc)
    x = np.array([[1.0, 1.0, 0], [-1.0, -1.0, 0], [1.0, -1.0, 0]], np.float32)
    # weighted sums: 0.5*t0 + 0.25*t1
    want = np.array([0.5 + 2.5, -0.5 - 2.5, 0.5 - 2.5])
    np.testing.assert_allclose(
        back.predict(x, output_margin=True, device=CPU), want, atol=1e-6
    )


def test_import_golden_base_score_not_half():
    """binary:logistic with base_score=0.2: the margin offset is
    logit(0.2), not 0.2 — the transform real xgboost applies."""
    t0 = _mk_tree(0, [1, -1, -1], [2, -1, -1], [0.0, -0.7, 0.7],
                  [0, 0, 0], [0, 0, 0])
    doc = _mk_doc([t0], [0], objective="binary:logistic", base_score="0.2")
    back = RayXGBoostBooster.import_xgboost_json(doc)
    x = np.array([[1.0, 0, 0], [-1.0, 0, 0]], np.float32)
    logit = np.log(0.2 / 0.8)
    want_margin = logit + np.array([0.7, -0.7])
    np.testing.assert_allclose(
        back.predict(x, output_margin=True, device=CPU), want_margin, atol=1e-5
    )
    np.testing.assert_allclose(
        back.predict(x, device=CPU), 1 / (1 + np.exp(-want_margin)), atol=1e-5
    )




def test_import_rejects_trees_deeper_than_the_heap():
    n = 35  # a right spine of depth 17
    left = [-1] * n
    right = [-1] * n
    for d in range(17):
        left[2 * d] = 2 * d + 1
        right[2 * d] = 2 * d + 2
    doc = _mk_doc([_mk_tree(0, left, right, [0.5] * n, [0] * n, [0] * n)],
                  [0])
    with pytest.raises(ValueError, match="depth"):
        RayXGBoostBooster.import_xgboost_json(doc)


def test_objective_param_entry_matches_jax():
    from xgboost_ray_tpu.models.xgb_export import (
        objective_param_entry as jax_entry)
    from xgboost_ray_tpu.params import TrainParams as JParams
    from xgboost_ray_tpu_torch.models.xgb_export import objective_param_entry
    from xgboost_ray_tpu_torch.params import TrainParams

    for obj, k in (("binary:logistic", 0), ("multi:softprob", 7),
                   ("reg:squarederror", 0), ("count:poisson", 0),
                   ("survival:aft", 0)):
        p, jp = TrainParams(), JParams()
        p.objective = jp.objective = obj
        p.num_class = jp.num_class = k
        assert objective_param_entry(p) == jax_entry(jp)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(4)
    x = rng.randn(250, 6).astype(np.float32)
    x[rng.rand(250, 6) < 0.1] = np.nan
    y = (np.nan_to_num(x[:, 0]) + np.nan_to_num(x[:, 3]) > 0).astype(
        np.float32)
    jb, tb = _jax_converted({"objective": "binary:logistic",
                             "max_depth": 4}, x, y, 6)
    return jb, tb, x


def test_jax_export_imported_by_the_port(pair):
    jb, tb, x = pair
    back = RayXGBoostBooster.import_xgboost_json(jb.export_xgboost_json())
    for name in ("feature", "threshold", "default_left", "is_leaf",
                 "value", "cover"):
        assert np.array_equal(getattr(back.forest, name),
                              getattr(tb.forest, name)), name
    assert np.array_equal(back.predict(x, output_margin=True, device=CPU),
                          tb.predict(x, output_margin=True, device=CPU))
    np.testing.assert_allclose(back.predict(x, device=CPU), jb.predict(x),
                               atol=1e-6)
    np.testing.assert_allclose(
        back.predict(x, pred_contribs=True, device=CPU),
        jb.predict(x, pred_contribs=True), atol=1e-5)


def test_port_export_imported_by_jax(pair):
    jb, tb, x = pair
    doc = tb.export_xgboost_json()
    assert doc == jb.export_xgboost_json()
    back = jx.RayXGBoostBooster.import_xgboost_json(doc)
    for name in ("feature", "threshold", "default_left", "is_leaf",
                 "value", "cover"):
        assert np.array_equal(np.asarray(getattr(back.forest, name)),
                              getattr(tb.forest, name)), name
    assert np.array_equal(back.predict(x, output_margin=True),
                          jb.predict(x, output_margin=True))
    np.testing.assert_allclose(back.predict(x), tb.predict(x, device=CPU),
                               atol=1e-6)


def test_post_models_hot_swaps_to_an_xgboost_json_file(binary, tmp_path):
    import urllib.request

    bst, x = binary
    other, _ = _binary_model(rounds=3)
    path = str(tmp_path / "other.xgb.json")
    other.export_xgboost_json(path)
    h = serve.create_server(bst, max_batch=32, device=CPU)
    try:
        req = urllib.request.Request(
            h.url + "/models", json.dumps({"path": path}).encode("utf-8"),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read())["model_version"] == 2
        req = urllib.request.Request(
            h.url + "/predict",
            json.dumps({"data": x[:4].tolist(), "kind": "margin"}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            got = np.asarray(json.loads(r.read())["predictions"], np.float32)
        assert np.array_equal(got, other.predict(x[:4], output_margin=True,
                                                 device=CPU))
    finally:
        h.shutdown()
