"""SHAP values of the port (``ops/shap.py``, the CPU side of kernel B15)
against the JAX package, on the CPU.

The same JAX-trained models (carried over with
``convert.booster_from_jax_state`` and by saved file) predict
contributions (exact and Saabas) and interaction values in both packages:
binary, ``reg:squarederror`` and ``multi:softprob`` (K = 3), depths 1 to
4, NaN features, ``iteration_range``, ``base_margin``, DART tree weights
and ``num_parallel_tree`` 2. Then ``tests/test_shap.py``'s checks re-aimed
at the port: the brute-force Shapley oracles, efficiency (rows sum to the
margin), symmetry, the stump, the interaction identities, and a model
without node statistics raising.

Tolerance against the JAX package, and why: both take the same f32
operations per leaf (the same merged paths, weight table and cover
ratios), but XLA sums the weighted coefficients with a dot product and the
reduces in an order of its choosing, and may fuse products into adds; the
port sums in path order without fusing. Each output is a sum of at most a
few hundred such terms, so the two agree within
``1e-5 * (1 + sum |phi|)`` per row (measured: a few ulps, 2.4e-7 at most).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu.ops import predict as jpred
from xgboost_ray_tpu.ops.grow import Tree as JTree
from xgboost_ray_tpu_torch.convert import booster_from_jax_state
from xgboost_ray_tpu_torch.ops import shap as tsh
from xgboost_ray_tpu_torch.ops.grow import Tree

CPU = "cpu"
JRP = jx.RayParams(num_actors=1)
TRP = tx.RayParams(num_actors=1)


def _data(seed, n=200, f=6, nan=0.1):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    x[rng.rand(n, f) < nan] = np.nan
    z = np.nan_to_num(x)
    return x, z


def _convert(jb):
    return booster_from_jax_state(
        jb.forest._asdict(), jb.cuts, jb.base_score,
        dataclasses.asdict(jb.params), tree_weights=jb.tree_weights,
        feature_names=jb.feature_names)


def _jax_model(params, y_fn, rounds, seed=0):
    x, z = _data(seed)
    jb = jx.train(params, jx.RayDMatrix(x, y_fn(z)), rounds, ray_params=JRP)
    return jb, _convert(jb), x


MODEL_SPECS = {
    "binary_d4": ({"objective": "binary:logistic", "max_depth": 4},
                  lambda z: (z[:, 0] + z[:, 1] * z[:, 2] > 0), 4),
    "regression_d3": ({"objective": "reg:squarederror", "max_depth": 3},
                      lambda z: z[:, 0] - 0.5 * z[:, 3] + z[:, 1] * z[:, 4],
                      5),
    "softprob_k3_d3": ({"objective": "multi:softprob", "num_class": 3,
                        "max_depth": 3},
                       lambda z: (z[:, 0] > 0).astype(np.float32)
                       + (z[:, 1] > 0), 4),
    "stump_d1": ({"objective": "binary:logistic", "max_depth": 1},
                 lambda z: z[:, 1] > 0, 6),
    "dart_d3": ({"objective": "binary:logistic", "booster": "dart",
                 "rate_drop": 0.3, "one_drop": 1, "max_depth": 3},
                lambda z: z[:, 0] + z[:, 2] > 0, 6),
    "npt2_d2": ({"objective": "binary:logistic", "max_depth": 2,
                 "num_parallel_tree": 2, "subsample": 0.8},
                lambda z: z[:, 0] * z[:, 3] > 0, 4),
}


@pytest.fixture(scope="module", params=list(MODEL_SPECS))
def model(request):
    params, y_fn, rounds = MODEL_SPECS[request.param]
    jb, tb, x = _jax_model(params, lambda z: y_fn(z).astype(np.float32),
                           rounds)
    return request.param, jb, tb, x


def _assert_close(got, ref):
    """max |d| <= 1e-5 (1 + sum |phi|) per row (see the module note)."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    g = got.reshape(got.shape[0], -1).astype(np.float64)
    r = ref.reshape(ref.shape[0], -1).astype(np.float64)
    bound = 1e-5 * (1.0 + np.abs(r).sum(1))
    assert (np.abs(g - r).max(1) <= bound).all(), np.abs(g - r).max()


KINDS = {"exact": dict(pred_contribs=True),
         "saabas": dict(pred_contribs=True, approx_contribs=True),
         "interactions": dict(pred_interactions=True)}


@pytest.mark.parametrize("kind", list(KINDS))
def test_booster_matches_jax(model, kind):
    name, jb, tb, x = model
    kw = KINDS[kind]
    _assert_close(tb.predict(x, device=CPU, **kw), jb.predict(x, **kw))


def test_iteration_range_and_base_margin_match_jax(model):
    name, jb, tb, x = model
    bm_shape = (x.shape[0], tb.num_outputs) if tb.num_outputs > 1 else (
        x.shape[0],)
    bm = np.random.RandomState(5).randn(*bm_shape).astype(np.float32)
    rounds = tb.num_boosted_rounds()
    for kw in (dict(pred_contribs=True, iteration_range=(1, rounds)),
               dict(pred_contribs=True, approx_contribs=True,
                    base_margin=bm),
               dict(pred_interactions=True, base_margin=bm,
                    iteration_range=(0, 2))):
        _assert_close(tb.predict(x, device=CPU, **kw), jb.predict(x, **kw))


def test_saved_file_cross_loads(model, tmp_path):
    name, jb, tb, x = model
    path = str(tmp_path / "m.json")
    jb.save_model(path)
    loaded = tx.RayXGBoostBooster.load_model(path)
    got = loaded.predict(x[:50], pred_contribs=True, device=CPU)
    assert np.array_equal(got, tb.predict(x[:50], pred_contribs=True,
                                          device=CPU))


def test_rows_sum_to_margin(model):
    """Efficiency: contributions (and the interaction matrix's grand total)
    sum to the margin within f32 rounding of the per-tree telescoping sums:
    1e-5 relative, 2e-5 absolute."""
    name, jb, tb, x = model
    m = tb.predict(x, output_margin=True, device=CPU)
    for kind, kw in KINDS.items():
        out = tb.predict(x, device=CPU, **kw)
        axes = (-1, -2) if kind == "interactions" else (-1,)
        np.testing.assert_allclose(out.sum(axis=axes), m, rtol=1e-5,
                                   atol=2e-5)


@pytest.fixture(scope="module")
def k3_model():
    params, y_fn, rounds = MODEL_SPECS["softprob_k3_d3"]
    return _jax_model(params, lambda z: y_fn(z).astype(np.float32), rounds,
                      seed=3)


@pytest.mark.parametrize("fn", ["predict_contribs", "predict_contribs_exact",
                                "predict_interactions"])
def test_kernel_functions_match_jax_functions(k3_model, fn):
    """The ops-level functions against the JAX ops on one model at K = 3
    with ``ntree_limit`` and tree weights: the wrappers' CPU path."""
    jb, tb, x = k3_model
    t = tb.num_trees
    tw = np.random.RandomState(1).uniform(0.5, 1.5, t).astype(np.float32)
    sf = tsh.shap_forest(tb.forest, tb.max_depth, CPU,
                         num_features=tb.num_features)
    sc = tsh.tree_scales(sf, 3, 1, 6, tw)
    got = getattr(tsh, fn)(sf, torch.from_numpy(x), sc).numpy()
    fd = JTree(*[jnp.asarray(f) for f in jb.forest])
    ref = np.asarray(getattr(jpred, fn)(
        fd, jnp.asarray(x), max_depth=jb.max_depth, num_outputs=3,
        ntree_limit=6, tree_weights=jnp.asarray(tw)))
    _assert_close(got, ref)


def test_weight_table_is_the_reference_table():
    for d in (1, 3, 6, 9):
        assert np.array_equal(tsh.weight_table(d),
                              np.asarray(jpred._shap_weight_table(d)))


def test_leaves_enumerate_canonical_slots_in_order():
    """Each tree's leaves in slot order, repeated features merged into their
    first occurrence (z multiplied), as ``_shap_path_data`` does."""
    depth = 3
    heap = (2 << depth) - 1
    f = {k: np.zeros((1, heap), dt) for k, dt in (
        ("feature", np.int32), ("split_bin", np.int32),
        ("threshold", np.float32), ("default_left", bool),
        ("is_leaf", bool), ("value", np.float32), ("gain", np.float32),
        ("cover", np.float32), ("base_weight", np.float32))}
    f["feature"][:] = -1
    # root splits f0; left child leaf; right child splits f0 again, then f1
    f["feature"][0, [0, 2, 6]] = [0, 0, 1]
    f["is_leaf"][0, [1, 5, 13, 14]] = True
    f["value"][0, [1, 5, 13, 14]] = [1.0, 2.0, 3.0, 4.0]
    f["cover"][0, [0, 1, 2, 5, 6, 13, 14]] = [8, 2, 6, 2, 4, 1, 3]
    sf = tsh.shap_forest(Tree(**f), depth, CPU, num_features=2)
    assert sf.n_leaves.tolist() == [4]
    assert sf.leaf_value[0].tolist() == [1.0, 2.0, 3.0, 4.0]
    assert sf.leaf_m[0].tolist() == [1, 1, 2, 2]
    z = sf.elem_z[0].numpy()
    # leaf 5: f0 right (6/8), then f0 left (2/6) merged into it
    assert z[1, 0] == np.float32(np.float32(0.75) * np.float32(2 / 6))
    assert sf.tree_feats[0].tolist() == [0, 1]
    assert sf.elem_slot[0, 2].tolist()[:2] == [0, 1]
    e = (0.25 * 1.0 + 2.0 * z[1, 0] + 3.0 * z[2, 0] * z[2, 1]
         + 4.0 * z[3, 0] * z[3, 1])
    assert abs(float(sf.expectation[0]) - e) < 1e-6


# --------------------------------------------------------------------------
# tests/test_shap.py re-aimed at the port (its models trained by the port)
# --------------------------------------------------------------------------


def _train(params, x, y, rounds):
    return tx.train(params, tx.RayDMatrix(x, y), rounds, ray_params=TRP,
                    device=CPU)


def _sum_check(bst, x, atol=1e-4, **kw):
    contribs = bst.predict(x, pred_contribs=True, device=CPU, **kw)
    margins = bst.predict(x, output_margin=True, device=CPU)
    np.testing.assert_allclose(contribs.sum(axis=-1), margins, atol=atol)
    return contribs


def test_contribs_sum_to_margin_binary():
    rng = np.random.RandomState(0)
    x = rng.randn(300, 6).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 2] > 0).astype(np.float32)
    bst = _train({"objective": "binary:logistic", "max_depth": 4}, x, y, 10)
    contribs = _sum_check(bst, x, approx_contribs=True)
    assert contribs.shape == (300, 7)
    mass = np.abs(contribs[:, :-1]).sum(axis=0)
    assert mass[0] == mass.max()
    _sum_check(bst, x)


def test_contribs_sum_to_margin_multiclass():
    rng = np.random.RandomState(1)
    x = rng.randn(240, 5).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32) + (x[:, 1] > 0).astype(np.int32)
    bst = _train({"objective": "multi:softprob", "num_class": 3,
                  "max_depth": 3}, x, y.astype(np.float32), 6)
    assert _sum_check(bst, x, approx_contribs=True).shape == (240, 3, 6)
    assert _sum_check(bst, x).shape == (240, 3, 6)


def test_contribs_single_feature_tree():
    rng = np.random.RandomState(2)
    x = np.zeros((200, 3), np.float32)
    x[:, 0] = rng.randn(200)
    y = (x[:, 0] > 0).astype(np.float32)
    bst = _train({"objective": "binary:logistic", "max_depth": 2}, x, y, 3)
    for approx in (True, False):
        contribs = _sum_check(bst, x, approx_contribs=approx)
        np.testing.assert_allclose(contribs[:, 1:3], 0.0, atol=1e-6)
        assert np.abs(contribs[:, 0]).max() > 0.1
        assert np.allclose(contribs[:, -1], contribs[0, -1])


def test_contribs_hand_computed_stump():
    x = np.array([[0.0], [0.0], [10.0], [10.0]], np.float32)
    y = np.array([0.0, 0.0, 1.0, 1.0], np.float32)
    bst = _train({"objective": "reg:squarederror", "max_depth": 1,
                  "eta": 1.0, "lambda": 0.0, "base_score": 0.5}, x, y, 1)
    for approx in (True, False):
        contribs = bst.predict(x, pred_contribs=True, device=CPU,
                               approx_contribs=approx)
        np.testing.assert_allclose(contribs[:, -1], 0.5, atol=1e-5)
        np.testing.assert_allclose(contribs[:, 0], [-0.5, -0.5, 0.5, 0.5],
                                   atol=1e-5)


def test_contribs_save_load_roundtrip(tmp_path):
    rng = np.random.RandomState(5)
    x = rng.randn(100, 3).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    bst = _train({"objective": "binary:logistic", "max_depth": 3}, x, y, 5)
    p = str(tmp_path / "m.json")
    bst.save_model(p)
    loaded = tx.RayXGBoostBooster.load_model(p)
    for approx in (True, False):
        assert np.array_equal(
            loaded.predict(x, pred_contribs=True, approx_contribs=approx,
                           device=CPU),
            bst.predict(x, pred_contribs=True, approx_contribs=approx,
                        device=CPU))


def _cond_exp(forest, t, node, xrow, coalition):
    if forest.is_leaf[t, node]:
        return float(forest.value[t, node])
    f = int(forest.feature[t, node])
    left, right = 2 * node + 1, 2 * node + 2
    if f in coalition:
        xv = xrow[f]
        go_right = ((not forest.default_left[t, node]) if np.isnan(xv)
                    else xv >= forest.threshold[t, node])
        return _cond_exp(forest, t, right if go_right else left, xrow,
                         coalition)
    cl = float(forest.cover[t, left])
    cr = float(forest.cover[t, right])
    if cl + cr <= 0:
        return float(forest.value[t, node])
    return (cl * _cond_exp(forest, t, left, xrow, coalition)
            + cr * _cond_exp(forest, t, right, xrow, coalition)) / (cl + cr)


def _brute_force_shap(bst, x):
    """Shapley values by full subset enumeration (``tests/test_shap.py``
    ``_brute_force_shap``): [N, F+1], bias = tree expectations + base."""
    import itertools
    import math

    forest = bst.forest
    nf = x.shape[1]
    out = np.zeros((x.shape[0], nf + 1), np.float64)
    for r, xrow in enumerate(x):
        for t in range(forest.feature.shape[0]):
            out[r, -1] += _cond_exp(forest, t, 0, xrow, frozenset())
            for i in range(nf):
                others = [f for f in range(nf) if f != i]
                for k in range(nf):
                    w = (math.factorial(k) * math.factorial(nf - k - 1)
                         / math.factorial(nf))
                    for s in itertools.combinations(others, k):
                        s = frozenset(s)
                        out[r, i] += w * (
                            _cond_exp(forest, t, 0, xrow, s | {i})
                            - _cond_exp(forest, t, 0, xrow, s))
    out[:, -1] += bst.base_score_margin_np()
    return out.astype(np.float32)


def _brute_force_interactions(bst, x):
    """The off-diagonal interaction oracle of ``tests/test_shap.py``."""
    import itertools
    import math

    forest = bst.forest
    nf = x.shape[1]
    out = np.zeros((x.shape[0], nf, nf), np.float64)
    for r, xrow in enumerate(x):
        for t in range(forest.feature.shape[0]):
            for i, j in itertools.combinations(range(nf), 2):
                others = [f for f in range(nf) if f not in (i, j)]
                acc = 0.0
                for k in range(nf - 1):
                    w = (math.factorial(k) * math.factorial(nf - k - 2)
                         / (2.0 * math.factorial(nf - 1)))
                    for s in itertools.combinations(others, k):
                        s = frozenset(s)
                        acc += w * (
                            _cond_exp(forest, t, 0, xrow, s | {i, j})
                            - _cond_exp(forest, t, 0, xrow, s | {i})
                            - _cond_exp(forest, t, 0, xrow, s | {j})
                            + _cond_exp(forest, t, 0, xrow, s))
                out[r, i, j] += acc
                out[r, j, i] += acc
    return out.astype(np.float32)


def test_exact_shap_matches_brute_force():
    rng = np.random.RandomState(7)
    x = rng.randn(200, 4).astype(np.float32)
    y = (x[:, 0] + 0.7 * x[:, 1] * x[:, 2] > 0).astype(np.float32)
    bst = _train({"objective": "binary:logistic", "max_depth": 3,
                  "eta": 0.4}, x, y, 5)
    probe = x[:16]
    exact = bst.predict(probe, pred_contribs=True, device=CPU)
    np.testing.assert_allclose(exact, _brute_force_shap(bst, probe),
                               atol=2e-4)
    saabas = bst.predict(probe, pred_contribs=True, approx_contribs=True,
                         device=CPU)
    assert np.abs(exact - saabas).max() > 1e-4


def test_exact_shap_efficiency_with_missing_values():
    rng = np.random.RandomState(8)
    x = rng.randn(300, 6).astype(np.float32)
    x[rng.rand(300, 6) < 0.15] = np.nan
    y = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 3]) > 0).astype(
        np.float32)
    bst = _train({"objective": "binary:logistic", "max_depth": 6}, x, y, 10)
    _sum_check(bst, x)


def test_exact_shap_stump_matches_oracle():
    rng = np.random.RandomState(9)
    x = rng.randn(200, 3).astype(np.float32)
    y = (x[:, 1] > 0).astype(np.float32)
    bst = _train({"objective": "binary:logistic", "max_depth": 1}, x, y, 6)
    probe = x[:8]
    np.testing.assert_allclose(
        bst.predict(probe, pred_contribs=True, device=CPU),
        _brute_force_shap(bst, probe), atol=2e-4)


def test_exact_shap_symmetry():
    rng = np.random.RandomState(10)
    a = rng.randn(4000).astype(np.float32)
    b = rng.randn(4000).astype(np.float32)
    x = np.stack([a, b], axis=1)
    y = ((a + b) > 0).astype(np.float32)
    bst = _train({"objective": "binary:logistic", "max_depth": 3}, x, y, 8)
    contribs = _sum_check(bst, x)
    mass = np.abs(contribs[:, :2]).sum(axis=0)
    assert abs(mass[0] - mass[1]) / mass.max() < 0.2


def test_pred_interactions_identities():
    rng = np.random.RandomState(12)
    x = rng.randn(400, 4).astype(np.float32)
    y = ((x[:, 0] > 0) ^ (x[:, 1] > 0)).astype(np.float32)
    bst = _train({"objective": "binary:logistic", "max_depth": 3,
                  "eta": 0.4}, x, y, 6)
    q = x[:32]
    inter = bst.predict(q, pred_interactions=True, device=CPU)
    assert inter.shape == (32, 5, 5)
    contribs = bst.predict(q, pred_contribs=True, device=CPU)
    margins = bst.predict(q, output_margin=True, device=CPU)
    np.testing.assert_allclose(inter.sum(axis=2), contribs, atol=2e-4)
    np.testing.assert_allclose(inter.sum(axis=(1, 2)), margins, atol=5e-4)
    np.testing.assert_allclose(inter, np.swapaxes(inter, 1, 2), atol=1e-5)
    off = np.abs(inter[:, :4, :4]).sum(axis=0)
    np.fill_diagonal(off, 0.0)
    assert off[0, 1] >= off.max() - 1e-3
    oracle = _brute_force_interactions(bst, x[:6])
    got = inter[:6, :4, :4].copy()
    for r in range(6):
        np.fill_diagonal(got[r], 0.0)
    np.testing.assert_allclose(got, oracle, atol=3e-4)


def test_interactions_multiclass_shape():
    rng = np.random.RandomState(13)
    x = rng.randn(90, 3).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32) + (x[:, 1] > 0).astype(np.int32)
    bst = _train({"objective": "multi:softprob", "num_class": 3,
                  "max_depth": 2}, x, y.astype(np.float32), 4)
    inter = bst.predict(x[:16], pred_interactions=True, device=CPU)
    assert inter.shape == (16, 3, 4, 4)
    contribs = bst.predict(x[:16], pred_contribs=True, device=CPU)
    np.testing.assert_allclose(inter.sum(axis=3), contribs, atol=2e-4)


def test_approx_with_interactions_warns_and_is_exact():
    rng = np.random.RandomState(14)
    x = rng.randn(60, 3).astype(np.float32)
    bst = _train({"objective": "binary:logistic", "max_depth": 2}, x,
                 (x[:, 0] > 0).astype(np.float32), 2)
    with pytest.warns(UserWarning, match="approx_contribs"):
        got = bst.predict(x, pred_interactions=True, approx_contribs=True,
                          device=CPU)
    assert np.array_equal(got, bst.predict(x, pred_interactions=True,
                                           device=CPU))


def test_model_without_node_stats_raises():
    import copy

    rng = np.random.RandomState(15)
    x = rng.randn(60, 3).astype(np.float32)
    bst = _train({"objective": "binary:logistic", "max_depth": 2}, x,
                 (x[:, 0] > 0).astype(np.float32), 2)
    old = copy.deepcopy(bst)
    old._has_node_stats = False
    for kw in (dict(pred_contribs=True), dict(pred_interactions=True),
               dict(pred_contribs=True, approx_contribs=True)):
        with pytest.raises(ValueError, match="contributions"):
            old.predict(x, device=CPU, **kw)
    assert np.array_equal(old.predict(x, device=CPU),
                          bst.predict(x, device=CPU))


def test_distributed_predict_passes_shap_kwargs():
    """``predict()`` over a sharded matrix: shards in rank order, each
    shard's base margin in its rows' bias column, as the booster gives."""
    rng = np.random.RandomState(16)
    x = rng.randn(120, 4).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    bst = _train({"objective": "binary:logistic", "max_depth": 3}, x, y, 3)
    bm = rng.randn(120).astype(np.float32)
    rp = tx.RayParams(num_actors=2)
    got = tx.predict(bst, tx.RayDMatrix(x, base_margin=bm), ray_params=rp,
                     device=CPU, pred_contribs=True)
    assert np.array_equal(got, bst.predict(x, pred_contribs=True,
                                           base_margin=bm, device=CPU))
    got = tx.predict(bst, tx.RayDMatrix(x), ray_params=rp, device=CPU,
                     pred_interactions=True)
    assert np.array_equal(got, bst.predict(x, pred_interactions=True,
                                           device=CPU))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bst.predict(x, pred_contribs=True)
