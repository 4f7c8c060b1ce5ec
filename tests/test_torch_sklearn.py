"""The port's sklearn estimators against the JAX package's.

``tests/test_sklearn.py``'s and ``tests/test_sklearn_parity.py``'s
in-slice cases, re-aimed at both packages on sklearn's breast_cancer, iris
and ``make_regression`` at ``num_actors=1`` (each JAX reference fit once
per module), the port with ``device="cpu"``. Tolerances: dumps equal,
``classes_`` equal, eval history within 1e-6 absolute and predictions
within 1e-6 (float32 sums taken in another order: the f32 summation
bound); the port's own round trips (pickle, ``clone``) bitwise. The
out-of-slice estimators and settings raise ``NotImplementedError`` naming
the key the port refuses.
"""

import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest
from sklearn.base import clone
from sklearn.datasets import load_breast_cancer, load_iris, make_regression
from sklearn.metrics import log_loss
from sklearn.model_selection import GridSearchCV

import xgboost_ray_tpu.sklearn as js
import xgboost_ray_tpu_torch.sklearn as ts

ATOL = 1e-6


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():  # num_actors=1: "NOT be distributed"
        warnings.simplefilter("ignore", UserWarning)
        yield


def _bc():
    x, y = load_breast_cancer(return_X_y=True)
    return x.astype(np.float32), y


def _both(name, kwargs, x, y, **fit_kw):
    """The same estimator fitted by both packages: (port, JAX)."""
    t = getattr(ts, name)(device="cpu", **kwargs).fit(x, y, **fit_kw)
    j = getattr(js, name)(**kwargs).fit(x, y, **fit_kw)
    return t, j


def _assert_same_model(t, j):
    assert t.get_booster().get_dump(with_stats=True) == \
        j.get_booster().get_dump(with_stats=True)
    for name, runs in j.evals_result().items():
        for metric, values in runs.items():
            np.testing.assert_allclose(t.evals_result()[name][metric], values,
                                       rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def binary():
    x, y = _bc()
    return x, y, _both("RayXGBClassifier",
                       dict(n_estimators=5, max_depth=4,
                            eval_metric=["error", "logloss"]),
                       x, y, eval_set=[(x[:200], y[:200])])


@pytest.fixture(scope="module")
def iris():
    x, y = load_iris(return_X_y=True)
    x, y = x.astype(np.float32), y + 1  # labels 1..3
    return x, y, _both("RayXGBClassifier", dict(n_estimators=4, max_depth=3),
                       x, y)


@pytest.fixture(scope="module")
def regression():
    x, y = make_regression(300, 6, noise=0.5, random_state=0)
    x, y = x.astype(np.float32), y.astype(np.float32)
    return x, y, _both("RayXGBRegressor", dict(n_estimators=5, max_depth=3),
                       x, y)


def test_binary_classifier_matches_jax(binary):
    x, y, (t, j) = binary
    _assert_same_model(t, j)
    assert np.array_equal(t.classes_, j.classes_) and t.n_classes_ == 2
    np.testing.assert_allclose(t.predict_proba(x), j.predict_proba(x),
                               rtol=0, atol=ATOL)
    assert np.array_equal(t.predict(x), j.predict(x))
    p = t.predict_proba(x)
    assert np.array_equal(p[:, 1], t.get_booster().predict(x, device="cpu"))
    assert np.array_equal(t.predict(x), t.classes_[(p[:, 1] > 0.5).astype(int)])
    assert t.n_features_in_ == x.shape[1]


def test_multiclass_classifier_matches_jax(iris):
    x, y, (t, j) = iris
    _assert_same_model(t, j)
    assert np.array_equal(t.classes_, [1, 2, 3]) and t.n_classes_ == 3
    assert np.array_equal(t.classes_, j.classes_)
    proba = t.predict_proba(x)
    np.testing.assert_allclose(proba, j.predict_proba(x), rtol=0, atol=ATOL)
    assert np.array_equal(t.predict(x), t.classes_[proba.argmax(axis=1)])
    assert np.array_equal(t.predict(x), j.predict(x))


def test_regressor_matches_jax(regression):
    x, y, (t, j) = regression
    _assert_same_model(t, j)
    # values near 100: the f32 bound is relative
    np.testing.assert_allclose(t.predict(x), j.predict(x), rtol=1e-6, atol=0)


def test_label_codes_are_the_dict_loops():
    """``np.unique``'s inverse gives the JAX module's per-row dict codes."""
    rng = np.random.default_rng(0)
    for y in (rng.integers(-3, 9, 1000), rng.choice(["b", "a", "c"], 500),
              rng.choice([0.5, -1.25, 7.0], 700).astype(np.float32)):
        classes, codes = np.unique(y, return_inverse=True)
        loop = {c: i for i, c in enumerate(classes)}
        assert np.array_equal(codes, [loop[v] for v in y])
        assert np.array_equal(ts.encode_labels(classes, y), codes)
    with pytest.raises(ValueError, match="not among"):
        ts.encode_labels(np.array([0, 1]), np.array([0, 2]))


def test_string_labels():
    x, y = _bc()
    labels = np.array(["neg", "pos"])[y]
    t = ts.RayXGBClassifier(n_estimators=2, max_depth=2, device="cpu")
    t.fit(x, labels)
    assert list(t.classes_) == ["neg", "pos"]
    assert set(t.predict(x)) <= {"neg", "pos"}


def test_pickle_round_trip(binary):
    x, _, (t, _) = binary
    back = pickle.loads(pickle.dumps(t))
    assert np.array_equal(back.predict_proba(x), t.predict_proba(x))
    raw = pickle.dumps(t.get_booster())
    # the model document: host arrays only, no tensor to rebuild
    assert b"_rebuild" not in raw and b"torch._utils" not in raw
    bst = pickle.loads(raw)
    assert bst.get_dump() == t.get_booster().get_dump()
    assert bst.save_raw() == t.get_booster().save_raw()


def test_clone_and_get_params_keep_device():
    est = ts.RayXGBClassifier(n_estimators=7, max_depth=2, learning_rate=0.1,
                              device="cpu")
    params = est.get_params()
    assert params["device"] == "cpu" and params["n_estimators"] == 7
    cloned = clone(est)
    assert cloned.device == "cpu" and cloned.max_depth == 2
    assert "device" not in cloned.get_xgb_params()


def test_grid_search_over_depth():
    rng = np.random.RandomState(2)
    x = rng.randn(120, 4).astype(np.float32)
    y = (x[:, 0] > 0).astype(int)
    gs = GridSearchCV(ts.RayXGBClassifier(n_estimators=3, device="cpu"),
                      {"max_depth": [2, 3]}, cv=2, error_score="raise")
    gs.fit(x, y)
    assert gs.best_params_["max_depth"] in (2, 3)
    assert gs.best_estimator_.device == "cpu"


def test_n_jobs_maps_to_num_actors():
    est = ts.RayXGBClassifier(n_estimators=2, max_depth=2, n_jobs=3,
                              device="cpu")
    assert est._get_ray_params(None).num_actors == 3
    rng = np.random.RandomState(2)
    x = rng.randn(120, 3).astype(np.float32)
    est.fit(x, (x[:, 0] > 0).astype(np.float32))
    assert est.get_booster().num_boosted_rounds() == 2
    assert est.additional_results_["train_n"] == 120


def _custom_squared_error(y_true, y_pred):
    grad = (y_pred - y_true).astype(np.float32)
    return grad, np.ones_like(grad)


def _custom_logistic(y_true, y_pred):
    p = 1.0 / (1.0 + np.exp(-y_pred))
    return (p - y_true).astype(np.float32), (p * (1 - p)).astype(np.float32)


@pytest.mark.parametrize("name,objective", [
    ("RayXGBRegressor", _custom_squared_error),
    ("RayXGBClassifier", _custom_logistic),
])
def test_custom_objective_matches_jax(name, objective):
    rng = np.random.RandomState(0)
    x = rng.randn(300, 4).astype(np.float32)
    y = ((x[:, 0] * 2 + 0.1 * rng.randn(300)) if name == "RayXGBRegressor"
         else (x[:, 0] > 0)).astype(np.float32)
    t, j = _both(name, dict(n_estimators=4, max_depth=3, objective=objective),
                 x, y, eval_set=[(x, y)])
    _assert_same_model(t, j)
    np.testing.assert_allclose(t.predict(x), j.predict(x), rtol=1e-6, atol=ATOL)


def test_custom_squared_error_trains_the_builtin_model():
    rng = np.random.RandomState(0)
    x = rng.randn(300, 4).astype(np.float32)
    y = (x[:, 0] * 2 + 0.1 * rng.randn(300)).astype(np.float32)
    kw = dict(n_estimators=4, max_depth=3, base_score=0.5, device="cpu")
    custom = ts.RayXGBRegressor(objective=_custom_squared_error, **kw).fit(x, y)
    builtin = ts.RayXGBRegressor(**kw).fit(x, y)
    assert custom.get_booster().get_dump() == builtin.get_booster().get_dump()
    assert np.array_equal(custom.predict(x), builtin.predict(x))


def test_callable_eval_metric_matches_jax(binary):
    x, y, _ = binary
    t, j = _both("RayXGBClassifier", dict(n_estimators=3, max_depth=3,
                                          eval_metric=log_loss),
                 x, y, eval_set=[(x[:200], y[:200])])
    _assert_same_model(t, j)
    res = t.evals_result()["validation_0"]["log_loss"]
    assert len(res) == 3
    p = t.predict_proba(x[:200])[:, 1]
    assert np.isclose(res[-1], log_loss(y[:200], p), atol=1e-4)


def test_early_stopping_predicts_the_best_rounds(binary):
    x, y, _ = binary
    t, j = _both("RayXGBClassifier", dict(n_estimators=20, max_depth=3,
                                          learning_rate=1.0,
                                          eval_metric=["logloss"]),
                 x[:400], y[:400], eval_set=[(x[400:], y[400:])],
                 early_stopping_rounds=3)
    _assert_same_model(t, j)
    res = t.evals_result()["validation_0"]["logloss"]
    assert t.best_iteration == j.best_iteration == int(np.argmin(res))
    assert len(res) < 20
    best = t.get_booster().predict(x[400:], device="cpu",
                                   iteration_range=(0, t.best_iteration + 1))
    assert np.array_equal(t.predict_proba(x[400:])[:, 1], best)


def test_apply_and_feature_importances(binary):
    x, _, (t, j) = binary
    assert np.array_equal(t.apply(x), t.get_booster().predict(
        x, pred_leaf=True, device="cpu"))
    assert np.array_equal(t.apply(x), j.apply(x))
    score = t.get_booster().get_score(importance_type="gain")
    names = [f"f{i}" for i in range(x.shape[1])]
    vals = np.array([score.get(n, 0.0) for n in names])
    np.testing.assert_allclose(t.feature_importances_, vals / vals.sum())
    np.testing.assert_allclose(t.feature_importances_, j.feature_importances_,
                               rtol=1e-6)


def test_booster_host_api_matches_jax(binary):
    _, _, (t, j) = binary
    tb, jb = t.get_booster(), j.get_booster()
    for kind in ("weight", "gain", "total_gain"):
        ts_, js_ = tb.get_score(importance_type=kind), jb.get_score(
            importance_type=kind)
        assert ts_.keys() == js_.keys()
        np.testing.assert_allclose([ts_[k] for k in ts_],
                                   [js_[k] for k in ts_], rtol=1e-6)
    assert tb.get_fscore() == jb.get_fscore()
    tdf, jdf = tb.trees_to_dataframe(), jb.trees_to_dataframe()
    assert list(tdf.columns) == list(jdf.columns) and len(tdf) == len(jdf)
    assert tdf[["ID", "Feature", "Yes", "No", "Missing"]].equals(
        jdf[["ID", "Feature", "Yes", "No", "Missing"]])
    tb.set_attr(best="3", gone=None)
    assert tb.attr("best") == "3" and tb.attributes() == {"best": "3"}
    assert pickle.loads(pickle.dumps(tb)).attributes() == {"best": "3"}


def test_sample_weight_eval_set_flows_into_metric(binary):
    x, y, _ = binary
    w = np.random.RandomState(7).uniform(0.2, 3.0, 200).astype(np.float32)
    t, j = _both("RayXGBClassifier", dict(n_estimators=3, max_depth=3,
                                          eval_metric=["logloss"]),
                 x, y, eval_set=[(x[:200], y[:200])],
                 sample_weight_eval_set=[w])
    _assert_same_model(t, j)


@pytest.mark.parametrize("name,kwargs,key", [
    ("RayXGBRFClassifier", {}, "subsample"),
    ("RayXGBRFRegressor", {}, "subsample"),
    ("RayXGBRFClassifier", dict(subsample=1.0, colsample_bynode=1.0),
     "num_parallel_tree"),
])
def test_rf_estimators_match_jax(name, kwargs, key):
    """The random-forest estimators train (their sampled rows and columns,
    their ``num_parallel_tree``, named by ``key``): the JAX package's model,
    ``random_state`` its seed, predictions within 1e-6."""
    x, y = _bc()
    if name == "RayXGBRFRegressor":
        y = x[:, 0] * 0.01 + y
    t, j = _both(name, dict(n_estimators=2, max_depth=2, random_state=4,
                            **kwargs), x, y)
    _assert_same_model(t, j)
    assert t.get_xgb_params()[key] == j.get_xgb_params()[key]
    assert t.get_booster().num_boosted_rounds() == 1
    np.testing.assert_allclose(t.predict(x), j.predict(x), rtol=1e-6,
                               atol=ATOL)


@pytest.mark.parametrize("name,kwargs,key", [
    ("RayXGBClassifier", dict(hist_quant="int8"), "hist_quant"),
    ("RayXGBRegressor", dict(gh_precision="int8"), "gh_precision"),
    ("RayXGBClassifier", dict(gh_precision="int16"), "gh_precision"),
])
def test_quantized_estimators_fit(name, kwargs, key):
    """The estimators train with quantized gradients or the quantized
    histogram wire (``key``): one round on the CPU, and they predict."""
    x, y = _bc()
    est = getattr(ts, name)(n_estimators=1, device="cpu",
                            hist_quant_min_bytes=0, **kwargs)
    est.fit(x, y)
    assert est.get_xgb_params()[key] == kwargs[key]
    pred = est.predict(x)
    assert pred.shape == (x.shape[0],) and np.isfinite(pred).all()


def test_feature_weights_and_ranker_raise():
    """``feature_weights`` in ``fit`` bias the column draws as the JAX
    package's (a zero-weight feature is never split on); weights of the
    wrong length raise; the ranker needs qid and a rank:* objective."""
    x, y = _bc()
    fw = np.ones(x.shape[1], np.float32)
    fw[[0, 7, 20, 27]] = 0.0
    t, j = _both("RayXGBClassifier", dict(n_estimators=3, max_depth=3,
                                          colsample_bynode=0.5),
                 x, y, feature_weights=fw)
    _assert_same_model(t, j)
    used = set(np.asarray(t.get_booster().forest.feature).ravel().tolist())
    assert not used & {0, 7, 20, 27}
    with pytest.raises(ValueError, match="feature_weights"):
        ts.RayXGBClassifier(n_estimators=2, device="cpu").fit(
            x, y, feature_weights=np.ones(3))
    ranker = ts.RayXGBRanker(n_estimators=2, device="cpu")
    assert ranker._default_objective == js.RayXGBRanker._default_objective
    # the ranker trains now; it needs qid and a rank:* objective
    with pytest.raises(ValueError, match="qid"):
        ranker.fit(x, y)
    with pytest.raises(ValueError, match="rank:"):
        ts.RayXGBRanker(n_estimators=2, objective="binary:logistic",
                        device="cpu").fit(x, y, qid=np.zeros(len(y)))


def test_rf_defaults_are_the_jax_modules():
    for name in ("RayXGBRFClassifier", "RayXGBRFRegressor"):
        t, j = getattr(ts, name)(n_estimators=7), getattr(js, name)(n_estimators=7)
        assert t.get_xgb_params() == j.get_xgb_params()
        assert t._num_boost_round() == j._num_boost_round() == 1


def test_imports_and_fits_without_sklearn():
    code = (
        "import sys; sys.modules['sklearn'] = None\n"
        "import numpy as np, warnings; warnings.simplefilter('ignore')\n"
        "import xgboost_ray_tpu_torch.sklearn as s\n"
        "x = np.random.default_rng(0).standard_normal((200, 3), np.float32)\n"
        "y = (x[:, 0] > 0).astype(np.float32)\n"
        "c = s.RayXGBClassifier(n_estimators=2, device='cpu').fit(x, y)\n"
        "print(s._SKLEARN_INSTALLED, c.predict(x[:3]).shape)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False (3,)"
