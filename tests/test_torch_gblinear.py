"""``booster="gblinear"`` in the port against the JAX package on the CPU
(``tests/test_torch_gblinear_world.py`` holds the 2-rank gloo world):

- B16's plain version (``ops/linear.linear_round_plain``) against one
  round of the reference's ``LinearEngine`` on the same margins: weights
  and bias within ``LINEAR_RTOL`` of the largest weight (XLA's row reduces
  sum in their own order; B16's sums take the fixed blocked order of
  ``ops/linear.blocked_sum``, which is within the f32 summation bound of an
  f64 sum);
- ``train()`` at ``num_actors`` 1: ``reg:squarederror`` with L1 and L2,
  ``binary:logistic`` and ``multi:softprob`` (``_torch_dart.check_linear``:
  weights and bias within ``LINEAR_RTOL``, the exact zeros where the
  reference's are zero, the history and ``predict`` within 1e-5);
- NaN as an implicit zero, save / load and the xgboost JSON export and
  import across both packages, the warm start, the reference's validation
  messages, ``predict()``, ``coef_`` / ``intercept_``;
- where the reference's ``linear.py`` had the defects ``ADVICE.md`` lists
  (``:119`` iteration_range, ``:177`` the export's objective block, ``:189``
  path-or-JSON), the port does as the reference does since it fixed them.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import _torch_dart as S
import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu.linear import LinearEngine as JLinearEngine
from xgboost_ray_tpu.linear import RayLinearBooster as JLinear
from xgboost_ray_tpu.params import parse_params as jparse
from xgboost_ray_tpu_torch.linear import RayLinearBooster as TLinear
from xgboost_ray_tpu_torch.ops import linear as tlin
from xgboost_ray_tpu_torch.ops.objectives import (
    grad_hess,
    objective_from_params,
)
from xgboost_ray_tpu_torch.params import parse_params

RP1 = dict(ray_params=tx.RayParams(num_actors=1))


def _train(params, x, y, rounds, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return tx.train(params, tx.RayDMatrix(x, y), rounds, device="cpu",
                        **RP1, **kw)


def test_blocked_sum_order():
    """``blocked_sum`` is the kernel's order: within the f32 summation
    bound of an f64 sum, and (for rows within one thread's four) exactly the
    in-order sum."""
    rng = np.random.default_rng(0)
    for n in (1, 255, 1024, 1025, 300_000):
        v = rng.standard_normal((n, 2)).astype(np.float32)
        got = tlin.blocked_sum(torch.from_numpy(v)).numpy()
        ref = v.astype(np.float64).sum(0)
        bound = 2 * np.log2(n + 1) * 2 ** -24 * np.abs(v).sum(0)
        assert (np.abs(got - ref) <= bound + 1e-30).all(), (n, got, ref)
    v = np.array([[1e8], [1.0], [-1e8], [1.0]], np.float32)
    # rows 0..3 are four threads' first rows: the tree adds (1e8 + -1e8)
    # and (1 + 1), not the running sum
    assert tlin.blocked_sum(torch.from_numpy(v)).item() == 2.0


@pytest.mark.parametrize("name", sorted(S.LINEAR_CASES))
def test_round_plain_matches_reference(name):
    params, label = S.LINEAR_CASES[name]
    raw = S.linear_params(name)
    x, y = S.XL[:S.N_TRAIN], label[:S.N_TRAIN]
    rng = np.random.default_rng(4)
    shard = {"data": x, "label": y, "weight": None, "base_margin": None}
    jeng = JLinearEngine([shard], jparse(raw), num_actors=1)
    w0 = rng.standard_normal(jeng._w.shape).astype(np.float32) * 0.3
    b0 = rng.standard_normal(jeng._b.shape).astype(np.float32) * 0.3
    jeng._w, jeng._b = w0, b0
    jeng.step(0)
    p = parse_params(raw)
    obj = objective_from_params(p)
    xt = torch.from_numpy(np.ascontiguousarray(np.nan_to_num(x).T))
    m = tlin.linear_margins(xt, torch.from_numpy(w0), torch.from_numpy(b0),
                            None, obj.base_score_to_margin(0.5))
    ones = torch.ones(x.shape[0])
    yt = torch.from_numpy(y)
    if obj.softmax:
        from xgboost_ray_tpu_torch.ops.objectives import softmax_grad_hess

        g, h = softmax_grad_hess(m, yt, ones)
        gh = torch.stack([g.T, h.T], dim=2).contiguous()
    else:
        g, h = grad_hess(m[:, 0], yt, ones, obj)
        gh = torch.stack([g, h], dim=1)[None].contiguous()
    w, b = tlin.linear_round_plain(xt, gh, torch.from_numpy(w0),
                                   torch.from_numpy(b0), p.learning_rate,
                                   p.reg_lambda * x.shape[0],
                                   p.reg_alpha * x.shape[0])
    jw, jb = np.asarray(jeng._w), np.asarray(jeng._b)
    scale = np.abs(jw).max()
    np.testing.assert_allclose(w.numpy(), jw, rtol=0,
                               atol=S.LINEAR_RTOL * scale)
    np.testing.assert_allclose(b.numpy(), jb, rtol=0,
                               atol=S.LINEAR_RTOL * max(np.abs(jb).max(), 1))


@pytest.mark.parametrize("name", sorted(S.LINEAR_CASES))
def test_train_matches_jax(name):
    jb, jev = S.jax_linear(name, 1)
    tb, tev = S.port_linear(name)
    assert isinstance(tb, TLinear)
    S.check_linear(jb, jev, tb, tev)
    if name == "squared_l1l2":
        # the L1 term's clamp to -w holds the noise column at exactly 0
        assert (tb.weights[4] == 0).all()


def test_missing_values_are_implicit_zeros():
    x, y = S.XL[:S.N_TRAIN].copy(), S.YR[:S.N_TRAIN]
    mask = np.random.default_rng(6).random(x.shape) < 0.2
    x_missing, x_zero = x.copy(), np.nan_to_num(x.copy())
    x_missing[mask] = np.nan
    x_zero[mask] = 0.0
    kw = {"objective": "reg:squarederror", "booster": "gblinear", "eta": 0.5}
    a = _train(kw, x_missing, y, 6)
    b = _train(kw, x_zero, y, 6)
    np.testing.assert_array_equal(a.weights, b.weights)
    np.testing.assert_array_equal(a.predict(x_missing, device="cpu"),
                                  a.predict(x_zero, device="cpu"))


def test_save_load_and_xgboost_json_across_packages(tmp_path):
    jb, _ = S.jax_linear("softprob", 1)
    tb, _ = S.port_linear("softprob")
    x = S.XL
    # the port's files in the JAX package
    p = str(tmp_path / "port.json")
    tb.save_model(p)
    back = TLinear.load_model(p)
    np.testing.assert_array_equal(back.weights, tb.weights)
    np.testing.assert_array_equal(back.predict(x, device="cpu"),
                                  tb.predict(x, device="cpu"))
    jback = JLinear.load_model(p)
    np.testing.assert_array_equal(jback.weights, tb.weights)
    np.testing.assert_allclose(np.asarray(jback.predict(x)),
                               tb.predict(x, device="cpu"), atol=1e-6)
    doc = json.loads(tb.export_xgboost_json())
    assert doc["learner"]["gradient_booster"]["name"] == "gblinear"
    assert len(doc["learner"]["gradient_booster"]["model"]["weights"]) == \
        (S.F + 1) * 3
    assert doc["learner"]["objective"]["softmax_multiclass_param"][
        "num_class"] == "3"
    # the JAX package's in the port, by every loader
    q = str(tmp_path / "jax.json")
    jb.save_model(q)
    for src in (q, jb.export_xgboost_json(),
                json.loads(jb.export_xgboost_json())):
        tback = TLinear.import_xgboost_json(src)
        np.testing.assert_array_equal(tback.weights, jb.weights)
        np.testing.assert_allclose(tback.predict(x, device="cpu"),
                                   np.asarray(jb.predict(x)), atol=1e-6)
    assert isinstance(tx.main.coerce_model(q), TLinear)
    raw = TLinear.load_raw(tb.save_raw())
    np.testing.assert_array_equal(raw.weights, tb.weights)
    assert raw.params.num_class == 3 and raw.params.learning_rate == 0.5


def test_warm_start_matches_jax():
    jb0, _ = S.jax_linear("binary", 1)
    x, y = S.XL[:S.N_TRAIN], S.Y[:S.N_TRAIN]
    params = S.linear_params("binary")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jb = jx.train(params, jx.RayDMatrix(x, y), 4, xgb_model=jb0,
                      ray_params=jx.RayParams(num_actors=1))
    tb = _train(params, x, y, 4,
                xgb_model=TLinear.import_xgboost_json(
                    jb0.export_xgboost_json()))
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds() == 12
    np.testing.assert_allclose(tb.weights, jb.weights, rtol=0,
                               atol=S.LINEAR_RTOL * np.abs(jb.weights).max())


def test_validation_errors():
    x = np.random.RandomState(0).randn(60, 3).astype(np.float32)
    y = x[:, 0].astype(np.float32)
    base = {"objective": "reg:squarederror", "booster": "gblinear"}
    for extra, err, match in (
            ({"feature_selector": "greedy"}, NotImplementedError,
             "feature_selector"),
            ({"updater": "bogus"}, ValueError, "updater"),
            ({"monotone_constraints": "(1,0,0)"}, NotImplementedError,
             "tree growth"),
            ({"grow_policy": "lossguide", "max_leaves": 4},
             NotImplementedError, "tree growth"),
            ({"gh_precision": "int8"}, NotImplementedError, "gblinear")):
        with pytest.raises(err, match=match):
            _train(dict(base, **extra), x, y, 1)
    for ok in ({"updater": "shotgun"}, {"updater": "coord_descent"},
               {"feature_selector": "cyclic"}):
        assert parse_params(dict(base, **ok)).booster == "gblinear"
    # gblinear's lambda defaults to 0 unless set
    assert parse_params(base).reg_lambda == 0.0
    assert parse_params(dict(base, reg_lambda=0.3)).reg_lambda == 0.3
    with pytest.raises(NotImplementedError, match="gblinear"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            tx.train({"objective": "rank:pairwise", "booster": "gblinear"},
                     tx.RayDMatrix(x, y, qid=np.zeros(60, np.int64)), 1,
                     device="cpu", **RP1)
    with pytest.raises(NotImplementedError, match="categorical"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            tx.train(base, tx.RayDMatrix(np.round(np.abs(x)), y,
                                         feature_types=["c", "q", "q"]), 1,
                     device="cpu", **RP1)
    with pytest.raises(NotImplementedError, match="custom objectives"):
        _train(base, x, y, 1, obj=lambda m, d: (m, np.ones_like(m)))
    with pytest.raises(ValueError, match="serve_registry"):
        _train(base, x, y, 1, serve_registry=object())
    tree = _train({"objective": "reg:squarederror", "max_depth": 2}, x, y, 1)
    with pytest.raises(ValueError, match="gblinear model"):
        _train(base, x, y, 1, xgb_model=tree)


def test_predict():
    """``predict()`` over ranks equals the booster's own call; margins,
    the no-op iteration ranges (ADVICE.md ``linear.py:119``) and the
    refusals of tree outputs."""
    tb, _ = S.port_linear("binary")
    x = S.XL
    own = tb.predict(x, device="cpu")
    got = tx.predict(tb, tx.RayDMatrix(x), device="cpu",
                     ray_params=tx.RayParams(num_actors=2))
    np.testing.assert_array_equal(got, own)
    assert own.shape == (x.shape[0],) and 0 <= own.min() <= own.max() <= 1
    m = tb.predict(x, output_margin=True, device="cpu")
    np.testing.assert_allclose(1 / (1 + np.exp(-m.astype(np.float64))), own,
                               rtol=1e-6, atol=1e-7)
    for form in ((0, 0), [0, 0], (np.int64(0), np.int64(0)),
                 np.array([0, 0])):
        np.testing.assert_array_equal(
            tb.predict(x, iteration_range=form, device="cpu"), own)
    with pytest.raises(NotImplementedError, match="iteration_range"):
        tb.predict(x, iteration_range=(0, 2), device="cpu")
    with pytest.raises(NotImplementedError, match="pred_contribs"):
        tb.predict(x, pred_contribs=True, device="cpu")
    with pytest.raises(RuntimeError):
        tb.predict(x)  # the card by default: none here


def test_coef_and_intercept():
    from xgboost_ray_tpu_torch.sklearn import RayXGBRegressor

    x, y = S.XL[:S.N_TRAIN], S.YR[:S.N_TRAIN]
    m = RayXGBRegressor(n_estimators=8, booster="gblinear",
                        learning_rate=0.5, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        m.fit(x, y, ray_params=tx.RayParams(num_actors=1))
    bst = m.get_booster()
    np.testing.assert_array_equal(m.coef_, bst.weights[:, 0])
    np.testing.assert_array_equal(m.intercept_, bst.bias)
    assert m.intercept_.shape == (1,)
    assert np.mean((m.predict(x) - y) ** 2) < 0.5
