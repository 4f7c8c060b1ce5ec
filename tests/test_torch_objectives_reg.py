"""The row-elementwise objectives and metrics of the port against the JAX
package on the CPU: every regression, count, hinge and quantile objective's
gradients, envelope (base margin, transform, outputs, default metric) and
metrics, K4's plain version in its K-output mode, and ``train()`` with each
objective at ``num_actors`` 1 and 2.

Tolerances: gradients and hessians bitwise against the compiled JAX
closures (a NaN matches any NaN); transforms and base margins bitwise
(``exp`` finite up to 88.72, as ``jnp.exp``: ``tests/test_torch_cox.py``
holds it from 80 to 89); metric sums within 1e-6 relative
(float32 sums taken in another order); ``train()``: ``get_dump()`` equal,
predictions within 1e-6, eval history within 1e-6 absolute or relative.
At ``num_actors=2`` the port runs as a 2-rank gloo world (one device folds
the shards' f32 histograms in another order than the JAX package's
2-device psum), sharing one world per module.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu.ops import metrics as jm
from xgboost_ray_tpu.ops import objectives as jo
from xgboost_ray_tpu_torch import distributed as D
from xgboost_ray_tpu_torch.ops import metrics as tm
from xgboost_ray_tpu_torch.ops import objectives as to

#: (objective, its parameters, the label kind of ``_rows``)
OBJECTIVES = [
    ("reg:absoluteerror", {}, "reg"),
    ("reg:pseudohubererror", {}, "reg"),
    ("reg:pseudohubererror", {"huber_slope": 0.7}, "reg"),
    ("reg:squaredlogerror", {}, "pos"),
    ("count:poisson", {}, "count"),
    ("reg:gamma", {}, "pos"),
    ("reg:tweedie", {}, "tweedie"),
    ("reg:tweedie", {"tweedie_variance_power": 1.3}, "tweedie"),
    ("binary:hinge", {}, "bin"),
    ("binary:logitraw", {}, "bin"),
    ("reg:logistic", {}, "bin"),
    ("reg:linear", {}, "reg"),
]


def _rows(kind, seed=0, n=60000):
    """Margins (ordinary ones, the clip's and the sigmoid's edges,
    subnormals, NaN, +-inf), labels of ``kind`` and weights (some zero,
    one subnormal)."""
    rng = np.random.default_rng(seed)
    m = np.concatenate([
        rng.standard_normal(n) * 3, rng.uniform(-40, 40, n // 4),
        [0.0, -0.0, 1e-40, -1e-40, 30, -30, 31, -31, 87, -87, np.nan,
         np.inf, -np.inf]]).astype(np.float32)
    k = m.shape[0]
    if kind == "count":
        y = rng.poisson(2.0, k)
    elif kind == "pos":
        y = rng.gamma(2.0, 1.5, k)
    elif kind == "tweedie":
        y = rng.poisson(1.0, k) * rng.gamma(2.0, 1.0, k)
    elif kind == "bin":
        y = rng.uniform(size=k) < 0.5
    else:
        y = rng.standard_normal(k) * 2
    w = rng.uniform(0.1, 2.0, k).astype(np.float32)
    w[:5] = 0.0
    w[5] = 1e-40
    return m, y.astype(np.float32), w


def _same(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return bool(np.all((a.view(np.int32) == b.view(np.int32))
                       | (np.isnan(a) & np.isnan(b))))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _ulps(a, b):
    """Per-element ulp distance of two float32 arrays (NaN matches NaN)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    d = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))
    return np.where(np.isnan(a) & np.isnan(b), 0, d)


def jax_round_gh(obj, *arrays):
    """The JAX closure's (g, h) as the reference's round computes them: g
    and h stacked in one program (``engine.py:1306-1330``), where XLA fuses
    them into one loop."""
    def gh(*a):
        g, h = obj.grad_hess(*a)
        return jnp.stack([g[:, 0], h[:, 0]], axis=1)

    out = np.asarray(jax.jit(gh)(*arrays))
    return out[:, 0], out[:, 1]


@pytest.mark.parametrize("name,kw,kind", OBJECTIVES)
def test_grad_hess_bitwise(name, kw, kind):
    """Bitwise the reference's round, except reg:tweedie (ROADMAP C):
    XLA's CPU loop computes the few rows at the edges of its parallel
    partitions in scalar code, which fuses y e^{(1-rho) m} into g and h
    where the vector body does not; the port follows the vector body, so
    those rows (at most 8 of these 75,013) are 1 ulp off."""
    m, y, w = _rows(kind)
    g, h = jax_round_gh(jo.get_objective(name, **kw), jnp.asarray(m[:, None]),
                        jnp.asarray(y), jnp.asarray(w))
    tg, th = to.grad_hess(*_t(m, y, w), to.get_objective(name, **kw))
    if name != "reg:tweedie":
        assert _same(tg.numpy(), g) and _same(th.numpy(), h), name
        return
    for got, want in ((tg, g), (th, h)):
        d = _ulps(got.numpy(), want)
        assert d.max() <= 1 and np.count_nonzero(d) <= 8, (d.max(),
                                                            np.count_nonzero(d))


@pytest.mark.parametrize("alphas", [(0.5,), (0.1, 0.5, 0.9)])
def test_quantile_grad_hess_bitwise(alphas):
    m, y, w = _rows("reg")
    mk = np.stack([m + np.float32(i) for i in range(len(alphas))], 1)
    g, h = jax.jit(jo.get_objective("reg:quantileerror",
                                    quantile_alpha=list(alphas)).grad_hess)(
        jnp.asarray(mk), jnp.asarray(y), jnp.asarray(w))
    tg, th = to.quantile_grad_hess(*_t(mk, y, w), alphas)
    assert _same(tg.numpy(), g) and _same(th.numpy(), h)


@pytest.mark.parametrize("name,kw,kind", OBJECTIVES + [
    ("reg:quantileerror", {"quantile_alpha": [0.1, 0.5, 0.9]}, "reg"),
    ("survival:aft", {}, "pos")])
def test_envelope_matches_jax(name, kw, kind):
    """base_score -> margin, the transform, outputs, default metric and
    output kind, bitwise."""
    j, t = jo.get_objective(name, **kw), to.get_objective(name, **kw)
    assert (t.default_metric, t.num_outputs, t.output_kind) == (
        j.default_metric, j.num_outputs, j.output_kind)
    for s in (0.5, 0.2, 0.93, 1.7, 3.0):
        if "logis" in name and s >= 1:
            continue
        assert t.base_score_to_margin(s) == j.base_score_to_margin(s), s
    m, _, _ = _rows(kind, seed=3)
    m = np.clip(np.nan_to_num(m), -80, 80).reshape(-1, 1)
    if t.num_outputs > 1:
        m = np.repeat(m, t.num_outputs, 1)
    assert _same(t.transform(torch.from_numpy(m)).numpy(),
                 j.transform(jnp.asarray(m)))


#: (metric, its parameters, the label kind of ``_rows``)
METRICS = [("logloss", {}, "bin"), ("error", {}, "bin"),
           ("error@0.7", {}, "bin"), ("rmse", {}, "reg"), ("mae", {}, "reg"),
           ("rmsle", {}, "pos"), ("mphe", {}, "reg"),
           ("mphe", {"huber_slope": 0.7}, "reg"), ("mape", {}, "reg"),
           ("poisson-nloglik", {}, "count"), ("quantile", {}, "reg"),
           ("quantile", {"quantile_alpha": 0.3}, "reg")]


@pytest.mark.parametrize("name,kw,kind", METRICS)
def test_metric_partials_match_jax(name, kw, kind):
    m, y, w = _rows(kind, seed=4)
    ok = np.isfinite(m)
    m, y, w = m[ok], y[ok], w[ok]
    num, den = jm.elementwise_contrib(
        name, jnp.asarray(m[:, None]), jnp.asarray(y), jnp.asarray(w),
        huber_slope=kw.get("huber_slope", 1.0),
        quantile_alpha=kw.get("quantile_alpha", 0.5))
    consts = to.objective_consts(
        huber_slope=kw.get("huber_slope", 1.0),
        threshold=tm.error_threshold([name]),
        alpha0=kw.get("quantile_alpha", 0.5))
    sums = tm.metric_partials(*_t(m, y, w), [name], consts)
    got = tm.metric_values(sums, [name])[name]
    want = float(num) / float(den)
    if name in ("rmse", "rmsle"):
        want = want ** 0.5
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12), name


def test_quantile_metric_over_k_outputs():
    m, y, w = _rows("reg", seed=5)
    ok = np.isfinite(m)
    mk = np.stack([m[ok] - 1, m[ok], m[ok] + 1], 1).astype(np.float32)
    y, w = y[ok], w[ok]
    alphas = (0.1, 0.5, 0.9)
    num, den = jm.elementwise_contrib("quantile", jnp.asarray(mk),
                                      jnp.asarray(y), jnp.asarray(w),
                                      quantile_alpha=alphas)
    sums = tm.metric_partials(*_t(mk[:, 0], y, w), ["quantile"],
                              alphas=alphas, margins=torch.from_numpy(mk))
    assert tm.metric_values(sums, ["quantile"])["quantile"] == pytest.approx(
        float(num) / float(den), rel=1e-6)


def test_round_update_multi_plain():
    """K4's K-output plain mode: the [N, K] margins updated in place, the
    [K, N, 2] gradient planes of the new margins bitwise the JAX closure's,
    the pinball sum over K within 1e-6."""
    obj = to.get_objective("reg:quantileerror", quantile_alpha=[0.1, 0.5, 0.9])
    m, y, w = _rows("reg", seed=6)
    ok = np.isfinite(m)
    y, w = y[ok], w[ok]
    mk = np.stack([m[ok]] * 3, 1).astype(np.float32)
    rv = np.random.default_rng(7).standard_normal((3, mk.shape[0])).astype(
        np.float32)
    margin = torch.from_numpy(mk.copy())
    gh, sums = to.round_update_multi(margin, *_t(rv, y, w), obj,
                                     metrics=["quantile"])
    new = mk + rv.T
    assert np.array_equal(margin.numpy(), new)
    g, h = jax.jit(jo.get_objective(
        "reg:quantileerror", quantile_alpha=[0.1, 0.5, 0.9]).grad_hess)(
        jnp.asarray(new), jnp.asarray(y), jnp.asarray(w))
    assert _same(gh[:, :, 0].numpy(), np.asarray(g).T)
    assert _same(gh[:, :, 1].numpy(), np.asarray(h).T)
    num, den = jm.elementwise_contrib("quantile", jnp.asarray(new),
                                      jnp.asarray(y), jnp.asarray(w),
                                      quantile_alpha=(0.1, 0.5, 0.9))
    assert tm.metric_values(sums, ["quantile"])["quantile"] == pytest.approx(
        float(num) / float(den), rel=1e-6)


def test_xla_transcendentals_bitwise():
    """The reference's float32 log, log1p and erf as its compiled CPU
    program evaluates them, and its correctly rounded sqrt."""
    rng = np.random.default_rng(8)
    cases = {
        "log": (jnp.log, to.log_f32, np.exp(rng.uniform(-87, 88, 200000))),
        "log1p": (jnp.log1p, to.log1p_f32, rng.uniform(-1, 3, 200000)),
        "erf": (jax.lax.erf, to.erf_f32, rng.standard_normal(200000) * 2),
        "sqrt": (jnp.sqrt, to.sqrt_rn, np.abs(rng.standard_normal(200000))),
    }
    edges = [0.0, 1e-40, np.inf, -np.inf, np.nan, -1.0, 5.0]
    for name, (jf, tf, x) in cases.items():
        x = np.concatenate([x, edges]).astype(np.float32)
        assert _same(tf(torch.from_numpy(x)).numpy(), jax.jit(jf)(x)), name


def test_a10_last_part_raises():
    """Ranking, survival:cox and their metrics, qid, error@t at up to four
    thresholds a run, and logloss and the AUCs with a softmax objective
    train now; what the port still refuses of these raises: a fifth
    error@t threshold, the metrics a softmax objective does not sum, and
    qid with weights (per-group weights)."""
    for name in ("rank:pairwise", "survival:cox"):
        assert to.get_objective(name).name == name
    for metric in ("ndcg", "map@5", "cox-nloglik"):
        tm.check_metric(metric, False)
    for metric in ("logloss", "auc", "aucpr"):
        tm.check_metric(metric, True)
    assert len(tm.error_thresholds(["error@0.3", "error@0.7"])) == 2
    with pytest.raises(NotImplementedError, match="thresholds"):
        tm.error_thresholds(["error@0.1", "error@0.2", "error@0.3",
                             "error@0.4", "error@0.6"])
    for metric in ("rmse", "error", "ndcg"):
        with pytest.raises(NotImplementedError, match="softmax"):
            tm.check_metric(metric, True)
    with pytest.raises(NotImplementedError, match="per-group weight"):
        tx.RayDMatrix(np.zeros((4, 2), np.float32), np.zeros(4, np.float32),
                      qid=np.zeros(4), weight=np.ones(4, np.float32))
    with pytest.raises(ValueError, match="requires qid"):
        tx.train({"objective": "rank:pairwise"}, tx.RayDMatrix(
            np.zeros((4, 2), np.float32), np.zeros(4, np.float32)), 1,
            ray_params=tx.RayParams(num_actors=1), device="cpu")


# --------------------------------------------------------------------------
# train(): the port against the JAX package, one small matrix for the file
# --------------------------------------------------------------------------

ROUNDS = 5


def _matrix():
    """2,000 + 500 rows of 6 features and a label of each kind, from a
    seed: the linear signal's regression target, its exp as a positive
    target, Poisson counts and compound Poisson-Gamma values of its exp,
    and its sign as a binary label."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2500, 6)).astype(np.float32)
    lin = 0.5 * x[:, 0] - 0.3 * x[:, 1] + 0.2 * x[:, 2] * x[:, 3]
    noise = rng.standard_normal(2500)
    labels = {
        "reg": lin + 0.3 * noise,
        "pos": np.exp(lin + 0.2 * noise),
        "count": rng.poisson(np.exp(lin)),
        "tweedie": rng.poisson(np.exp(lin)) * rng.gamma(2.0, 0.5, 2500),
        "bin": lin + 0.5 * noise > 0,
    }
    return x, {k: np.asarray(v, np.float32) for k, v in labels.items()}


X, LABELS = _matrix()

#: (objective, its extra parameters, label kind); each trains with its
#: default metric and the metrics listed
TRAIN_CASES = [
    ("reg:absoluteerror", {"eval_metric": ["rmse", "mae"]}, "reg"),
    ("reg:pseudohubererror", {"huber_slope": 0.7}, "reg"),
    ("reg:squaredlogerror", {"eval_metric": ["rmsle", "mape"]}, "pos"),
    ("count:poisson", {}, "count"),
    ("reg:gamma", {"eval_metric": ["rmse", "mae"]}, "pos"),
    ("reg:tweedie", {"tweedie_variance_power": 1.3}, "tweedie"),
    ("binary:hinge", {"eval_metric": ["error", "error@0.7"]}, "bin"),
    ("reg:quantileerror", {"quantile_alpha": [0.1, 0.5, 0.9]}, "reg"),
    ("binary:logitraw", {}, "bin"),
]


@pytest.fixture(scope="module")
def world2():
    with D.World(2, "cpu") as w:
        yield w


def _jax_train(params, y):
    ev = {}
    dtrain = jx.RayDMatrix(X[:2000], y[:2000])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        bst = jx.train(params, dtrain, ROUNDS, evals_result=ev,
                       evals=[(dtrain, "train"),
                              (jx.RayDMatrix(X[2000:], y[2000:]), "valid")],
                       ray_params=jx.RayParams(num_actors=params.pop(
                           "_actors")))
    return bst, ev


def _port_train(params, y, actors, world):
    if actors == 1:
        ev = {}
        dtrain = tx.RayDMatrix(X[:2000], y[:2000])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            bst = tx.train(params, dtrain, ROUNDS, evals_result=ev,
                           evals=[(dtrain, "train"),
                                  (tx.RayDMatrix(X[2000:], y[2000:]),
                                   "valid")],
                           ray_params=tx.RayParams(num_actors=1),
                           device="cpu")
        return bst, ev
    held = [dict(D.share({"x": X[2000:], "label": y[2000:]}),
                 sharding="INTERLEAVED")]
    out = world.run(D._train_rank, D.share({"x": X[:2000], "label": y[:2000]}),
                    params, ROUNDS, {"device": "cpu",
                                     "eval_names": ["train", "valid"],
                                     "eval_data": [None, *held]})
    assert out[0]["model"] == out[1]["model"]
    return tx.RayXGBoostBooster.load_raw(out[0]["model"]), out[0]["evals_result"]


def assert_history_close(tev, jev):
    assert tev.keys() == jev.keys()
    for s in jev:
        assert list(tev[s]) == list(jev[s]), s
        for m in jev[s]:
            np.testing.assert_allclose(tev[s][m], jev[s][m], rtol=1e-6,
                                       atol=1e-6, err_msg=f"{s}-{m}")


@pytest.mark.parametrize("actors", [1, 2])
@pytest.mark.parametrize("name,kw,kind", TRAIN_CASES)
def test_train_matches_jax(name, kw, kind, actors, world2):
    """Dumps equal, history and predictions (quantiles [N, 3], hinge's
    classes, the exp of the log-link objectives) within 1e-6. Depth 4, the
    quantile model's three trees a round at depth 2 (the JAX package's
    K-tree round compiles for longer: the test stays under 8 s)."""
    depth = 2 if name == "reg:quantileerror" else 4
    params = {"objective": name, "max_depth": depth, **kw}
    y = LABELS[kind]
    jb, jev = _jax_train(dict(params, _actors=actors), y)
    tb, tev = _port_train(dict(params), y, actors, world2)
    assert tb.get_dump() == jb.get_dump()
    assert_history_close(tev, jev)
    tp, jp = tb.predict(X, device="cpu"), np.asarray(jb.predict(X))
    assert tp.shape == jp.shape
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.predict(X, output_margin=True, device="cpu"),
                               jb.predict(X, output_margin=True), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name,kw,kind", [TRAIN_CASES[3], TRAIN_CASES[7],
                                          TRAIN_CASES[6]])
def test_models_cross_load(name, kw, kind, tmp_path):
    """A JAX model of the objective loads and predicts in the port and a
    port model in the JAX package (the model JSON is shared), values within
    1e-6, the parameters (alphas, slopes) kept."""
    params = {"objective": name, "max_depth": 2, **kw}
    y = LABELS[kind]
    jb, _ = _jax_train(dict(params, _actors=1), y)
    jb.save_model(str(tmp_path / "j.json"))
    tb = tx.RayXGBoostBooster.load_model(str(tmp_path / "j.json"))
    np.testing.assert_allclose(tb.predict(X, device="cpu"),
                               np.asarray(jb.predict(X)), rtol=1e-6, atol=1e-6)
    tb.save_model(str(tmp_path / "t.json"))
    back = jx.RayXGBoostBooster.load_model(str(tmp_path / "t.json"))
    assert back.params.quantile_alpha == jb.params.quantile_alpha
    np.testing.assert_allclose(np.asarray(back.predict(X)),
                               np.asarray(jb.predict(X)), rtol=0, atol=0)


def test_served_values_match_predict():
    """serve's ``value`` kind of a Poisson and a quantile model: bitwise
    ``predict`` on the same device."""
    from xgboost_ray_tpu_torch.serve.predictor import CompiledPredictor

    for name, kw, kind in (TRAIN_CASES[3], TRAIN_CASES[7]):
        params = {"objective": name, "max_depth": 3, **kw}
        dm = tx.RayDMatrix(X[:2000], LABELS[kind][:2000])
        bst = tx.train(params, dm, 3, ray_params=tx.RayParams(num_actors=1),
                       device="cpu")
        pred = CompiledPredictor(bst, device="cpu")
        out = pred.predict(X[:37], "value")
        assert np.array_equal(out, bst.predict(X[:37], device="cpu")), name


def test_squaredlogerror_rejects_labels_at_or_below_minus_one():
    y = LABELS["reg"][:2000].copy()
    y[3] = -1.0
    with pytest.raises(ValueError, match="labels > -1"):
        tx.train({"objective": "reg:squaredlogerror"},
                 tx.RayDMatrix(X[:2000], y), 1,
                 ray_params=tx.RayParams(num_actors=1), device="cpu")
