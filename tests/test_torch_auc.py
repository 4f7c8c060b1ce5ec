"""The AUC metrics of the port against the JAX package on the CPU: B9a's
plain histogram (bins, fixed-point sums), ``auc`` / ``aucpr`` from the
merged bins, the host ``auc_exact``, ``train()`` with them at
``num_actors`` 1 and 2, early stopping on a maximised metric, and the
sklearn facade with ``count:poisson`` and ``eval_metric="auc"``.

Tolerances: bins bitwise; bin sums within float32 summation (1e-5
relative) of the reference's float32 scatter-add; ``auc`` / ``aucpr``
within 1e-6 of the reference's binned values; ``auc_exact`` within 1e-12
of ``_auc_np``; ``train()``: dumps equal, history within 1e-6, the early
stopping round and ``best_iteration`` equal. At ``num_actors=2`` the port
runs as a 2-rank gloo world.
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
from xgboost_ray_tpu_torch import distributed as D
from xgboost_ray_tpu_torch.ops import metrics as tm


def _rows(n=50_000, seed=0, k=1):
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal((n, k)) * 2.5).astype(np.float32)
    m[:6, 0] = [0.0, 1e-40, 40.0, -40.0, np.nan, 8.3178]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m[:, k - 1]))).astype(
        np.float32)
    y[7] = np.nan
    w = rng.uniform(0.2, 3.0, n).astype(np.float32)
    w[8] = 0.0
    return m, y, w


@pytest.mark.parametrize("k", [1, 3])
def test_histogram_matches_jax(k):
    """B9a's plain bins bitwise the reference's, its exact fixed-point sums
    within 1e-5 of the reference's float32 ones, the order of the rows
    changing no bit of it."""
    m, y, w = _rows(k=k)
    ref = np.asarray(jax.jit(jm.auc_hist)(jnp.asarray(m), jnp.asarray(y),
                                          jnp.asarray(w)))
    score = tm.auc_score(torch.from_numpy(m))
    p = np.asarray(jax.nn.sigmoid(jnp.asarray(m[:, 0 if k == 1 else 1])))
    jbins = np.clip(np.nan_to_num(p * tm.AUC_BINS).astype(np.int32), 0,
                    tm.AUC_BINS - 1)
    assert np.array_equal(tm.auc_bins(score).numpy(), jbins)
    scale = tm.auc_scale(float(np.abs(w).max()), m.shape[0])
    h = tm.auc_histogram(score, torch.from_numpy(y), torch.from_numpy(w),
                         scale)
    assert h.dtype == torch.int64 and h.shape == (2, tm.AUC_BINS)
    assert int(h.abs().sum()) <= 2 ** 53
    np.testing.assert_allclose(h.numpy() / scale, ref, rtol=1e-5, atol=1e-4)
    perm = np.random.default_rng(1).permutation(m.shape[0])
    hp = tm.auc_histogram(score[perm], torch.from_numpy(y[perm]),
                          torch.from_numpy(w[perm]), scale)
    assert torch.equal(h, hp)


@pytest.mark.parametrize("seed", [0, 1])
def test_auc_from_hist_matches_jax(seed):
    m, y, w = _rows(seed=seed)
    ok = ~np.isnan(y)
    m, y, w = m[ok], y[ok], w[ok]
    h = np.asarray(jax.jit(jm.auc_hist)(jnp.asarray(m), jnp.asarray(y),
                                        jnp.asarray(w)))
    score = tm.auc_score(torch.from_numpy(m))
    scale = tm.auc_scale(float(w.max()), m.shape[0])
    th = tm.auc_histogram(score, torch.from_numpy(y), torch.from_numpy(w),
                          scale).numpy().astype(np.float64)
    assert tm.auc_from_hist(th) == pytest.approx(
        float(jm.auc_from_hist(jnp.asarray(h))), abs=1e-6)
    assert tm.aucpr_from_hist(th) == pytest.approx(
        float(jm.aucpr_from_hist(jnp.asarray(h))), abs=1e-6)
    # one class only: 0.5 and 0.0, as the reference
    one = np.zeros_like(th)
    one[0] = th[0]
    assert tm.auc_from_hist(one) == 0.5
    assert tm.aucpr_from_hist(np.zeros_like(th)) == 0.0


@pytest.mark.parametrize("ties", [False, True])
def test_auc_exact_matches_jax(ties):
    m, y, w = _rows(n=20_000, seed=3)
    ok = ~np.isnan(y) & np.isfinite(m[:, 0])
    s, y, w = m[ok, 0].astype(np.float64), y[ok], w[ok].astype(np.float64)
    if ties:
        s = np.round(s, 1)
    assert tm.auc_exact_np(s, y, w) == pytest.approx(jm._auc_np(s, y, w),
                                                     abs=1e-12)
    assert tm.auc_exact_np(s, y, None) == pytest.approx(
        jm._auc_np(s, y, np.ones_like(s)), abs=1e-12)


# --------------------------------------------------------------------------
# train()
# --------------------------------------------------------------------------


def _matrix():
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2500, 6)).astype(np.float32)
    lin = 0.8 * x[:, 0] - 0.5 * x[:, 1] + 0.3 * x[:, 2] * x[:, 3]
    y = (lin + rng.standard_normal(2500) > 0).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 2500).astype(np.float32)
    return x, y, w


X, Y, W = _matrix()
PARAMS = {"objective": "binary:logistic", "max_depth": 4,
          "eval_metric": ["logloss", "auc", "aucpr", "auc_exact"]}


@pytest.fixture(scope="module")
def world2():
    with D.World(2, "cpu") as w:
        yield w


def _train(pkg, params, rounds, actors=1, **kw):
    dtrain = pkg.RayDMatrix(X[:2000], Y[:2000], weight=W[:2000])
    evals = [(dtrain, "train"),
             (pkg.RayDMatrix(X[2000:], Y[2000:], weight=W[2000:]), "valid")]
    if pkg is tx:
        kw["device"] = "cpu"
    ev = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        bst = pkg.train(params, dtrain, rounds, evals=evals, evals_result=ev,
                        ray_params=pkg.RayParams(num_actors=actors), **kw)
    return bst, ev


def _world_train(world, params, rounds, **options):
    def part(sl):
        return D.share({"x": X[sl], "label": Y[sl], "weight": W[sl]})

    out = world.run(D._train_rank, part(slice(0, 2000)), params, rounds,
                    {"device": "cpu", "eval_names": ["train", "valid"],
                     "eval_data": [None, dict(part(slice(2000, None)),
                                              sharding="INTERLEAVED")],
                     **options})
    assert out[0]["model"] == out[1]["model"]
    assert out[0]["evals_result"] == out[1]["evals_result"]
    return tx.RayXGBoostBooster.load_raw(out[0]["model"]), out[0]["evals_result"]


def _assert_history_close(tev, jev):
    assert list(tev) == list(jev)
    for s in jev:
        assert list(tev[s]) == list(jev[s]), s
        for m in jev[s]:
            np.testing.assert_allclose(tev[s][m], jev[s][m], rtol=0,
                                       atol=1e-6, err_msg=f"{s}-{m}")


@pytest.mark.parametrize("actors", [1, 2])
def test_train_with_auc_matches_jax(actors, world2):
    """auc and aucpr from the binned histogram merged in the round's one
    all-reduce, auc_exact from the host: the history of both sets within
    1e-6, the dump equal. At two ranks auc_exact is each rank's value
    weighted by its weight sum, as the reference's multi-process host
    metric (the JAX package on one process computes it over all rows)."""
    jb, jev = _train(jx, dict(PARAMS), 4, actors)
    if actors == 1:
        tb, tev = _train(tx, dict(PARAMS), 4)
    else:
        tb, tev = _world_train(world2, dict(PARAMS), 4)
        for s in tev:
            tev[s].pop("auc_exact")
            jev[s].pop("auc_exact")
    assert tb.get_dump() == jb.get_dump()
    _assert_history_close(tev, jev)


@pytest.mark.parametrize("actors", [1, 2])
def test_early_stopping_on_auc_matches_jax(actors, world2):
    """Early stopping on the held-out auc (the last metric, maximised)
    stops at the reference's round with its best iteration and score."""
    params = {"objective": "binary:logistic", "max_depth": 4, "eta": 0.9,
              "eval_metric": ["logloss", "auc"]}
    jb, jev = _train(jx, dict(params), 30, actors, early_stopping_rounds=2)
    if actors == 1:
        tb, tev = _train(tx, dict(params), 30, early_stopping_rounds=2)
    else:
        tb, tev = _world_train(world2, dict(params), 30,
                               early_stopping_rounds=2)
    assert len(tev["valid"]["auc"]) == len(jev["valid"]["auc"]) < 30
    assert tb.best_iteration == jb.best_iteration
    assert tb.best_score == pytest.approx(jb.best_score, abs=1e-6)
    assert tb.get_dump() == jb.get_dump()


def test_auc_is_the_same_bits_at_one_and_two_ranks(world2):
    """B9a's fixed-point histogram: the merged auc of two ranks is the
    same float64 as one rank's over the same rows (its float32 partial
    sums are not, so logloss is compared within 1e-6)."""
    params = {"objective": "binary:logistic", "max_depth": 3,
              "eval_metric": ["logloss", "auc", "aucpr"]}
    _, one = _world_train(world2, dict(params), 3, num_actors=2,
                          sharding="BATCH")
    dtrain = tx.RayDMatrix(X[:2000], Y[:2000], weight=W[:2000],
                           sharding=tx.RayShardingMode.BATCH)
    dvalid = tx.RayDMatrix(X[2000:], Y[2000:], weight=W[2000:],
                           sharding=tx.RayShardingMode.INTERLEAVED)
    ev = {}
    tx.train(params, dtrain, 3, evals=[(dtrain, "train"), (dvalid, "valid")],
             evals_result=ev, ray_params=tx.RayParams(num_actors=2),
             device="cpu")
    for s in ("train", "valid"):
        assert one[s]["auc"] == ev[s]["auc"]
        assert one[s]["aucpr"] == ev[s]["aucpr"]


def test_sklearn_regressor_poisson_matches_jax():
    """RayXGBRegressor(objective="count:poisson") against the JAX
    estimator: the exp of the margins within 1e-6."""
    from xgboost_ray_tpu.sklearn import RayXGBRegressor as JR

    counts = np.random.default_rng(4).poisson(
        np.exp(0.4 * X[:, 0])).astype(np.float32)
    kw = {"n_estimators": 4, "max_depth": 3}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        tr = tx.RayXGBRegressor(objective="count:poisson", device="cpu",
                                **kw).fit(X[:2000], counts[:2000])
        jr = JR(objective="count:poisson", **kw).fit(X[:2000], counts[:2000])
    np.testing.assert_allclose(tr.predict(X), jr.predict(X), rtol=1e-6)


def test_sklearn_classifier_auc_early_stopping_matches_jax():
    """A classifier with eval_metric="auc" and early stopping against the
    JAX estimator: the best iteration, the auc history within 1e-6."""
    from xgboost_ray_tpu.sklearn import RayXGBClassifier as JC

    ckw = dict(n_estimators=20, max_depth=3, learning_rate=0.9,
               eval_metric="auc", early_stopping_rounds=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        tc = tx.RayXGBClassifier(device="cpu", **ckw).fit(
            X[:2000], Y[:2000], eval_set=[(X[2000:], Y[2000:])])
        jc = JC(**ckw).fit(X[:2000], Y[:2000],
                           eval_set=[(X[2000:], Y[2000:])])
    assert tc.best_iteration == jc.best_iteration
    np.testing.assert_allclose(tc.evals_result()["validation_0"]["auc"],
                               jc.evals_result()["validation_0"]["auc"],
                               atol=1e-6)
    np.testing.assert_allclose(tc.predict_proba(X), jc.predict_proba(X),
                               rtol=1e-6, atol=1e-7)
