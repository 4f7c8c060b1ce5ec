"""Shared data and checks of the port's dart and gblinear tests
(``tests/test_torch_dart*.py``, ``tests/test_torch_gblinear*.py``): seeded
rows with 3 % NaN, binary, 3-class and real labels, a held-out split, and
the dart configurations trained by both packages."""

import functools
import warnings

import numpy as np

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu_torch import distributed as D
from xgboost_ray_tpu_torch import linear as TL

N_TRAIN, N_VALID, F = 600, 200, 5


def _data(seed=0):
    rng = np.random.default_rng(seed)
    n = N_TRAIN + N_VALID
    x = rng.standard_normal((n, F)).astype(np.float32)
    x[rng.random((n, F)) < 0.03] = np.nan
    lin = np.nan_to_num(x[:, 0] + 0.5 * x[:, 1] - 0.4 * x[:, 3])
    y = (lin + 0.5 * rng.standard_normal(n) > 0).astype(np.float32)
    yk = np.clip(np.round(np.nan_to_num(x[:, 0] + x[:, 2]) + 1.0), 0,
                 2).astype(np.float32)
    yr = (2.0 * np.nan_to_num(x[:, 0]) - np.nan_to_num(x[:, 1])
          + 0.3 * rng.standard_normal(n)).astype(np.float32)
    return x, y, yk, yr


X, Y, YK, YR = _data()

#: name -> (params, label, held-out set with early stopping)
DART_CASES = {
    # binary, weighted drops, forest normalisation, one_drop and skip_drop,
    # a held-out set and early stopping
    "binary": ({"objective": "binary:logistic", "rate_drop": 0.3,
                "one_drop": 1, "skip_drop": 0.2, "sample_type": "weighted",
                "normalize_type": "forest",
                "eval_metric": ["error", "logloss"]}, Y, True),
    # K = 3 trees a round, uniform drops, tree normalisation
    "softprob": ({"objective": "multi:softprob", "num_class": 3,
                  "rate_drop": 0.3, "max_depth": 1}, YK, False),
    # row sampling under the drops
    "subsample": ({"objective": "binary:logistic", "rate_drop": 0.3,
                   "subsample": 0.8}, Y, False),
}
DART_ROUNDS = 5


def dart_params(name):
    return {"booster": "dart", "eta": 0.3, "max_bin": 32, "seed": 3,
            "max_depth": 2, **DART_CASES[name][0]}


def _evals(pkg, name):
    _, label, held = DART_CASES[name]
    dtrain = pkg.RayDMatrix(X[:N_TRAIN], label[:N_TRAIN])
    evals = [(dtrain, "train")]
    if held:
        evals.append((pkg.RayDMatrix(X[N_TRAIN:], label[N_TRAIN:]),
                      "valid"))
    return dtrain, evals


def _train(pkg, name, actors, **kw):
    dtrain, evals = _evals(pkg, name)
    ev = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        bst = pkg.train(dart_params(name), dtrain, DART_ROUNDS, evals=evals,
                        evals_result=ev,
                        early_stopping_rounds=2 if len(evals) > 1 else None,
                        ray_params=pkg.RayParams(num_actors=actors), **kw)
    return bst, ev


@functools.lru_cache(maxsize=None)
def jax_dart(name, actors):
    return _train(jx, name, actors)


def port_dart(name, world=None):
    """The port at world 1, or in ``world`` (2 gloo ranks, ``num_actors``
    2)."""
    if world is None:
        return _train(tx, name, 1, device="cpu")
    _, label, held = DART_CASES[name]
    names = ["train"] + (["valid"] if held else [])
    eval_data = [None] + ([dict(D.share({"x": X[N_TRAIN:],
                                         "label": label[N_TRAIN:]}),
                                sharding="INTERLEAVED")] if held else [])
    out = world.run(D._train_rank,
                    D.share({"x": X[:N_TRAIN], "label": label[:N_TRAIN]}),
                    dart_params(name), DART_ROUNDS,
                    {"device": "cpu", "eval_names": names,
                     "eval_data": eval_data, "num_actors": 2,
                     "early_stopping_rounds": 2 if held else None})
    assert out[0]["model"] == out[1]["model"]
    return (tx.RayXGBoostBooster.load_raw(out[0]["model"]),
            out[0]["evals_result"])


def check_dart(jb, jev, tb, tev):
    """Dumps with stats equal (B4w sums the forest in XLA's order), tree
    weights equal, the history within 1e-6 (K4's metric sums in their own
    order)."""
    assert tb.get_dump(with_stats=True) == jb.get_dump(with_stats=True)
    np.testing.assert_array_equal(tb.tree_weights,
                                  np.asarray(jb.tree_weights))
    assert tb.best_iteration == jb.best_iteration
    assert tev.keys() == jev.keys()
    for s in jev:
        assert list(tev[s]) == list(jev[s])
        for m in jev[s]:
            np.testing.assert_allclose(tev[s][m], jev[s][m], rtol=0,
                                       atol=1e-6, err_msg=f"{s}-{m}")


def check_dart_predict(jb, tb):
    """``predict`` within 1e-6 (B8's walk sums the weighted trees in its
    own order)."""
    np.testing.assert_allclose(tb.predict(X, device="cpu"),
                               np.asarray(jb.predict(X)), rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------------------------------
# gblinear
# --------------------------------------------------------------------------

#: name -> (params, label)
LINEAR_CASES = {
    # L1 and L2, a near-constant column whose weight the L1 term holds at 0
    "squared_l1l2": ({"objective": "reg:squarederror", "reg_alpha": 0.05,
                      "reg_lambda": 0.1}, YR),
    "binary": ({"objective": "binary:logistic"}, Y),
    "softprob": ({"objective": "multi:softprob", "num_class": 3}, YK),
}
LINEAR_ROUNDS = 8
#: gblinear weights and bias against the JAX package, relative to the
#: largest |weight| (bias: to max(|bias|, 1)): the coordinate sums are
#: XLA's row reduces there and B16's fixed blocked order here (measured:
#: 2.7e-7), and ``x @ w`` likewise
LINEAR_RTOL = 1e-5


def linear_x():
    """The rows of the gblinear cases: column 4 carries no signal, a
    hundredth of the others' scale (the L1 term keeps its weight 0)."""
    x = X.copy()
    x[:, 4] = 0.01 * np.random.default_rng(5).standard_normal(x.shape[0])
    return x


XL = linear_x()


def linear_params(name):
    return {"booster": "gblinear", "eta": 0.5, **LINEAR_CASES[name][0]}


def _linear_train(pkg, name, actors, **kw):
    _, label = LINEAR_CASES[name]
    dtrain = pkg.RayDMatrix(XL[:N_TRAIN], label[:N_TRAIN])
    dvalid = pkg.RayDMatrix(XL[N_TRAIN:], label[N_TRAIN:])
    ev = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        bst = pkg.train(linear_params(name), dtrain, LINEAR_ROUNDS,
                        evals=[(dtrain, "train"), (dvalid, "valid")],
                        evals_result=ev,
                        ray_params=pkg.RayParams(num_actors=actors), **kw)
    return bst, ev


@functools.lru_cache(maxsize=None)
def jax_linear(name, actors):
    return _linear_train(jx, name, actors)


def port_linear(name, world=None):
    if world is None:
        return _linear_train(tx, name, 1, device="cpu")
    _, label = LINEAR_CASES[name]
    held = dict(D.share({"x": XL[N_TRAIN:], "label": label[N_TRAIN:]}),
                sharding="INTERLEAVED")
    out = world.run(D._train_rank,
                    D.share({"x": XL[:N_TRAIN], "label": label[:N_TRAIN]}),
                    linear_params(name), LINEAR_ROUNDS,
                    {"device": "cpu", "eval_names": ["train", "valid"],
                     "eval_data": [None, held], "num_actors": 2})
    assert out[0]["model"] == out[1]["model"]
    return (TL.RayLinearBooster.load_raw(out[0]["model"]),
            out[0]["evals_result"])


def check_linear(jb, jev, tb, tev):
    """Weights and bias within ``LINEAR_RTOL``, the same exact zeros, the
    history and ``predict`` within 1e-5."""
    scale = np.abs(jb.weights).max()
    np.testing.assert_allclose(tb.weights, jb.weights, rtol=0,
                               atol=LINEAR_RTOL * scale)
    np.testing.assert_allclose(
        tb.bias, jb.bias, rtol=0,
        atol=LINEAR_RTOL * max(np.abs(jb.bias).max(), 1.0))
    np.testing.assert_array_equal(tb.weights == 0, jb.weights == 0)
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds()
    assert tev.keys() == jev.keys()
    for s in jev:
        assert list(tev[s]) == list(jev[s])
        for m in jev[s]:
            np.testing.assert_allclose(tev[s][m], jev[s][m], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{s}-{m}")
    np.testing.assert_allclose(tb.predict(XL, device="cpu"),
                               np.asarray(jb.predict(XL)), rtol=1e-5,
                               atol=1e-5)
