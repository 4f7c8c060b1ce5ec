"""Shared data and checks of the port's sampled ``train()`` tests
(``tests/test_torch_sampling_train.py``, ``tests/test_torch_sampling_world.py``):
a seeded matrix of 2,001 training rows (an odd count: at ``num_actors`` 2 the
reference's second block has a padding row, which takes part in the draws)
and 500 held-out rows, binary and 3-class labels, feature weights with two
zeros, and the configurations of the sampling slice."""

import warnings

import numpy as np

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu_torch import distributed as D

ROUNDS = 3
N_TRAIN = 2001


def _data(seed=0, n=N_TRAIN + 500, f=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.03] = np.nan
    lin = x[:, 0] + 0.5 * x[:, 1] - 0.4 * np.nan_to_num(x[:, 3])
    y = (np.nan_to_num(lin) + rng.standard_normal(n) * 0.5 > 0)
    yk = np.clip(np.round(np.nan_to_num(x[:, 0] + x[:, 2]) + 1.0), 0, 2)
    fw = rng.random(f).astype(np.float32)
    fw[[2, 5]] = 0.0
    return x, y.astype(np.float32), yk.astype(np.float32), fw


X, Y, YK, FW = _data()

#: name -> (params, label, feature weights or None)
CASES = {
    # S1: uniform rows, bytree and bynode masks, error@t at two thresholds
    "uniform": ({"objective": "binary:logistic", "subsample": 0.8,
                 "colsample_bytree": 0.8, "colsample_bynode": 0.8,
                 "eval_metric": ["logloss", "error@0.3", "error@0.7",
                                 "auc"]}, Y, None),
    # S2: GOSS and bylevel masks
    "goss": ({"objective": "binary:logistic",
              "sampling_method": "gradient_based", "top_rate": 0.2,
              "other_rate": 0.1, "colsample_bylevel": 0.7}, Y, None),
    # S3: bynode masks over feature weights (two of them 0)
    "weights": ({"objective": "binary:logistic", "colsample_bynode": 0.5},
                Y, FW),
    # S5: a sampled multiclass model and the softmax metric combinations
    "softprob": ({"objective": "multi:softprob", "num_class": 3,
                  "subsample": 0.8,
                  "eval_metric": ["mlogloss", "logloss", "auc"]}, YK, None),
    "softmax_metrics": ({"objective": "multi:softmax", "num_class": 3,
                         "eval_metric": ["merror", "logloss", "aucpr"]},
                        YK, None),
    # a random forest: one round of parallel trees, lr 1
    "forest": ({"objective": "binary:logistic", "subsample": 0.8,
                "colsample_bynode": 0.8, "num_parallel_tree": 3,
                "learning_rate": 1.0, "reg_lambda": 1e-5, "max_depth": 2},
               Y, None),
}


def params_of(name):
    params, _, _ = CASES[name]
    return {"max_depth": 2 if params["objective"].startswith("multi")
            else 3, "max_bin": 64, "seed": 7, **params}


def _matrices(pkg, label, fw):
    dtrain = pkg.RayDMatrix(X[:N_TRAIN], label[:N_TRAIN], feature_weights=fw)
    return dtrain, pkg.RayDMatrix(X[N_TRAIN:], label[N_TRAIN:])


def jax_train(name, actors):
    _, label, fw = CASES[name]
    dtrain, dvalid = _matrices(jx, label, fw)
    ev = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        bst = jx.train(params_of(name), dtrain, ROUNDS, evals_result=ev,
                       evals=[(dtrain, "train"), (dvalid, "valid")],
                       ray_params=jx.RayParams(num_actors=actors))
    return bst, ev


def port_train(name, actors, world=None):
    """The port at world 1 (``num_actors`` 1), or in a 2-rank gloo world
    (``num_actors`` 2: the reference's two device blocks, a rank each)."""
    _, label, fw = CASES[name]
    if world is None:
        dtrain, dvalid = _matrices(tx, label, fw)
        ev = {}
        bst = tx.train(params_of(name), dtrain, ROUNDS, evals_result=ev,
                       evals=[(dtrain, "train"), (dvalid, "valid")],
                       ray_params=tx.RayParams(num_actors=actors),
                       device="cpu")
        return bst, ev
    held = [dict(D.share({"x": X[N_TRAIN:], "label": label[N_TRAIN:]}),
                 sharding="INTERLEAVED")]
    out = world.run(D._train_rank,
                    D.share({"x": X[:N_TRAIN], "label": label[:N_TRAIN]}),
                    params_of(name), ROUNDS,
                    {"device": "cpu", "eval_names": ["train", "valid"],
                     "eval_data": [None, *held], "feature_weights": fw,
                     "num_actors": actors})
    assert out[0]["model"] == out[1]["model"]
    return tx.RayXGBoostBooster.load_raw(out[0]["model"]), out[0]["evals_result"]


def check_pair(jb, jev, tb, tev):
    """Dumps with stats equal, the history within 1e-6, predictions within
    1e-6 (the f32 sums of a few trees)."""
    assert tb.get_dump(with_stats=True) == jb.get_dump(with_stats=True)
    assert tev.keys() == jev.keys()
    for s in jev:
        assert list(tev[s]) == list(jev[s]), s
        for m in jev[s]:
            np.testing.assert_allclose(tev[s][m], jev[s][m], rtol=0,
                                       atol=1e-6, err_msg=f"{s}-{m}")
    tp, jp = tb.predict(X, device="cpu"), np.asarray(jb.predict(X))
    assert tp.shape == jp.shape
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-6)
