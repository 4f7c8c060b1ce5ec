"""Shared data and checks of the port's ranking ``train()`` tests
(``tests/test_torch_ranking_train.py``, ``tests/test_torch_ranking_world.py``):
seeded queries of 5 to 69 documents (the padded width above 32 in every
shard), a held-out set, and the comparison with the JAX package."""

import warnings

import numpy as np

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu_torch import distributed as D

ROUNDS = 3
PARAMS = {"eval_metric": ["ndcg@5", "map", "ndcg"], "max_depth": 3,
          "eta": 0.3, "max_bin": 32}


def _data(seed, groups):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(5, 70, groups)
    sizes[0] = 69  # the padded width stays above 32 in every shard
    qid = np.repeat(np.arange(groups), sizes)
    x = rng.standard_normal((qid.size, 6)).astype(np.float32)
    y = np.clip(np.round(x[:, 0] - 0.5 * x[:, 1]
                         + rng.standard_normal(qid.size) * 0.6 + 1.5),
                0, 4).astype(np.float32)
    return x, y, qid


X, Y, Q = _data(0, 16)
XV, YV, QV = _data(1, 6)


def assert_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 1e-6 * np.maximum(np.abs(want), 1.0)
    assert (np.abs(got - want) <= tol).all(), (what, got, want)


def train_pair(pkg, params, actors, world=None):
    """(booster, evals_result) of ``params`` on the module's queries with a
    held-out set; the port at ``actors`` 2 as the ranks of ``world``."""
    if pkg is tx and actors == 2:
        out = world.run(
            D._train_rank, D.share({"x": X, "label": Y, "qid": Q}), params,
            ROUNDS, {"device": "cpu", "eval_names": ["train", "valid"],
                     "eval_data": [None, dict(D.share(
                         {"x": XV, "label": YV, "qid": QV}),
                         sharding="INTERLEAVED")]})
        assert out[0]["model"] == out[1]["model"]
        return (tx.RayXGBoostBooster.load_raw(out[0]["model"]),
                out[0]["evals_result"])
    dtrain = pkg.RayDMatrix(X, Y, qid=Q)
    evals = [(dtrain, "train"), (pkg.RayDMatrix(XV, YV, qid=QV), "valid")]
    kw = {"device": "cpu"} if pkg is tx else {}
    ev = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        bst = pkg.train(params, dtrain, ROUNDS, evals=evals, evals_result=ev,
                        ray_params=pkg.RayParams(num_actors=actors), **kw)
    return bst, ev


def check_pair(objective, actors, world=None):
    params = {"objective": objective, **PARAMS}
    jb, jev = train_pair(jx, dict(params), actors)
    tb, tev = train_pair(tx, dict(params), actors, world)
    assert tb.get_dump(with_stats=True) == jb.get_dump(with_stats=True)
    for s in jev:
        assert list(tev[s]) == list(jev[s])
        for m in jev[s]:
            np.testing.assert_allclose(tev[s][m], jev[s][m], rtol=1e-6,
                                       err_msg=f"{s}-{m}")
    assert_close(tb.predict(XV, device="cpu"), jb.predict(XV), objective)
