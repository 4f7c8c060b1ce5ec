"""Shared training helpers of the port's constraint and K-output
parallel-tree tests (``tests/test_torch_constraints.py``,
``tests/test_torch_parallel_multi.py``): ``tests/_torch_sampling.py``'s
seeded matrix (2,001 training rows, 500 held-out, 8 features, 3% missing,
binary and 3-class labels, and noisy 3-class ones)
trained by the JAX package at ``num_actors`` 1 or 2 and by the port at
world 1 or in a 2-rank gloo world (``num_actors`` 2), and the comparison
of the two models."""

import warnings

import numpy as np

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from _torch_sampling import N_TRAIN, X, Y, YK  # noqa: F401
from xgboost_ray_tpu_torch import distributed as D

#: 3-class labels with 60% of them redrawn at random: a held-out loss that
#: stops improving within a few rounds (early stopping)
_rng = np.random.default_rng(3)
YN = np.where(_rng.random(len(YK)) < 0.6, _rng.integers(0, 3, len(YK)),
              YK).astype(np.float32)


def jax_train(params, label, rounds, actors=1, early_stopping_rounds=None):
    """The JAX package's model and history (sets ``train`` and ``valid``)."""
    dtrain = jx.RayDMatrix(X[:N_TRAIN], label[:N_TRAIN])
    dvalid = jx.RayDMatrix(X[N_TRAIN:], label[N_TRAIN:])
    ev = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        bst = jx.train(params, dtrain, rounds, evals_result=ev,
                       evals=[(dtrain, "train"), (dvalid, "valid")],
                       early_stopping_rounds=early_stopping_rounds,
                       ray_params=jx.RayParams(num_actors=actors))
    return bst, ev


def port_train(params, label, rounds, world=None,
               early_stopping_rounds=None):
    """The port's model and history at world 1 (``num_actors`` 1), or in
    the 2-rank ``world`` (``num_actors`` 2, a rank each block); the two
    ranks' models must be the same bytes."""
    if world is None:
        dtrain = tx.RayDMatrix(X[:N_TRAIN], label[:N_TRAIN])
        dvalid = tx.RayDMatrix(X[N_TRAIN:], label[N_TRAIN:])
        ev = {}
        bst = tx.train(params, dtrain, rounds, evals_result=ev,
                       evals=[(dtrain, "train"), (dvalid, "valid")],
                       early_stopping_rounds=early_stopping_rounds,
                       ray_params=tx.RayParams(num_actors=1), device="cpu")
        return bst, ev
    held = [dict(D.share({"x": X[N_TRAIN:], "label": label[N_TRAIN:]}),
                 sharding="INTERLEAVED")]
    out = world.run(D._train_rank,
                    D.share({"x": X[:N_TRAIN], "label": label[:N_TRAIN]}),
                    params, rounds,
                    {"device": "cpu", "eval_names": ["train", "valid"],
                     "eval_data": [None, *held], "num_actors": 2,
                     "early_stopping_rounds": early_stopping_rounds})
    assert out[0]["model"] == out[1]["model"]
    return (tx.RayXGBoostBooster.load_raw(out[0]["model"]),
            out[0]["evals_result"])


def close(got, ref, what):
    """Within the f32 summation bound: 1e-6 relative above 1, 1e-6
    absolute below."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    bound = 1e-6 * np.maximum(np.abs(ref), 1.0)
    assert (np.abs(got - ref) <= bound).all(), what


def check_pair(jb, jev, tb, tev):
    """Dumps with stats equal; the history and ``predict`` within the f32
    summation bound."""
    assert tb.get_dump(with_stats=True) == jb.get_dump(with_stats=True)
    assert tev.keys() == jev.keys()
    for s in jev:
        assert list(tev[s]) == list(jev[s]), s
        for m in jev[s]:
            close(tev[s][m], jev[s][m], f"{s}-{m}")
    close(tb.predict(X, device="cpu"), np.asarray(jb.predict(X)), "predict")
