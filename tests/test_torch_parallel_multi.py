"""Parallel trees of K outputs (``num_parallel_tree`` T with
``multi:softprob`` or K quantile alphas) of the port against the JAX
package on the CPU.

- the round pass's T-tree add over K outputs
  (``ops/objectives.add_class_values``: the softmax pass's and K4's
  K-output kernel's plain versions) is bitwise the reference's margin add,
  ``margins.at[:, k].add(row_value / T)`` tree by tree
  (``xgboost_ray_tpu/engine.py:1413``), compiled;
- ``train()`` with ``multi:softprob`` at K = 3 and T = 3 with ``subsample``
  0.8, a held-out set and early stopping, and with ``reg:quantileerror`` at
  two alphas and T = 2, equals the JAX package at ``num_actors`` 1 and 2
  (a 2-rank gloo world): dumps with stats equal, the history and
  ``predict`` within the f32 summation bound (1e-6 relative above 1,
  absolute below), the same best iteration;
- a 3-class ``RayXGBRFClassifier`` is the JAX estimator's forest, and the
  same forest through ``train()`` at ``num_actors`` 2 is the JAX
  package's.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import _torch_constraints as C
from xgboost_ray_tpu import sklearn as jsk
from xgboost_ray_tpu_torch import sklearn as tsk
from xgboost_ray_tpu_torch.distributed import World
from xgboost_ray_tpu_torch.ops import objectives as to

#: name -> (params, label, rounds, early_stopping_rounds)
CASES = {
    "softprob": ({"objective": "multi:softprob", "num_class": 3,
                  "num_parallel_tree": 3, "subsample": 0.8,
                  "learning_rate": 1.0, "max_depth": 2,
                  "eval_metric": ["merror", "mlogloss"]}, "noisy", 6, 2),
    "quantile": ({"objective": "reg:quantileerror",
                  "quantile_alpha": [0.2, 0.8], "num_parallel_tree": 2,
                  "max_depth": 2}, "binary", 3, None),
    # the 3-class random forest RayXGBRFClassifier fits (one round)
    "forest": ({"objective": "multi:softprob", "num_class": 3,
                "num_parallel_tree": 2, "learning_rate": 1.0,
                "subsample": 0.8, "colsample_bynode": 0.8,
                "reg_lambda": 1e-5, "max_depth": 2}, "classes", 1, None),
}


def _run(name):
    params, label, rounds, es = CASES[name]
    return ({"max_bin": 32, "seed": 7, **params},
            {"binary": C.Y, "classes": C.YK, "noisy": C.YN}[label], rounds, es)


@functools.lru_cache(maxsize=None)
def _jax(name, actors):
    params, label, rounds, es = _run(name)
    return C.jax_train(params, label, rounds, actors, es)


@pytest.fixture(scope="module")
def world2():
    with World(2, "cpu") as w:
        yield w


@pytest.mark.parametrize("k,t", [(3, 2), (3, 3), (7, 4), (2, 1)])
def test_class_values_add_matches_jax(k, t):
    rng = np.random.default_rng(10 * k + t)
    m = rng.standard_normal((4097, k)).astype(np.float32)
    v = rng.standard_normal((k * t, 4097)).astype(np.float32)

    @jax.jit
    def ref(m, v):
        for c in range(k):
            for i in range(t):
                m = m.at[:, c].add(v[c * t + i] / t)
        return m

    got = torch.from_numpy(m.copy())
    to.add_class_values(got, torch.from_numpy(v))
    assert np.array_equal(got.numpy().view(np.int32),
                          np.asarray(ref(m, v)).view(np.int32))


@pytest.mark.parametrize("name", ["softprob", "quantile"])
def test_train_matches_jax(name):
    params, label, rounds, es = _run(name)
    jb, jev = _jax(name, 1)
    tb, tev = C.port_train(params, label, rounds, early_stopping_rounds=es)
    C.check_pair(jb, jev, tb, tev)
    k = params.get("num_class") or len(params["quantile_alpha"])
    n_rounds = tb.num_boosted_rounds()
    assert tb.forest.feature.shape[0] == n_rounds * k * params[
        "num_parallel_tree"]
    if es:
        assert n_rounds < rounds  # it stopped early, where JAX did
        assert tb.best_iteration == jb.best_iteration


@pytest.mark.parametrize("name", list(CASES))
def test_train_matches_jax_two_actors(name, world2):
    params, label, rounds, es = _run(name)
    jb, jev = _jax(name, 2)
    tb, tev = C.port_train(params, label, rounds, world2,
                           early_stopping_rounds=es)
    C.check_pair(jb, jev, tb, tev)


def test_rf_classifier_three_classes_matches_jax():
    """A 3-class ``RayXGBRFClassifier``: the JAX estimator's forest (2
    parallel trees a class), probabilities within the f32 bound."""
    kw = dict(n_estimators=2, max_depth=2, max_bin=32, random_state=7)
    x, y = C.X[:C.N_TRAIN], C.YK[:C.N_TRAIN]
    t = tsk.RayXGBRFClassifier(device="cpu", **kw).fit(x, y)
    j = jsk.RayXGBRFClassifier(**kw).fit(x, y)
    assert (t.get_booster().get_dump(with_stats=True)
            == j.get_booster().get_dump(with_stats=True))
    assert t.get_booster().forest.feature.shape[0] == 3 * 2
    C.close(t.predict_proba(C.X), j.predict_proba(C.X), "predict_proba")
    assert np.array_equal(t.predict(C.X), j.predict(C.X))
