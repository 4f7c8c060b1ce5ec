"""Learning to rank through the port's entry points against the JAX package
on the CPU: ``train()`` with ``rank:pairwise`` / ``rank:ndcg`` /
``rank:map`` at ``num_actors`` 1 (``num_actors`` 2, a 2-rank gloo world:
``tests/test_torch_ranking_world.py``), the ``RayXGBRanker`` estimator,
JAX-trained ``rank:ndcg`` and ``survival:cox`` models predicting through
the port, and a served probe.

Tolerances: ``get_dump(with_stats=True)`` equal (the gradients are the
reference's bit for bit: the queries' padded width is above 32); the
history within 1e-6 relative (the reference adds the groups' ndcg / map in
f32 chunks, the port in f64); predictions within 1e-6, relative above 1
and absolute below (the margin sum over a few trees fuses otherwise in
XLA's program); the served values bitwise the port's ``predict``.
"""

import json
import urllib.request
import warnings

import numpy as np
import pytest

import xgboost_ray_tpu as jx
import xgboost_ray_tpu.sklearn as js
import xgboost_ray_tpu_torch as tx
import xgboost_ray_tpu_torch.sklearn as ts
from _torch_ranking import (PARAMS, QV, ROUNDS, XV, YV, Q, X, Y, assert_close,
                            check_pair)
from xgboost_ray_tpu_torch import serve
from xgboost_ray_tpu_torch.convert import booster_from_jax_state

@pytest.mark.parametrize("objective", ["rank:pairwise", "rank:ndcg",
                                       "rank:map"])
def test_train_matches_jax(objective):
    check_pair(objective, 1)


def test_ranker_matches_the_jax_estimator():
    """``RayXGBRanker`` (the ranker cases of the JAX package's
    ``tests/test_sklearn.py``, aimed at the port): ``qid`` is required, the
    fit learns, and model, history and scores equal the JAX estimator's."""
    kw = dict(n_estimators=ROUNDS, max_depth=3, eval_metric=["ndcg@5"],
              max_bin=32)
    with pytest.raises(ValueError, match="qid"):
        ts.RayXGBRanker(device="cpu", **kw).fit(X, Y)
    ests = {}
    for mod, extra in ((js, {}), (ts, {"device": "cpu"})):
        est = mod.RayXGBRanker(**kw, **extra)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            est.fit(X, Y, qid=Q, eval_set=[(XV, YV)], eval_qid=[QV],
                    ray_params=mod.RayParams(num_actors=1))
        ests[mod] = est
    j, t = ests[js], ests[ts]
    assert t.get_booster().get_dump(with_stats=True) == \
        j.get_booster().get_dump(with_stats=True)
    hist = t.evals_result()["validation_0"]["ndcg@5"]
    np.testing.assert_allclose(
        hist, j.evals_result()["validation_0"]["ndcg@5"], rtol=1e-6)
    assert hist[-1] > hist[0]
    scores = t.predict(XV)
    assert scores.shape == (XV.shape[0],)
    assert_close(scores, j.predict(XV), "RayXGBRanker.predict")


@pytest.mark.parametrize("objective", ["rank:ndcg", "survival:cox"])
def test_jax_trained_models_predict_through_the_port(objective, tmp_path):
    """A JAX-trained ``rank:ndcg`` model (values: the margins) and a
    ``survival:cox`` model (values: the hazard ratio exp(margin), B8's exp
    transform) carried across with ``booster_from_jax_state`` and loaded
    from the JAX package's saved model predict as the JAX booster does."""
    if objective == "rank:ndcg":
        dm = jx.RayDMatrix(X, Y, qid=Q)
    else:
        t = np.exp(0.4 * X[:, 0]).astype(np.float32)
        dm = jx.RayDMatrix(X, np.where(np.arange(X.shape[0]) % 3 == 0, -t, t))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jb = jx.train({"objective": objective, "max_depth": 3, "max_bin": 32},
                      dm, ROUNDS, ray_params=jx.RayParams(num_actors=1))
    path = str(tmp_path / "model.json")
    jb.save_model(path)
    conv = booster_from_jax_state(jb.forest._asdict(), jb.cuts,
                                  jb.base_score, jb.params)
    want_m = np.asarray(jb.predict(XV, output_margin=True))
    want_v = np.asarray(jb.predict(XV))
    for bst in (conv, tx.RayXGBoostBooster.load_model(path)):
        assert_close(bst.predict(XV, output_margin=True, device="cpu"), want_m,
               objective)
        assert_close(bst.predict(XV, device="cpu"), want_v, objective)


def test_served_ranking_probe():
    """A served ``value`` probe of a ranking model: bitwise its
    ``predict``."""
    dtrain = tx.RayDMatrix(X, Y, qid=Q)
    bst = tx.train({"objective": "rank:ndcg", **PARAMS}, dtrain, ROUNDS,
                   ray_params=tx.RayParams(num_actors=1), device="cpu")
    h = serve.create_server(bst, max_batch=32, max_delay_ms=1.0,
                            device="cpu")
    try:
        q = XV[:11]
        for kind, kw in (("value", {}), ("margin", {"output_margin": True})):
            req = urllib.request.Request(
                h.url + "/predict",
                json.dumps({"data": q.tolist(), "kind": kind}).encode(),
                {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                got = json.loads(r.read())["predictions"]
            ref = bst.predict(q, device="cpu", **kw)
            assert np.array_equal(np.asarray(got, ref.dtype), ref), kind
    finally:
        h.shutdown()
