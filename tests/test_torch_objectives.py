"""Parity of the objectives, K4's plain version and the metrics with the
JAX package.

Tolerances: gradients and hessians bitwise (the plain version evaluates the
sigmoid with the reference's own float32 exp); metric sums within 1e-6
relative (float32 sums taken in another order); base_score -> margin
bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgboost_ray_tpu.ops import metrics as jm
from xgboost_ray_tpu.ops import objectives as jo
from xgboost_ray_tpu_torch.ops import metrics as tm
from xgboost_ray_tpu_torch.ops import objectives as to


def _rows(seed, n=20000):
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal(n) * 6).astype(np.float32)
    m[:4] = [0.0, -100.0, 100.0, 88.5]
    y = (rng.random(n) > 0.4).astype(np.float32)
    w = rng.uniform(0.2, 3.0, n).astype(np.float32)
    return m, y, w


def test_exp_f32_and_sigmoid_match_compiled_jax():
    """exp_f32 equals the compiled exp wherever its result is a normal
    float32 (|v| <= 87); beyond that the sigmoid built on it still equals
    jax.nn.sigmoid bit for bit (1 / (1 + e) is 0 or 1 either way)."""
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.standard_normal(50000).astype(np.float32) * 20,
                        np.linspace(-87, 87, 20001, dtype=np.float32)])
    v = np.clip(v, -87, 87)
    ref = np.asarray(jax.jit(jnp.exp)(jnp.asarray(v)))
    assert np.array_equal(to.exp_f32(torch.from_numpy(v)).numpy(), ref)
    m = np.concatenate([rng.standard_normal(50000).astype(np.float32) * 40,
                        np.array([0.0, -88.5, 88.5, -150.0, 150.0], np.float32)])
    ref = np.asarray(jax.jit(jax.nn.sigmoid)(jnp.asarray(m)))
    assert np.array_equal(to.sigmoid(torch.from_numpy(m)).numpy(), ref)


@pytest.mark.parametrize("name,spw", [
    ("binary:logistic", 1.0), ("binary:logistic", 2.5),
    ("reg:squarederror", 1.0),
])
def test_grad_hess_bitwise(name, spw):
    m, y, w = _rows(1)
    obj = jo.get_objective(name, scale_pos_weight=spw)
    g, h = jax.jit(obj.grad_hess)(jnp.asarray(m[:, None]), jnp.asarray(y),
                                  jnp.asarray(w))
    tg, th_ = to.grad_hess(torch.from_numpy(m), torch.from_numpy(y),
                           torch.from_numpy(w), name == "binary:logistic", spw)
    assert np.array_equal(tg.numpy(), np.asarray(g)[:, 0])
    assert np.array_equal(th_.numpy(), np.asarray(h)[:, 0])


def test_round_update_plain_and_metric_partials():
    m, y, w = _rows(2)
    rv = (np.random.default_rng(3).standard_normal(m.shape[0]) * 0.1).astype(np.float32)
    margin = torch.from_numpy(m.copy())
    gh, sums = to.round_update(margin, torch.from_numpy(rv), torch.from_numpy(y),
                               torch.from_numpy(w), True)
    new = m + rv
    assert np.array_equal(margin.numpy(), new)
    g, h = jo.get_objective("binary:logistic").grad_hess(
        jnp.asarray(new[:, None]), jnp.asarray(y), jnp.asarray(w))
    assert np.array_equal(gh.numpy(), np.stack([np.asarray(g)[:, 0],
                                                np.asarray(h)[:, 0]], 1))
    args = (jnp.asarray(new[:, None]), jnp.asarray(y), jnp.asarray(w))
    ref = {"logloss": jm._logloss(*args), "error": jm._error(*args),
           "rmse": jm._rmse(*args)}
    got = tm.metric_values(sums, ["logloss", "error", "rmse"])
    for name, (num, den) in ref.items():
        val = float(num) / max(float(den), 1e-12)
        if name == "rmse":
            val = float(np.sqrt(val))
        assert got[name] == pytest.approx(val, rel=1e-6), name


def test_objective_envelopes():
    for name in ("binary:logistic", "reg:squarederror", "multi:softprob",
                 "multi:softmax"):
        k = 3 if name.startswith("multi:") else 0
        j, t = jo.get_objective(name, k), to.get_objective(name, k)
        assert t.default_metric == j.default_metric
        assert t.num_outputs == j.num_outputs
        for s in (0.5, 0.2, 0.93, 1.7, 0.0):
            if name == "binary:logistic" and s >= 1:
                continue
            assert t.base_score_to_margin(s) == j.base_score_to_margin(s)
    # ranking and survival:cox train now: their envelopes are the JAX
    # package's; an objective outside the port still raises
    from xgboost_ray_tpu.ops.ranking import get_ranking_objective

    for name in ("rank:pairwise", "rank:ndcg", "rank:map", "survival:cox"):
        j = (get_ranking_objective(name) if name.startswith("rank:")
             else jo.get_objective(name))
        t = to.get_objective(name)
        assert t.default_metric == j.default_metric, name
        for s in (0.5, 0.2, 0.93, 1.7, 1e-20):
            assert t.base_score_to_margin(s) == j.base_score_to_margin(s)
    with pytest.raises(NotImplementedError, match="rank:nope"):
        to.get_objective("rank:nope")
