"""survival:cox on the port against the JAX package on the CPU: B14's
plain version (``cox_risk_terms``, the gradients, ``cox-nloglik``),
``train()`` at ``num_actors`` 1 and 2 (a 2-rank gloo world: the labels and
weights gathered once, the margins every round), and the exp transform
above the old clamp (ROADMAP C7).

Tolerances: the risk terms and the gradients bitwise against the
reference's round program (its scans are XLA's blocked CPU cumsum, which
``ops/split.blocked_cumsum`` follows; below a dozen rows XLA's program for
the whole set fuses otherwise, so the sets here have hundreds of rows or
more); ``cox-nloglik`` within 1e-6 relative (the reference sums its terms
in f32, the port in f64); ``train()``: ``get_dump(with_stats=True)`` equal,
history and predicted hazard ratios within 1e-6 relative; the exp bitwise
``jax.jit(jnp.exp)``.
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
from xgboost_ray_tpu_torch.ops import cox as tc
from xgboost_ray_tpu_torch.ops import objectives as to


def _same(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.array_equal(a.view(np.int32), b.view(np.int32)) or bool(
        ((a.view(np.int32) == b.view(np.int32))
         | (np.isnan(a) & np.isnan(b))).all())


def _rows(n, seed, censored=0.3):
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal(n) * 0.7).astype(np.float32)
    t = (np.round(rng.exponential(2.0, n) * 4) / 4 + 0.25).astype(np.float32)
    y = np.where(rng.uniform(size=n) < censored, -t, t).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w[::17] = 0.0
    m[::17] = 30.0  # w = 0 rows hold the largest margin
    w[t == t.max()] = 1.0  # the last risk set has weight (else D = 0)
    return m, y, w


CASES = [(300, 0.3), (20_000, 0.3), (4099, 1.0), (1000, 0.0)]


@pytest.mark.parametrize("n,censored", CASES)
def test_gradients_match_the_reference_round(n, censored):
    m, y, w = _rows(n, n, censored)
    obj = jo.get_objective("survival:cox")

    def gh(*a):
        g, h = obj.grad_hess(*a)
        return jnp.stack([g[:, 0], h[:, 0]], axis=1)

    ref = np.asarray(jax.jit(gh)(jnp.asarray(m[:, None]), jnp.asarray(y),
                                 jnp.asarray(w)))
    t = [torch.from_numpy(a) for a in (m, y, w)]
    got, _ = tc.cox_round(*t, tc.cox_setup(t[1]))
    assert _same(got.numpy(), ref)
    # a rank's slice of the rows is its rows of the world's gradients
    part, _ = tc.cox_round(*t, tc.cox_setup(t[1]), n // 3, n - n // 3)
    assert _same(part.numpy(), ref[n // 3:])


@pytest.mark.parametrize("n,censored", CASES)
def test_risk_terms_and_metric_match_jax(n, censored):
    m, y, w = _rows(n, n + 1, censored)
    ref = [np.asarray(a) for a in jax.jit(jo.cox_risk_terms)(
        jnp.asarray(m), jnp.asarray(y), jnp.asarray(w))]
    t = [torch.from_numpy(a) for a in (m, y, w)]
    got = tc.cox_risk_terms(*t)
    for name, g, r in zip(("r", "ev", "S1", "S2", "logD"), got, ref):
        assert _same(g.numpy(), r), name
    num, den = jm.cox_nloglik_global(jnp.asarray(m), jnp.asarray(y),
                                     jnp.asarray(w))
    _, sums = tc.cox_round(*t, tc.cox_setup(t[1]), with_metric=True)
    if float(den) == 0:
        assert float(sums[1]) == 0
        return
    assert float(sums[0] / sums[1]) == pytest.approx(
        float(num) / float(den), rel=1e-6)


def test_zero_weight_last_risk_set_is_nan_as_in_the_reference():
    """Where the rows of the latest time all have w = 0 their risk set's D
    is 0 (the reference's clamp at 1e-38 is a subnormal its CPU program
    flushes), and 0 / 0 makes every gradient NaN: the port gives the same
    NaN, as the reference's program does."""
    m, y, w = _rows(300, 9)
    w[np.abs(y) == np.abs(y).max()] = 0.0
    obj = jo.get_objective("survival:cox")
    g, h = jax.jit(obj.grad_hess)(jnp.asarray(m[:, None]), jnp.asarray(y),
                                  jnp.asarray(w))
    t = [torch.from_numpy(a) for a in (m, y, w)]
    got, _ = tc.cox_round(*t, tc.cox_setup(t[1]))
    assert np.isnan(np.asarray(h)).all() and torch.isnan(got[:, 1]).all()
    assert _same(got[:, 0].numpy(), np.asarray(g)[:, 0])


def test_cox_metric_sum_order():
    """The f64 sums in B14's fixed order: thread t of T adds rows t, t + T,
    ..., then runs of T / 256 partials, then the runs."""
    rng = np.random.default_rng(2)
    terms = torch.from_numpy(rng.standard_normal(70_001).astype(np.float32))
    ev = torch.from_numpy(rng.uniform(size=70_001).astype(np.float32))
    got = tc.cox_metric_sum_plain(terms, ev)
    t_all = tc.COX_SUM_CTAS * tc.COX_THREADS
    acc = np.zeros(t_all)
    for k in range(-(-70_001 // t_all)):
        blk = terms[k * t_all:(k + 1) * t_all].double().numpy()
        acc[:blk.size] += blk
    per = t_all // tc.COX_THREADS
    total = 0.0
    for j in range(tc.COX_THREADS):
        run = 0.0
        for v in acc[j * per:(j + 1) * per]:
            run += v
        total += run
    assert got[0].item() == total


def test_exp_transform_is_jnp_exp_above_88():
    """ROADMAP C7: the exp transform (survival:cox's hazard ratio, the
    log-link objectives') from 80 to 89 in steps of 0.01, at +-inf and NaN,
    bitwise ``jax.jit(jnp.exp)``: finite up to 88.72, inf above."""
    m = np.concatenate([np.arange(8000, 8901) / 100.0,
                        [np.inf, -np.inf, np.nan]]).astype(np.float32)
    got = to.value_transform(torch.from_numpy(m), "exp").numpy()
    ref = np.asarray(jax.jit(jnp.exp)(jnp.asarray(m)))
    assert _same(got, ref)
    assert np.isfinite(got[m <= 88.72]).all()
    assert np.isinf(got[(m > 88.73) & np.isfinite(m)]).all()
    obj = to.get_objective("survival:cox")
    assert obj.transform_kind == "exp" and obj.default_metric == "cox-nloglik"
    assert obj.base_score_to_margin(0.5) == jo.get_objective(
        "survival:cox").base_score_to_margin(0.5)


# --------------------------------------------------------------------------
# train()
# --------------------------------------------------------------------------


def _matrix():
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2500, 6)).astype(np.float32)
    t = np.exp(0.5 * x[:, 0] - 0.3 * x[:, 1]
               + 0.4 * rng.standard_normal(2500)).astype(np.float32)
    y = np.where(rng.uniform(size=2500) < 0.3, -t, t).astype(np.float32)
    return x, y


X, Y = _matrix()
ROUNDS = 4
PARAMS = {"objective": "survival:cox", "eval_metric": ["cox-nloglik"],
          "max_depth": 4, "max_bin": 64}


@pytest.fixture(scope="module")
def world2():
    with D.World(2, "cpu") as w:
        yield w


def _train(pkg, actors, world=None):
    if pkg is tx and actors == 2:
        def part(sl):
            return D.share({"x": X[sl], "label": Y[sl]})

        out = world.run(D._train_rank, part(slice(0, 2000)), dict(PARAMS),
                        ROUNDS,
                        {"device": "cpu", "eval_names": ["train", "valid"],
                         "eval_data": [None, dict(part(slice(2000, None)),
                                                  sharding="INTERLEAVED")]})
        assert out[0]["model"] == out[1]["model"]
        assert out[0]["evals_result"] == out[1]["evals_result"]
        return (tx.RayXGBoostBooster.load_raw(out[0]["model"]),
                out[0]["evals_result"])
    dtrain = pkg.RayDMatrix(X[:2000], Y[:2000])
    evals = [(dtrain, "train"), (pkg.RayDMatrix(X[2000:], Y[2000:]), "valid")]
    kw = {"device": "cpu"} if pkg is tx else {}
    ev = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        bst = pkg.train(dict(PARAMS), dtrain, ROUNDS, evals=evals,
                        evals_result=ev,
                        ray_params=pkg.RayParams(num_actors=actors), **kw)
    return bst, ev


@pytest.mark.parametrize("actors", [1, 2])
def test_train_matches_jax(actors, world2):
    jb, jev = _train(jx, actors)
    tb, tev = _train(tx, actors, world2)
    assert tb.get_dump(with_stats=True) == jb.get_dump(with_stats=True)
    for s in jev:
        np.testing.assert_allclose(tev[s]["cox-nloglik"],
                                   jev[s]["cox-nloglik"], rtol=1e-6)
    np.testing.assert_allclose(tb.predict(X, device="cpu"),
                               np.asarray(jb.predict(X)), rtol=1e-6)
