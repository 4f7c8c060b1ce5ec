"""survival:aft on the port against the JAX package on the CPU: the AFT
pass's plain gradients (normal and logistic, two sigmas) over right-,
interval- and un-censored rows, the ``aft-nloglik`` metric, label bounds
carried from arrays and from file columns, and ``train()`` at
``num_actors`` 1 and 2.

Tolerances: gradients bitwise against the reference's round program,
except that XLA's CPU loop computes the few rows at its parallel
partitions' edges in scalar code whose fused multiply-adds differ from its
vector body's (ROADMAP C): those hessians (at most 8 of 100,000 rows, at
the partitions' last rows) are within 1e-5 relative; the metric within
1e-5 relative (float32 sums of terms up to 20); ``train()``: ``get_dump()`` equal, history and predicted
times within 1e-6 relative. At
``num_actors=2`` the port runs as a 2-rank gloo world.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu.ops import survival as js
from xgboost_ray_tpu_torch import distributed as D
from xgboost_ray_tpu_torch.ops import metrics as tm
from xgboost_ray_tpu_torch.ops import objectives as to
from xgboost_ray_tpu_torch.ops import survival as ts


def _bounds(rng, n, t):
    """Log-normal event times ``t`` as bounds: 30 % right-censored (upper
    +inf), 10 % interval-censored, the rest uncensored."""
    lo, hi = t.copy(), t.copy()
    u = rng.uniform(size=n)
    hi[u < 0.3] = np.inf
    iv = (u >= 0.3) & (u < 0.4)
    lo[iv] = t[iv] * 0.6
    hi[iv] = t[iv] * 1.7
    return lo.astype(np.float32), hi.astype(np.float32)


def _rows(n=100_000, seed=5):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal(n).astype(np.float32)
    t = np.exp(rng.standard_normal(n) * 0.8 + 0.3).astype(np.float32)
    lo, hi = _bounds(rng, n, t)
    lo[:3] = [0.0, 1e-40, np.nan]
    m[3:6] = [np.nan, 1e-40, 40.0]
    w = rng.uniform(0.2, 2, n).astype(np.float32)
    w[6] = 0.0
    return m, lo, hi, w


def _same(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))


AFT_PARAMS = [("normal", 1.0), ("normal", 1.3), ("logistic", 1.0),
              ("logistic", 0.5)]


@pytest.mark.parametrize("dist,sigma", AFT_PARAMS)
def test_aft_grad_hess_matches_the_reference_round(dist, sigma):
    m, lo, hi, w = _rows()
    f = js.make_aft_grad_hess(dist, sigma)

    def gh(*a):
        g, h = f(*a)
        return jnp.stack([g[:, 0], h[:, 0]], axis=1)

    ref = np.asarray(jax.jit(gh)(jnp.asarray(m[:, None]), jnp.asarray(lo),
                                 jnp.asarray(hi), jnp.asarray(w)))
    obj = to.get_objective("survival:aft", aft_loss_distribution=dist,
                           aft_loss_distribution_scale=sigma)
    g, h = ts.aft_grad_hess(*(torch.from_numpy(a) for a in (m, lo, hi, w)),
                            obj.consts)
    assert _same(g.numpy(), ref[:, 0]).all()
    off = ~_same(h.numpy(), ref[:, 1])
    assert np.count_nonzero(off) <= 8
    np.testing.assert_allclose(h.numpy()[off], ref[off, 1], rtol=1e-5)


@pytest.mark.parametrize("dist,sigma", AFT_PARAMS)
def test_aft_nloglik_matches_jax(dist, sigma):
    """Within 1e-5 relative of the JAX package's device metric and of its
    float64 host metric (scipy's pdf and cdf): float32 sums over these
    terms (1 to 20 a row) are each up to 4e-6 from the exact mean at 20,000
    rows, the reference's and the port's alike."""
    m, lo, hi, w = _rows(n=20_000, seed=6)
    ok = np.isfinite(m) & np.isfinite(lo) & (lo > 0)
    m, lo, hi, w = m[ok], lo[ok], hi[ok], w[ok]
    num, den = js.aft_nloglik_contrib(
        jnp.asarray(m[:, None]), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(w), distribution=dist, sigma=sigma)
    consts = to.objective_consts(sigma=sigma, aft_distribution=dist)
    t = [torch.from_numpy(a) for a in (m, lo, hi, w)]
    sums = tm.metric_partials(t[0], t[1], t[3], ["aft-nloglik"], consts,
                              t[1], t[2])
    got = tm.metric_values(sums, ["aft-nloglik"])["aft-nloglik"]
    assert got == pytest.approx(float(num) / float(den), rel=1e-5)
    host = js.aft_nloglik_np(m, lo, hi, w, distribution=dist, sigma=sigma)
    assert got == pytest.approx(host, rel=1e-5)


# --------------------------------------------------------------------------
# train()
# --------------------------------------------------------------------------


def _matrix():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2500, 6)).astype(np.float32)
    t = np.exp(0.5 * x[:, 0] - 0.3 * x[:, 1]
               + 0.4 * rng.standard_normal(2500)).astype(np.float32)
    lo, hi = _bounds(rng, 2500, t)
    return x, lo, hi


X, LO, HI = _matrix()
ROUNDS = 5


@pytest.fixture(scope="module")
def world2():
    with D.World(2, "cpu") as w:
        yield w


def _evals(pkg):
    dtrain = pkg.RayDMatrix(X[:2000], label_lower_bound=LO[:2000],
                            label_upper_bound=HI[:2000])
    dvalid = pkg.RayDMatrix(X[2000:], label_lower_bound=LO[2000:],
                            label_upper_bound=HI[2000:])
    return dtrain, [(dtrain, "train"), (dvalid, "valid")]


def _train(pkg, params, actors, world=None):
    if pkg is tx and actors == 2:
        def part(sl):
            return D.share({"x": X[sl], "label_lower_bound": LO[sl],
                            "label_upper_bound": HI[sl]})

        out = world.run(D._train_rank, part(slice(0, 2000)), params, ROUNDS,
                        {"device": "cpu", "eval_names": ["train", "valid"],
                         "eval_data": [None, dict(part(slice(2000, None)),
                                                  sharding="INTERLEAVED")]})
        assert out[0]["model"] == out[1]["model"]
        return (tx.RayXGBoostBooster.load_raw(out[0]["model"]),
                out[0]["evals_result"])
    dtrain, evals = _evals(pkg)
    kw = {"device": "cpu"} if pkg is tx else {}
    ev = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        bst = pkg.train(params, dtrain, ROUNDS, evals=evals, evals_result=ev,
                        ray_params=pkg.RayParams(num_actors=actors), **kw)
    return bst, ev


@pytest.mark.parametrize("actors", [1, 2])
@pytest.mark.parametrize("dist", ["normal", "logistic"])
def test_train_matches_jax(dist, actors, world2):
    params = {"objective": "survival:aft", "max_depth": 4,
              "aft_loss_distribution": dist,
              "aft_loss_distribution_scale": 1.2,
              "eval_metric": ["aft-nloglik", "mae"]}
    jb, jev = _train(jx, dict(params), actors)
    tb, tev = _train(tx, dict(params), actors, world2)
    assert tb.get_dump() == jb.get_dump()
    for s in jev:
        assert list(tev[s]) == list(jev[s])
        for mname in jev[s]:
            np.testing.assert_allclose(tev[s][mname], jev[s][mname],
                                       rtol=1e-6, err_msg=f"{s}-{mname}")
    np.testing.assert_allclose(tb.predict(X, device="cpu"),
                               np.asarray(jb.predict(X)), rtol=1e-6)


def test_bounds_from_file_columns(tmp_path):
    """Bounds named as file columns, loaded centrally and by each rank of
    a distributed matrix, give the model the arrays give (the label-free
    set's labels are its lower bounds, as the reference takes them)."""
    paths = []
    for i in range(2):
        sl = slice(1000 * i, 1000 * (i + 1))
        df = pd.DataFrame(X[sl], columns=[f"f{j}" for j in range(6)])
        df["lo"], df["hi"] = LO[sl], HI[sl]
        paths.append(str(tmp_path / f"part{i}.csv"))
        df.to_csv(paths[-1], index=False, float_format="%.9g")
    params = {"objective": "survival:aft", "max_depth": 3}
    dumps = []
    batch = tx.RayShardingMode.BATCH  # rank r: rows of file r
    for dm in (tx.RayDMatrix(X[:2000], label_lower_bound=LO[:2000],
                             label_upper_bound=HI[:2000], sharding=batch),
               tx.RayDMatrix(paths, label_lower_bound="lo",
                             label_upper_bound="hi", distributed=False,
                             sharding=batch),
               tx.RayDMatrix(paths, label_lower_bound="lo",
                             label_upper_bound="hi", distributed=True,
                             sharding=batch)):
        bst = tx.train(params, dm, 3, ray_params=tx.RayParams(num_actors=2),
                       device="cpu")
        dumps.append(bst.get_dump())
    assert dumps[0] == dumps[1] == dumps[2]
    with pytest.raises(ValueError, match="column names"):
        tx.RayDMatrix(paths, label_lower_bound=LO, distributed=True)


def test_aft_without_bounds_or_label_raises():
    with pytest.raises(ValueError, match="label_lower_bound"):
        tx.train({"objective": "survival:aft"}, tx.RayDMatrix(X[:100]), 1,
                 ray_params=tx.RayParams(num_actors=1), device="cpu")
    with pytest.raises(ValueError, match="aft_loss_distribution"):
        tx.train({"objective": "survival:aft",
                  "aft_loss_distribution": "weibull"},
                 tx.RayDMatrix(X[:100], LO[:100]), 1,
                 ray_params=tx.RayParams(num_actors=1), device="cpu")
