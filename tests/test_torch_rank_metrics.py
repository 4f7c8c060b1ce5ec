"""ndcg / map of the port against the JAX package on the CPU: B9r's plain
version (``rank_metric_contrib``) for ndcg, ndcg@k, map and map@k, and the
host versions (``ndcg_np`` / ``map_np``) for a set without groups, through
``train()`` too.

Tolerances: the JAX metric adds its groups' values in f32 chunks of
``clip(4,000,000 // G, 1, 4096)`` groups; the port adds them in f64 in a
fixed order, so the means agree within 1e-6 relative (each group's value
is the same computation: the per-group values are equal bit for bit where
G > 32). The host versions are the same numpy code: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu.ops import metrics as jm
from xgboost_ray_tpu.ops import ranking as jr
from xgboost_ray_tpu_torch.ops import metrics as tm
from xgboost_ray_tpu_torch.ops import ranking as tr


def _set(sizes, seed, ties=False):
    rng = np.random.default_rng(seed)
    qid = np.repeat(np.arange(len(sizes)), sizes)
    n = qid.size
    m = (np.zeros(n, np.float32) if ties
         else rng.standard_normal(n).astype(np.float32))
    y = rng.integers(0, 5, n).astype(np.float32)
    y[:3] = 0.0  # a group of one with no relevant document
    rows, ptr = jr.build_group_rows(qid)
    lay = tr.GroupLayout(torch.from_numpy(ptr), rows.shape[1])
    return qid, m, y, rows, ptr, lay


CASES = {
    "mixed": ([1, 2, 70, 33, 5, 40, 1, 64, 17, 3], False),
    "ties": ([1, 2, 70, 33, 5, 40, 1, 64, 17, 3], True),
    "small_g": ([1, 3, 9, 20, 4], False),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", ["ndcg", "map"])
def test_rank_metric_matches_jax(case, kind):
    sizes, ties = CASES[case]
    _, m, y, rows, ptr, lay = _set(sizes, 5, ties)
    mt, yt = torch.from_numpy(m), torch.from_numpy(y)
    for k in (None, 1, 3, 10, 1000):
        num, den = jm.rank_metric_contrib(kind, jnp.asarray(m[:, None]),
                                          jnp.asarray(y), jnp.asarray(rows),
                                          k)
        sums = tm.rank_metric_contrib(kind, mt, yt, lay, k)
        assert float(sums[1]) == float(den) == len(sizes)
        want = float(num) / float(den)
        got = float(sums[0] / sums[1])
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), (k, got, want)
        name = kind if k is None else f"{kind}@{k}"
        host = tm.rank_metric_np(name, m, y, ptr)
        jfn = jm._ndcg_np if kind == "ndcg" else jm._map_np
        kk = 2 ** 31 - 1 if k is None else k
        assert host == jfn(m.astype(np.float64), y.astype(np.float64), ptr,
                           kk)
        assert got == pytest.approx(host, rel=1e-6, abs=1e-7)


def test_group_values_bitwise_above_32():
    """G > 32: each group's value is the reference's chunk program's bit
    for bit (the mean differs only by the order of the group sum)."""
    _, m, y, rows, _, lay = _set(CASES["mixed"][0], 6)
    vals = tm.rank_metric_groups_plain("ndcg", torch.from_numpy(m),
                                       torch.from_numpy(y), lay, 10)
    for g in range(rows.shape[0]):
        num, _ = jm.rank_metric_contrib("ndcg", jnp.asarray(m[:, None]),
                                        jnp.asarray(y),
                                        jnp.asarray(rows[g:g + 1]), 10)
        assert np.float32(num) == vals[g].numpy(), g


def test_rank_metric_sum_order():
    """The f64 sum over groups in B9r's fixed order: 128 contiguous runs,
    each in order, then the runs."""
    v = torch.from_numpy(np.random.default_rng(1).uniform(
        size=1000).astype(np.float32))
    got = tm.rank_metric_sum_plain(v)
    per = -(-1000 // tm.RANK_SUM_THREADS)
    runs = [sum(v[i:i + per].double().tolist(), 0.0)
            for i in range(0, 1000, per)]
    assert got[0].item() == sum(runs, 0.0) and got[1].item() == 1000.0


def _data(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(5, 70, 30)
    qid = np.repeat(np.arange(sizes.size), sizes)
    x = rng.standard_normal((qid.size, 5)).astype(np.float32)
    y = np.clip(np.round(x[:, 0] + rng.standard_normal(qid.size) * 0.6
                         + 1.5), 0, 4).astype(np.float32)
    return x, y, qid


def test_train_host_metric_for_a_set_without_groups():
    """A held-out set without qid makes ndcg / map host metrics for every
    set (``engine.py:748-766``): the whole held-out set one group; the
    history equals the JAX package's."""
    x, y, qid = _data(2)
    xv, yv, _ = _data(3)
    params = {"objective": "rank:ndcg", "eval_metric": ["ndcg@5", "map"],
              "max_depth": 3, "max_bin": 32}
    hist = {}
    for pkg, kw in ((jx, {}), (tx, {"device": "cpu"})):
        dtrain = pkg.RayDMatrix(x, y, qid=qid)
        ev = {}
        pkg.train(params, dtrain, 3, evals=[(dtrain, "train"),
                                            (pkg.RayDMatrix(xv, yv), "v")],
                  evals_result=ev, ray_params=pkg.RayParams(num_actors=1),
                  **kw)
        hist[pkg] = ev
    for s in ("train", "v"):
        for mname in ("ndcg@5", "map"):
            np.testing.assert_allclose(hist[tx][s][mname], hist[jx][s][mname],
                                       rtol=1e-6)
