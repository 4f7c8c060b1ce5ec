"""``train()`` with quantized gradients (``gh_precision``) and the quantized
histogram wire (``hist_quant``) against the JAX package at ``num_actors`` 1
(``tests/test_torch_quant_world.py`` holds ``num_actors`` 2 and the other
configurations: the two files share the time of the JAX compiles).

Tolerances. Every histogram sum of quantized gradients is an exact integer
in both packages, and the wire's arithmetic is the reference's bit for bit
(``tests/test_torch_hist_wire.py``). But the reference's compiled CPU
program recomputes the dequantize product (the gradients' scale, or the
wire's) inside the split search's fusions, and LLVM contracts it into the
following add (``H + lambda``, a prefix sum, the sibling subtraction) where
it fuses, differently from program to program (ROADMAP queue C, C9): the
port rounds each product once. So the trees' structure (features, split
bins, default directions) is held exactly, and the statistics (gain, cover,
leaf values) within 5e-5 relative, as queue C's C8 holds the lossguide
oracle; the history within 1e-6; and a same-seed rerun bitwise.
"""

import re

import numpy as np
import pytest

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx

_STAT = re.compile(r"(gain|cover|leaf)=([-0-9.e+]+)")
BASE = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 32,
        "eval_metric": ["logloss"], "hist_quant_min_bytes": 0, "seed": 3}


def _data(n=240, f=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    z = np.nan_to_num(x)
    y = (z[:, 0] + 0.4 * z[:, 1] + 0.5 * rng.standard_normal(n) > 0)
    return x, y.astype(np.float32)


def assert_same_model(tb, jb):
    """Structure exactly, statistics within 5e-5 relative (C9)."""
    a, b = tb.get_dump(with_stats=True), jb.get_dump(with_stats=True)
    assert [_STAT.sub("", t) for t in a] == [_STAT.sub("", t) for t in b]
    sa = np.array([float(v) for t in a for _, v in _STAT.findall(t)])
    sb = np.array([float(v) for t in b for _, v in _STAT.findall(t)])
    np.testing.assert_allclose(sa, sb, rtol=5e-5, atol=1e-6)


def _train_both(params, make, rounds=2, **kw):
    out = []
    for pkg, dev in ((jx, {}), (tx, {"device": "cpu"})):
        dtrain, dtest = make(pkg)
        evals = [(dtrain, "train")] + ([(dtest, "test")] if dtest else [])
        ev = {}
        bst = pkg.train(params, dtrain, rounds, evals=evals, evals_result=ev,
                        ray_params=pkg.RayParams(num_actors=1), **kw, **dev)
        out.append((bst, ev))
    return out


def _numeric(pkg, n=240):
    x, y = _data(n)
    return pkg.RayDMatrix(x, y), None


#: depth 2 where a depth-3 case of the same kind is here (the int16 ones):
#: the JAX compiles of depth 3 would take this file past its time
CONFIGS = {
    "gh_int8": {"gh_precision": "int8", "max_depth": 2},
    "gh_int16": {"gh_precision": "int16"},
    "wire_int8": {"hist_quant": "int8", "max_depth": 2},
    "wire_int16": {"hist_quant": "int16"},
    "wire_int8_block": {"hist_quant": "int8_block", "max_depth": 2},
    "wire_int16_block": {"hist_quant": "int16_block",
                         "hist_quant_block": 64},
    "gh_int8_subsample": {"gh_precision": "int8", "subsample": 0.5},
    "gh_int8_lossguide": {"gh_precision": "int8", "grow_policy": "lossguide",
                          "max_leaves": 8},
    "gh_int8_wire_int8_lossguide": {
        "gh_precision": "int8", "hist_quant": "int8",
        "grow_policy": "lossguide", "max_leaves": 8},
    "wire_int8_lossguide": {"hist_quant": "int8", "grow_policy": "lossguide",
                            "max_leaves": 8},
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_matches_jax(name):
    params = dict(BASE, **CONFIGS[name])
    (jb, jev), (tb, tev) = _train_both(params, _numeric)
    assert_same_model(tb, jb)
    np.testing.assert_allclose(tev["train"]["logloss"],
                               jev["train"]["logloss"], rtol=1e-6, atol=1e-7)
    x, _ = _data()
    np.testing.assert_allclose(tb.predict(x, device="cpu"), jb.predict(x),
                               rtol=1e-5, atol=1e-6)


def test_multiclass_int8_gh():
    x, y = _data(300)
    y3 = (np.nan_to_num(x[:, 0]) > 0.5).astype(np.float32) + (
        np.nan_to_num(x[:, 2]) > 0).astype(np.float32)
    params = dict(BASE, objective="multi:softprob", num_class=3,
                  eval_metric=["mlogloss"], gh_precision="int8", max_depth=2)
    (jb, jev), (tb, tev) = _train_both(
        params, lambda pkg: (pkg.RayDMatrix(x, y3), None))
    assert_same_model(tb, jb)
    np.testing.assert_allclose(tev["train"]["mlogloss"],
                               jev["train"]["mlogloss"], rtol=1e-6)


def test_eval_set_and_early_stopping_int8_gh():
    x, y = _data(300)

    def make(pkg):
        return pkg.RayDMatrix(x[:200], y[:200]), pkg.RayDMatrix(x[200:],
                                                                y[200:])

    params = dict(BASE, gh_precision="int8", eta=1.0)
    (jb, jev), (tb, tev) = _train_both(params, make, rounds=5,
                                       early_stopping_rounds=2)
    assert_same_model(tb, jb)
    assert tb.best_iteration == jb.best_iteration
    np.testing.assert_allclose(tev["test"]["logloss"], jev["test"]["logloss"],
                               rtol=1e-6, atol=1e-7)


def test_same_seed_rerun_bitwise_and_seed_changes_rounding():
    x, y = _data()
    runs = {}
    for key, seed in (("a", 3), ("b", 3), ("c", 4)):
        bst = tx.train(dict(BASE, gh_precision="int8", seed=seed),
                       tx.RayDMatrix(x, y), 3, device="cpu",
                       ray_params=tx.RayParams(num_actors=1))
        runs[key] = bst.predict(x, output_margin=True, device="cpu")
    np.testing.assert_array_equal(runs["a"], runs["b"])
    assert not np.array_equal(runs["a"], runs["c"])


def test_reports_gh_plane_and_tree_bytes():
    x, y = _data()
    extra = {}
    tx.train(dict(BASE, gh_precision="int16"), tx.RayDMatrix(x, y), 1,
             device="cpu", additional_results=extra,
             ray_params=tx.RayParams(num_actors=1))
    assert extra["gh_plane_bytes_per_shard"] == 240 * 2 * 2
    assert extra["hist_allreduce_bytes_per_round"] == 0  # one rank: no wire
