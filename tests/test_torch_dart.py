"""``booster="dart"`` in the port against the JAX package on the CPU, at
``num_actors`` 1 (``tests/test_torch_dart_world.py`` holds the 2-rank gloo
world):

- the drops (``TorchEngine._dart_sample_drops``) bitwise the reference's
  (``engine.py:2969-2991``) over 20 iterations, uniform and weighted, with
  and without ``one_drop`` and ``skip_drop``, with an ``iteration_offset``;
- B4w's plain version (``ops/grow.predict_forest_weighted_plain``) bitwise
  the reference's ``forest_margin`` (a vmap of ``predict_tree_binned`` and
  an einsum over the slots, ``engine.py:2880-2892``), at one output up to
  48 slots and at three up to 60 (XLA's CPU order: the sum from +0 in slot
  order, each term fused with one output, rounded with more; a forest of
  one slot fuses into the base);
- ``train()``: dumps with stats and tree weights equal, the history and
  ``predict`` within 1e-6 (``_torch_dart.check_dart``), for
  ``binary:logistic`` (weighted drops, forest normalisation, a held-out set
  and early stopping), ``multi:softprob`` K = 3 and ``subsample`` 0.8;
- ``rate_drop`` 0 against gbtree, save / load and cross-loading, the
  ``xgb_model`` warm start, the invalid parameters' messages and
  ``RayXGBClassifier(booster="dart")``.
"""

import functools
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dart as S
import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu import engine as jengine
from xgboost_ray_tpu.ops import grow as jgrow
from xgboost_ray_tpu_torch import engine as tengine
from xgboost_ray_tpu_torch.ops import grow as tgrow
from xgboost_ray_tpu_torch.params import parse_params


@pytest.mark.parametrize("sample_type", ["uniform", "weighted"])
@pytest.mark.parametrize("one_drop", [0, 1])
@pytest.mark.parametrize("skip_drop", [0.0, 0.4])
def test_drops_bitwise(sample_type, one_drop, skip_drop):
    rng = np.random.default_rng(11)
    t_cap = 30
    weights = np.zeros(t_cap, np.float32)
    weights[:20] = rng.uniform(0.1, 1.0, 20).astype(np.float32)
    raw = {"booster": "dart", "rate_drop": 0.15, "one_drop": one_drop,
           "skip_drop": skip_drop, "sample_type": sample_type, "seed": 9}

    def state(pkg_params, t):
        return types.SimpleNamespace(
            params=pkg_params, dart_t=t, dart_weights=weights,
            _dart_t_cap=t_cap, dart_t_cap=t_cap, iteration_offset=7)

    for i in range(20):
        t = min(i, 20)
        ref = jengine.TpuEngine._dart_sample_drops(
            state(jx.params.parse_params(raw), t), i)
        got = tengine.TorchEngine._dart_sample_drops(
            state(parse_params(raw), t), i)
        np.testing.assert_array_equal(got, ref, err_msg=f"iteration {i}")


def _forest(t_cap, n_trees, depth, n_features, max_bin, seed):
    """Random trees in the first ``n_trees`` of ``t_cap`` slots (empty slots
    a root leaf of value 0), as numpy fields."""
    rng = np.random.default_rng(seed)
    heap = (2 << depth) - 1
    feature = rng.integers(0, n_features, (t_cap, heap)).astype(np.int32)
    split_bin = rng.integers(0, max_bin, (t_cap, heap)).astype(np.int32)
    default_left = rng.random((t_cap, heap)) < 0.5
    is_leaf = np.zeros((t_cap, heap), bool)
    is_leaf[:, heap // 2:] = True
    is_leaf[:, 1:heap // 2] |= rng.random((t_cap, heap // 2 - 1)) < 0.15
    value = rng.standard_normal((t_cap, heap)).astype(np.float32) * 0.3
    zero = np.zeros((t_cap, heap), np.float32)
    feature[n_trees:] = -1
    is_leaf[n_trees:] = False
    is_leaf[n_trees:, 0] = True
    value[n_trees:] = 0.0
    return dict(feature=feature, split_bin=split_bin, threshold=zero,
                default_left=default_left, is_leaf=is_leaf, value=value,
                gain=zero, cover=zero, base_weight=zero)


@pytest.mark.parametrize("t_cap,n_trees,k", [(1, 1, 1), (12, 9, 1),
                                             (48, 40, 1), (21, 15, 3),
                                             (60, 60, 3)])
def test_forest_margin_plain_matches_jax(t_cap, n_trees, k):
    rng = np.random.default_rng(t_cap + k)
    n, nf, depth, max_bin = 700, 6, 4, 32
    fields = _forest(t_cap, n_trees, depth, nf, max_bin, seed=t_cap)
    bins = rng.integers(0, max_bin + 1, (n, nf)).astype(np.uint8)
    static = rng.standard_normal((n, k)).astype(np.float32)
    w = np.zeros(t_cap, np.float32)
    w[:n_trees] = rng.uniform(0.2, 1.3, n_trees).astype(np.float32)
    onehot = jax.nn.one_hot(jnp.arange(t_cap) % k, k, dtype=jnp.float32)

    @jax.jit
    def forest_margin(forest, b, st, wt):
        leaf = jax.vmap(lambda tr: jgrow.predict_tree_binned(
            tr, b, depth, max_bin))(forest)
        return st + jnp.einsum("ts,tk->sk", leaf * wt[:, None], onehot,
                               precision=jax.lax.Precision.HIGHEST)

    ref = np.asarray(forest_margin(
        jgrow.Tree(**{f: jnp.asarray(v) for f, v in fields.items()}),
        bins, static, w))
    got = tgrow.predict_forest_weighted_plain(
        tgrow.Tree(**{f: torch.from_numpy(v) for f, v in fields.items()}),
        n_trees, torch.from_numpy(bins), torch.from_numpy(static),
        torch.from_numpy(w), depth, max_bin).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", sorted(S.DART_CASES))
def test_train_matches_jax(name):
    jb, jev = S.jax_dart(name, 1)
    tb, tev = _port(name)
    S.check_dart(jb, jev, tb, tev)


@pytest.mark.parametrize("name", sorted(S.DART_CASES))
def test_predict_matches_jax(name):
    S.check_dart_predict(S.jax_dart(name, 1)[0], _port(name)[0])


@functools.lru_cache(maxsize=None)
def _port(name):
    return S.port_dart(name)


def test_zero_drop_matches_gbtree():
    """``rate_drop`` 0: every weight 1, the gbtree model within 1e-4 (the
    reference's gate, ``tests/test_dart.py``)."""
    x, y = S.X[:S.N_TRAIN], S.Y[:S.N_TRAIN]
    base = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.3,
            "max_bin": 32}
    kw = dict(device="cpu", ray_params=tx.RayParams(num_actors=1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        dart = tx.train(dict(base, booster="dart", rate_drop=0.0),
                        tx.RayDMatrix(x, y), 6, **kw)
        gb = tx.train(base, tx.RayDMatrix(x, y), 6, **kw)
    np.testing.assert_array_equal(dart.tree_weights, np.ones(6, np.float32))
    np.testing.assert_allclose(
        dart.predict(x, output_margin=True, device="cpu"),
        gb.predict(x, output_margin=True, device="cpu"), atol=1e-4)


def test_save_load_and_cross_load(tmp_path):
    jb, _ = S.jax_dart("binary", 1)
    tb, _ = _port("binary")
    p = str(tmp_path / "port.json")
    tb.save_model(p)
    back = tx.RayXGBoostBooster.load_model(p)
    np.testing.assert_array_equal(back.tree_weights, tb.tree_weights)
    np.testing.assert_array_equal(back.predict(S.X, device="cpu"),
                                  tb.predict(S.X, device="cpu"))
    # the port's file in the JAX package, and the JAX package's in the port
    jback = jx.RayXGBoostBooster.load_model(p)
    np.testing.assert_array_equal(np.asarray(jback.tree_weights),
                                  tb.tree_weights)
    q = str(tmp_path / "jax.json")
    jb.save_model(q)
    tback = tx.RayXGBoostBooster.load_model(q)
    np.testing.assert_array_equal(tback.tree_weights,
                                  np.asarray(jb.tree_weights))
    np.testing.assert_allclose(tback.predict(S.X, device="cpu"),
                               np.asarray(jb.predict(S.X)), rtol=1e-6,
                               atol=1e-6)


def test_warm_start_matches_jax():
    """2 more dart rounds on the JAX package's 5-round model in both
    packages: its trees and weights first, the new rounds' drops over all
    of them (``iteration_offset`` 5)."""
    jb0, _ = S.jax_dart("binary", 1)
    x, y = S.X[:S.N_TRAIN], S.Y[:S.N_TRAIN]
    params = {k: v for k, v in S.dart_params("binary").items()
              if k != "eval_metric"}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jb = jx.train(params, jx.RayDMatrix(x, y), 2, xgb_model=jb0,
                      ray_params=jx.RayParams(num_actors=1))
        tb = tx.train(params, tx.RayDMatrix(x, y), 2,
                      xgb_model=tx.RayXGBoostBooster.load_raw(
                          _jax_raw(jb0)),
                      device="cpu", ray_params=tx.RayParams(num_actors=1))
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds()
    assert tb.get_dump(with_stats=True) == jb.get_dump(with_stats=True)
    np.testing.assert_array_equal(tb.tree_weights,
                                  np.asarray(jb.tree_weights))


def _jax_raw(bst) -> bytes:
    import json

    return json.dumps(bst._to_dict()).encode()


def test_invalid_params():
    x, y = S.X[:50], S.Y[:50]
    dm = tx.RayDMatrix(x, y)
    kw = dict(device="cpu", ray_params=tx.RayParams(num_actors=1))
    for extra, match in ((dict(num_parallel_tree=4), "num_parallel_tree"),
                         (dict(normalize_type="x"), "normalize_type"),
                         (dict(sample_type="x"), "sample_type")):
        with pytest.raises(ValueError, match=match):
            tx.train(dict(booster="dart", **extra), dm, 2, **kw)
    with pytest.raises(ValueError, match="booster"):
        tx.train(dict(booster="gbforest"), dm, 2, **kw)
    with pytest.raises(ValueError, match="custom objectives"):
        tx.train(dict(booster="dart"), dm, 2,
                 obj=lambda m, d: (m, np.ones_like(m)), **kw)


def test_classifier():
    from xgboost_ray_tpu_torch.sklearn import RayXGBClassifier

    x, y = S.X[:S.N_TRAIN], S.Y[:S.N_TRAIN]
    clf = RayXGBClassifier(n_estimators=6, booster="dart", rate_drop=0.2,
                           one_drop=1, max_depth=3, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        clf.fit(x, y, ray_params=tx.RayParams(num_actors=1))
    tw = clf.get_booster().tree_weights
    assert tw is not None and tw.shape == (6,)
    assert np.all(tw > 0) and np.all(tw <= 1.0)
    assert (clf.predict(x) == y).mean() > 0.8
