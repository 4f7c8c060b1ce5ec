"""Held-out eval sets, early stopping and ``xgb_model`` warm start: the
port's ``train()`` against the JAX package's on the CPU, and B4's plain
version (``ops/grow.predict_tree_binned_plain``) against the JAX
``predict_tree_binned``.

sklearn's bundled breast_cancer is split 400 rows to train, 169 held out.
At ``num_actors=2`` the port runs as a 2-rank gloo world, each rank on its
shard of both matrices, whose histograms and metric partials merge as
``a + b`` as the reference's ``psum`` over two devices does (folded onto
one device the port associates its f32 sums otherwise). Tolerances: cuts, tree structure (``feature``, ``split_bin``,
``default_left``, ``is_leaf``) and B4's row values bitwise; ``get_dump()``
equal; eval history, ``best_score`` and leaf values within 1e-6 absolute
(float32 metric sums taken in another order; a warm start's init margins
come from the forest walk, whose float sum over trees is associated as the
reference's only where ``tests/test_torch_predict.py`` says).
"""

import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from sklearn.datasets import load_breast_cancer

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu.ops import grow as jg
from xgboost_ray_tpu_torch import distributed as D
from xgboost_ray_tpu_torch.ops import grow as tg

README_PARAMS = {"objective": "binary:logistic",
                 "eval_metric": ["logloss", "error"]}
#: early stopping decides on the last metric: logloss
ES_PARAMS = {"objective": "binary:logistic", "eta": 0.5,
             "eval_metric": ["error", "logloss"]}
STRUCTURE = ("feature", "split_bin", "default_left", "is_leaf")


def _split():
    d = load_breast_cancer()
    x, y = d.data.astype(np.float32), d.target.astype(np.float32)
    return x[:400], y[:400], x[400:], y[400:]


def _train(pkg, params, rounds, actors=1, held_out=True, **kw):
    """(booster, evals_result) of ``pkg.train`` with the training set and,
    with ``held_out``, the held-out rows as eval sets."""
    xt, yt, xv, yv = _split()
    dtrain = pkg.RayDMatrix(xt, yt)
    evals = [(dtrain, "train")]
    if held_out:
        evals.append((pkg.RayDMatrix(xv, yv), "valid"))
    if pkg is tx:
        kw["device"] = "cpu"
    ev = {}
    with warnings.catch_warnings():  # num_actors=1: "NOT be distributed"
        warnings.simplefilter("ignore", UserWarning)
        bst = pkg.train(params, dtrain, rounds, evals=evals, evals_result=ev,
                        ray_params=pkg.RayParams(num_actors=actors), **kw)
    return bst, ev


def _assert_history_close(tev, jev, sets=("train", "valid")):
    for s in sets:
        assert tev[s].keys() == jev[s].keys()
        for m in jev[s]:
            np.testing.assert_allclose(tev[s][m], jev[s][m], rtol=0,
                                       atol=1e-6, err_msg=f"{s}-{m}")


@pytest.fixture(scope="module")
def world2():
    with D.World(2, "cpu") as w:
        yield w


def _train_world(world, params, rounds, held_out=True):
    """``_train_rank`` in ``world`` on the split: (rank 0's booster,
    evals_result)."""
    xt, yt, xv, yv = _split()
    held = [dict(D.share({"x": xv, "label": yv}), sharding="INTERLEAVED")]
    out = world.run(D._train_rank, D.share({"x": xt, "label": yt}), params,
                    rounds, {"device": "cpu",
                             "eval_names": ["train", "valid"][:1 + held_out],
                             "eval_data": [None, *held][:1 + held_out]})
    assert out[0]["model"] == out[1]["model"]
    assert out[0]["evals_result"] == out[1]["evals_result"]
    return tx.RayXGBoostBooster.load_raw(out[0]["model"]), out[0]["evals_result"]


@pytest.mark.parametrize("actors", [1, 2])
def test_held_out_eval_matches_jax(actors, request):
    jb, jev = _train(jx, README_PARAMS, 10, actors)
    if actors == 1:
        def run(held_out=True):
            return _train(tx, README_PARAMS, 10, held_out=held_out)
    else:
        world = request.getfixturevalue("world2")

        def run(held_out=True):
            return _train_world(world, README_PARAMS, 10, held_out)
    tb, tev = run()
    assert list(tev) == ["train", "valid"]
    _assert_history_close(tev, jev)
    assert tev["valid"]["logloss"][-1] < tev["valid"]["logloss"][0]
    assert tb.get_dump() == jb.get_dump()
    assert np.array_equal(tb.cuts, np.asarray(jb.cuts))
    # the held-out rows do not move training: the train-only run's model
    alone, _ = run(held_out=False)
    assert alone.get_dump() == tb.get_dump()


@pytest.mark.parametrize("maximize", [None, True])
def test_early_stopping_matches_jax(maximize):
    kw = dict(early_stopping_rounds=3, maximize=maximize)
    jb, jev = _train(jx, ES_PARAMS, 60, **kw)
    tb, tev = _train(tx, ES_PARAMS, 60, **kw)
    _assert_history_close(tev, jev)
    rounds = len(jev["valid"]["logloss"])
    assert len(tev["valid"]["logloss"]) == rounds < 60
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds() == rounds
    assert tb.best_iteration == jb.best_iteration
    assert tb.best_score == pytest.approx(jb.best_score, abs=1e-6)
    # stopped 3 rounds after the best round of the last metric, logloss
    hist = tev["valid"]["logloss"]
    best = int(np.argmax(hist) if maximize else np.argmin(hist))
    assert tb.best_iteration == best and rounds == best + 4


def _assert_forest_close(tb, jb):
    for name in STRUCTURE:
        assert np.array_equal(getattr(tb.forest, name),
                              np.asarray(getattr(jb.forest, name))), name
    np.testing.assert_allclose(tb.forest.value, np.asarray(jb.forest.value),
                               rtol=0, atol=1e-6)


def test_warm_start_matches_jax(tmp_path):
    jb5, _ = _train(jx, README_PARAMS, 5)
    tb5, _ = _train(tx, README_PARAMS, 5)
    jb, jev = _train(jx, README_PARAMS, 5, xgb_model=jb5)
    tb, tev = _train(tx, README_PARAMS, 5, xgb_model=tb5)
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds() == 10
    _assert_forest_close(tb, jb)
    _assert_history_close(tev, jev)
    # the first five trees are the init model's
    assert tb.get_dump()[:5] == tb5.get_dump()
    # the models cross-load: the port continues the JAX package's saved
    # 5-round model, and the JAX package loads the port's result
    path = str(tmp_path / "jax5.json")
    jb5.save_model(path)
    from_file, _ = _train(tx, README_PARAMS, 5, xgb_model=path)
    _assert_forest_close(from_file, jb)
    loaded = jx.RayXGBoostBooster.load_raw(tb.save_raw())
    assert loaded.get_dump() == tb.get_dump()
    assert loaded.num_boosted_rounds() == 10


def test_warm_start_with_early_stopping_counts_the_init_rounds():
    tb5, _ = _train(tx, ES_PARAMS, 5)
    jb5, _ = _train(jx, ES_PARAMS, 5)
    tb, tev = _train(tx, ES_PARAMS, 60, xgb_model=tb5,
                     early_stopping_rounds=2)
    jb, jev = _train(jx, ES_PARAMS, 60, xgb_model=jb5,
                     early_stopping_rounds=2)
    assert tb.best_iteration == jb.best_iteration
    hist = tev["valid"]["logloss"]
    assert tb.best_iteration == 5 + int(np.argmin(hist))
    assert tb.num_boosted_rounds() == jb.num_boosted_rounds() == 5 + len(hist)


def test_warm_start_of_another_depth_raises_like_jax():
    """Init trees of another ``max_depth`` have another heap size: the JAX
    package stacks them with the new trees and fails; so does the port."""
    deep = dict(README_PARAMS, max_depth=3)
    for pkg in (jx, tx):
        init, _ = _train(pkg, deep, 2, held_out=False)
        with pytest.raises(ValueError):
            _train(pkg, README_PARAMS, 2, xgb_model=init)


class _Hooks:
    def __init__(self):
        self.calls = []

    def before_training(self, engine):
        self.calls.append("before_training")

    def before_iteration(self, engine, i, result):
        self.calls.append(("before", i))

    def after_iteration(self, engine, i, result):
        self.calls.append(("after", i, len(result["valid"]["logloss"])))
        return i == 2

    def after_training(self, engine):
        self.calls.append("after_training")


def test_callback_hooks_run_in_order():
    hooks = _Hooks()
    bst, _ = _train(tx, README_PARAMS, 10, callbacks=[hooks])
    assert hooks.calls == ["before_training", ("before", 0), ("after", 0, 1),
                           ("before", 1), ("after", 1, 2), ("before", 2),
                           ("after", 2, 3), "after_training"]
    assert bst.num_boosted_rounds() == 3


def test_eval_set_must_be_a_matrix():
    xt, yt, xv, _ = _split()
    with pytest.raises(ValueError, match="eval set 'valid'"):
        tx.train(README_PARAMS, tx.RayDMatrix(xt, yt), 1, device="cpu",
                 evals=[(xv, "valid")], ray_params=tx.RayParams(num_actors=1))


# ---------------------------------------------------------------------------
# B4's plain version against the JAX walk
# ---------------------------------------------------------------------------


def _random_tree(rng, depth, num_features, max_bin, leaf_rate=0.3):
    """A heap tree whose leaves lie at every depth (an internal node below
    the root's children is a leaf with ``leaf_rate``; the last level is all
    leaves), nodes below a leaf unused (feature -1), split bins over the
    whole range."""
    heap = (1 << (depth + 1)) - 1
    feature = np.full(heap, -1, np.int32)
    split_bin = np.zeros(heap, np.int32)
    default_left = np.zeros(heap, bool)
    is_leaf = np.zeros(heap, bool)
    value = rng.standard_normal(heap).astype(np.float32)
    live = np.zeros(heap, bool)
    live[0] = True
    for i in range(heap):
        if not live[i]:
            continue
        # the root and its left child split (where the depth allows), one
        # sending missing rows left and one right; the root's right child
        # is a leaf (above the last level from depth 2 on)
        if i >= heap // 2 or i == 2 or (i > 2 and rng.random() < leaf_rate):
            is_leaf[i] = True
            continue
        feature[i] = rng.integers(0, num_features)
        split_bin[i] = rng.integers(0, max_bin)
        default_left[i] = rng.random() < 0.5 if i > 1 else i == 0
        live[2 * i + 1] = live[2 * i + 2] = True
    return dict(feature=feature, split_bin=split_bin, default_left=default_left,
                is_leaf=is_leaf, value=value)


@pytest.mark.parametrize("max_bin,dtype", [(255, np.uint8), (256, np.int16),
                                           (1000, np.int16)])
@pytest.mark.parametrize("depth", [1, 3, 6])
def test_b4_plain_matches_jax(max_bin, dtype, depth):
    rng = np.random.default_rng(100 * depth + max_bin)
    n, f = 3000, 11
    bins = rng.integers(0, max_bin + 1, (n, f)).astype(dtype)
    bins[rng.random((n, f)) < 0.15] = max_bin  # the missing bin
    fields = _random_tree(rng, depth, f, max_bin)
    zeros = np.zeros_like(fields["value"])
    jtree = jg.Tree(threshold=zeros, gain=zeros, cover=zeros,
                    base_weight=zeros,
                    **{k: v for k, v in fields.items()})
    ref = np.asarray(jg.predict_tree_binned(
        jg.Tree(*[jnp.asarray(a) for a in jtree]), jnp.asarray(bins), depth,
        max_bin))
    ttree = tg.Tree(*[torch.from_numpy(np.asarray(a)) for a in jtree])
    got = tg.predict_tree_binned(ttree, torch.from_numpy(bins), depth, max_bin)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))
