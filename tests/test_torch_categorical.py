"""Categorical one-vs-rest splits of the port against the JAX package on
the CPU.

- K2's plain search with categorical features (``ops/split._search_plain``
  with ``cat``) is bitwise the JAX ``find_splits`` with ``cat_mask`` on
  random histograms, unmasked, masked and constrained (monotone signs on
  numeric features beside categorical ones); the winner's carried child
  weights are the reference grower's recomputation from the single slot
  (``xgboost_ray_tpu/ops/grow.py:715-735``);
- K3's and B4's plain routing (``route_right_binned`` /
  ``predict_tree_binned_plain`` with ``cat``) equal the JAX rule and walk,
  with code ``max_bin - 2`` and an all-missing column;
- the loaders encode a ``category`` frame as the JAX package's does,
  translate codes between category sets, and refuse what it refuses, with
  its messages;
- ``train()`` on a ``category`` frame with NaN, on the same codes with
  ``feature_types``, with monotone and interaction constraints, under
  ``multi:softprob``, with ``subsample`` / ``colsample_bynode`` and with a
  held-out set of another category subset and early stopping equals the
  JAX package at ``num_actors`` 1 and 2 (a 2-rank gloo world): dumps with
  stats equal, the history and ``predict`` within the f32 summation bound;
  predict translates a frame of another category order; save / load keeps
  the mapping; the sklearn estimators pass ``enable_categorical`` on.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import _torch_constraints as C
import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu.ops import grow as jg
from xgboost_ray_tpu.ops import split as js
from xgboost_ray_tpu_torch import distributed as D
from xgboost_ray_tpu_torch import sklearn as tsk
from xgboost_ray_tpu_torch.distributed import World
from xgboost_ray_tpu_torch.matrix import translate_shard_categories
from xgboost_ray_tpu_torch.ops import grow as tg
from xgboost_ray_tpu_torch.ops import split as ts

N_TRAIN, N_VALID = 1200, 300
ROUNDS = 3
FT = ["q", "c", "q", "c", "c", "q"]
COLORS = np.array(["red", "green", "blue", "teal", "plum"])


def _data(seed=0):
    """Six features: numeric 0, 2, 5 (5% missing in 0), categorical 1 (6
    codes), 3 (30 codes, 10% missing) and 4 (the colors); labels from
    category membership and its interactions with a numeric feature."""
    rng = np.random.default_rng(seed)
    n = N_TRAIN + N_VALID
    num = rng.standard_normal((n, 3)).astype(np.float32)
    num[rng.random(n) < 0.05, 0] = np.nan
    c1 = rng.integers(0, 6, n).astype(np.float32)
    c3 = rng.integers(0, 30, n).astype(np.float32)
    c3[rng.random(n) < 0.1] = np.nan
    color = rng.integers(0, 5, n)
    x = np.column_stack([num[:, 0], c1, num[:, 1], c3, color,
                         num[:, 2]]).astype(np.float32)
    y = ((np.isin(c1, [1, 4]) ^ (num[:, 1] > 0)) | (c3 == 7)
         | (color == 3)).astype(np.float32)
    score = (np.isin(c1, [2, 5]) + 0.7 * (color % 3) + num[:, 1]
             + (c3 % 4 == 1))
    yk = np.digitize(score, np.quantile(score, [1 / 3, 2 / 3])
                     ).astype(np.float32)
    return x, y, yk, color


X, Y, YK, COLOR = _data()


def _frame(x, color_codes, cats=COLORS):
    """The features as a frame: column 1 a ``category`` column of its
    integer codes, column 3 a ``category`` column of its codes
    as strings (NaN stays missing; the strings sort as the codes), column
    4 a ``category`` column of color names over ``cats`` in that order
    (so its codes are ``color_codes``), the others numeric."""
    df = pd.DataFrame({f"f{i}": x[:, i] for i in (0, 2, 5)})
    df["f1"] = pd.Categorical(x[:, 1].astype(np.int64))
    df["f3"] = pd.Categorical(np.array(
        [None if np.isnan(v) else f"k{int(v):02d}" for v in x[:, 3]],
        dtype=object))
    df["f4"] = pd.Categorical(COLORS[color_codes], categories=list(cats))
    return df[["f0", "f1", "f2", "f3", "f4", "f5"]]


# --------------------------------------------------------------------------
# K2's plain search, K3's and B4's rules
# --------------------------------------------------------------------------


def _hist(seed, n_nodes, f, nbt):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n_nodes, f, nbt)) * 3
    h = rng.uniform(0.0, 2.0, (n_nodes, f, nbt))
    h[:, :, 5:9] = 0.0  # empty slots: tied candidates
    g[:, :, 5:9] = 0.0
    g[:, :, -1] += (g[:, :1, :].sum(-1) - g.sum(-1))
    h[:, :, -1] = np.abs(h[:, :, -1]) + 1.0
    h[:, 2, :-1] = 0.0  # feature 2: every row missing
    g[:, 2, :-1] = 0.0
    return np.stack([g, h], -1).astype(np.float32)


@functools.partial(jax.jit, static_argnums=(5,))
def _jax_search(h, cat, fmask, mono, lo_hi, p):
    node_gh = h[:, 0, :, :].sum(axis=1)
    lo, hi = lo_hi if lo_hi is not None else (None, None)
    return js.find_splits(h, node_gh, p, feature_mask=fmask, cat_mask=cat,
                          monotone=mono, node_lower=lo, node_upper=hi)


@pytest.mark.parametrize("mode", ["plain", "masked", "constrained"])
def test_search_matches_jax(mode):
    """The categorical candidates bitwise the JAX package's: gain, feature,
    bin, direction and validity at every node, with an all-missing
    categorical feature, empty slots and, constrained, monotone signs on
    numeric features beside the categorical ones."""
    n_nodes, f, nbt = 6, 7, 40
    h = _hist(3, n_nodes, f, nbt)
    cat = np.zeros(f, bool)
    cat[[1, 2, 4]] = True
    p = ts.SplitParams(reg_lambda=1.0, min_child_weight=0.5)
    fmask = mono = lo_hi = None
    if mode == "masked":
        fmask = np.ones(f, bool)
        fmask[[0, 4]] = False
    if mode == "constrained":
        mono = np.array([1, 0, 0, -1, 0, 1, 0], np.float32)
        rng = np.random.default_rng(5)
        lo = (rng.standard_normal(n_nodes) * 0.2 - 0.3).astype(np.float32)
        hi = (lo + np.abs(rng.standard_normal(n_nodes))).astype(np.float32)
        lo[0], hi[0] = -np.inf, np.inf
        lo_hi = (lo, hi)
    jp = js.SplitParams(reg_lambda=1.0, min_child_weight=0.5)
    ref = _jax_search(jnp.asarray(h), jnp.asarray(cat),
                      None if fmask is None else jnp.asarray(fmask),
                      None if mono is None else jnp.asarray(mono),
                      None if lo_hi is None else tuple(map(jnp.asarray,
                                                           lo_hi)), jp)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got, child_w = ts._search_plain(
        torch.from_numpy(h), p, t(fmask),
        None if mono is None else torch.from_numpy(mono).to(torch.int8),
        *(t(b) for b in (lo_hi or (None, None))), torch.from_numpy(cat))
    for name in ("gain", "feature", "split_bin", "default_left", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert cat[got.feature.numpy()].any()  # a categorical winner
    if child_w is not None:
        # the reference grower's recomputation (ops/grow.py:715-735): the
        # winner's left sums from its single slot, the missing bucket added
        # where it goes left, clamped weights
        fs = got.feature.numpy()
        sb = got.split_bin.numpy()
        node_gh = got.node_gh.numpy()
        for k in range(n_nodes):
            hf = h[k, fs[k]]
            gl, hl = ((hf[sb[k], 0], hf[sb[k], 1]) if cat[fs[k]] else
                      (np.float32(np.cumsum(hf[:-1, 0])[sb[k]]),
                       np.float32(np.cumsum(hf[:-1, 1])[sb[k]])))
            if got.default_left[k]:
                gl, hl = gl + hf[-1, 0], hl + hf[-1, 1]
            if not cat[fs[k]]:
                continue  # numeric: blocked vs plain cumsum order
            w = lambda g_, h_: ts.bounded_weight(  # noqa: E731
                torch.tensor(g_), torch.tensor(h_), p,
                torch.tensor(lo_hi[0][k]), torch.tensor(lo_hi[1][k]))
            assert child_w[0][k] == w(gl, hl), k
            assert child_w[1][k] == w(node_gh[k, 0] - gl,
                                      node_gh[k, 1] - hl), k


def test_route_and_walk_match_jax():
    """K3's and B4's plain rules with categorical splits: the JAX
    ``route_right_binned`` on every (bin, split, direction, flag), and the
    walk of random trees mixing numeric and categorical splits (code
    ``max_bin - 2`` and an all-missing column) bitwise the JAX
    ``predict_tree_binned``."""
    max_bin = 256
    bv = np.arange(max_bin + 1, dtype=np.int32)
    for sbin in (0, 7, max_bin - 2):
        for dl in (False, True):
            for is_cat in (False, True):
                ref = np.asarray(jg.route_right_binned(
                    jnp.asarray(bv), sbin, jnp.asarray(dl),
                    jnp.asarray(is_cat), max_bin))
                got = tg.route_right_binned(
                    torch.from_numpy(bv), torch.tensor(sbin),
                    torch.tensor(dl), max_bin, torch.tensor(is_cat))
                np.testing.assert_array_equal(got.numpy(), ref)
    rng = np.random.default_rng(11)
    n, f, depth = 500, 5, 4
    bins = rng.integers(0, max_bin - 1, (n, f)).astype(np.int16)
    bins[rng.random((n, f)) < 0.1] = max_bin
    bins[:, 3] = max_bin  # every row missing
    bins[::9, 1] = max_bin - 2
    cat = np.array([False, True, False, True, True])
    heap = (1 << (depth + 1)) - 1
    feat = rng.integers(0, f, heap).astype(np.int32)
    sbin = rng.integers(0, max_bin - 1, heap).astype(np.int32)
    sbin[feat == 1] = max_bin - 2
    leaf = np.zeros(heap, bool)
    leaf[(1 << depth) - 1:] = True
    leaf[rng.choice(heap, 4, replace=False)] = True
    feat[leaf] = -1
    dl = rng.random(heap) < 0.5
    value = rng.standard_normal(heap).astype(np.float32)
    jt = jg.empty_tree(heap)._replace(
        feature=jnp.asarray(feat), split_bin=jnp.asarray(sbin),
        default_left=jnp.asarray(dl), is_leaf=jnp.asarray(leaf),
        value=jnp.asarray(value))
    ref = np.asarray(jg.predict_tree_binned(
        jt, jnp.asarray(bins), depth, max_bin, cat_features=(1, 3, 4)))
    tt = tg.empty_tree(heap, "cpu")._replace(
        feature=torch.from_numpy(feat), split_bin=torch.from_numpy(sbin),
        default_left=torch.from_numpy(dl), is_leaf=torch.from_numpy(leaf),
        value=torch.from_numpy(value))
    got = tg.predict_tree_binned(tt, torch.from_numpy(bins), depth, max_bin,
                                 cat=torch.from_numpy(cat))
    np.testing.assert_array_equal(got.numpy(), ref)


# --------------------------------------------------------------------------
# loading: encoding, translation, refusals
# --------------------------------------------------------------------------


def test_frame_encoding_matches_jax():
    """A frame's ``category`` / object columns become the JAX package's
    codes, feature types and category mapping."""
    df = _frame(X, COLOR)
    df["f2"] = df["f2"].astype(object).where(df["f2"] > 0, "neg")
    got = tx.RayDMatrix(df, Y, enable_categorical=True)
    got.load_data(1)
    ref = jx.RayDMatrix(df, Y, enable_categorical=True)
    ref.load_data(1)
    assert got.resolved_feature_types == ref.resolved_feature_types
    assert got.resolved_categories == ref.resolved_categories
    np.testing.assert_array_equal(got.shards()[0]["data"],
                                  ref.get_data(0, 1)["data"])


def test_translation_matches_jax():
    """Codes of one category set re-mapped onto another: a category missing
    from the target NaN, as the JAX package's translation."""
    from xgboost_ray_tpu import matrix as jm

    shard = {"data": np.array([[0, 1.0], [2, np.nan], [1, 3.0]],
                              np.float32), "label": None}
    src, dst = {0: ("b", "c", "z")}, {0: ("a", "b", "c")}
    got = translate_shard_categories(shard, src, dst)
    np.testing.assert_array_equal(
        got["data"], jm.translate_shard_categories(shard, src, dst)["data"])
    assert translate_shard_categories(shard, dst, dst) is shard


def test_refusals_match_jax():
    """An object column without ``enable_categorical``, codes beyond
    ``max_bin - 2``, a monotone sign on a categorical feature, an
    auto-encoded eval set against a model of codes, and auto-encoding under
    distributed loading raise with the JAX package's messages."""
    df = pd.DataFrame({"s": ["a", "b", "a", "c"], "v": [1.0, 2.0, 3.0, 4.0]})
    with pytest.raises(ValueError, match="enable_categorical"):
        tx.RayDMatrix(df, np.array([0, 1, 0, 1], np.float32)).load_data(1)
    x = np.stack([np.arange(100, dtype=np.float32) * 10,
                  np.random.RandomState(3).randn(100).astype(np.float32)], 1)
    y = (np.arange(100) % 2).astype(np.float32)
    with pytest.raises(ValueError, match="max_bin"):
        tx.train({"objective": "binary:logistic", "max_bin": 64},
                 tx.RayDMatrix(x, y, feature_types=["c", "q"]), 2,
                 device="cpu", ray_params=tx.RayParams(num_actors=1))
    x[:, 0] = np.arange(100) % 5
    with pytest.raises(ValueError, match="monotone constraint on "
                                         "categorical feature 0"):
        tx.train({"objective": "binary:logistic",
                  "monotone_constraints": "(1,0)"},
                 tx.RayDMatrix(x, y, feature_types=["c", "q"]), 1,
                 device="cpu", ray_params=tx.RayParams(num_actors=1))
    dfe = pd.DataFrame({"c": pd.Categorical(["p", "q"] * 50), "v": x[:, 1]})
    with pytest.raises(ValueError, match="auto-encoded categorical"):
        tx.train({"objective": "binary:logistic"},
                 tx.RayDMatrix(x, y, feature_types=["c", "q"]), 1,
                 evals=[(tx.RayDMatrix(dfe, y, enable_categorical=True),
                         "v")], device="cpu",
                 ray_params=tx.RayParams(num_actors=1))
    bst = tx.train({"objective": "binary:logistic", "max_depth": 2},
                   tx.RayDMatrix(x, y, feature_types=["c", "q"]), 1,
                   device="cpu", ray_params=tx.RayParams(num_actors=1))
    with pytest.raises(ValueError, match="trained on integer codes"):
        tx.predict(bst, tx.RayDMatrix(dfe, enable_categorical=True),
                   device="cpu", ray_params=tx.RayParams(num_actors=1))
    loader = tx.matrix._DistributedRayDMatrixLoader(
        ["a.csv"], label="y", enable_categorical=True)
    with pytest.raises(ValueError, match="distributed loading"):
        loader._encode_categories(dfe)


# --------------------------------------------------------------------------
# train() against the JAX package
# --------------------------------------------------------------------------

#: name -> (params, label kind, how the data is given)
CASES = {
    "frame": ({"objective": "binary:logistic", "max_depth": 3}, "binary",
              "frame"),
    "codes": ({"objective": "binary:logistic", "max_depth": 3}, "binary",
              "codes"),
    "constraints": ({"objective": "binary:logistic", "max_depth": 2,
                     "monotone_constraints": "(1,0,-1,0,0,1)",
                     "interaction_constraints": "[[0, 1, 3], [1, 2, 4, 5]]"},
                    "binary", "codes"),
    "softprob": ({"objective": "multi:softprob", "num_class": 3,
                  "max_depth": 2}, "classes", "codes"),
    "sampled": ({"objective": "binary:logistic", "max_depth": 2,
                 "subsample": 0.8, "colsample_bynode": 0.8}, "binary",
                "codes"),
}


def _params(name):
    params = CASES[name][0]
    return {"max_bin": 32, "seed": 7, "eval_metric": ["logloss"]
            if params["objective"] == "binary:logistic" else ["mlogloss"],
            **params}


def _label(name):
    return Y if CASES[name][1] == "binary" else YK


def _matrices(pkg, name, label):
    """(train, valid) matrices of ``pkg`` for the case's form of data."""
    sl, sv = slice(0, N_TRAIN), slice(N_TRAIN, None)
    if CASES[name][2] == "frame":
        df = _frame(X, COLOR)
        return (pkg.RayDMatrix(df.iloc[sl], label[sl],
                               enable_categorical=True),
                pkg.RayDMatrix(df.iloc[sv], label[sv],
                               enable_categorical=True))
    return (pkg.RayDMatrix(X[sl], label[sl], feature_types=FT),
            pkg.RayDMatrix(X[sv], label[sv], feature_types=FT))


@functools.lru_cache(maxsize=None)
def _jax(name, actors):
    label = _label(name)
    dtrain, dvalid = _matrices(jx, name, label)
    ev = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        bst = jx.train(_params(name), dtrain, ROUNDS, evals_result=ev,
                       evals=[(dtrain, "train"), (dvalid, "valid")],
                       ray_params=jx.RayParams(num_actors=actors))
    return bst, ev


def _port(name, world=None):
    label = _label(name)
    if world is None:
        dtrain, dvalid = _matrices(tx, name, label)
        ev = {}
        bst = tx.train(_params(name), dtrain, ROUNDS, evals_result=ev,
                       evals=[(dtrain, "train"), (dvalid, "valid")],
                       ray_params=tx.RayParams(num_actors=1), device="cpu")
        return bst, ev
    held = [dict(D.share({"x": X[N_TRAIN:], "label": label[N_TRAIN:]}),
                 sharding="INTERLEAVED")]
    out = world.run(D._train_rank,
                    D.share({"x": X[:N_TRAIN], "label": label[:N_TRAIN]}),
                    _params(name), ROUNDS,
                    {"device": "cpu", "eval_names": ["train", "valid"],
                     "eval_data": [None, *held], "num_actors": 2,
                     "feature_types": FT})
    assert out[0]["model"] == out[1]["model"]
    return (tx.RayXGBoostBooster.load_raw(out[0]["model"]),
            out[0]["evals_result"])


@pytest.fixture(scope="module")
def world2():
    with World(2, "cpu") as w:
        yield w


def _check(jb, jev, tb, tev):
    assert tb.get_dump(with_stats=True) == jb.get_dump(with_stats=True)
    assert tev.keys() == jev.keys()
    for s in jev:
        for m in jev[s]:
            C.close(tev[s][m], jev[s][m], f"{s}-{m}")
    C.close(tb.predict(X, device="cpu"), np.asarray(jb.predict(X)),
            "predict")


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_matches_jax(name):
    """``train()`` at ``num_actors=1`` equals the JAX package's: dumps with
    stats, the history and ``predict`` (the frame case: its model keeps the
    frame's types and category mapping, as the JAX package's)."""
    jb, jev = _jax(name, 1)
    tb, tev = _port(name)
    _check(jb, jev, tb, tev)
    assert tb.feature_types == jb.feature_types
    assert tb.categories == jb.categories


@pytest.mark.parametrize("name", sorted(set(CASES) - {"frame"}))
def test_train_matches_jax_two_ranks(world2, name):
    """In a 2-rank gloo world (``num_actors=2``, the codes with
    ``feature_types``) the model equals the JAX package's at
    ``num_actors=2``."""
    jb, jev = _jax(name, 2)
    tb, tev = _port(name, world2)
    _check(jb, jev, tb, tev)


def test_frame_and_codes_models_equal_and_cross_load():
    """The frame and the same codes with ``feature_types`` train the same
    model (the frame's encoding is the codes); a categorical model saved
    by either package loads in the other with its feature types and
    category mapping and predicts there bitwise as that package's own
    model (a frame translated by the mapping too)."""
    frame, codes = _port("frame")[0], _port("codes")[0]
    assert frame.get_dump(with_stats=True) == codes.get_dump(with_stats=True)
    jb = _jax("frame", 1)[0]
    in_port = tx.RayXGBoostBooster.load_raw(jb.save_raw())
    in_jax = jx.RayXGBoostBooster.load_raw(frame.save_raw())
    for loaded, own in ((in_port, frame), (in_jax, jb)):
        assert loaded.feature_types == own.feature_types
        assert loaded.categories == own.categories
    df = _frame(X, COLOR)
    kw = {"device": "cpu"}
    np.testing.assert_array_equal(in_port.predict(df, **kw),
                                  frame.predict(df, **kw))
    np.testing.assert_array_equal(in_port.predict(X, **kw),
                                  frame.predict(X, **kw))
    np.testing.assert_array_equal(np.asarray(in_jax.predict(X)),
                                  np.asarray(jb.predict(X)))


def test_eval_subset_early_stopping_and_predict_order():
    """A held-out frame holding a subset of the colors (its own codes
    differ) is translated onto the training mapping: history and early
    stopping as the JAX package's; ``predict`` on a frame whose category
    order differs equals ``predict`` on the codes; the mapping survives
    save / load."""
    keep = np.isin(COLOR, [1, 3, 4])
    df = _frame(X, COLOR)
    dv = df[keep].copy()
    dv["f4"] = pd.Categorical(dv["f4"].astype(str))  # its own category set
    params = {"objective": "binary:logistic", "max_depth": 2, "max_bin": 32,
              "eval_metric": ["error", "logloss"]}
    runs = []
    for pkg, kw in ((jx, {}), (tx, {"device": "cpu"})):
        dtrain = pkg.RayDMatrix(df, Y, enable_categorical=True)
        dvalid = pkg.RayDMatrix(dv, Y[keep], enable_categorical=True)
        ev = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            bst = pkg.train(params, dtrain, 8, evals=[(dvalid, "v")],
                            evals_result=ev, early_stopping_rounds=2,
                            ray_params=pkg.RayParams(num_actors=1), **kw)
        runs.append((bst, ev))
    (jb, jev), (tb, tev) = runs
    assert tb.get_dump(with_stats=True) == jb.get_dump(with_stats=True)
    assert tb.best_iteration == jb.best_iteration
    for m in jev["v"]:
        C.close(tev["v"][m], jev["v"][m], m)
    shuffled = df.copy()
    shuffled["f4"] = pd.Categorical(df["f4"].astype(str),
                                    categories=list(COLORS[::-1]))
    codes = tx.RayDMatrix(X, feature_types=FT)
    np.testing.assert_array_equal(
        tx.predict(tb, tx.RayDMatrix(shuffled, enable_categorical=True),
                   device="cpu", ray_params=tx.RayParams(num_actors=1)),
        tx.predict(tb, codes, device="cpu",
                   ray_params=tx.RayParams(num_actors=1)))
    np.testing.assert_array_equal(tb.predict(shuffled, device="cpu"),
                                  tb.predict(X, device="cpu"))
    loaded = tx.RayXGBoostBooster.load_raw(tb.save_raw())
    assert loaded.categories == tb.categories == jb.categories
    np.testing.assert_array_equal(loaded.predict(shuffled, device="cpu"),
                                  tb.predict(X, device="cpu"))


def test_missing_follows_default_and_sklearn_passthrough():
    """The JAX package's categorical behaviours: missing codes follow the
    learned default; the estimators pass ``enable_categorical`` on to the
    matrix (a frame with a ``category`` column)."""
    rng = np.random.RandomState(4)
    cat = rng.randint(0, 5, 600).astype(np.float32)
    x = np.stack([cat, rng.randn(600).astype(np.float32)], axis=1)
    y = np.isin(cat, [1, 3]).astype(np.float32)
    x[::7, 0] = np.nan
    bst = tx.train({"objective": "binary:logistic", "max_depth": 3},
                   tx.RayDMatrix(x, y, feature_types=["c", "q"]), 5,
                   device="cpu", ray_params=tx.RayParams(num_actors=1))
    pred = bst.predict(x, device="cpu")
    mask = ~np.isnan(x[:, 0])
    assert ((pred[mask] > 0.5) == y[mask]).mean() > 0.95
    color = rng.choice(["a", "b", "c", "d"], size=300)
    df = pd.DataFrame({"cat": pd.Categorical(color),
                       "num": rng.randn(300).astype(np.float32)})
    yc = np.isin(color, ["b", "d"]).astype(np.float32)
    clf = tsk.RayXGBClassifier(n_estimators=4, max_depth=2,
                               learning_rate=1.0, enable_categorical=True,
                               device="cpu")
    clf.fit(df, yc)
    assert (clf.predict(df) == yc).mean() == 1.0
    assert clf.get_booster().categories == {0: ("a", "b", "c", "d")}
