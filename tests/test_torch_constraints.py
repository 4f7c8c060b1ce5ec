"""Monotone and interaction constraints of the port against the JAX
package on the CPU.

- K2's plain constrained search (``ops/split.find_splits_plain`` with
  ``monotone`` / ``lower`` / ``upper``) is bitwise the JAX ``find_splits``
  on random histograms and bounds (infinite, equal and crossing bounds,
  ``reg_alpha``, ``max_delta_step``, zero hessians); the level step's
  next bounds, from the winner's carried child weights, are bitwise the
  reference grower's, which recomputes them from a second cumsum
  (``xgboost_ray_tpu/ops/grow.py:710-748``);
- the interaction mask K2 reads off a node's ancestors
  (``ops/split.interaction_mask``) equals the reference's state tensors
  (``ops/grow.InteractionState``, ``ic_active`` / ``ic_used`` /
  ``ic_has_used``) on random trees;
- ``train()`` with monotone constraints (string and tuple forms, signs +1
  and -1), interaction constraints, both, both with ``colsample_bynode``
  and ``subsample`` 0.8, and ``multi:softprob`` with monotone constraints
  equals the JAX package at ``num_actors`` 1 and 2 (a 2-rank gloo world):
  dumps with stats equal, the history and ``predict`` within the f32
  summation bound (1e-6 relative above 1, absolute below);
- the models keep their constraints exactly: margins along a grid in each
  constrained feature never decrease for +1 and never increase for -1
  (a sum of monotone terms in a fixed order rounds monotonically), and
  every root-to-leaf path's features lie in one group;
- the parameters parse and fail as the JAX package's do (its messages),
  and pass through the sklearn estimators.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_constraints as C
import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu.ops import split as js
from xgboost_ray_tpu_torch import sklearn as tsk
from xgboost_ray_tpu_torch.distributed import World
from xgboost_ray_tpu_torch.ops import grow as tg
from xgboost_ray_tpu_torch.ops import split as ts

ROUNDS = 3
GROUPS = "[[0, 1], [2, 3, 4], [1, 5, 6, 7]]"

#: name -> (params, label kind); each JAX model trains once a module
CASES = {
    "monotone": ({"objective": "binary:logistic", "max_depth": 3,
                  "monotone_constraints": "(1,-1,0,-1,0,1)"}, "binary"),
    "interaction": ({"objective": "binary:logistic", "max_depth": 3,
                     "interaction_constraints": GROUPS}, "binary"),
    "both": ({"objective": "binary:logistic", "max_depth": 3,
              "monotone_constraints": (1, 0, -1, 0, 0, 1),
              "interaction_constraints": GROUPS}, "binary"),
    "both_sampled": ({"objective": "binary:logistic", "max_depth": 3,
                      "monotone_constraints": (1, 0, -1, 0, 0, 1),
                      "interaction_constraints": GROUPS,
                      "colsample_bynode": 0.8, "subsample": 0.8},
                     "binary"),
    "softprob_monotone": ({"objective": "multi:softprob", "num_class": 3,
                           "max_depth": 2,
                           "monotone_constraints": "(1,0,-1)"}, "classes"),
}


def _params(name):
    params, _ = CASES[name]
    return {"max_bin": 32, "seed": 7, "eval_metric": ["logloss"]
            if params["objective"] == "binary:logistic" else ["mlogloss"],
            **params}


def _label(name):
    return C.Y if CASES[name][1] == "binary" else C.YK


@functools.lru_cache(maxsize=None)
def _jax(name, actors):
    return C.jax_train(_params(name), _label(name), ROUNDS, actors)


@functools.lru_cache(maxsize=None)
def _port(name):
    return C.port_train(_params(name), _label(name), ROUNDS)


@pytest.fixture(scope="module")
def world2():
    with World(2, "cpu") as w:
        yield w


# --------------------------------------------------------------------------
# K2's plain constrained search and level step
# --------------------------------------------------------------------------


def _hist(seed, n_nodes, f, nbt):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n_nodes, f, nbt)) * 3
    h = rng.uniform(0.0, 2.0, (n_nodes, f, nbt))
    h[:, :, 5:9] = 0.0  # empty bins: tied neighbouring candidates
    g[:, :, 5:9] = 0.0
    g[:, :, -1] += (g[:, :1, :].sum(-1) - g.sum(-1))
    h[:, :, -1] = np.abs(h[:, :, -1]) + 1.0
    return np.stack([g, h], -1).astype(np.float32)


def _bounds(rng, n):
    """Random monotone bounds: node 0 unbounded, 1 equal, 2 crossing, 3 and
    4 one-sided, the others finite intervals."""
    lo = (rng.standard_normal(n) * 0.3 - 0.2).astype(np.float32)
    hi = (lo + np.abs(rng.standard_normal(n)) * 0.5).astype(np.float32)
    lo[0], hi[0] = -np.inf, np.inf
    lo[1] = hi[1]
    lo[2], hi[2] = 0.3, -0.3
    lo[3] = -np.inf
    hi[4] = np.inf
    return lo, hi


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_search(h, mono, lo, hi, p):
    """The JAX ``find_splits`` (monotone branch) after the grower's readout,
    compiled alone: the rounding the port pins. (XLA fuses
    score_given_weight's multiply-add with the operand order its HLO
    canonicalisation gives, which depends on the program around it;
    compiled alone, every term is fma(2 T, w, ((h + lambda) w) w).)"""
    node_gh = h[:, 0, :, :].sum(axis=1)
    return js.find_splits(h, node_gh, p, monotone=mono, node_lower=lo,
                          node_upper=hi), node_gh


@functools.partial(jax.jit, static_argnums=(5,))
def _jax_children(h, node_gh, sp, mono, lo_hi, p):
    """The reference grower's node values and children's bounds of one
    level (``ops/grow.py:710-748``): the winner's child weights recomputed
    from a second cumsum over its feature's buckets."""
    lo, hi = lo_hi
    max_bin = h.shape[2] - 1
    fsafe = jnp.clip(sp.feature, 0, h.shape[1] - 1)
    hist_f = jnp.take_along_axis(h, fsafe[:, None, None, None], axis=1)[:, 0]
    gf, hf = hist_f[..., 0], hist_f[..., 1]
    sbin_c = jnp.clip(sp.split_bin, 0, max_bin - 2)[:, None]
    gl_c = jnp.take_along_axis(jnp.cumsum(gf[:, :max_bin], axis=-1), sbin_c,
                               axis=1)[:, 0]
    hl_c = jnp.take_along_axis(jnp.cumsum(hf[:, :max_bin], axis=-1), sbin_c,
                               axis=1)[:, 0]
    gl_c = jnp.where(sp.default_left, gl_c + gf[:, max_bin], gl_c)
    hl_c = jnp.where(sp.default_left, hl_c + hf[:, max_bin], hl_c)
    wl = js.bounded_weight(gl_c, hl_c, p, lo, hi)
    wr = js.bounded_weight(node_gh[:, 0] - gl_c, node_gh[:, 1] - hl_c, p, lo,
                           hi)
    mid = 0.5 * (wl + wr)
    c = jnp.where(sp.valid, mono[fsafe], 0.0)
    lower = jnp.stack([jnp.where(c < 0, jnp.maximum(lo, mid), lo),
                       jnp.where(c > 0, jnp.maximum(lo, mid), lo)],
                      axis=1).reshape(-1)
    upper = jnp.stack([jnp.where(c > 0, jnp.minimum(hi, mid), hi),
                       jnp.where(c < 0, jnp.minimum(hi, mid), hi)],
                      axis=1).reshape(-1)
    value = p.learning_rate * js.bounded_weight(node_gh[:, 0], node_gh[:, 1],
                                                p, lo, hi)
    return lower, upper, value


#: (seed, nbt, reg_lambda, reg_alpha, max_delta_step, min_child_weight):
#: with reg_alpha 0 and max_delta_step on, XLA fuses the children's other
#: product (``ops/split.score_given_weight``)
SEARCH_CASES = [
    (0, 257, 1.0, 0.0, 0.0, 1.0),
    (1, 65, 0.5, 0.3, 0.4, 0.0),
    (2, 17, 0.0, 0.0, 0.0, 0.0),  # zero hessians below
    (3, 257, 1.0, 0.7, 0.0, 2.0),
    (4, 33, 2.0, 0.0, 0.25, 0.5),
    (6, 257, 1.0, 0.3, 0.25, 1.0),
    (5, 129, 0.0, 0.1, 0.0, 0.0),  # zero hessians below
]


@pytest.mark.parametrize("case", SEARCH_CASES)
def test_find_splits_constrained_matches_jax(case):
    seed, nbt, lam, alpha, mds, mcw = case
    rng = np.random.default_rng(seed)
    n, f = 8, 5
    hist = _hist(seed, n, f, nbt)
    if lam == 0.0:
        hist[1::2, :, :, 1] = 0.0  # H + lambda = 0 on every other node
    mono = rng.choice([-1, 0, 1], f)
    mono[0], mono[1] = 1, -1
    lo, hi = _bounds(rng, n)
    jp = js.SplitParams(reg_lambda=lam, reg_alpha=alpha, max_delta_step=mds,
                        min_child_weight=mcw)
    args = (jnp.asarray(hist), jnp.asarray(mono, jnp.float32),
            jnp.asarray(lo), jnp.asarray(hi))
    sp, node_gh = _jax_search(*args, jp)
    lower, upper, value = _jax_children(args[0], node_gh, sp, args[1],
                                        args[2:], jp)
    p = ts.SplitParams(reg_lambda=lam, reg_alpha=alpha, max_delta_step=mds,
                       min_child_weight=mcw)
    got = ts.find_splits_plain(torch.from_numpy(hist), p,
                               monotone=torch.tensor(mono, dtype=torch.int8),
                               lower=torch.from_numpy(lo),
                               upper=torch.from_numpy(hi))
    for name in ("gain", "feature", "split_bin", "default_left", "valid"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(sp, name))), name
    # the level step: records, node values and the children's bounds
    cons = ts.TreeConstraints(tuple(int(c) for c in mono), (), f, "cpu")
    rec = ts.TreeRecords(tg.empty_tree(2 * n + 1, "cpu"),
                         torch.zeros((f, nbt - 2)), None, p, cons)
    step = ts.split_level_plain(torch.from_numpy(hist), None, None,
                                torch.ones(n, dtype=torch.bool), rec,
                                bounds=(torch.from_numpy(lo),
                                        torch.from_numpy(hi)))
    assert np.array_equal(step.bounds[0].numpy(), np.asarray(lower))
    assert np.array_equal(step.bounds[1].numpy(), np.asarray(upper))
    assert np.array_equal(step.node_value.numpy(), np.asarray(value))


def test_all_zero_monotone_is_unconstrained():
    """A ``monotone_constraints`` of zeros is no constraint (the reference's
    ``mono_on``): the same model as none, and no constraint in the grow
    config."""
    params = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 32}
    x, y = C.X[:500], C.Y[:500]
    plain = tx.train(params, tx.RayDMatrix(x, y), 2, device="cpu",
                     ray_params=tx.RayParams(num_actors=1))
    zero = tx.train({**params, "monotone_constraints": "(0,0,0)"},
                    tx.RayDMatrix(x, y), 2, device="cpu",
                    ray_params=tx.RayParams(num_actors=1))
    assert zero.get_dump(with_stats=True) == plain.get_dump(with_stats=True)
    assert ts.TreeConstraints((0, 0, 0), (), 8, "cpu").on is False


# --------------------------------------------------------------------------
# the interaction mask: ancestors against the reference's state
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n_sets", [(0, 3), (1, 1), (2, 40)])
def test_interaction_mask_matches_state(seed, n_sets):
    """Random trees of depth 6 over 10 features: at every level the mask
    read off each node's ancestors equals the one the reference's state
    tensors give (40 groups: two words of bits a feature)."""
    rng = np.random.default_rng(seed)
    f, depth = 10, 6
    groups = tuple(tuple(sorted(set(rng.choice(f, rng.integers(1, 5)))))
                   for _ in range(n_sets))
    cons = ts.TreeConstraints((), groups, f, "cpu")
    assert cons.ic_bits.shape == (f, -(-n_sets // 32))
    state = tg.InteractionState(cons.membership)
    feature = torch.full(((2 << depth) - 1,), -1, dtype=torch.int32)
    active = torch.ones(1, dtype=torch.bool)
    for d in range(depth):
        n_nodes = 1 << d
        allowed = state.allowed()
        got = ts.interaction_mask(feature, n_nodes, cons.membership)
        assert torch.equal(got, allowed), d
        # each active node splits on an allowed feature, or becomes a leaf
        valid = active & torch.from_numpy(rng.random(n_nodes) < 0.75)
        pick = torch.tensor([int(rng.choice(np.flatnonzero(a.numpy())))
                             for a in allowed], dtype=torch.int32)
        feature[n_nodes - 1:2 * n_nodes - 1] = torch.where(valid, pick, -1)
        state.split(valid, pick)
        active = torch.repeat_interleave(valid, 2)


# --------------------------------------------------------------------------
# train() against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_train_matches_jax(name):
    jb, jev = _jax(name, 1)
    tb, tev = _port(name)
    C.check_pair(jb, jev, tb, tev)
    if name == "monotone":
        # the tuple form gives the same model
        params = dict(_params(name), monotone_constraints=(1, -1, 0, -1, 0, 1))
        tt, _ = C.port_train(params, C.Y, ROUNDS)
        assert tt.get_dump(with_stats=True) == jb.get_dump(with_stats=True)


@pytest.mark.parametrize("name", list(CASES))
def test_train_matches_jax_two_actors(name, world2):
    jb, jev = _jax(name, 2)
    tb, tev = C.port_train(_params(name), _label(name), ROUNDS, world2)
    C.check_pair(jb, jev, tb, tev)


def _signs(name):
    raw = _params(name)["monotone_constraints"]
    if isinstance(raw, str):
        raw = [int(v) for v in raw.strip("()").split(",")]
    return {i: c for i, c in enumerate(raw) if c}


@pytest.mark.parametrize("name", ["monotone", "both", "softprob_monotone"])
def test_monotone_grid(name):
    """Margins along a 64-point grid in each constrained feature (the other
    features from 50 rows, missing values included) never decrease for +1
    and never increase for -1, exactly; the model splits on some of them."""
    tb, _ = _port(name)
    grid = np.linspace(-3.0, 3.0, 64, dtype=np.float32)
    rows = C.X[:50]
    moved = False
    for fi, sign in _signs(name).items():
        x = np.repeat(rows, len(grid), axis=0)
        x[:, fi] = np.tile(grid, len(rows))
        m = tb.predict(x, output_margin=True, device="cpu")
        m = m.reshape(len(rows), len(grid), -1)
        steps = np.diff(m, axis=1) * sign
        assert (steps >= 0).all(), (fi, sign)
        moved = moved or bool((steps > 0).any())
    assert moved


def _path_features(bst):
    """The feature sets of every root-to-leaf path of every tree."""
    feature = np.asarray(bst.forest.feature)
    is_leaf = np.asarray(bst.forest.is_leaf)
    paths = []
    for t in range(feature.shape[0]):
        stack = [(0, frozenset())]
        while stack:
            i, used = stack.pop()
            if is_leaf[t, i] or feature[t, i] < 0:
                paths.append(used)
                continue
            used = used | {int(feature[t, i])}
            stack += [(2 * i + 1, used), (2 * i + 2, used)]
    return paths


@pytest.mark.parametrize("name", ["interaction", "both", "both_sampled"])
def test_interaction_paths(name):
    tb, _ = _port(name)
    groups = [frozenset(g) for g in eval(GROUPS)]
    paths = _path_features(tb)
    assert any(len(p) > 1 for p in paths)
    for path in paths:
        assert any(path <= g for g in groups), path


# --------------------------------------------------------------------------
# parsing, validation and the estimators
# --------------------------------------------------------------------------


@pytest.mark.parametrize("key,value,err,match", [
    ("monotone_constraints", "(2,0)", ValueError, "-1, 0, or"),
    ("monotone_constraints", {"f0": 1}, ValueError, "dict-form"),
    ("monotone_constraints", "(1,0,0,0)", ValueError, "entries but the data"),
    ("interaction_constraints", [[0, 7]], ValueError, "feature indices"),
    ("interaction_constraints", "[[0, 1", ValueError, "could not parse"),
    ("interaction_constraints", [[0, -1]], ValueError, ">= 0"),
])
def test_constraint_validation_errors(key, value, err, match):
    """The JAX package's checks and messages
    (``tests/test_constraints.py:188``)."""
    x = np.random.RandomState(0).randn(50, 3).astype(np.float32)
    y = x[:, 0].astype(np.float32)
    for pkg, kw in ((jx, {}), (tx, {"device": "cpu"})):
        with pytest.raises(err, match=match):
            pkg.train({"objective": "reg:squarederror", key: value},
                      pkg.RayDMatrix(x, y), 1,
                      ray_params=pkg.RayParams(num_actors=1), **kw)


def test_constraints_parse_as_jax():
    from xgboost_ray_tpu.params import parse_params as jparse
    from xgboost_ray_tpu_torch.params import parse_params as tparse

    for raw in ({"monotone_constraints": "(1, -1,0)"},
                {"monotone_constraints": [1, 0, -1]},
                {"monotone_constraints": "()"},
                {"interaction_constraints": "[[2, 0, 0], [1], []]"},
                {"interaction_constraints": [(3, 1)]},
                {"interaction_constraints": "[]"}):
        j, t = jparse(dict(raw)), tparse(dict(raw))
        assert t.monotone_constraints == j.monotone_constraints
        assert t.interaction_constraints == j.interaction_constraints


def test_constraints_through_estimators():
    """Both parameters pass through an estimator's keywords: the fitted
    model is the JAX estimator's."""
    from xgboost_ray_tpu import sklearn as jsk

    kw = dict(n_estimators=2, max_depth=2, max_bin=32,
              monotone_constraints="(1,0,-1)",
              interaction_constraints=[[0, 1], [2, 3, 4, 5, 6, 7]])
    x, y = C.X[:C.N_TRAIN], C.Y[:C.N_TRAIN]
    t = tsk.RayXGBClassifier(device="cpu", **kw).fit(x, y)
    j = jsk.RayXGBClassifier(**kw).fit(x, y)
    assert (t.get_booster().get_dump(with_stats=True)
            == j.get_booster().get_dump(with_stats=True))
    assert t.get_xgb_params()["monotone_constraints"] == "(1,0,-1)"
    C.close(t.predict_proba(x), j.predict_proba(x), "predict_proba")
