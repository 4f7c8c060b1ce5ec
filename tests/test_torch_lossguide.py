"""Leaf-wise growth (``grow_policy="lossguide"``) of the port against the JAX
package on the CPU.

- the plain frontier step (``ops/grow_lossguide.frontier_step_plain``)
  keeps the reference scan's tables (``xgboost_ray_tpu/ops/
  grow_lossguide.py:200-289``, transcribed below step for step) on random
  gains with ties, invalid children, a budget the heap cuts short and an
  exhausted frontier: entries, selections and tree records equal;
- the distance between the port's plain histogram (the scatter order of
  K1's plain version) and the reference's lossguide histogram
  (``hist_onehot``: an f32 one-hot product whose missing bucket is the
  node total less the regular bins) on the same rows is pinned;
- ``train()`` at the full budget, on chains that hit the budget, under
  ``binary:logistic``, with categorical features and NaN under
  ``multi:softprob``, with ``subsample`` / ``colsample_bytree`` 0.8 and
  with a held-out set and early stopping equals the JAX package at
  ``num_actors`` 1 and 2 (a 2-rank gloo world): the trees' structure
  (features, thresholds, directions, leaves) exactly, every gain, cover
  and leaf value, the history and ``predict`` within ``LG_RTOL`` relative
  (the reference's histogram above is the oracle's limit: its sums differ
  from the scatter order's by up to ~1e-5 relative, which the next
  rounds' gradients carry);
- at ``max_leaves = 2^max_depth`` the port's lossguide model has the
  depthwise model's structure and margins within 1e-4 (the reference's
  own gate, ``tests/test_lossguide.py:72-86``);
- the parameters fail as the JAX package's do, with its messages.
"""

import functools
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu.ops import histogram as jh
from xgboost_ray_tpu_torch import distributed as D
from xgboost_ray_tpu_torch.distributed import World
from xgboost_ray_tpu_torch.ops import grow as tg
from xgboost_ray_tpu_torch.ops import grow_lossguide as lg
from xgboost_ray_tpu_torch.ops import histogram as th
from xgboost_ray_tpu_torch.ops import split as ts

#: relative bound of the statistics against the JAX package (absolute
#: below 1): the oracle's one-hot histogram (module docstring)
LG_RTOL = 5e-5
ROUNDS = 3


# --------------------------------------------------------------------------
# the frontier step against the reference scan's tables
# --------------------------------------------------------------------------


def _reference_scan_step(tab, tree, sp, t, heap, lr_value):
    """One step of the reference scan body on numpy tables (``:200-289``):
    returns (do_split, chosen entry, split slot) and updates ``tab`` /
    ``tree`` in place. ``sp``: the step's two children's (gain, feature,
    bin, dl, valid, value, cover)."""
    scores = np.where(tab["active"], tab["gain"], -np.inf)
    i = int(np.argmax(scores))
    do_split = bool(np.isfinite(scores[i]))
    slot = max(int(tab["slot"][i]), 0)
    if do_split:
        tree["feature"][slot] = tab["feat"][i]
        tree["split_bin"][slot] = tab["bin"][i]
        tree["default_left"][slot] = tab["dl"][i]
        tree["is_leaf"][slot] = False
        tree["value"][slot] = 0.0
        tree["gain"][slot] = tab["gain"][i]
        tab["active"][i] = False
    kids = np.array([2 * slot + 1, 2 * slot + 2])
    can = sp["valid"] & (2 * kids + 2 < heap) & do_split
    ks = [1 + 2 * t, 2 + 2 * t]
    if do_split:
        tree["is_leaf"][kids] = True
        tree["value"][kids] = sp["value"]
        tree["cover"][kids] = sp["cover"]
    tab["slot"][ks] = np.where(do_split, kids, -1)
    tab["active"][ks] = do_split
    tab["gain"][ks] = np.where(can, sp["gain"], -np.inf)
    tab["feat"][ks] = np.where(do_split, sp["feat"], 0)
    tab["bin"][ks] = np.where(do_split, sp["bin"], 0)
    tab["dl"][ks] = sp["dl"] & do_split
    return do_split, i, slot


@pytest.mark.parametrize("seed", [0, 1])
def test_frontier_step_matches_reference_tables(seed):
    """Random children's searches (gains with ties, invalid splits) through
    the plain frontier step and the transcribed reference step: the same
    entry tables, choices and records at every step, through a budget the
    heap's depth cuts short (depth 3, 12 leaves) into an exhausted
    frontier."""
    rng = np.random.default_rng(seed)
    depth, leaves, f, nbt = 3, 12, 4, 6
    heap = (1 << (depth + 1)) - 1
    n_ent = 2 * leaves - 1
    p = ts.SplitParams(learning_rate=0.5)
    tree = tg.empty_tree(heap, "cpu")
    cuts = torch.from_numpy(np.sort(rng.standard_normal((f, nbt - 2)), 1)
                            .astype(np.float32))
    rec = ts.TreeRecords(tree, cuts, None, p)
    fr = lg.new_frontier(leaves, 100, f, nbt, "cpu")
    fr.store.copy_(torch.arange(fr.store.numel(), dtype=torch.float32)
                   .reshape(fr.store.shape))
    tab = {"slot": np.full(n_ent, -1), "active": np.zeros(n_ent, bool),
           "gain": np.full(n_ent, -np.inf, np.float32),
           "feat": np.zeros(n_ent, np.int32), "bin": np.zeros(n_ent, np.int32),
           "dl": np.zeros(n_ent, bool)}
    ref = {k: getattr(tg.empty_tree(heap, "cpu"), k).numpy().copy()
           for k in ("feature", "split_bin", "default_left", "is_leaf",
                     "value", "gain", "cover")}

    def search(n):
        gain = rng.choice([1.0, 2.0, 2.0, 3.0, -np.inf], n).astype(np.float32)
        gh = np.stack([rng.standard_normal(n), rng.uniform(1, 5, n)],
                      1).astype(np.float32)
        sp = ts.LevelSplits(
            torch.from_numpy(gain), torch.from_numpy(
                rng.integers(0, f, n).astype(np.int32)),
            torch.from_numpy(rng.integers(0, nbt - 2, n).astype(np.int32)),
            torch.from_numpy(rng.random(n) < 0.5),
            torch.from_numpy(np.isfinite(gain) & (rng.random(n) < 0.9)),
            torch.from_numpy(gh))
        value = (p.learning_rate * ts.leaf_weight(sp.node_gh[:, 0],
                                                  sp.node_gh[:, 1], p))
        return sp, {"gain": gain, "feat": sp.feature.numpy(),
                    "bin": sp.split_bin.numpy(),
                    "dl": sp.default_left.numpy(),
                    "valid": sp.valid.numpy(), "value": value.numpy(),
                    "cover": gh[:, 1]}

    sp, root = search(1)
    lg.frontier_step_plain(fr, rec, sp, None, 0, True, False)
    tab["slot"][0], tab["active"][0] = 0, True
    tab["gain"][0] = root["gain"][0] if root["valid"][0] else -np.inf
    tab["feat"][0], tab["bin"][0] = root["feat"][0], root["bin"][0]
    tab["dl"][0] = root["dl"][0]
    ref["is_leaf"][0], ref["value"][0] = True, root["value"][0]
    ref["cover"][0] = root["cover"][0]
    exhausted = False
    for t in range(leaves - 1):
        # the plain step chose in its last call; the reference chooses now
        sp, kids = search(2)
        do_split, i, slot = _reference_scan_step(tab, ref, kids, t, heap,
                                                 None)
        assert int(fr.last[0]) == int(do_split)
        if do_split:
            assert int(fr.last[1]) == slot
            assert int(fr.state[1]) == th.SPLIT
            assert torch.equal(fr.parent, fr.store[i:i + 1])
        exhausted |= not do_split
        # K3's children segments of the split leaf (any valid split)
        s, e = int(fr.seg[1]), int(fr.seg[2])
        mid = (s + e) // 2
        new_seg = torch.tensor([0, s, s, mid, e, e, 100], dtype=torch.int32)
        select = t + 2 < leaves
        lg.frontier_step_plain(fr, rec, sp, new_seg, t + 1, select,
                               not select)
        # the plain step has also retired its next choice already
        active = tab["active"].copy()
        scores = np.where(active, tab["gain"], -np.inf)
        nxt = int(np.argmax(scores))
        if select and np.isfinite(scores[nxt]):
            active[nxt] = False
        np.testing.assert_array_equal(fr.slot.numpy(), tab["slot"])
        np.testing.assert_array_equal(fr.active.numpy(), active)
        np.testing.assert_array_equal(fr.gain.numpy(), tab["gain"])
        np.testing.assert_array_equal(fr.feat.numpy(), tab["feat"])
        np.testing.assert_array_equal(fr.bin.numpy(), tab["bin"])
        np.testing.assert_array_equal(fr.dl.numpy(), tab["dl"])
    assert exhausted  # the heap's depth ran the frontier dry
    for k, v in ref.items():
        np.testing.assert_array_equal(getattr(tree, k).numpy(), v,
                                      err_msg=k)
    # the leaves in row order tile [0, 100)
    m = int((fr.leaf_state == th.LEAF).sum())
    assert m == int(fr.active.sum())
    segs = fr.leaf_seg[:m + 1].clone()
    segs[m] = 100
    assert bool((segs[1:] >= segs[:-1]).all())


# --------------------------------------------------------------------------
# the oracle's histogram
# --------------------------------------------------------------------------


def test_plain_histogram_vs_onehot():
    """The port's plain K1 (scatter order, f32) and the reference's
    lossguide histogram (``hist_onehot``) on the same rows: regular bins
    within 1e-5 of the largest bucket; the missing bucket, which the
    reference forms as the node total less the regular bins, within 1e-4
    of the node's total weight. (Measured: 3e-6 and 1.3e-5.)"""
    rng = np.random.default_rng(0)
    n, f, nbt = 3000, 6, 33
    bins = rng.integers(0, nbt, (n, f)).astype(np.uint8)
    gh = np.stack([rng.standard_normal(n), rng.uniform(0, 0.25, n)],
                  1).astype(np.float32)
    pos = (rng.random(n) < 0.4).astype(np.int32)
    ref = np.asarray(jax.jit(
        lambda b, g, q: jh.hist_onehot(b, g, q, 2, nbt))(bins, gh, pos))
    order = np.argsort(pos, kind="stable").astype(np.int32)
    seg = np.array([0, (pos == 0).sum(), n], np.int32)
    got, _ = th.build_histogram_plain(
        torch.from_numpy(bins), torch.from_numpy(gh),
        torch.from_numpy(order), torch.from_numpy(seg), 2, nbt)
    got = got.numpy()
    scale = np.abs(ref).max()
    assert np.abs(got[:, :, :-1] - ref[:, :, :-1]).max() <= 1e-5 * scale
    total = np.abs(gh).sum(0).max()
    assert np.abs(got[:, :, -1] - ref[:, :, -1]).max() <= 1e-4 * total


# --------------------------------------------------------------------------
# train() against the JAX package
# --------------------------------------------------------------------------


def _chain(n=600, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, size=(n, 4)).astype(np.float32)
    y = (10.0 ** np.floor(x[:, 0] * 6) + 0.01 * rng.randn(n)).astype(
        np.float32)
    return x, y, None


def _full(n=500, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 5).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] * x[:, 2] + 0.1 * rng.randn(n)).astype(
        np.float32)
    return x, y, None


def _xor(n=600, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6).astype(np.float32)
    y = ((x[:, 0] > 0) ^ (x[:, 1] > 0)).astype(np.float32)
    return x, y, None


def _cat3(n=500, seed=8):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 3, n).astype(np.float32)
    x = np.zeros((n, 3), np.float32)
    x[:, 0] = y + 0.3 * rng.randn(n)
    x[:, 1] = rng.randint(0, 4, n)
    x[y == 2, 1] = 3
    x[rng.rand(n) < 0.2, 0] = np.nan
    return x, y, ["q", "c", "q"]


#: name -> (params, data, held-out rows for early stopping or 0)
CASES = {
    "full_budget": ({"objective": "reg:squarederror", "max_leaves": 8,
                     "max_depth": 3, "eta": 0.4}, _full, 0),
    "chain": ({"objective": "reg:squarederror", "max_leaves": 5,
               "max_depth": 6, "eta": 0.5}, _chain, 0),
    "cat_softprob": ({"objective": "multi:softprob", "num_class": 3,
                      "max_leaves": 8, "max_depth": 5, "eta": 0.4},
                     _cat3, 0),
    "sampled": ({"objective": "binary:logistic", "max_leaves": 12,
                 "max_depth": 4, "subsample": 0.8,
                 "colsample_bytree": 0.8}, _xor, 0),
    # binary:logistic (the reference's xor, :100) with a held-out set and
    # early stopping
    "binary_early_stop": ({"objective": "binary:logistic", "max_leaves": 16,
                           "max_depth": 5, "eta": 0.4,
                           "eval_metric": ["logloss"]}, _xor, 150),
}


def _params(name):
    return {"grow_policy": "lossguide", "seed": 0, "max_bin": 32,
            **CASES[name][0]}


def _split(name):
    x, y, ft = CASES[name][1]()
    n_valid = CASES[name][2]
    hi = x.shape[0] - n_valid
    return x, y, ft, hi


def _train(pkg, name, actors=1, **kw):
    x, y, ft, hi = _split(name)
    dtrain = pkg.RayDMatrix(x[:hi], y[:hi], feature_types=ft)
    evals = [(dtrain, "train")]
    if hi < x.shape[0]:
        evals.append((pkg.RayDMatrix(x[hi:], y[hi:], feature_types=ft),
                      "valid"))
    ev = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        bst = pkg.train(_params(name), dtrain, ROUNDS + 3 * (hi < x.shape[0]),
                        evals=evals, evals_result=ev,
                        early_stopping_rounds=2 if hi < x.shape[0] else None,
                        ray_params=pkg.RayParams(num_actors=actors), **kw)
    return bst, ev


@functools.lru_cache(maxsize=None)
def _jax(name, actors):
    return _train(jx, name, actors)


def _port_world(world, name):
    x, y, ft, hi = _split(name)
    held = []
    names = ["train"]
    if hi < x.shape[0]:
        held = [dict(D.share({"x": x[hi:], "label": y[hi:]}),
                     sharding="INTERLEAVED")]
        names.append("valid")
    n_rounds = ROUNDS + 3 * (hi < x.shape[0])
    out = world.run(D._train_rank, D.share({"x": x[:hi], "label": y[:hi]}),
                    _params(name), n_rounds,
                    {"device": "cpu", "eval_names": names,
                     "eval_data": [None, *held], "num_actors": 2,
                     "feature_types": ft,
                     "early_stopping_rounds": 2 if held else None})
    assert out[0]["model"] == out[1]["model"]
    return (tx.RayXGBoostBooster.load_raw(out[0]["model"]),
            out[0]["evals_result"])


_STAT = re.compile(r"(gain|cover|leaf)=([-0-9.e+]+)")


def _lg_close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    bound = LG_RTOL * np.maximum(np.abs(ref), 1.0)
    assert (np.abs(got - ref) <= bound).all(), (
        what, np.abs(got - ref).max())


def _dry_nodes(bst, x):
    """Per tree, the split nodes no row of ``x`` with a missing value of
    the node's feature reaches (walked with ``bst``'s own routing)."""
    fo = bst.forest
    cat = np.zeros(x.shape[1], bool)
    cat[list(bst.cat_features)] = True
    rows = np.arange(x.shape[0])
    out = []
    for t in range(fo.feature.shape[0]):
        feat, leaf = np.asarray(fo.feature[t]), np.asarray(fo.is_leaf[t])
        wet = np.zeros(feat.shape[0], bool)
        pos = np.zeros(x.shape[0], np.int64)
        while True:
            live = ~leaf[pos] & (feat[pos] >= 0)
            if not live.any():
                break
            f = np.maximum(feat[pos], 0)
            v = x[rows, f]
            miss = np.isnan(v)
            wet[pos[live & miss]] = True
            thr = np.asarray(fo.threshold[t])[pos]
            sb = np.asarray(fo.split_bin[t])[pos]
            right = np.where(miss, ~np.asarray(fo.default_left[t])[pos],
                             np.where(cat[f], v != sb, v >= thr))
            pos = np.where(live, 2 * pos + 1 + right, pos)
        out.append({i for i in np.nonzero((feat >= 0) & ~leaf & ~wet)[0]})
    return out


def _structure(dump, dry):
    """A dump without its statistics; where no missing value reaches a
    node (``dry``), without its missing direction: the reference's empty
    missing bucket there is its subtraction's rounding residue
    (``_append_missing``), whose sign sets the direction, where the
    port's is exactly 0 (the tie rule: left). No row takes it."""
    dump = _STAT.sub(r"\1=", dump)
    return re.sub(r"(?m)^(\t*)(\d+)(:\[.*),missing=\d+",
                  lambda m: (m.group(0) if int(m.group(2)) not in dry else
                             f"{m.group(1)}{m.group(2)}{m.group(3)},missing=*"),
                  dump)


def _check(name, jb, jev, tb, tev):
    """Structure exact (but for ``_structure``'s directions), statistics
    within ``LG_RTOL``."""
    jd, td = jb.get_dump(with_stats=True), tb.get_dump(with_stats=True)
    x, _, _, hi = _split(name)
    dry = _dry_nodes(tb, x[:hi])
    assert [_structure(d, s) for d, s in zip(td, dry)] == [
        _structure(d, s) for d, s in zip(jd, dry)]
    _lg_close([float(v) for d in td for _, v in _STAT.findall(d)],
              [float(v) for d in jd for _, v in _STAT.findall(d)], "stats")
    assert tev.keys() == jev.keys()
    for s in jev:
        for m in jev[s]:
            _lg_close(tev[s][m], jev[s][m], f"{s}-{m}")
    assert tb.best_iteration == jb.best_iteration
    x = _split(name)[0]
    _lg_close(tb.predict(x, device="cpu"), np.asarray(jb.predict(x)),
              "predict")


@pytest.fixture(scope="module")
def world2():
    with World(2, "cpu") as w:
        yield w


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_matches_jax(name):
    jb, jev = _jax(name, 1)
    tb, tev = _train(tx, name, device="cpu")
    _check(name, jb, jev, tb, tev)


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_matches_jax_two_ranks(world2, name):
    jb, jev = _jax(name, 2)
    tb, tev = _port_world(world2, name)
    _check(name, jb, jev, tb, tev)


def _leaf_stats(bst):
    leaf = np.asarray(bst.forest.is_leaf)
    out = []
    for t in range(leaf.shape[0]):
        slots = np.nonzero(leaf[t])[0]
        depths = np.floor(np.log2(slots + 1)).astype(int)
        out.append((len(slots), int(depths.max()) if len(slots) else 0))
    return out


def test_budget_and_full_budget_depthwise():
    """Chains fill their budget and grow deeper than a balanced tree of
    that many leaves; at ``max_leaves = 2^max_depth`` the lossguide model
    has the depthwise model's structure and margins within 1e-4."""
    chain = _train(tx, "chain", device="cpu")[0]
    stats = _leaf_stats(chain)
    assert all(c == 5 for c, _ in stats) and any(d > 3 for _, d in stats)
    x, y, _ = _full()
    kw = {"objective": "reg:squarederror", "max_depth": 3, "eta": 0.4,
          "max_bin": 32}
    a = tx.train(dict(kw, grow_policy="lossguide", max_leaves=8),
                 tx.RayDMatrix(x, y), 5, device="cpu",
                 ray_params=tx.RayParams(num_actors=1))
    b = tx.train(kw, tx.RayDMatrix(x, y), 5, device="cpu",
                 ray_params=tx.RayParams(num_actors=1))
    for field in ("feature", "split_bin", "is_leaf", "default_left"):
        np.testing.assert_array_equal(getattr(a.forest, field),
                                      getattr(b.forest, field))
    np.testing.assert_allclose(a.predict(x, device="cpu"),
                               b.predict(x, device="cpu"), atol=1e-4)


def test_validation_matches_jax():
    """The reference's refusals and messages (``tests/test_lossguide.py:
    114``) and the leaf budget's cap."""
    x = np.random.RandomState(0).randn(50, 3).astype(np.float32)
    dm = tx.RayDMatrix(x, x[:, 0].copy())
    base = {"objective": "reg:squarederror"}
    for params, err, match in (
            ({"grow_policy": "bogus"}, ValueError, "grow_policy"),
            ({"max_leaves": 8}, NotImplementedError, "max_leaves"),
            ({"grow_policy": "lossguide", "colsample_bylevel": 0.5},
             NotImplementedError, "colsample_bylevel"),
            ({"grow_policy": "lossguide", "colsample_bynode": 0.5},
             NotImplementedError, "colsample_bynode"),
            ({"grow_policy": "lossguide",
              "monotone_constraints": "(1,0,0)"}, NotImplementedError,
             "monotone"),
            ({"grow_policy": "lossguide",
              "interaction_constraints": "[[0, 1]]"}, NotImplementedError,
             "interaction"),
            ({"grow_policy": "lossguide", "hist_impl": "partition"},
             NotImplementedError, "hist_impl")):
        with pytest.raises(err, match=match):
            tx.train({**base, **params}, dm, 1, device="cpu",
                     ray_params=tx.RayParams(num_actors=1))
    from xgboost_ray_tpu_torch.params import leaf_budget, parse_params

    assert leaf_budget(parse_params({"grow_policy": "lossguide",
                                     "max_depth": 3})) == 8
    assert leaf_budget(parse_params({"grow_policy": "lossguide",
                                     "max_depth": 3,
                                     "max_leaves": 100})) == 8
    assert leaf_budget(parse_params({"max_depth": 3})) == 0
