"""Prediction of the port against the JAX package, on the CPU.

The port's plain walk (``ops/predict.py``, the CPU side of kernel B8)
against the reference's ``predict_margin`` / ``predict_leaf_index`` and
their node-array twins on random forests (inputs made with numpy from a
seed: early leaves, level-``max_depth`` nodes that are not marked leaves,
NaN, exact threshold ties, a categorical feature with half-integer codes),
then the booster, ``predict()`` over sharded matrices, and model round
trips between the packages.

Tolerances, and why:
- leaf indices: bitwise, in both layouts;
- margins: both packages take float32 sums of the same terms (leaf value x
  tree weight), so they agree within the summation error bound
  ``T * eps * sum |term| / num_parallel_tree`` per row and class, plus one
  rounding of the base add. Where the reference's compiled CPU reduce sums
  in the port's order they are bitwise, and the tests pin where that is:
  over 32 trees XLA sums a window-32 tree (``ops/split.tree_sum``), which
  the port reproduces, for every option; up to 32 trees it sums in order
  (the port's window tree then is in order) unless tree weights multiply
  the leaves (XLA fuses the product into the sum with FMAs) or the count
  is small enough to be vectorised (4 gathered leaves as
  ``(l0 + l2) + (l1 + l3)``). K = 3 goes through a one-hot matrix product
  in the reference, whose order the CPU GEMM picks: within the bound;
- values: the sigmoid of margins within the bound, so within a quarter of
  it plus one rounding; bitwise where the margins are (the port's
  ``sigmoid`` is bitwise the reference's CPU ``jax.nn.sigmoid``).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.datasets import load_breast_cancer

import jax
import jax.numpy as jnp

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu.ops import node_array as jna
from xgboost_ray_tpu.ops import predict as jpred
from xgboost_ray_tpu.ops.grow import Tree as JTree
from xgboost_ray_tpu_torch.convert import booster_from_jax_state
from xgboost_ray_tpu_torch.ops import node_array as tna
from xgboost_ray_tpu_torch.ops import predict as tp
from xgboost_ray_tpu_torch.ops.grow import Tree
from xgboost_ray_tpu_torch.ops.split import tree_sum

EPS32 = float(np.finfo(np.float32).eps)
THRESHOLDS = np.array([-1.0, -0.5, 0.0, 0.5, 1.0], np.float32)
CAT = 2  # the categorical column of the random inputs


def random_forest(rng, n_trees, depth, n_features, cat=(CAT,), p_leaf=0.2,
                  p_open_bottom=0.3):
    """A padded-heap forest: internal nodes split on a random feature
    (categorical ones on a code), leaves above the last level with
    probability ``p_leaf``, and a share of last-level nodes left unmarked
    (the walk must read their value anyway). Unused slots hold feature -1."""
    heap = (2 << depth) - 1
    feature = np.full((n_trees, heap), -1, np.int32)
    split_bin = np.zeros((n_trees, heap), np.int32)
    threshold = np.zeros((n_trees, heap), np.float32)
    default_left = np.zeros((n_trees, heap), bool)
    is_leaf = np.zeros((n_trees, heap), bool)
    value = np.zeros((n_trees, heap), np.float32)
    for t in range(n_trees):
        live = np.zeros(heap, bool)
        live[0] = True
        for i in range(heap):
            if not live[i]:
                continue
            level = int(np.log2(i + 1))
            value[t, i] = rng.standard_normal() * 0.3
            if level == depth:
                is_leaf[t, i] = rng.random() >= p_open_bottom
            elif i > 0 and rng.random() < p_leaf:
                is_leaf[t, i] = True
            else:
                f = int(rng.integers(n_features))
                feature[t, i] = f
                split_bin[t, i] = int(rng.integers(5)) if f in cat else int(
                    rng.integers(255))
                threshold[t, i] = rng.choice(THRESHOLDS)
                default_left[t, i] = rng.random() < 0.5
                live[2 * i + 1] = live[2 * i + 2] = True
    z = np.zeros((n_trees, heap), np.float32)
    return Tree(feature, split_bin, threshold, default_left, is_leaf, value,
                z, z, z)


def random_rows(rng, n, n_features):
    x = rng.standard_normal((n, n_features)).astype(np.float32)
    ties = rng.random((n, n_features)) < 0.2
    x[ties] = rng.choice(THRESHOLDS, int(ties.sum()))
    x[rng.random((n, n_features)) < 0.1] = np.nan
    # categorical codes, with halves that round to even (2.5 -> 2, 3.5 -> 4)
    x[:, CAT] = rng.choice(np.array([0, 1, 2, 2.5, 3, 3.5, 4, np.nan],
                                    np.float32), n)
    return x


def _jtree(fo):
    return JTree(*[jnp.asarray(f) for f in fo])


def _pf(fo, depth, layout="heap", n_features=5):
    """The packed forest of the random inputs (column ``CAT``
    categorical)."""
    return tp.device_forest(fo, depth, layout, num_features=n_features,
                            cat_features=(CAT,))


def _inputs(depth, n_trees, seed=0, n=301, f=5):
    rng = np.random.default_rng(seed + 100 * depth + n_trees)
    return random_forest(rng, n_trees, depth, f), random_rows(rng, n, f), rng


CASES = [(d, t) for d in (1, 3, 6) for t in (1, 7, 40)]


@pytest.mark.parametrize("depth,n_trees", CASES)
def test_leaf_index_bitwise_both_layouts(depth, n_trees):
    fo, x, _ = _inputs(depth, n_trees)
    ref = np.asarray(jpred.predict_leaf_index(
        _jtree(fo), jnp.asarray(x), depth, cat_features=(CAT,)))
    na = jna.NodeForest(*[jnp.asarray(f) for f in
                          jna.forest_to_node_array(fo, depth)])
    ref_na = np.asarray(jna.predict_leaf_index_na(
        na, jnp.asarray(x), depth, cat_features=(CAT,)))
    assert np.array_equal(ref, ref_na)
    for layout in tp.LAYOUTS:
        got = tp.predict_leaf_index(_pf(fo, depth, layout),
                                    torch.from_numpy(x))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), ref), layout


def _abs_terms(fo, depth, x, tw=None, n_outputs=1, npt=1):
    """Per row and class, the sum of |leaf value x tree weight| over the
    trees: the scale of the summation error bound."""
    leaf, _ = tp.walk_plain(_pf(fo, depth, n_features=x.shape[1]),
                            torch.from_numpy(x))
    terms = np.abs(leaf.numpy())
    if tw is not None:
        terms = terms * tw[:, None]
    cls = (np.arange(terms.shape[0]) // npt) % n_outputs
    return np.stack([terms[cls == k].sum(0) for k in range(n_outputs)], 1)


def _within_sum_bound(got, ref, abs_terms, n_trees, npt=1):
    """Two float32 sums of the same n_trees terms, each within
    n_trees * eps / 2 * sum |term| of the exact sum; / npt; then the base
    add rounds once more."""
    bound = n_trees * EPS32 * abs_terms / npt + 2 * EPS32 * np.abs(ref)
    return bool((np.abs(got - ref) <= bound).all())


OPTIONS = ("plain", "tree_weights", "ntree_limit", "npt2", "tree_weights+npt2")


@pytest.mark.parametrize("depth,n_trees", CASES)
def test_margin_one_output_matches_jax(depth, n_trees):
    fo, x, rng = _inputs(depth, n_trees)
    n = x.shape[0]
    base = (rng.standard_normal((n, 1)) * 0.2).astype(np.float32)
    tw = rng.uniform(0.2, 1.5, n_trees).astype(np.float32)
    pfs = {layout: _pf(fo, depth, layout) for layout in tp.LAYOUTS}
    bitwise = set()
    for name in OPTIONS:
        opts = {}
        if "tree_weights" in name:
            opts["tree_weights"] = tw
        if name == "ntree_limit":
            opts["ntree_limit"] = max(1, n_trees // 2)
        if "npt2" in name:
            opts["num_parallel_tree"] = 2
        jopts = dict(opts)
        topts = dict(opts)
        if "tree_weights" in opts:
            jopts["tree_weights"] = jnp.asarray(tw)
            topts["tree_weights"] = torch.from_numpy(tw)
        ref = np.asarray(jpred.predict_margin(
            _jtree(fo), jnp.asarray(x), jnp.asarray(base), depth, 1,
            cat_features=(CAT,), **jopts))
        terms = _abs_terms(fo, depth, x, opts.get("tree_weights"))
        got = {layout: tp.predict_margin(pf, torch.from_numpy(x),
                                         torch.from_numpy(base),
                                         **topts).numpy()
               for layout, pf in pfs.items()}
        assert np.array_equal(got["heap"], got["node_array"]), name
        assert _within_sum_bound(got["heap"], ref, terms, n_trees,
                                 opts.get("num_parallel_tree", 1)), name
        if np.array_equal(got["heap"], ref):
            bitwise.add(name)
    # where the reference's program sums as the window tree, bitwise: over
    # 32 trees always; up to 32 trees when no weight multiplies the leaves
    # (weighted, XLA fuses leaf * weight into the sum with FMAs)
    expect = set(OPTIONS) if n_trees > 32 else {
        "plain", "ntree_limit", "npt2"}
    assert expect <= bitwise, (expect - bitwise)


def test_reference_sum_orders_below_33_trees():
    """What the reference's compiled reduce does with few trees (pinned
    so that an XLA upgrade that changes it shows here): weighted leaves are
    summed in order with fused multiply-adds; four unweighted leaves
    gathered by the walk are summed as (l0 + l2) + (l1 + l3)."""
    rng = np.random.default_rng(21)
    for n_trees in (3, 7, 20):
        a = (rng.standard_normal((n_trees, 512)) * 0.3).astype(np.float32)
        w = rng.uniform(0.2, 1.5, n_trees).astype(np.float32)
        ref = np.asarray(jax.jit(lambda a, w: (a * w[:, None]).sum(0))(
            jnp.asarray(a), jnp.asarray(w)))
        acc = np.zeros(512, np.float32)
        for t in range(n_trees):  # exact product, one rounding: an FMA
            acc = (acc.astype(np.float64)
                   + a[t].astype(np.float64) * np.float64(w[t])).astype(
                       np.float32)
        assert np.array_equal(acc, ref), n_trees
    fo, x, _ = _inputs(3, 4, seed=5)
    ref = np.asarray(jpred.predict_margin(
        _jtree(fo), jnp.asarray(x), jnp.zeros((x.shape[0], 1)), 3, 1,
        cat_features=(CAT,)))[:, 0]
    leaf = tp.walk_plain(_pf(fo, 3), torch.from_numpy(x))[0].numpy()
    assert np.array_equal((leaf[0] + leaf[2]) + (leaf[1] + leaf[3]), ref)


@pytest.mark.parametrize("n_trees", [7, 40, 120])
def test_margin_three_outputs_within_sum_bound(n_trees):
    depth = 4
    fo, x, rng = _inputs(depth, n_trees, seed=7)
    n = x.shape[0]
    base = (rng.standard_normal((n, 3)) * 0.2).astype(np.float32)
    ref = np.asarray(jpred.predict_margin(
        _jtree(fo), jnp.asarray(x), jnp.asarray(base), depth, 3,
        num_parallel_tree=2, cat_features=(CAT,)))
    leaf, _ = tp.walk_plain(_pf(fo, depth), torch.from_numpy(x))
    cls = (np.arange(n_trees) // 2) % 3
    abs_sum = np.stack([np.abs(leaf.numpy()[cls == k]).sum(0)
                        for k in range(3)], 1)
    # each order's error is below T * eps / 2 * sum |term|; / npt, then
    # the base add rounds once more
    bound = n_trees * EPS32 * abs_sum / 2 + 2 * EPS32 * np.abs(ref)
    for layout in tp.LAYOUTS:
        got = tp.predict_margin(_pf(fo, depth, layout),
                                torch.from_numpy(x), torch.from_numpy(base),
                                num_outputs=3, num_parallel_tree=2).numpy()
        assert (np.abs(got - ref) <= bound).all(), layout


def test_tree_sum_is_the_reference_reduce():
    """The finding the margins rest on: XLA's CPU sum over the tree axis is
    not in order but the window-32 tree of ``ops/split.tree_sum``; in order
    and window tree agree up to 32 trees."""
    rng = np.random.default_rng(3)
    total = jax.jit(lambda a: a.sum(axis=0))
    for n_trees in (7, 33, 40, 500, 1100):
        a = (rng.standard_normal((n_trees, 2000)) * 0.3).astype(np.float32)
        ref = np.asarray(total(jnp.asarray(a)))
        assert np.array_equal(tree_sum(torch.from_numpy(a.T.copy())).numpy(),
                              ref), n_trees
        acc = np.zeros(2000, np.float32)
        for t in range(n_trees):
            acc = acc + a[t]
        assert np.array_equal(acc, ref) == (n_trees <= 32), n_trees
    fronts = tp.tree_windows(1100)
    assert fronts[:3] == (10, 1120, 2) and fronts[3][:3] == [1100, 35, 2]


def test_forest_to_node_array_bitwise_and_walks_agree():
    fo, x, _ = _inputs(6, 40, seed=11)
    ref = jna.forest_to_node_array(fo, 6)
    got = tna.forest_to_node_array(fo, 6)
    for a, b in zip(got, ref):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="heap width"):
        tna.forest_to_node_array(fo, 5)
    xt = torch.from_numpy(x)
    heap = tp.walk_plain(_pf(fo, 6, "heap"), xt)
    level = tp.walk_plain(_pf(fo, 6, "node_array"), xt)
    for a, b in zip(heap, level):
        assert np.array_equal(a.numpy().view(np.int32), b.numpy().view(np.int32))


def _owners(fo, depth):
    """Per tree and heap node: the first leaf at or above it, or -1."""
    t, heap = fo.feature.shape
    owner = np.full((t, heap), -1)
    for i in range(heap):
        up = owner[:, (i - 1) // 2] if i else np.full(t, -1)
        here = fo.is_leaf[:, i] & (i < (1 << depth) - 1)
        owner[:, i] = np.where(up >= 0, up, np.where(here, i, -1))
    return owner


@pytest.mark.parametrize("depth", [3, 5])
def test_packed_record_round_trips_both_layouts(depth):
    """Every field the walk reads comes back bitwise from the packed
    records, in both layouts: splits (numeric and categorical, either
    default_left), leaves above max_depth, last-level nodes (marked or not)
    and the unused slots under leaves (copies of their leaf)."""
    rng = np.random.default_rng(40 + depth)
    fo = random_forest(rng, 9, depth, 5)
    fo.feature[0, 0] = 7  # out of range: clamped as the reference gathers
    heap = (2 << depth) - 1
    owner = _owners(fo, depth)
    assert (owner >= 0).any() and (owner < 0).any()
    recs = {}
    for layout in tp.LAYOUTS:
        v, w = (a.numpy() for a in tp.decode_nodes(_pf(fo, depth, layout)))
        if layout == "node_array":  # back to heap order
            pos = np.concatenate([
                (9 * ((1 << k) - 1) + (np.arange(9)[:, None] << k)
                 + np.arange(1 << k)[None, :]) for k in range(depth + 1)],
                axis=1)
            v, w = v[pos], w[pos]
        else:
            v, w = v.reshape(9, heap), w.reshape(9, heap)
        recs[layout] = (v.view(np.int32), w)
        last = (1 << depth) - 1
        fc = np.clip(fo.feature, 0, 4)
        split = (owner < 0) & (np.arange(heap) < last)
        code = fo.split_bin.astype(np.float32)
        want = np.where(fc == CAT, code, fo.threshold)
        assert np.array_equal(v[split].view(np.int32),
                              want[split].view(np.int32))
        assert np.array_equal(w[split] & tp.FEATURE_MASK, fc[split])
        assert np.array_equal((w[split] & tp.DEFAULT_LEFT) != 0,
                              fo.default_left[split])
        assert np.array_equal((w[split] & tp.CATEGORICAL) != 0,
                              fc[split] == CAT)
        assert not (w[split] & tp.LEAF).any()
        under = (owner >= 0) & (np.arange(heap) < last)
        src = np.where(owner >= 0, owner, np.arange(heap))
        ends = np.take_along_axis(fo.value, src, 1)
        assert np.array_equal(w[under], np.full(under.sum(), tp.LEAF))
        assert np.array_equal(v[under].view(np.int32),
                              ends[under].view(np.int32))
        assert np.array_equal(v[:, last:].view(np.int32),
                              ends[:, last:].view(np.int32))
        assert np.array_equal(w[:, last:], src[:, last:])
    assert all(np.array_equal(a, b) for a, b in zip(*recs.values()))


def test_nan_follows_default_left_either_way():
    fo = random_forest(np.random.default_rng(2), 2, 1, 5, cat=(), p_leaf=0.0,
                       p_open_bottom=0.0)
    fo.feature[:, 0] = [0, 3]
    fo.default_left[:, 0] = [True, False]
    x = np.full((3, 5), np.nan, np.float32)
    x[1, 3] = x[2, 0] = 10.0
    ref = np.asarray(jpred.predict_leaf_index(_jtree(fo), jnp.asarray(x), 1))
    for layout in tp.LAYOUTS:
        got = tp.predict_leaf_index(_pf(fo, 1, layout), torch.from_numpy(x))
        assert np.array_equal(got.numpy(), ref), layout
    assert ref[0].tolist() == [1, 2]


def _same(a, b):
    """Bitwise, a NaN matching any NaN (payloads differ by machine)."""
    a, b = np.asarray(a), np.asarray(b)
    nan = np.isnan(a)
    return bool(np.array_equal(nan, np.isnan(b))
                and np.array_equal(a[~nan].view(np.int32),
                                   b[~nan].view(np.int32)))


def test_plain_transform_is_the_sigmoid_bitwise():
    """The value mode's plain version: the objective's transform of the
    margins, bitwise ops/objectives.sigmoid and jax.nn.sigmoid, at NaN,
    +-inf, +-88.4, results that flush to zero and random margins; ranking's
    values are the margins, survival:cox's exp(m) bitwise jnp.exp (a
    subnormal flushed)."""
    from xgboost_ray_tpu_torch.ops.objectives import sigmoid, value_transform

    rng = np.random.default_rng(9)
    special = np.array([np.nan, np.inf, -np.inf, 88.4, -88.4, 88.38, -88.38,
                        -87.4, -87.0, -86.9, -103.0, 0.0, -0.0, 1e-30, 17.0],
                       np.float32)
    m = np.concatenate([special, (rng.standard_normal(3000) * 12).astype(
        np.float32)])
    fo = random_forest(rng, 3, 2, 5, cat=())
    fo.value[:] = 0.0  # the margins are the base margins
    x = random_rows(rng, m.size, 5)
    base = torch.from_numpy(m[:, None].copy())
    for layout in tp.LAYOUTS:
        pf = _pf(fo, 2, layout)
        margin = tp.predict_margin(pf, torch.from_numpy(x), base)
        assert _same(margin.numpy()[:, 0], np.where(m == 0, 0.0, m))
        value = tp.predict_margin(pf, torch.from_numpy(x), base,
                                  transform="binary:logistic")
        assert value.shape == (m.size, 1)
        got = value.numpy()[:, 0]
        assert _same(got, sigmoid(margin[:, 0]).numpy())
        assert _same(got, np.asarray(jax.jit(jax.nn.sigmoid)(
            jnp.asarray(margin.numpy()[:, 0]))))
        ident = tp.predict_margin(pf, torch.from_numpy(x), base,
                                  transform="reg:squarederror")
        assert _same(ident.numpy(), margin.numpy())
    flushed = got[np.isin(m, [-87.4, -103.0])]
    assert (flushed == 0).all() and not np.signbit(flushed).any()
    # ranking predicts its margins, survival:cox the hazard ratio exp(m)
    rank = tp.predict_margin(pf, torch.from_numpy(x), base,
                             transform="rank:pairwise")
    assert _same(rank.numpy(), margin.numpy())
    cox = tp.predict_margin(pf, torch.from_numpy(x), base,
                            transform="survival:cox")
    want = value_transform(margin[:, 0], "exp").numpy()
    assert _same(cox.numpy()[:, 0], want)
    ref = np.asarray(jax.jit(jnp.exp)(jnp.asarray(margin.numpy()[:, 0])))
    ref = np.where(np.abs(ref) < np.finfo(np.float32).tiny, 0.0 * ref, ref)
    assert _same(want, ref.astype(np.float32))
    with pytest.raises(NotImplementedError, match="transforms one output"):
        tp.predict_margin(pf, torch.from_numpy(x), num_outputs=3,
                          transform="binary:logistic")


def test_feature_index_limit_and_width_checks():
    fo = random_forest(np.random.default_rng(3), 2, 2, 5)
    with pytest.raises(ValueError, match="24 bits"):
        tp.device_forest(fo, 2, num_features=1 << 24)
    tp.device_forest(fo, 2, num_features=(1 << 24) - 1)
    pf = _pf(fo, 2)
    with pytest.raises(ValueError, match="packed for 5 features"):
        tp.predict_margin(pf, torch.zeros(4, 6))
    with pytest.raises(ValueError, match="packed for 5 features"):
        tp.predict_leaf_index(pf, torch.zeros(4, 4))


def test_launch_plan_picks_each_mapping(monkeypatch):
    """The wrapper's choice of mapping, tile and shared memory (on a
    132-SM card): windows with 1-8 rows a CTA for small batches, rows
    (512 a CTA) from 132 CTAs, tiles that leave three CTAs an SM where they
    can, and device-memory reads where not even two trees fit."""
    monkeypatch.setattr(tp, "_sm_count", lambda index: 132)
    rng = np.random.default_rng(4)
    fo6 = _pf(random_forest(rng, 500, 6, 28, cat=()), 6, n_features=28)
    plan = lambda n: tp.launch_plan(n, 1, fo6, False, "cpu")
    assert [plan(n).rows_per_block for n in (1, 256, 1056, 2112, 4224)] == [
        1, 1, 2, 4, 8]
    assert {plan(n).mapping for n in (1, 256, 4224, 131 * 512)} == {"windows"}
    big = plan(131 * 512 + 1)
    assert big == tp.LaunchPlan("rows", 1, 8, True,
                                16 * 8 * 127 + 4 * 28 * 512)
    assert big.shared_bytes <= tp._SHARED_BUDGETS[0]  # three CTAs an SM
    assert plan(70001).mapping == "rows"
    leaf = tp.launch_plan(1 << 20, 1, fo6, True, "cpu")
    assert leaf == tp.LaunchPlan("rows", 1, 32, True, 16 * 32 * 127
                                 + 4 * 28 * 512 + 4 * 512 * 33)
    wide = _pf(random_forest(rng, 3, 2, 300, cat=()), 2, n_features=300)
    assert not tp.launch_plan(1 << 20, 1, wide, False, "cpu").staged
    deep = _pf(random_forest(rng, 2, 10, 5, cat=(), p_leaf=0.9), 10)
    assert tp.launch_plan(1 << 20, 1, deep, False, "cpu").trees_per_tile == 2


@pytest.mark.parametrize("n_trees,n,k,want", [
    (6_800, 4_224, 1, ("windows", 8)),
    (7_000, 4_224, 1, ("windows", 4)),  # 8 rows' sums do not fit: 4
    (10_000, 10_000, 1, ("windows", 4)),
    (30_000, 2_000, 1, ("windows", 1)),
    (54_600, 8, 1, ("windows", 1)),
    (54_700, 8, 1, ("rows", 1)),  # not even one row's sums fit
    (60_000, 1, 10, ("rows", 1)),  # 6,000 trees a class of ten
])
def test_launch_plan_fits_windows_sums_or_takes_rows(monkeypatch, n_trees, n,
                                                     k, want):
    """A large forest's windows mapping takes fewer rows a CTA until its
    per-window sums ([R][windows][34] words) fit a CTA's shared memory, and
    the rows mapping where not even one row's do; it never raises for the
    size of the forest, in either mode."""
    monkeypatch.setattr(tp, "_sm_count", lambda index: 132)
    fo = tp.PredictForest(None, n_trees, 6, "heap", 28, False)
    got = tp.launch_plan(n, k, fo, False, "cpu")
    assert (got.mapping, got.rows_per_block) == want
    assert got.shared_bytes <= tp._SHARED_MAX
    if got.mapping == "windows":
        assert got.shared_bytes == (4 * got.rows_per_block
                                    * -(-n_trees // 32) * 34)
    leaf = tp.launch_plan(n, 1, fo, True, "cpu")  # no sums in leaf mode
    assert leaf.shared_bytes <= tp._SHARED_MAX


# --------------------------------------------------------------------------
# booster, predict(), round trips
# --------------------------------------------------------------------------

README_PARAMS = {"objective": "binary:logistic",
                 "eval_metric": ["logloss", "error"]}


def _readme_data():
    data = load_breast_cancer()
    return data.data.astype(np.float32), data.target.astype(np.float32)


@pytest.fixture(scope="module")
def readme_models():
    x, y = _readme_data()
    with pytest.warns(UserWarning):
        jb = jx.train(README_PARAMS, jx.RayDMatrix(x, y), 10,
                      ray_params=jx.RayParams(num_actors=1))
        tb = tx.train(README_PARAMS, tx.RayDMatrix(x, y), 10, device="cpu",
                      ray_params=tx.RayParams(num_actors=1))
    conv = booster_from_jax_state(jb.forest._asdict(), jb.cuts, jb.base_score,
                                  dataclasses.asdict(jb.params))
    return jb, tb, conv, x


def assert_predictions_match(tb, data, got, ref, **kw):
    """Leaf indices bitwise; margins within the summation bound of the
    booster's trees, values within a quarter of it (sigmoid' <= 1/4) plus
    one rounding."""
    assert got.dtype == ref.dtype and got.shape == ref.shape, kw
    if kw.get("pred_leaf"):
        assert np.array_equal(got, ref), kw
        return
    b = tb._rounds(kw.get("iteration_range"))
    x = b._coerce_features(data)
    leaf = tp.walk_plain(b.device_forest("cpu"),
                         torch.from_numpy(x))[0].numpy()
    terms = np.abs(leaf if b.tree_weights is None
                   else leaf * b.tree_weights[:, None]).sum(0)
    bound = b.num_trees * EPS32 * terms + 2 * EPS32 * np.abs(ref)
    if not kw.get("output_margin"):
        bound = bound / 4 + EPS32
    assert (np.abs(got - ref) <= bound).all(), kw


def test_booster_predict_matches_jax(readme_models):
    jb, _, conv, x = readme_models
    bm = np.random.default_rng(0).standard_normal(len(x)).astype(np.float32)
    cases = [dict(), dict(output_margin=True), dict(pred_leaf=True),
             dict(iteration_range=(2, 7)),
             dict(iteration_range=(0, 4), output_margin=True),
             dict(pred_leaf=True, iteration_range=(3, 5)),
             dict(ntree_limit=6, output_margin=True),
             dict(base_margin=bm), dict(base_margin=bm, output_margin=True)]
    bitwise = []
    for kw in cases:
        ref = np.asarray(jb.predict(x, **kw))
        got = conv.predict(x, device="cpu", **kw)
        assert_predictions_match(conv, x, got, ref, **kw)
        bitwise.append(np.array_equal(got, ref))
    # ten unweighted trees are summed in order by both: all bitwise but
    # the four-tree sub-forest (the reference vectorises that sum)
    assert bitwise == [True] * 4 + [False] + [True] * 4


def test_port_trained_model_predicts_as_jax_trained(readme_models, tmp_path):
    jb, tb, _, x = readme_models
    for kw in (dict(), dict(output_margin=True), dict(pred_leaf=True)):
        assert np.array_equal(tb.predict(x, device="cpu", **kw),
                              np.asarray(jb.predict(x, **kw))), kw
    # a model saved by either package predicts the same in the other
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    jb.save_model(jpath)
    tb.save_model(tpath)
    from_jax = tx.RayXGBoostBooster.load_model(jpath)
    from_torch = jx.RayXGBoostBooster.load_model(tpath)
    for kw in (dict(), dict(output_margin=True), dict(pred_leaf=True)):
        assert np.array_equal(from_jax.predict(x, device="cpu", **kw),
                              np.asarray(jb.predict(x, **kw))), kw
        assert np.array_equal(np.asarray(from_torch.predict(x, **kw)),
                              tb.predict(x, device="cpu", **kw)), kw


@pytest.mark.parametrize("num_actors", [1, 2])
@pytest.mark.parametrize("sharding", ["BATCH", "INTERLEAVED"])
def test_distributed_predict_matches_jax(readme_models, num_actors, sharding):
    jb, tb, _, x = readme_models
    xo = x[:333]  # odd: the shards differ by one row
    bm = np.linspace(-1, 1, len(xo)).astype(np.float32)
    for kw in (dict(), dict(output_margin=True), dict(pred_leaf=True),
               dict(base_margin=bm, output_margin=True)):
        ref = np.asarray(jx.predict(
            jb, jx.RayDMatrix(xo, sharding=getattr(jx.RayShardingMode, sharding)),
            ray_params=jx.RayParams(num_actors=num_actors), **kw))
        got = tx.predict(
            tb, tx.RayDMatrix(xo, sharding=getattr(tx.RayShardingMode, sharding)),
            ray_params=tx.RayParams(num_actors=num_actors), device="cpu", **kw)
        assert got.shape == ref.shape and np.array_equal(got, ref), kw


def test_matrix_base_margin_column_rides_along(readme_models):
    jb, tb, _, x = readme_models
    xo, bm = x[:77], np.linspace(-2, 2, 77).astype(np.float32)
    for sharding in ("BATCH", "INTERLEAVED"):
        ref = np.asarray(jx.predict(
            jb, jx.RayDMatrix(xo, base_margin=bm,
                              sharding=getattr(jx.RayShardingMode, sharding)),
            ray_params=jx.RayParams(num_actors=2), output_margin=True))
        got = tx.predict(
            tb, tx.RayDMatrix(xo, base_margin=bm,
                              sharding=getattr(tx.RayShardingMode, sharding)),
            ray_params=tx.RayParams(num_actors=2), device="cpu",
            output_margin=True)
        assert np.array_equal(got, ref), sharding


def test_jax_dart_model_carried_across():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((400, 5)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)
    jb = jx.train({"objective": "binary:logistic", "booster": "dart",
                   "rate_drop": 0.3, "one_drop": 1, "max_depth": 3, "seed": 1},
                  jx.RayDMatrix(x, y), 6, ray_params=jx.RayParams(num_actors=2))
    assert jb.tree_weights is not None and not np.all(jb.tree_weights == 1.0)
    conv = booster_from_jax_state(
        jb.forest._asdict(), jb.cuts, jb.base_score,
        dataclasses.asdict(jb.params), tree_weights=jb.tree_weights)
    assert np.array_equal(conv.tree_weights, jb.tree_weights)
    for kw in (dict(), dict(output_margin=True), dict(pred_leaf=True)):
        assert_predictions_match(conv, x, conv.predict(x, device="cpu", **kw),
                                 np.asarray(jb.predict(x, **kw)), **kw)
    # without the weights the carried model would predict another margin
    bare = booster_from_jax_state(jb.forest._asdict(), jb.cuts, jb.base_score,
                                  dataclasses.asdict(jb.params))
    assert not np.array_equal(bare.predict(x, output_margin=True, device="cpu"),
                              np.asarray(jb.predict(x, output_margin=True)))


def test_jax_categorical_model_carried_across():
    rng = np.random.default_rng(6)
    n = 500
    colors = np.array(["red", "green", "blue", "teal", "plum"])
    frame = pd.DataFrame({
        "color": pd.Categorical(rng.choice(colors, n)),
        "noise": rng.standard_normal(n).astype(np.float32)})
    y = frame["color"].isin(["green", "teal"]).to_numpy().astype(np.float32)
    jb = jx.train({"objective": "binary:logistic", "max_depth": 3},
                  jx.RayDMatrix(frame, y, enable_categorical=True), 4,
                  ray_params=jx.RayParams(num_actors=2))
    assert jb.categories and jb.cat_features == (0,)
    conv = booster_from_jax_state(
        jb.forest._asdict(), jb.cuts, jb.base_score,
        dataclasses.asdict(jb.params), feature_names=jb.feature_names,
        feature_types=jb.feature_types, categories=jb.categories)
    assert conv.cat_features == (0,) and conv.categories == jb.categories
    # a frame whose own category order differs from training's
    query = pd.DataFrame({
        "color": pd.Categorical(rng.choice(colors, 60),
                                categories=colors[::-1]),
        "noise": rng.standard_normal(60).astype(np.float32)})
    for kw in (dict(), dict(output_margin=True), dict(pred_leaf=True)):
        assert_predictions_match(conv, query,
                                 conv.predict(query, device="cpu", **kw),
                                 np.asarray(jb.predict(query, **kw)), **kw)
    assert conv.predict(query, device="cpu").min() < 0.5 < conv.predict(
        query, device="cpu").max()


def test_guards(readme_models):
    jb, tb, _, x = readme_models
    # SHAP outputs (B15's plain versions here) sum to the margin
    m = tb.predict(x, output_margin=True, device="cpu")
    np.testing.assert_allclose(
        tb.predict(x, pred_contribs=True, device="cpu").sum(-1), m,
        rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(
        tb.predict(x[:20], pred_interactions=True, device="cpu").sum((-1, -2)),
        m[:20], rtol=1e-5, atol=2e-5)
    with pytest.raises(ValueError, match="Feature shape mismatch"):
        tb.predict(x[:, :5], device="cpu")
    with pytest.raises(ValueError, match="RayDMatrix"):
        tx.predict(tb, x, ray_params=tx.RayParams(num_actors=1), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tb.predict(x)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tx.predict(tb, tx.RayDMatrix(x),
                       ray_params=tx.RayParams(num_actors=1))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tx.serve.ModelRegistry()


@pytest.mark.parametrize("form", ["booster", "path", "json_text",
                                  "json_dict", "pickle"])
def test_predict_takes_every_model_form(readme_models, tmp_path, form):
    """``predict()`` and the serving registry share one model coercion
    (``models.booster.coerce_model``): each form predicts as the booster."""
    import json
    import pickle

    _, tb, _, x = readme_models
    path = tmp_path / "m.json"
    tb.save_model(str(path))
    model = {"booster": tb, "path": str(path), "json_text": path.read_text(),
             "json_dict": json.loads(path.read_text()),
             "pickle": pickle.dumps(tb)}[form]
    assert tx.serve.coerce_model is tx.models.booster.coerce_model
    got = tx.predict(model, tx.RayDMatrix(x[:50]),
                     ray_params=tx.RayParams(num_actors=2), device="cpu",
                     output_margin=True)
    assert np.array_equal(got, tb.predict(x[:50], output_margin=True,
                                          device="cpu"))


def test_predict_rejects_a_model_of_another_type(readme_models):
    _, _, _, x = readme_models
    with pytest.raises(TypeError, match="cannot use a model of type list"):
        tx.predict([1, 2], tx.RayDMatrix(x[:5]),
                   ray_params=tx.RayParams(num_actors=1), device="cpu")


def test_serve_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "from xgboost_ray_tpu_torch import serve, predict\n"
        "import xgboost_ray_tpu_torch.ops.predict, xgboost_ray_tpu_torch.obs\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'xgboost_ray_tpu' or m.startswith('xgboost_ray_tpu.')]\n"
        "print(bad)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
