"""Parity of K2's plain versions (split search + node-total readout, the
level step with its sibling formation and records, the final level's
records) and ``leaf_weight`` with the JAX package.

Tolerance: bitwise (floats compared bit for bit where a level step's
outputs are checked). The plain version associates its float sums as the
compiled JAX program does (blocked prefix scan, windowed readout), so gains
and totals match exactly on the same histogram; ``tree_sum`` and
``blocked_cumsum`` are also held against XLA directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgboost_ray_tpu.ops import histogram as jh
from xgboost_ray_tpu.ops import split as js
from xgboost_ray_tpu_torch.ops import grow as tg
from xgboost_ray_tpu_torch.ops import histogram as th
from xgboost_ray_tpu_torch.ops import split as ts


def _jax_level(hist, p):
    @jax.jit
    def fn(h):
        node_gh = h[:, 0, :, :].sum(axis=1)  # build_tree's readout
        return js.find_splits(h, node_gh, p), node_gh

    sp, node_gh = fn(jnp.asarray(hist))
    return sp, np.asarray(node_gh)


def _hist(seed, n_nodes=6, f=5, nbt=257):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n_nodes, f, nbt)) * 3
    h = rng.uniform(0.0, 2.0, (n_nodes, f, nbt))
    h[:, :, 40:60] = 0.0  # empty bins: tied neighbouring candidates
    g[:, :, 40:60] = 0.0
    # every feature sums to the same node totals (one set of rows)
    g[:, :, -1] += (g[:, :1, :].sum(-1) - g.sum(-1))
    h[:, :, -1] = np.abs(h[:, :, -1]) + 1.0
    return np.stack([g, h], -1).astype(np.float32)


@pytest.mark.parametrize("params", [
    dict(),
    dict(reg_lambda=0.5, reg_alpha=0.3, gamma=1.0, min_child_weight=5.0),
])
def test_find_splits_bitwise(params):
    hist = _hist(0)
    jp = js.SplitParams(**params)
    tp = ts.SplitParams(**params)
    ref, ref_gh = _jax_level(hist, jp)
    got = ts.find_splits(torch.from_numpy(hist), tp)
    assert np.array_equal(got.node_gh.numpy(), ref_gh)
    for name in ("gain", "feature", "split_bin", "default_left", "valid"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(ref, name))), name


def test_first_max_tie_rule():
    """Two identical features and runs of empty bins: the winner is the
    lowest flat index feature * (n_bins - 1) + bin, as jnp.argmax picks."""
    rng = np.random.default_rng(1)
    n_bins = 16
    col = np.zeros((n_bins + 1, 2), np.float32)
    col[:4] = [[-2.0, 1.0]] * 4  # bins 0..3
    col[4:10] = 0.0  # empty: candidates 3..9 tie
    col[10:n_bins] = [[3.0, 1.5]] * (n_bins - 10)
    hist = np.zeros((2, 3, n_bins + 1, 2), np.float32)
    hist[:, 0] = rng.standard_normal((n_bins + 1, 2)).astype(np.float32) * 0.01
    hist[:, 0, :, 1] = np.abs(hist[:, 0, :, 1])
    hist[:, 1] = col
    hist[:, 2] = col  # same gains as feature 1
    hist[:, 0, -1] = col.sum(0)[None] - hist[:, 0, :-1].sum(1)  # same totals
    ref, _ = _jax_level(hist, js.SplitParams(min_child_weight=0.0))
    got = ts.find_splits(torch.from_numpy(hist),
                         ts.SplitParams(min_child_weight=0.0))
    assert got.feature.tolist() == np.asarray(ref.feature).tolist() == [1, 1]
    assert got.split_bin.tolist() == np.asarray(ref.split_bin).tolist() == [3, 3]


def test_no_valid_split_keeps_index_zero():
    hist = np.zeros((1, 2, 9, 2), np.float32)
    hist[0, :, 0] = [1.0, 0.5]  # every row in bin 0: no candidate passes
    ref, _ = _jax_level(hist, js.SplitParams())
    got = ts.find_splits(torch.from_numpy(hist), ts.SplitParams())
    assert not bool(got.valid[0]) and not bool(np.asarray(ref.valid)[0])
    assert int(got.feature[0]) == int(ref.feature[0]) == 0
    assert int(got.split_bin[0]) == int(ref.split_bin[0]) == 0
    assert bool(got.default_left[0]) == bool(ref.default_left[0])


@pytest.mark.parametrize("params", [
    dict(), dict(reg_alpha=0.7), dict(max_delta_step=0.4, reg_lambda=0.0),
])
def test_leaf_weight_and_score(params):
    rng = np.random.default_rng(2)
    g = (rng.standard_normal(500) * 4).astype(np.float32)
    h = rng.uniform(0, 3, 500).astype(np.float32)
    h[:5] = 0.0
    for fn_j, fn_t in ((js.leaf_weight, ts.leaf_weight), (js.score, ts.score)):
        ref = np.asarray(fn_j(jnp.asarray(g), jnp.asarray(h),
                              js.SplitParams(**params)))
        got = fn_t(torch.from_numpy(g), torch.from_numpy(h),
                   ts.SplitParams(**params))
        assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n", [7, 16, 255, 256, 1000])
def test_blocked_cumsum_matches_xla(n):
    x = np.random.default_rng(n).standard_normal((4, n)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(jnp.asarray(x)))
    assert np.array_equal(ts.blocked_cumsum(torch.from_numpy(x)).numpy(), ref)


@pytest.mark.parametrize("m", [17, 33, 257, 1025])
def test_tree_sum_matches_xla(m):
    x = np.random.default_rng(m).standard_normal((3, m, 2)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: a.sum(axis=1))(jnp.asarray(x)))
    assert np.array_equal(ts.tree_sum(torch.from_numpy(x)).numpy(), ref)


RECORDS = ("feature", "split_bin", "threshold", "default_left", "is_leaf",
           "value", "gain", "cover", "base_weight")
REGULARIZED = dict(reg_lambda=0.7, reg_alpha=0.3, gamma=0.5,
                   min_child_weight=2.0, max_delta_step=0.4,
                   learning_rate=0.1)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                     b.view(np.int32))
    return np.array_equal(a, b)


def _level_inputs(seed, n_par=4, f=5, nbt=257):
    """A level of 2 n_par nodes: parents' histograms, the smaller
    children's (each bucket a share of the parent's), which child is
    smaller, feat_has_missing, active nodes (one empty) and cuts."""
    rng = np.random.default_rng(seed)
    prev = _hist(seed, n_par, f, nbt)
    share = rng.uniform(0.0, 1.0, prev.shape[:3] + (1,)).astype(np.float32)
    small = (prev * share).astype(np.float32)
    small[1] = 0.0  # parent 1's smaller child is empty
    sir = rng.random(n_par) < 0.5
    fhm = np.array([True, False, True, False, False][:f])
    active = rng.random(2 * n_par) < 0.8
    active[:2] = True
    cuts = np.sort(rng.standard_normal((f, nbt - 2)), 1).astype(np.float32)
    return prev, small, sir, fhm, active, cuts


def _jax_level_step(prev, small, sir, fhm, active, cuts, jp, sibling):
    n_nodes = active.shape[0]
    f = cuts.shape[0]
    max_bin = cuts.shape[1] + 1

    @jax.jit
    def fn(prev, small, sir, fhm, active, cuts):
        if sibling:  # xgboost_ray_tpu/ops/grow.py:570-575
            big = prev - small
            s = sir[:, None, None, None]
            left = jnp.where(s, big, small)
            right = jnp.where(s, small, big)
            hist = jnp.stack([left, right], axis=1).reshape(
                (n_nodes,) + small.shape[1:])
        else:
            hist = prev
        hist = jh.zero_phantom_missing(hist, fhm)
        node_gh = hist[:, 0, :, :].sum(axis=1)
        sp = js.find_splits(hist, node_gh, jp)
        valid_split = sp.valid & active  # grow.py:661-684
        node_value = jp.learning_rate * js.leaf_weight(
            node_gh[:, 0], node_gh[:, 1], jp)
        is_new_leaf = active & ~valid_split
        fsafe = jnp.clip(sp.feature, 0, f - 1)
        thr = cuts[fsafe, jnp.clip(sp.split_bin, 0, max_bin - 2)]
        rec = dict(
            feature=jnp.where(valid_split, sp.feature, -1),
            split_bin=jnp.where(valid_split, sp.split_bin, 0),
            threshold=jnp.where(valid_split, thr, 0.0),
            default_left=sp.default_left & valid_split,
            is_leaf=is_new_leaf,
            value=jnp.where(is_new_leaf, node_value, 0.0),
            gain=jnp.where(valid_split, sp.gain, 0.0),
            cover=jnp.where(active, node_gh[:, 1], 0.0),
            base_weight=jnp.where(active, node_value, 0.0))
        return sp, node_gh, node_value, valid_split, is_new_leaf, rec, hist

    out = fn(*(jnp.asarray(a) for a in (prev, small, sir, fhm, active, cuts)))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("sibling", [True, False])
@pytest.mark.parametrize("params", [dict(), REGULARIZED])
def test_split_level_plain_matches_jax(sibling, params):
    prev, small, sir, fhm, active, cuts = _level_inputs(3)
    if not sibling:  # the level's full histogram, 2 n_par nodes
        prev = np.concatenate([prev, small])
        small = sir = None
    n_nodes = active.shape[0]
    sp, node_gh, node_value, vs, new_leaf, rec, hist = _jax_level_step(
        prev, small if sibling else prev, sir if sibling else active[:1],
        fhm, active, cuts, js.SplitParams(**params), sibling)
    tree = tg.empty_tree(2 * n_nodes + 3, "cpu")
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    step = ts.split_level_plain(
        t(small) if sibling else t(prev), t(prev) if sibling else None,
        t(sir), t(active),
        ts.TreeRecords(tree, t(cuts), t(fhm), ts.SplitParams(**params)))
    for name in ("gain", "feature", "split_bin", "default_left", "valid"):
        assert _bits_equal(getattr(step.splits, name).numpy(),
                           getattr(sp, name)), name
    assert _bits_equal(step.splits.node_gh.numpy(), node_gh)
    assert _bits_equal(step.node_value.numpy(), node_value)
    assert _bits_equal(step.hist.numpy(), hist)
    state = np.where(vs, th.SPLIT, np.where(new_leaf, th.LEAF, th.INACTIVE))
    assert _bits_equal(step.state.numpy(), state.astype(np.uint8))
    assert _bits_equal(step.active.numpy(), np.repeat(vs, 2))
    sl = slice(n_nodes - 1, 2 * n_nodes - 1)
    for name in RECORDS:
        assert _bits_equal(getattr(tree, name)[sl].numpy(), rec[name]), name
    # the level step exercises the paths it is meant to
    assert vs.any() and (~vs & active).any() and not active.all()


@pytest.mark.parametrize("params", [dict(), REGULARIZED])
def test_leaf_records_plain_matches_jax(params):
    rng = np.random.default_rng(4)
    n_nodes = 64
    node_gh = np.stack([rng.standard_normal(n_nodes) * 5,
                        rng.uniform(0.0, 4.0, n_nodes)], 1).astype(np.float32)
    node_gh[:4] = [[0.0, 0.0], [-0.0, 1.0], [0.2, 0.0], [-3.0, 0.0]]
    active = rng.random(n_nodes) < 0.7
    jp = js.SplitParams(**params)

    @jax.jit
    def fn(node_gh, active):  # xgboost_ray_tpu/ops/grow.py:765-780
        node_value = jp.learning_rate * js.leaf_weight(
            node_gh[:, 0], node_gh[:, 1], jp)
        return dict(is_leaf=active,
                    value=jnp.where(active, node_value, 0.0),
                    cover=jnp.where(active, node_gh[:, 1], 0.0),
                    base_weight=jnp.where(active, node_value, 0.0))

    ref = jax.tree_util.tree_map(np.asarray, fn(jnp.asarray(node_gh),
                                                jnp.asarray(active)))
    tree = tg.empty_tree(2 * n_nodes - 1, "cpu")
    rec = ts.TreeRecords(tree, torch.zeros(3, 15), None,
                         ts.SplitParams(**params))
    node_value, state = ts.leaf_records_plain(
        torch.from_numpy(node_gh), torch.from_numpy(active), rec)
    sl = slice(n_nodes - 1, 2 * n_nodes - 1)
    for name, want in ref.items():
        assert _bits_equal(getattr(tree, name)[sl].numpy(), want), name
    assert _bits_equal(node_value.numpy(), ref["value"])
    assert _bits_equal(state.numpy(), np.where(active, th.LEAF, th.INACTIVE)
                       .astype(np.uint8))
