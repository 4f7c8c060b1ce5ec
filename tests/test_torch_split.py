"""Parity of K2's plain version (split search + node-total readout) and
``leaf_weight`` with the JAX package.

Tolerance: bitwise. The plain version associates its float sums as the
compiled JAX program does (blocked prefix scan, windowed readout), so gains
and totals match exactly on the same histogram; ``tree_sum`` and
``blocked_cumsum`` are also held against XLA directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgboost_ray_tpu.ops import split as js
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
