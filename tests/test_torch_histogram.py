"""Parity of K1 (histogram + node totals) and K3 (partition) plain versions
with the JAX package's functions.

Tolerances: with integer-valued gh every f32 sum is exact, so histograms
are bitwise; with random gh they are held within 2 ulps (the plain version
adds each bucket's rows in the order the JAX scatter does, so they are in
practice bitwise too). Partition outputs are integers: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgboost_ray_tpu.ops import histogram as jh
from xgboost_ray_tpu_torch.ops import histogram as th
from xgboost_ray_tpu_torch.ops.grow import route_right_binned


def _level(seed, n=4000, f=7, n_nodes=8, integer_gh=True):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, 257, (n, f)).astype(np.int16)
    if integer_gh:
        gh = np.stack([rng.integers(-3, 4, n), rng.integers(1, 5, n)], 1)
    else:
        gh = np.stack([rng.standard_normal(n), rng.uniform(0.01, 0.25, n)], 1)
    pos = rng.integers(0, n_nodes, n).astype(np.int32)
    return bins, gh.astype(np.float32), pos


def _sorted_layout(pos, n_nodes):
    order = np.argsort(pos, kind="stable").astype(np.int32)
    seg = np.concatenate([[0], np.cumsum(np.bincount(pos, minlength=n_nodes))])
    return torch.from_numpy(order), torch.from_numpy(seg.astype(np.int32))


@pytest.mark.parametrize("integer_gh", [True, False])
def test_histogram_matches_hist_scatter(integer_gh):
    bins, gh, pos = _level(3, integer_gh=integer_gh)
    ref = np.asarray(jax.jit(jh.hist_scatter, static_argnums=(3, 4))(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(pos), 8, 257))
    order, seg = _sorted_layout(pos, 8)
    hist, totals = th.build_histogram(torch.from_numpy(bins),
                                      torch.from_numpy(gh), order, seg, 8, 257)
    ref_tot = np.asarray(jh.node_sums(jnp.asarray(gh), jnp.asarray(pos), 8))
    if integer_gh:
        assert np.array_equal(hist.numpy(), ref)
        assert np.array_equal(totals.numpy(), ref_tot)
    else:
        np.testing.assert_array_max_ulp(hist.numpy(), ref, maxulp=2)
        np.testing.assert_array_max_ulp(totals.numpy(), ref_tot, maxulp=2)


def test_histogram_totals_only_and_compacted_rows():
    bins, gh, pos = _level(4)
    order, seg = _sorted_layout(pos, 8)
    full, tot = th.build_histogram(torch.from_numpy(bins), torch.from_numpy(gh),
                                   order, seg, 8, 257)
    none, tot2 = th.build_histogram(torch.from_numpy(bins), torch.from_numpy(gh),
                                    order, seg, 8, 257, with_hist=False)
    assert none is None and torch.equal(tot, tot2)
    # a longer row buffer than seg[-1] (the compacted list's capacity)
    padded = torch.cat([order, torch.full((50,), 7, dtype=torch.int32)])
    again, _ = th.build_histogram(torch.from_numpy(bins), torch.from_numpy(gh),
                                  padded, seg, 8, 257)
    assert torch.equal(full, again)


def test_node_sums_and_zero_phantom_missing():
    _, gh, pos = _level(5, integer_gh=False)
    ref = np.asarray(jh.node_sums(jnp.asarray(gh), jnp.asarray(pos), 8))
    got = th.node_sums(torch.from_numpy(gh), torch.from_numpy(pos), 8)
    assert np.array_equal(got.numpy(), ref)
    h = np.random.default_rng(0).standard_normal((4, 3, 9, 2)).astype(np.float32)
    fhm = np.array([True, False, True])
    ref = np.asarray(jh.zero_phantom_missing(jnp.asarray(h), jnp.asarray(fhm)))
    got = th.zero_phantom_missing(torch.from_numpy(h.copy()), torch.from_numpy(fhm))
    assert np.array_equal(got.numpy(), ref)


def test_update_partition_order_and_small_child_rows():
    rng = np.random.default_rng(6)
    n, n_nodes = 3001, 8
    pos = rng.integers(0, n_nodes, n).astype(np.int32)
    pos[pos == 5] = 4  # an empty node in the middle
    order = np.argsort(pos, kind="stable").astype(np.int32)
    counts = np.bincount(pos, minlength=n_nodes).astype(np.int32)
    go_right = rng.random(n) < 0.4
    ref_order, ref_counts = jax.jit(jh.update_partition_order)(
        jnp.asarray(order), jnp.asarray(counts), jnp.asarray(go_right))
    got_order, got_counts = th.update_partition_order(
        torch.from_numpy(order), torch.from_numpy(counts),
        torch.from_numpy(go_right))
    assert np.array_equal(got_order.numpy(), np.asarray(ref_order))
    assert np.array_equal(got_counts.numpy(), np.asarray(ref_counts))
    new_counts = np.asarray(ref_counts)
    sir = new_counts[1::2] <= new_counts[0::2]
    ref = jax.jit(jh.select_small_child_rows)(
        ref_order, ref_counts, jnp.asarray(sir))
    got = th.select_small_child_rows(got_order, got_counts, torch.from_numpy(sir))
    for a, b in zip(got, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_partition_level_routes_like_the_jax_grower():
    """K3's plain version against route_right_binned + the JAX partition
    functions: new order/segments, compacted small children, and the leaf
    value written for the rows of nodes that become leaves."""
    rng = np.random.default_rng(7)
    n, f, n_nodes = 2500, 5, 4
    bins = rng.integers(0, 257, (n, f)).astype(np.int16)
    pos = rng.integers(0, n_nodes, n).astype(np.int32)
    order, seg = _sorted_layout(pos, n_nodes)
    feature = torch.tensor([1, 4, 0, 2], dtype=torch.int32)
    sbin = torch.tensor([100, 3, 250, 0], dtype=torch.int32)
    dl = torch.tensor([True, False, True, False])
    state = torch.tensor([th.SPLIT, th.LEAF, th.SPLIT, th.INACTIVE],
                         dtype=torch.uint8)
    nval = torch.tensor([0.5, -1.25, 2.0, 9.0])
    row_value = torch.full((n,), 7.0)
    part = th.partition_level(order, seg, torch.from_numpy(bins), feature,
                              sbin, dl, state, nval, row_value, True, 256)
    # reference: per-row go-right from the JAX rule, JAX partition functions
    b = bins[np.arange(n), feature.numpy()[pos]]
    go = np.asarray(route_right_binned(
        torch.from_numpy(b.astype(np.int64)), sbin[pos], dl[pos], 256))
    go &= state.numpy()[pos] == th.SPLIT
    counts = np.bincount(pos, minlength=n_nodes).astype(np.int32)
    ref_order, ref_counts = jh.update_partition_order(
        jnp.asarray(order.numpy()), jnp.asarray(counts), jnp.asarray(go))
    assert np.array_equal(part.order.numpy(), np.asarray(ref_order))
    assert np.array_equal(np.diff(part.seg.numpy()), np.asarray(ref_counts))
    rc = np.asarray(ref_counts)
    sir = np.where(state.numpy() == th.SPLIT, rc[1::2] <= rc[0::2], True)
    assert np.array_equal(part.small_is_right.numpy(), sir)
    rows, _, valid, counts_sel = jh.select_small_child_rows(
        ref_order, ref_counts, jnp.asarray(sir))
    m = int(np.asarray(counts_sel).sum())
    assert np.array_equal(np.diff(part.small_seg.numpy()), np.asarray(counts_sel))
    assert np.array_equal(part.small_rows.numpy()[:m], np.asarray(rows)[:m])
    expect = np.where(pos == 1, -1.25, 7.0).astype(np.float32)
    assert np.array_equal(row_value.numpy(), expect)


@pytest.mark.parametrize("n_nodes", [64, 8, 1])
def test_leaf_value_mode_matches_full_partition_on_last_level(n_nodes):
    """The grower's last K3 call (every node LEAF or INACTIVE, nothing
    splits): the leaf-value mode writes the same row_value as the full
    partition, and the full partition leaves order and segments as they
    were."""
    rng = np.random.default_rng(8)
    n = 3001
    bins = torch.from_numpy(rng.integers(0, 257, (n, 4)).astype(np.int16))
    pos = rng.integers(0, n_nodes, n).astype(np.int32)
    if n_nodes > 2:
        pos[pos == 2] = 1  # an empty node
    order, seg = _sorted_layout(pos, n_nodes)
    active = torch.from_numpy(rng.random(n_nodes) < 0.75)
    state = torch.where(active, th.LEAF, th.INACTIVE).to(torch.uint8)
    nval = torch.from_numpy(rng.standard_normal(n_nodes).astype(np.float32))
    no_split = torch.zeros(n_nodes, dtype=torch.int32)
    rv_full = torch.full((n,), 5.0)
    part = th.partition_level_plain(order, seg, bins, no_split, no_split,
                                    active, state, nval, rv_full, False, 256)
    assert torch.equal(part.order, order)
    assert torch.equal(part.seg[0::2], seg)
    rv_leaf = torch.full((n,), 5.0)
    th.partition_leaf_values(order, seg, state, nval, rv_leaf)
    assert torch.equal(rv_leaf, rv_full)
    leaf_rows = np.isin(pos, np.nonzero(active.numpy())[0])
    expect = np.where(leaf_rows, nval.numpy()[pos], 5.0).astype(np.float32)
    assert np.array_equal(rv_leaf.numpy(), expect)
