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


# --------------------------------------------------------------------------
# K1's fixed point: build_histogram_fixed_plain (what the kernel computes)
# --------------------------------------------------------------------------


def _fixed_inputs(seed, n=6000, f=5, n_nodes=6):
    bins, gh, pos = _level(seed, n=n, f=f, n_nodes=n_nodes, integer_gh=False)
    gh[::7, 0] *= -40.0  # a wide range of magnitudes
    order, seg = _sorted_layout(pos, n_nodes)
    gh = torch.from_numpy(gh)
    return torch.from_numpy(bins), gh, order, seg, th.quant_scales(gh, n)


def test_fixed_histogram_bitwise_under_row_permutation_within_nodes():
    bins, gh, order, seg, qs = _fixed_inputs(11)
    ref, ref_tot = th.build_histogram_fixed_plain(bins, gh, order, seg, 6, 257,
                                                  qs)
    rng = np.random.default_rng(12)
    shuffled = order.clone()
    for k in range(6):
        lo, hi = int(seg[k]), int(seg[k + 1])
        shuffled[lo:hi] = order[lo:hi][torch.from_numpy(rng.permutation(hi - lo))]
    got, got_tot = th.build_histogram_fixed_plain(bins, gh, shuffled, seg, 6,
                                                  257, qs)
    assert ref.dtype == torch.int64
    assert torch.equal(got, ref) and torch.equal(got_tot, ref_tot)
    # the f32 sums of the same rows in the shuffled order differ in bits
    f32, _ = th.build_histogram_plain(bins, gh, order, seg, 6, 257)
    f32s, _ = th.build_histogram_plain(bins, gh, shuffled, seg, 6, 257)
    assert not torch.equal(f32, f32s)


def test_fixed_histograms_of_two_shards_sum_to_the_whole():
    bins, gh, order, seg, qs = _fixed_inputs(13)
    whole, whole_tot = th.build_histogram_fixed_plain(bins, gh, order, seg, 6,
                                                      257, qs)
    # split every node's rows between two "ranks" by row parity
    parts = []
    for r in range(2):
        keep = (order % 2 == r)
        node = th._node_of_slot(seg, 6)
        counts = torch.bincount(node[keep], minlength=6)
        seg_r = torch.cat([torch.zeros(1, dtype=torch.long),
                           torch.cumsum(counts, 0)]).to(torch.int32)
        parts.append(th.build_histogram_fixed_plain(
            bins, gh, order[keep].contiguous(), seg_r, 6, 257, qs))
    assert torch.equal(parts[0][0] + parts[1][0], whole)
    assert torch.equal(parts[0][1] + parts[1][1], whole_tot)
    # dequantised: the f32 histogram K2 reads, the same from either layout
    assert torch.equal(th.dequantize(parts[0][0] + parts[1][0], qs),
                       th.dequantize(whole, qs))


def test_fixed_histogram_dequantised_within_f32_tolerance():
    """The dequantised fixed-point sums against the f32 plain sums: both
    approximate the exact sum, the fixed point closer (n x 2^-e / 2 against
    the f32 adds' rounding), so they agree within 1e-5 x sum |v|."""
    bins, gh, order, seg, qs = _fixed_inputs(14)
    h, t = th.build_histogram_fixed_plain(bins, gh, order, seg, 6, 257, qs)
    f32, f32_tot = th.build_histogram_plain(bins, gh, order, seg, 6, 257)
    habs, tabs = th.build_histogram_plain(bins, gh.abs(), order, seg, 6, 257)
    dh, dt = th.dequantize(h, qs), th.dequantize(t, qs)
    assert dh.dtype == torch.float32
    assert bool(((dh - f32).abs() <= 1e-5 * habs).all())
    assert bool(((dt - f32_tot).abs() <= 1e-5 * tabs).all())
    # totals are feature 0's cells summed
    assert torch.equal(h[:, 0].sum(1), t)
    # integer gh scaled by a power of two: exact, so equal to the f32 sums
    bins_i, gh_i, pos = _level(15)
    order_i, seg_i = _sorted_layout(pos, 8)
    gh_i = torch.from_numpy(gh_i)
    qs_i = th.quant_scales(gh_i, gh_i.shape[0])
    hi, ti = th.build_histogram_fixed_plain(torch.from_numpy(bins_i), gh_i,
                                            order_i, seg_i, 8, 257, qs_i)
    fi, fti = th.build_histogram_plain(torch.from_numpy(bins_i), gh_i,
                                       order_i, seg_i, 8, 257)
    assert torch.equal(th.dequantize(hi, qs_i), fi)
    assert torch.equal(th.dequantize(ti, qs_i), fti)


def _exponent(scale: float) -> int:
    e = int(np.log2(scale))
    assert 2.0 ** e == scale
    return e


@pytest.mark.parametrize("n,absmax", [
    (1, 1.0), (569, 0.25), (11_000_000, 1.0), (11_000_000, 3.0e-8),
    (1000, 7.5e6), (3, 3.0e38), (1 << 40, 0.5), (100, 0.0)])
def test_scales_follow_the_exponent_rule(n, absmax):
    """Each e is the largest with n (max|v| 2^e + 1) < 2^62 (exact integer
    arithmetic on the f32 max), within [-126, 126]; a zero max takes 126."""
    m = np.float32(absmax)
    qs = th.scales_for(torch.tensor([m, m]), n)
    assert qs.dtype == torch.float32 and qs.shape == (4,)
    eg, eh = _exponent(float(qs[0])), _exponent(float(qs[1]))
    assert eg == eh and 2.0 ** -eg == float(qs[2]) == float(qs[3])
    assert -126 <= eg <= 126
    from fractions import Fraction

    def fits(e):
        return n * (Fraction(float(m)) * Fraction(2) ** e + 1) < 2 ** 62

    if absmax == 0.0:
        assert eg == 126
    else:
        assert fits(eg) and (eg == 126 or not fits(eg + 1))


def test_fixed_histogram_no_overflow_at_the_bound():
    """Every row at the largest |g| (signs mixed) and the largest |h| the
    rule admits for n rows: the int64 sums are the exact integer sums and
    stay below 2^62."""
    n = 4096
    m = np.float32(np.nextafter(np.float32(3.0), np.float32(4.0)))
    g = np.where(np.arange(n) % 5 == 0, -m, m).astype(np.float32)
    gh = torch.from_numpy(np.stack([g, np.full(n, m, np.float32)], 1))
    qs = th.quant_scales(gh, n)
    e = _exponent(float(qs[0]))
    bins = torch.zeros((n, 1), dtype=torch.int16)
    rows = torch.arange(n, dtype=torch.int32)
    seg = torch.tensor([0, n], dtype=torch.int32)
    h, t = th.build_histogram_fixed_plain(bins, gh, rows, seg, 1, 257, qs)
    q = int(np.rint(float(m) * 2.0 ** e))
    n_neg = int((g < 0).sum())
    assert int(h[0, 0, 0, 0]) == q * (n - 2 * n_neg)
    assert int(h[0, 0, 0, 1]) == int(t[0, 1]) == q * n < 2 ** 62
    assert n * (q + 1) >= 2 ** 61  # the bound is tight: e is the largest
    assert torch.equal(th.quantize_gh(gh, qs)[:2, 1],
                       torch.tensor([q, q], dtype=torch.int64))


def _children(seed, n=3001, n_par=8):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 2 * n_par, n).astype(np.int32)
    order = np.argsort(pos, kind="stable").astype(np.int32)
    counts = np.bincount(pos, minlength=2 * n_par).astype(np.int32)
    return order, counts


def test_select_small_child_rows_in_n_slots():
    """With N slots (a choice made from every rank's counts) the chosen
    children's rows are packed by parent as the JAX
    ``select_small_child_rows`` packs them into its N // 2, and the larger
    children, more than N // 2 rows, are packed whole."""
    order, counts = _children(16)
    n = order.shape[0]
    sir = counts[1::2] <= counts[0::2]
    rows, _, valid, sel = th.select_small_child_rows(
        torch.from_numpy(order), torch.from_numpy(counts),
        torch.from_numpy(sir), n)
    ref_rows, _, _, ref_sel = jh.select_small_child_rows(
        jnp.asarray(order), jnp.asarray(counts), jnp.asarray(sir))
    m = int(np.asarray(ref_sel).sum())
    assert np.array_equal(sel.numpy(), np.asarray(ref_sel))
    assert np.array_equal(rows.numpy()[:m], np.asarray(ref_rows)[:m])
    assert rows.shape == (n,) and bool((rows[m:] == n).all())
    assert int(valid.sum()) == m
    big, _, _, big_sel = th.select_small_child_rows(
        torch.from_numpy(order), torch.from_numpy(counts),
        torch.from_numpy(~sir), n)
    assert int(big_sel.sum()) == n - m > n // 2
    assert np.array_equal(np.sort(big.numpy()[:n - m]),
                          np.sort(np.setdiff1d(order, rows.numpy()[:m])))


def test_partition_level_chooses_from_merged_counts():
    """K3's plain version above one rank: ``merge_counts`` gets this rank's
    children's counts (int64) and the smaller child of each splitting
    parent follows the merged counts (right on ties); the compacted rows
    are that child's, in N slots. The identity merge gives the one-rank
    partition."""
    bins, _, pos = _level(18, n=3000, f=5, n_nodes=8)
    order, seg = _sorted_layout(pos, 8)
    rng = np.random.default_rng(19)
    args = (torch.from_numpy(bins),
            torch.from_numpy(rng.integers(0, 5, 8).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 255, 8).astype(np.int32)),
            torch.from_numpy(rng.random(8) < 0.5),
            torch.tensor([th.SPLIT] * 6 + [th.LEAF, th.INACTIVE],
                         dtype=torch.uint8),
            torch.zeros(8))
    one = th.partition_level(order, seg, *args, torch.zeros(3000), True, 256)
    seen = []

    def other_rank(c):  # a second rank holding twice the sibling's rows
        seen.append(c.clone())
        return c + 2 * c.view(-1, 2).flip(1).reshape(-1)

    got = th.partition_level(order, seg, *args, torch.zeros(3000), True, 256,
                             merge_counts=other_rank)
    counts = (one.seg[1:] - one.seg[:-1]).long()
    assert len(seen) == 1 and seen[0].dtype == torch.int64
    assert torch.equal(seen[0], counts)
    lc, rc = counts[0::2], counts[1::2]
    split = args[4] == th.SPLIT
    assert torch.equal(got.small_is_right,
                       torch.where(split, rc + 2 * lc <= lc + 2 * rc, True))
    assert torch.equal(got.order, one.order) and torch.equal(got.seg, one.seg)
    assert got.small_rows.shape == (3000,)
    ref, _, _, sel = th.select_small_child_rows(one.order, counts,
                                                got.small_is_right, 3000)
    m = int(sel.sum())
    assert torch.equal(got.small_rows[:m], ref[:m])
    assert torch.equal(got.small_seg[1:], torch.cumsum(sel, 0).int())
    same = th.partition_level(order, seg, *args, torch.zeros(3000), True, 256,
                              merge_counts=lambda c: c)
    m1 = int(one.small_seg[-1])
    assert torch.equal(same.small_is_right, one.small_is_right)
    assert torch.equal(same.small_seg, one.small_seg)
    assert torch.equal(same.small_rows[:m1], one.small_rows[:m1])


def test_build_histogram_on_the_cpu_takes_no_qscale():
    """The CPU sums f32 (the JAX package's sums); K1's fixed point is the
    card's, and its plain version is called by name."""
    bins, gh, order, seg, qs = _fixed_inputs(20)
    with pytest.raises(ValueError, match="no qscale"):
        th.build_histogram(bins, gh, order, seg, 6, 257, qscale=qs)
    h, t = th.build_histogram(bins, gh, order, seg, 6, 257)
    assert h.dtype == torch.float32 and t.dtype == torch.float32
