"""Parity of the port's quantile sketch and binning with the JAX package.

Inputs come from a seeded numpy generator and go through both packages in
one process; the JAX functions run compiled, as the engine runs them
(``engine.TpuEngine._sketch_and_bin``). Tolerance: cuts, bins and the
has-missing mask are bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgboost_ray_tpu.ops import binning as jb
from xgboost_ray_tpu_torch.convert import bins_from_cuts
from xgboost_ray_tpu_torch.ops import binning as tb


def _data(seed, n=3000, f=9, nan_rate=0.1):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, f)) * rng.uniform(0.1, 500, f)).astype(np.float32)
    x[:, 2] = np.round(x[:, 2])  # heavy ties
    x[rng.random((n, f)) < nan_rate] = np.nan
    x[:, 5] = np.nan  # an all-missing feature
    w = rng.uniform(0.1, 2.0, n).astype(np.float32)
    return x, w


def _jax_sketch_and_bin(x, w, max_bin):
    @jax.jit
    def fn(x, v, w):
        mn, mx = jb.feature_min_max(x, v)
        hist = jb.sketch_histogram(x, v, mn, mx, weight=w)
        cuts = jb.cuts_from_sketch(mn, mx, hist, max_bin)
        bins = jb.bin_matrix(x, cuts, max_bin)
        miss = jnp.sum(((bins == max_bin) & v[:, None]).astype(jnp.float32), 0)
        return bins, cuts, miss > 0

    v = jnp.ones(x.shape[0], bool)
    return [np.asarray(a) for a in fn(jnp.asarray(x), v, jnp.asarray(w))]


@pytest.mark.parametrize("max_bin", [256, 64])
@pytest.mark.parametrize("weighted", [False, True])
def test_cuts_and_bins_bitwise(max_bin, weighted):
    x, w = _data(1)
    if not weighted:
        w = np.ones_like(w)
    jbins, jcuts, jmiss = _jax_sketch_and_bin(x, w, max_bin)
    bins, cuts, miss = tb.sketch_and_bin(torch.from_numpy(x),
                                         torch.from_numpy(w), max_bin)
    assert np.array_equal(cuts.numpy(), jcuts)
    assert np.array_equal(bins.numpy(), jbins)
    assert bins.numpy().dtype == jbins.dtype == tb.bin_dtype(max_bin)
    assert np.array_equal(miss.numpy(), jmiss)


def test_bin_matrix_against_given_cuts():
    x, _ = _data(2)
    cuts = jb.sketch_cuts_np(x, 256)
    ref = jb.bin_matrix_np(x, cuts, 256)
    got = bins_from_cuts(x, cuts, 256)
    assert np.array_equal(got.numpy(), ref)


def test_bin_dtype_matches():
    for mb in (2, 16, 255, 256, 1024):
        assert tb.bin_dtype(mb) == jb.bin_dtype(mb)


def _fixed_sums(x, w, n_global, mn, mx):
    qs = tb.sketch_scale(w, n_global)
    return tb.sketch_histogram(x, mn, mx, w, qs), qs


def test_fixed_point_sketch_sums_are_order_and_shard_free():
    """The card's sketch sums (ROADMAP C2), called on the CPU: int64
    fixed-point sums of random weights are the same bits after a row
    permutation and when two shards are summed apart and merged (an
    all-reduce's integer add); the f32 sums differ in both."""
    x, w = _data(3, n=20000)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    mn, mx = tb.feature_min_max(xt)
    ref, qs = _fixed_sums(xt, wt, len(x), mn, mx)
    assert ref.dtype == torch.int64
    perm = torch.from_numpy(np.random.default_rng(4).permutation(len(x)))
    assert torch.equal(_fixed_sums(xt[perm], wt[perm], len(x), mn, mx)[0], ref)
    halves = [(xt[r::2], wt[r::2]) for r in range(2)]
    folded = sum(tb.sketch_histogram(xs, mn, mx, ws, qs) for xs, ws in halves)
    assert torch.equal(folded, ref)
    # the per-shard scale from the merged max|w| is the world's
    assert torch.equal(tb.sketch_scale(halves[0][1], len(x),
                                       lambda m: torch.maximum(
                                           m, halves[1][1].abs().amax())),
                       qs)
    f32 = tb.sketch_histogram(xt, mn, mx, wt)
    assert not torch.equal(tb.sketch_histogram(xt[perm], mn, mx, wt[perm]), f32)
    deq = tb.dequantize_sketch(ref, qs)
    assert deq.dtype == torch.float32
    np.testing.assert_allclose(deq.numpy(), f32.numpy(), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("weighted", [None, "ones"])
def test_fixed_point_sketch_equals_f32_with_unit_weights(weighted):
    """With unit weights every bucket is an integer count below 2^24: the
    fixed-point sums, made f32, are the f32 sums bit for bit, so the card's
    main-path cuts equal the CPU's (and the JAX package's)."""
    x, _ = _data(5, n=20000)
    xt = torch.from_numpy(x)
    w = None if weighted is None else torch.ones(len(x))
    mn, mx = tb.feature_min_max(xt)
    q, qs = _fixed_sums(xt, w, len(x), mn, mx)
    f32 = tb.sketch_histogram(xt, mn, mx, w)
    deq = tb.dequantize_sketch(q, qs)
    assert np.array_equal(deq.numpy().view(np.int32), f32.numpy().view(np.int32))
    assert torch.equal(tb.cuts_from_sketch(mn, mx, deq, 256),
                       tb.cuts_from_sketch(mn, mx, f32, 256))
