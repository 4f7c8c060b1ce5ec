"""Parity of the port's depthwise grower with the JAX package's build_tree
on identical bins and gh (the JAX grower compiled, at world 1).

Tolerances: tree structure (feature, split_bin, default_left, is_leaf) is
bitwise; value / gain / cover / base_weight / threshold and the per-row leaf
values within 4 ulps (they are in practice bitwise: the plain kernels sum
in the reference's order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgboost_ray_tpu.ops import grow as jg
from xgboost_ray_tpu.ops.split import SplitParams as JSplit
from xgboost_ray_tpu_torch.ops import binning as tb
from xgboost_ray_tpu_torch.ops import grow as tg
from xgboost_ray_tpu_torch.ops.split import SplitParams as TSplit

STRUCT = ("feature", "split_bin", "default_left", "is_leaf")
VALUES = ("value", "gain", "cover", "base_weight", "threshold")


def _problem(seed, n=3000, f=6, max_bin=256, integer_gh=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.08] = np.nan
    bins, cuts, fhm = tb.sketch_and_bin(torch.from_numpy(x), None, max_bin)
    if integer_gh:
        gh = np.stack([rng.integers(-2, 3, n), rng.integers(1, 4, n)], 1)
    else:
        m = x[:, 0] * 1.5 - np.nan_to_num(x[:, 1]) + rng.standard_normal(n)
        p = 1.0 / (1.0 + np.exp(-m))
        y = (rng.random(n) < p).astype(np.float32)
        q = 1.0 / (1.0 + np.exp(-0.3 * m))
        gh = np.stack([q - y, np.maximum(q * (1 - q), 1e-16)], 1)
    return bins, cuts, fhm, gh.astype(np.float32)


def _both(bins, cuts, fhm, gh, max_depth=6, max_bin=256, sibling=True,
          **split):
    jcfg = jg.GrowConfig(max_depth=max_depth, max_bin=max_bin,
                         split=JSplit(**split), hist_impl="scatter",
                         sibling_subtract=sibling, shards_may_skew=False)
    jt, jrv = jax.jit(lambda b, g, c, f: jg.build_tree(
        b, g, c, jcfg, feat_has_missing=f))(
        jnp.asarray(bins.numpy()), jnp.asarray(gh), jnp.asarray(cuts.numpy()),
        jnp.asarray(fhm.numpy()))
    tcfg = tg.GrowConfig(max_depth=max_depth, max_bin=max_bin,
                         split=TSplit(**split), sibling_subtract=sibling)
    tt, trv = tg.build_tree(bins, torch.from_numpy(gh), cuts, tcfg,
                            feat_has_missing=fhm)
    return jt, jrv, tt, trv


def _assert_same_tree(jt, jrv, tt, trv):
    for name in STRUCT:
        assert np.array_equal(getattr(tt, name).numpy(),
                              np.asarray(getattr(jt, name))), name
    for name in VALUES:
        np.testing.assert_array_max_ulp(getattr(tt, name).numpy(),
                                        np.asarray(getattr(jt, name)), maxulp=4)
    np.testing.assert_array_max_ulp(trv.numpy(), np.asarray(jrv), maxulp=4)


@pytest.mark.parametrize("integer_gh", [True, False])
def test_build_tree_matches_jax(integer_gh):
    bins, cuts, fhm, gh = _problem(0, integer_gh=integer_gh)
    _assert_same_tree(*_both(bins, cuts, fhm, gh))


def test_build_tree_regularized_no_sibling_subtraction():
    bins, cuts, fhm, gh = _problem(1)
    _assert_same_tree(*_both(bins, cuts, fhm, gh, max_depth=4, sibling=False,
                             reg_lambda=2.0, reg_alpha=0.1, gamma=0.05,
                             min_child_weight=3.0, learning_rate=0.1))


def test_build_tree_uint8_bins_and_early_leaves():
    # max_bin 64 (uint8 bins) and a strong min_child_weight: nodes stop
    # splitting above the last level, so done rows ride the partition
    bins, cuts, fhm, gh = _problem(2, n=1200, max_bin=64)
    assert bins.dtype == torch.uint8
    jt, jrv, tt, trv = _both(bins, cuts, fhm, gh, max_bin=64,
                             min_child_weight=40.0)
    assert bool(np.asarray(jt.is_leaf)[:31].any())
    _assert_same_tree(jt, jrv, tt, trv)


def test_build_tree_depth6_sibling_regularized():
    # sibling subtraction on, with the L1 term, the max_delta_step clamp and
    # a gamma threshold: every record the level step writes, at depth 6
    bins, cuts, fhm, gh = _problem(3)
    _assert_same_tree(*_both(bins, cuts, fhm, gh, max_depth=6, sibling=True,
                             reg_alpha=0.2, max_delta_step=0.3, gamma=0.1,
                             learning_rate=0.2))
