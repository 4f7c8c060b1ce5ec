"""Parity of the port's random draws with the JAX package's, bit for bit:
threefry keys and streams (``ops/random.py``), the row sample of a tree
(``ops/sampling.sample_rows_plain``, what B12r selects), the feature masks
(``ops/grow.sample_feature_mask_plain``, B12f), K2's masked split search,
the margin update over T parallel trees (K4's T-tree add) and the sampling
parameters' checks.

Tolerance: bitwise everywhere (rows in ``top_k``'s order, gradients and
masks exactly, floats bit for bit). Inputs come from numpy seeds; the JAX
functions run compiled on the CPU as the JAX package's own tests run them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgboost_ray_tpu import params as jparams
from xgboost_ray_tpu.ops import grow as jg
from xgboost_ray_tpu.ops import sampling as jsm
from xgboost_ray_tpu.ops import split as js
from xgboost_ray_tpu_torch import params as tparams
from xgboost_ray_tpu_torch.ops import grow as tg
from xgboost_ray_tpu_torch.ops import metrics as tm
from xgboost_ray_tpu_torch.ops import objectives as to
from xgboost_ray_tpu_torch.ops import random as tr
from xgboost_ray_tpu_torch.ops import sampling as tsm
from xgboost_ray_tpu_torch.ops import split as ts


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _jkey(key):
    return jnp.asarray(np.array(key, np.uint32))


@pytest.mark.parametrize("seed", [0, 7, 42, 2 ** 31 - 1, 123456789])
def test_keys_match_jax(seed):
    jk = jax.random.PRNGKey(seed)
    assert tuple(int(v) for v in np.asarray(jk)) == tr.prng_key(seed)
    k = tr.prng_key(seed)
    for d in (0, 3, tg.SALT_SUBSAMPLE, tg.SALT_BYNODE, 2 ** 32 - 1):
        jk2 = jax.random.fold_in(jk, d)
        assert tuple(int(v) for v in np.asarray(jk2)) == tr.fold_in(k, d)
    # the engine's chain: round, tree, salt, block
    chain = tr.fold_in(tr.fold_in(tr.fold_in(tr.fold_in(k, 4), 1),
                                  tg.SALT_GOSS), 1)
    jchain = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(jk, 4), 1), jg.SALT_GOSS), 1)
    assert tuple(int(v) for v in np.asarray(jchain)) == chain
    assert (tg.SALT_SUBSAMPLE, tg.SALT_BYTREE, tg.SALT_BYLEVEL,
            tg.SALT_BYNODE, tg.SALT_GOSS) == (
        jg.SALT_SUBSAMPLE, jg.SALT_BYTREE, jg.SALT_BYLEVEL, jg.SALT_BYNODE,
        jg.SALT_GOSS)


@pytest.mark.parametrize("shape", [(1,), (1000,), (7, 33), (64, 300)])
@pytest.mark.parametrize("seed", [1, 99])
def test_streams_match_jax(shape, seed):
    key = tr.fold_in(tr.prng_key(seed), 0x51D1)
    jk = _jkey(key)
    assert np.array_equal(np.asarray(jax.random.bits(jk, shape)).astype(
        np.int64), tr.random_bits(key, shape).numpy())
    assert np.array_equal(_bits(jax.random.uniform(jk, shape)),
                          _bits(tr.uniform(key, shape).numpy()))
    tiny = float(np.finfo(np.float32).tiny)
    assert np.array_equal(
        _bits(jax.random.uniform(jk, shape, minval=tiny, maxval=1.0)),
        _bits(tr.uniform(key, shape, tiny, 1.0).numpy()))
    assert np.array_equal(_bits(jax.random.gumbel(jk, shape)),
                          _bits(tr.gumbel(key, shape).numpy()))


def test_bits_match_jax_past_two_to_the_23():
    """2^23 + 5 elements: the uniform floats' 2^23 values tie, and the
    counts' low word runs past 2^23."""
    key = tr.prng_key(17)
    n = (1 << 23) + 5
    got = tr.random_bits(key, n).numpy()
    ref = np.asarray(jax.random.bits(_jkey(key), (n,))).astype(np.int64)
    assert np.array_equal(got, ref)
    m = got >> 9
    assert len(np.unique(m)) < n  # ties among the uniform keys


def _gh(n, seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        g = rng.integers(-3, 4, n).astype(np.float32)
        h = np.ones(n, np.float32)
    else:
        g = rng.standard_normal(n).astype(np.float32)
        h = rng.uniform(0.0, 0.25, n).astype(np.float32)
    g[::11] = -0.0
    return np.stack([g, h], 1)


SAMPLE_CASES = {
    "uniform": (1000, 1000, ("uniform", 0.8, 0.2, 0.1), False),
    "uniform_padding": (999, 1000, ("uniform", 0.3, 0.2, 0.1), False),
    "uniform_all": (1000, 1001, ("uniform", 1.0, 0.2, 0.1), False),
    "uniform_one": (1, 1, ("uniform", 0.5, 0.2, 0.1), False),
    "goss": (5000, 5000, ("gradient_based", 1.0, 0.2, 0.1), False),
    "goss_ties": (4995, 5000, ("gradient_based", 1.0, 0.2, 0.1), True),
    "goss_small_pool": (7, 12, ("gradient_based", 1.0, 0.5, 0.5), False),
    "goss_pool_padding": (995, 1000, ("gradient_based", 1.0, 0.6, 0.4),
                          True),
    "goss_rand_only": (800, 800, ("gradient_based", 1.0, 0.0, 0.3), False),
}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_rows_matches_jax(case):
    """Rows in ``top_k``'s order and the gradients (with GOSS's
    amplification, zero on padding and filler slots) bitwise; the CPU
    wrapper is the plain version."""
    n_valid, n_slots, (policy, rate, top, other), ties = SAMPLE_CASES[case]
    gh = _gh(n_valid, n_slots, ties)
    ghp = np.zeros((n_slots, 2), np.float32)
    ghp[:n_valid] = gh
    valid = np.arange(n_slots) < n_valid
    spec = tsm.SamplingSpec(policy, rate, top, other)
    jspec = jsm.SamplingSpec(policy, rate, top, other)
    assert tsm.row_budget(n_slots, spec) == jsm.row_budget(n_slots, jspec)
    key = tr.fold_in(tr.fold_in(tr.prng_key(7), 3), tg.SALT_SUBSAMPLE)
    jr, jgh = jax.jit(lambda g, v, k: jsm.sample_rows(g, v, k, jspec))(
        ghp, valid, _jkey(key))
    for fn in (tsm.sample_rows_plain, tsm.sample_rows):
        rows, gsel = fn(torch.from_numpy(gh), n_slots, key, spec)
        assert rows.dtype == torch.int32
        assert np.array_equal(rows.numpy(), np.asarray(jr))
        assert np.array_equal(_bits(gsel.numpy()), _bits(jgh))
    rows, _ = tsm.sample_rows(torch.from_numpy(gh), n_slots, key, spec,
                              row_offset=40)
    assert np.array_equal(rows.numpy(), np.asarray(jr) + 40)


@pytest.mark.parametrize("f", [1, 5, 28, 300])
@pytest.mark.parametrize("rate", [0.1, 0.5, 0.8])
@pytest.mark.parametrize("batch", [None, 8])
@pytest.mark.parametrize("weights", [False, True])
def test_feature_mask_matches_jax(f, rate, batch, weights):
    rng = np.random.default_rng(f)
    log_fw = None
    if weights:
        fw = rng.random(f).astype(np.float32)
        fw[rng.random(f) < 0.25] = 0.0
        fw[0] = 0.5
        with np.errstate(divide="ignore"):
            log_fw = np.log(fw)
    key = tr.fold_in(tr.fold_in(tr.prng_key(3), f), tg.SALT_BYNODE)
    ref = np.asarray(jg.sample_feature_mask(
        _jkey(key), f, rate, None if log_fw is None else jnp.asarray(log_fw),
        batch))
    got = tg.sample_feature_mask(
        key, f, rate, None if log_fw is None else torch.from_numpy(log_fw),
        batch)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), ref)
    if weights:  # a zero weight is never drawn
        assert not got.numpy()[..., fw == 0].any()
    base = torch.from_numpy(rng.random(f) < 0.6)
    anded = tg.sample_feature_mask(
        key, f, rate, None if log_fw is None else torch.from_numpy(log_fw),
        batch, base)
    assert np.array_equal(anded.numpy(), ref & base.numpy())


def _hist(seed, n_nodes=6, f=5, nbt=257):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n_nodes, f, nbt)) * 3
    h = rng.uniform(0.0, 2.0, (n_nodes, f, nbt))
    return np.stack([g, h], -1).astype(np.float32)


@pytest.mark.parametrize("per_node", [False, True])
def test_find_splits_masked_matches_jax(per_node):
    """K2's masked search: a masked feature's candidates score -inf, the
    first maximum wins (a node with every feature masked takes candidate 0
    with gain -inf, invalid)."""
    hist = _hist(3)
    rng = np.random.default_rng(4)
    mask = rng.random((6, 5) if per_node else (5,)) < 0.5
    if per_node:
        mask[2] = False
    p = js.SplitParams(min_child_weight=0.5)

    @jax.jit
    def ref(h, m):
        return js.find_splits(h, h[:, 0, :, :].sum(axis=1), p, feature_mask=m)

    jsp = ref(jnp.asarray(hist), jnp.asarray(mask))
    tsp = ts.find_splits_plain(torch.from_numpy(hist),
                               ts.SplitParams(min_child_weight=0.5),
                               torch.from_numpy(mask))
    for name in ("gain", "feature", "split_bin", "default_left", "valid"):
        assert np.array_equal(_bits(getattr(tsp, name).numpy()),
                              _bits(getattr(jsp, name))), name
    allowed = mask if per_node else np.broadcast_to(mask, (6, 5))
    chosen = tsp.feature.numpy()
    ok = tsp.valid.numpy()
    assert allowed[np.arange(6), chosen][ok].all()


@pytest.mark.parametrize("t", [1, 2, 3, 7, 100])
def test_tree_values_add_matches_jax(t):
    """``add_tree_values`` (K4's T-tree add): the reference's
    ``margins.at[:, 0].add(row_value / t_par)`` tree by tree, compiled."""
    rng = np.random.default_rng(t)
    m = rng.standard_normal((4097, 1)).astype(np.float32)
    v = rng.standard_normal((t, 4097)).astype(np.float32)

    @jax.jit
    def ref(m, v):
        for i in range(t):
            m = m.at[:, 0].add(v[i] / t)
        return m

    got = torch.from_numpy(m[:, 0].copy())
    to.add_tree_values(got, torch.from_numpy(v))
    assert np.array_equal(_bits(got.numpy()), _bits(np.asarray(ref(m, v))[:, 0]))


SAMPLING_PARAMS = [
    {"subsample": 0.5},
    {"subsample": None, "sampling_method": None, "top_rate": None},
    {"sampling_method": "gradient_based", "subsample": 0.6},
    {"sampling_method": "gradient_based"},
    {"sampling_method": "gradient_based", "top_rate": 0.3, "other_rate": 0.2},
    {"sampling_method": "gradient_based", "top_rate": 0.0,
     "other_rate": 0.25},
    {"num_parallel_tree": 4, "colsample_bynode": 0.8,
     "colsample_bylevel": 0.6},
]


@pytest.mark.parametrize("kw", SAMPLING_PARAMS)
def test_sampling_params_match_jax(kw):
    fields = ("subsample", "sampling_method", "top_rate", "other_rate",
              "colsample_bytree", "colsample_bylevel", "colsample_bynode",
              "num_parallel_tree")
    j = jparams.parse_params(dict(kw))
    t = tparams.parse_params(dict(kw))
    assert [getattr(t, k) for k in fields] == [getattr(j, k) for k in fields]
    spec = tsm.spec_from_params(t)
    jspec = jsm.spec_from_params(j)
    assert (spec is None) == (jspec is None)
    if spec is not None:
        assert (spec.policy, spec.rate, spec.top_rate, spec.other_rate) == (
            jspec.policy, jspec.rate, jspec.top_rate, jspec.other_rate)


@pytest.mark.parametrize("kw,err", [
    ({"subsample": 0.0}, "subsample"),
    ({"subsample": 1.5}, "subsample"),
    ({"sampling_method": "nope"}, "sampling_method"),
    ({"sampling_method": "gradient_based", "subsample": 0.5,
      "top_rate": 0.2}, "ambiguous"),
    ({"sampling_method": "gradient_based", "top_rate": 0.7,
      "other_rate": 0.5}, "top_rate"),
])
def test_sampling_params_refused_as_jax(kw, err):
    for pkg in (jparams, tparams):
        with pytest.raises(ValueError, match=err):
            pkg.parse_params(dict(kw))


def test_error_thresholds_in_metric_order():
    names = ["error@0.7", "logloss", "error", "error@0.3", "error@0.7"]
    assert tm.error_thresholds(names) == (float(np.float32(0.7)),
                                          float(np.float32(0.3)))
    assert tm.k4_slot("error@0.7", names) == to.PARTIALS.index("error_t")
    assert tm.k4_slot("error@0.3", names) == to.PARTIALS.index("error_t2")
    assert tm.k4_slot("error", names) == to.PARTIALS.index("error")
    consts = tm.threshold_consts(names)
    assert consts["threshold2"] == float(np.float32(0.3))
    assert consts["threshold3"] == consts["threshold4"] == 0.5
