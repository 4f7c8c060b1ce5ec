"""The kernels of stochastic boosting and of the constraints against their
plain versions on a CUDA device: B12r (row selection,
``ops/sampling.sample_rows``), B12f (feature masks,
``ops/grow.sample_feature_mask``), K2's masked and constrained level steps
(the next level's monotone bounds, the final level's clamped leaf values),
the T-tree modes of the softmax pass and of K4's K-output kernel,
K4's T-tree add and extra ``error@t`` sums, and the softmax pass's column-0
logloss. Every test skips without a CUDA device (the kernels have no CPU
mode); run them on the card with ``python -m pytest
tests/test_torch_cuda_sampling.py -q --noconftest``.

Tolerances: B12r selects the plain version's rows exactly (compared as
sorted row lists, stage by stage: the kernel writes a stage's rows in row
order, the plain version in ``top_k``'s) and its gradients bitwise row by
row; B12f's masks, K2's every output and records, K4's and the softmax
pass's margins and gradients are bitwise; the metric sums within 1e-5
relative (f32 sums per CTA). Training with every sampling option on the
card gives the model of the CPU path that sums K1's histograms in the
card's fixed point, and reruns bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from xgboost_ray_tpu_torch.ops import grow as tg
from xgboost_ray_tpu_torch.ops import histogram as th
from xgboost_ray_tpu_torch.ops.metrics import threshold_consts
from xgboost_ray_tpu_torch.ops import objectives as to
from xgboost_ray_tpu_torch.ops import random as tr
from xgboost_ray_tpu_torch.ops import sampling as tsm
from xgboost_ray_tpu_torch.ops import split as ts


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    t = t.detach().cpu()
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _same_bits(a, b):
    return torch.equal(_bits(a), _bits(b))


def _gh(n, seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:  # integer g, h = 1: GOSS scores tie in large groups
        g = rng.integers(-3, 4, n).astype(np.float32)
        h = np.ones(n, np.float32)
    else:
        g = rng.standard_normal(n).astype(np.float32)
        h = rng.uniform(0.0, 0.25, n).astype(np.float32)
    return torch.from_numpy(np.stack([g, h], 1))


def _by_row(rows, gh):
    order = torch.argsort(rows.long().cpu(), stable=True)
    return rows.long().cpu()[order], _bits(gh.cpu()[order])


def _hold_rows(gh, n_slots, key, spec, offset=0):
    """B12r against ``sample_rows_plain`` on the same inputs, stage by
    stage (GOSS: the top rows, then the sampled ones)."""
    rp, gp = tsm.sample_rows(gh, n_slots, key, spec, row_offset=offset)
    rk, gk = tsm.sample_rows(gh.cuda(), n_slots, key, spec,
                             row_offset=offset)
    m = tsm.row_budget(n_slots, spec)
    assert rk.shape == (m,) and gk.shape == (m, 2)
    cut = (tsm.goss_counts(n_slots, spec)[0]
           if spec.policy == "gradient_based" else m)
    for sl in (slice(0, cut), slice(cut, m)):
        a, b = _by_row(rk[sl], gk[sl]), _by_row(rp[sl], gp[sl])
        assert torch.equal(a[0], b[0]), "rows"
        assert torch.equal(a[1], b[1]), "gh_sel"


@pytest.mark.parametrize("n_valid,n_slots", [
    (1, 1), (200, 255), (256, 256), (257, 257), (9_999, 10_000),
    (1 << 20, 1 << 20), (3_000_000, 3_000_001)])
@pytest.mark.parametrize("rate", [0.1, 0.8, 1.0])
def test_sample_rows_uniform_bitwise(cuda, n_valid, n_slots, rate):
    spec = tsm.SamplingSpec("uniform", rate=rate)
    key = tr.fold_in(tr.fold_in(tr.prng_key(7), n_slots), tg.SALT_SUBSAMPLE)
    _hold_rows(_gh(n_valid, n_slots), n_slots, key, spec, offset=5)


def test_sample_rows_uniform_ties_bitwise(cuda):
    """9,000,000 slots: the uniform keys have 2^23 values, so the k-th key
    is tied and the lower slots of the tie are taken."""
    spec = tsm.SamplingSpec("uniform", rate=0.37)
    key = tr.prng_key(11)
    keys = (tr.random_bits(key, 9_000_000) >> 9)
    kth = torch.sort(keys, descending=True).values[
        tsm.row_budget(9_000_000, spec) - 1]
    assert int((keys == kth).sum()) > 1
    _hold_rows(_gh(9_000_000, 3), 9_000_000, key, spec)


@pytest.mark.parametrize("n_valid,n_slots,top,other,ties", [
    (10_000, 10_000, 0.2, 0.1, False), (9_995, 10_000, 0.2, 0.1, True),
    (7, 12, 0.5, 0.5, False),  # the pool smaller than rand_n
    (995, 1000, 0.6, 0.4, True), (1 << 20, (1 << 20) + 3, 0.1, 0.05, True),
    (3_000_000, 3_000_000, 0.2, 0.1, False)])
def test_sample_rows_goss_bitwise(cuda, n_valid, n_slots, top, other, ties):
    spec = tsm.SamplingSpec("gradient_based", top_rate=top, other_rate=other)
    key = tr.fold_in(tr.prng_key(3), tg.SALT_GOSS)
    _hold_rows(_gh(n_valid, n_slots, ties), n_slots, key, spec)


def test_sample_rows_reruns_and_counts(cuda):
    spec = tsm.SamplingSpec("gradient_based", top_rate=0.2, other_rate=0.1)
    gh = _gh(50_000, 1).cuda()
    tsm.sample_rows.launches = 0
    a = tsm.sample_rows(gh, 50_000, (1, 2), spec)
    b = tsm.sample_rows(gh, 50_000, (1, 2), spec)
    assert tsm.sample_rows.launches == 4  # two stages a draw
    assert torch.equal(a[0], b[0]) and _same_bits(a[1], b[1])


@pytest.mark.parametrize("f", [1, 28, 54, 300, 2000])
@pytest.mark.parametrize("rate", [0.1, 0.5, 0.8])
@pytest.mark.parametrize("batch", [None, 64])
@pytest.mark.parametrize("weights", [False, True])
def test_feature_mask_bitwise(cuda, f, rate, batch, weights):
    rng = np.random.default_rng(f)
    log_fw = base = None
    if weights:
        fw = rng.random(f).astype(np.float32)
        fw[rng.random(f) < 0.25] = 0.0
        fw[0] = 0.5
        with np.errstate(divide="ignore"):
            log_fw = torch.from_numpy(np.log(fw))
    if f > 1:
        base = torch.from_numpy(rng.random(f) < 0.7)
    key = tr.fold_in(tr.fold_in(tr.prng_key(5), f), tg.SALT_BYNODE)
    for b in (None, base):
        mp = tg.sample_feature_mask(key, f, rate, log_fw, batch, b)
        mk = tg.sample_feature_mask(
            key, f, rate, None if log_fw is None else log_fw.cuda(), batch,
            None if b is None else b.cuda(), device=cuda)
        assert mk.dtype == torch.bool and torch.equal(mk.cpu(), mp)


def _level_inputs(n, f, max_bin, n_par, seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, max_bin + 1, (n, f))
    bins = torch.from_numpy(bins.astype(np.uint8 if max_bin < 256
                                        else np.int16))
    gh = torch.from_numpy(np.stack([rng.integers(-3, 4, n),
                                    rng.integers(1, 5, n)], 1)
                          .astype(np.float32))
    pos = rng.integers(0, n_par, n)
    order = torch.from_numpy(np.argsort(pos, kind="stable").astype(np.int32))
    seg = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(pos, minlength=n_par))]).astype(np.int32))
    nbt = max_bin + 1
    prev, _ = th.build_histogram_plain(bins, gh, order, seg, n_par, nbt)
    keep = torch.from_numpy(rng.random(n) < 0.4)
    small, _ = th.build_histogram_plain(bins, gh * keep[:, None].float(),
                                        order, seg, n_par, nbt)
    sir = torch.from_numpy(rng.random(n_par) < 0.5)
    active = torch.from_numpy(rng.random(2 * n_par) < 0.8)
    return small, prev, sir, active


@pytest.mark.parametrize("n,f,max_bin,n_par", [
    (5000, 7, 256, 2), (70000, 28, 256, 16), (20000, 33, 255, 4),
    (6000, 75, 256, 1)])
@pytest.mark.parametrize("per_node", [False, True])
def test_split_level_masked_bitwise(cuda, n, f, max_bin, n_par, per_node):
    small, prev, sir, active = _level_inputs(n, f, max_bin, n_par, seed=f)
    n_nodes = 2 * n_par
    rng = np.random.default_rng(n)
    cuts = torch.from_numpy(
        np.sort(rng.standard_normal((f, max_bin - 1)), 1).astype(np.float32))
    shape = (n_nodes, f) if per_node else (f,)
    mask = torch.from_numpy(rng.random(shape) < 0.5)
    if per_node:
        mask[0] = False  # a node with no feature: every gain -inf
    p = ts.SplitParams(min_child_weight=2.0)
    heap = 2 * n_nodes + 1
    tree_p, tree_k = tg.empty_tree(heap, "cpu"), tg.empty_tree(heap, cuda)
    ts.split_level.launches_masked = 0
    sp = ts.split_level(small, prev, sir, active,
                        ts.TreeRecords(tree_p, cuts, None, p),
                        feature_mask=mask)
    sk = ts.split_level(small.to(cuda), prev.to(cuda), sir.to(cuda),
                        active.to(cuda),
                        ts.TreeRecords(tree_k, cuts.to(cuda), None, p),
                        feature_mask=mask.to(cuda))
    assert ts.split_level.launches_masked == 1
    for name in sp.splits._fields:
        assert _same_bits(getattr(sk.splits, name),
                          getattr(sp.splits, name)), name
    for name in ("node_value", "state", "active", "hist"):
        assert _same_bits(getattr(sk, name), getattr(sp, name)), name
    for name in tg.Tree._fields:
        assert _same_bits(getattr(tree_k, name), getattr(tree_p, name)), name


def _k4_rows(n, t, seed):
    rng = np.random.default_rng(seed)
    m = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    rv = torch.from_numpy(rng.standard_normal((t, n)).astype(np.float32))
    y = torch.from_numpy((rng.random(n) < 0.4).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
    return m, rv, y, w


@pytest.mark.parametrize("n", [1, 2049, 500_001])
@pytest.mark.parametrize("t", [1, 2, 3, 100])
@pytest.mark.parametrize("with_gh", [True, False])
def test_k4_tree_add_bitwise(cuda, n, t, with_gh):
    """K4 over a round's T parallel trees and a run's three error@t
    thresholds: margins (and gradients) bitwise the plain version's, sums
    within 1e-5 relative."""
    m, rv, y, w = _k4_rows(n, t, n + t)
    metrics = ["logloss", "error@0.3", "error@0.7", "error@0.9"]
    obj = to.get_objective(to.LOGISTIC)
    obj = dataclasses.replace(obj, consts=obj.consts._replace(
        **threshold_consts(metrics)))
    rvt = rv if t > 1 else rv[0]
    mp = m.clone()
    ghp, sp = to.round_update(mp, rvt, y, w, obj, with_gh=with_gh,
                              metrics=metrics)
    mk = m.cuda()
    to.round_update.tree_launches = 0
    ghk, sk = to.round_update(mk, rvt.cuda(), y.cuda(), w.cuda(), obj,
                              with_gh=with_gh, metrics=metrics)
    assert to.round_update.tree_launches == (1 if t > 1 else 0)
    assert _same_bits(mk, mp)
    if with_gh:
        assert _same_bits(ghk, ghp)
    np.testing.assert_allclose(sk.cpu().numpy(), sp.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("k", [3, 7, 40])
@pytest.mark.parametrize("with_gh", [True, False])
def test_softmax_column0_logloss(cuda, k, with_gh):
    rng = np.random.default_rng(k)
    n = 70_001
    m = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    rv = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, k, n).astype(np.float32))
    w = torch.ones(n)
    mp, mk = m.clone(), m.cuda()
    ghp, sp = to.softmax_update(mp, rv, y, w, with_gh, logloss0=True)
    ghk, sk = to.softmax_update(mk, rv.cuda(), y.cuda(), w.cuda(), with_gh,
                                logloss0=True)
    assert sk.shape == sp.shape == (4,)
    assert _same_bits(mk, mp)
    if with_gh:
        assert _same_bits(ghk, ghp)
    np.testing.assert_allclose(sk.cpu().numpy(), sp.numpy(), rtol=1e-5)


SAMPLED = {
    "uniform": dict(subsample=0.8, colsample_bytree=0.8,
                    colsample_bynode=0.8,
                    eval_metric=["logloss", "error@0.3", "error@0.7", "auc"]),
    "goss": dict(sampling_method="gradient_based", top_rate=0.2,
                 other_rate=0.1, colsample_bylevel=0.7),
    "weights": dict(colsample_bynode=0.5, colsample_bytree=0.9),
    "forest": dict(subsample=0.8, colsample_bynode=0.8, num_parallel_tree=6,
                   learning_rate=1.0, reg_lambda=1e-5),
}


@pytest.mark.parametrize("name", list(SAMPLED))
def test_sampled_training_on_card(cuda, name, monkeypatch):
    """train() with each sampling option on the card reruns bit for bit and
    equals the CPU path summing K1's histograms in the card's fixed point
    (dumps equal, history within 1e-6); a feature of weight 0 is never
    split on."""
    import xgboost_ray_tpu_torch as tx
    from xgboost_ray_tpu_torch import engine as E
    from xgboost_ray_tpu_torch.ops import grow as G

    rng = np.random.default_rng(0)
    n, f = 30_001, 9
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] + rng.standard_normal(n) > 0).astype(
        np.float32)
    fw = None
    if name == "weights":
        fw = rng.random(f).astype(np.float32)
        fw[[2, 5]] = 0.0
    params = {"objective": "binary:logistic", "max_depth": 5, "seed": 3,
              **SAMPLED[name]}

    def run(device):
        dm = tx.RayDMatrix(x, y, feature_weights=fw)
        ev = {}
        bst = tx.train(params, dm, 4, evals=[(dm, "train")], evals_result=ev,
                       ray_params=tx.RayParams(num_actors=2), device=device)
        return bst, ev

    E.reset_kernel_launches()
    bk, evk = run("cuda")
    launches = E.kernel_launches()
    bk2, _ = run("cuda")
    assert bk.get_dump(with_stats=True) == bk2.get_dump(with_stats=True)
    if name != "weights":
        assert launches["B12r"] > 0
    if name != "forest":
        assert launches["B12f"] > 0 and launches["K2masked"] > 0
    else:
        assert launches["K4trees"] > 0

    def fixed(bins, gh, rows, seg, n_nodes, nbt, with_hist=True, qscale=None):
        return th.build_histogram_fixed_plain(bins, gh, rows, seg, n_nodes,
                                              nbt, qscale, with_hist)

    monkeypatch.setattr(G, "build_histogram", fixed)
    monkeypatch.setattr(G, "dequantize", th.dequantize_plain)
    monkeypatch.setattr(E.TorchEngine, "_scales", lambda e: th.quant_scales(
        e.gh, e.n_global, e.coll.max))
    monkeypatch.setattr(E.TorchEngine, "_tree_scales", lambda e, g:
                        th.quant_scales(g, e.sample_rows_global, e.coll.max))
    bc, evc = run("cpu")
    assert bk.get_dump(with_stats=True) == bc.get_dump(with_stats=True)
    for m in evc["train"]:
        np.testing.assert_allclose(evk["train"][m], evc["train"][m],
                                   rtol=1e-6, atol=1e-6)
    if fw is not None:
        used = set(np.asarray(bk.forest.feature).ravel().tolist())
        assert not used & {2, 5}


# --------------------------------------------------------------------------
# K2's constrained level step and the K-output T-tree modes
# --------------------------------------------------------------------------


def _ancestors(tree, level, f, rng):
    """Split features of the levels above ``level`` (a fifth of them -1:
    leaves, whose descendants K2 still scores)."""
    top = (1 << level) - 1
    feat = rng.integers(0, f, top)
    feat[rng.random(top) < 0.2] = -1
    tree.feature[:top] = torch.from_numpy(feat.astype(np.int32))


def _level_bounds(n_nodes, kind, rng):
    if kind == "inf":
        return (torch.full((n_nodes,), float("-inf")),
                torch.full((n_nodes,), float("inf")))
    lo = (rng.standard_normal(n_nodes) * 0.2 - 0.1).astype(np.float32)
    hi = (lo + np.abs(rng.standard_normal(n_nodes)) * 0.3).astype(np.float32)
    if n_nodes > 2:  # crossing and (finite) equal intervals
        lo[2], hi[2] = 0.2, -0.2
        hi[-1] = lo[-1]
    # one-sided intervals; never both ends the same infinity, which no
    # grower makes (the children's bounds are finite midpoints) and where
    # every weight is infinite and every gain NaN (jnp.argmax then takes
    # the first NaN, the kernel's election keeps -inf)
    lo[::3] = -np.inf
    hi[1::4] = np.inf
    return torch.from_numpy(lo), torch.from_numpy(hi)


@pytest.mark.parametrize("f", [28, 33, 75])
@pytest.mark.parametrize("level", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bounds", ["inf", "crossing"])
def test_split_level_constrained_bitwise(cuda, f, level, masked, bounds):
    """K2's constrained instantiations (monotone signs and 40 interaction
    groups, unmasked and under a node mask) against the plain level step:
    every output, the records, the next level's bounds bitwise; the final
    level's leaf records under the bounds too."""
    rng = np.random.default_rng(100 * f + 10 * level + masked)
    n_nodes = 1 << level
    if level:
        small, prev, sir, active = _level_inputs(
            6000 + 3000 * n_nodes, f, 256, n_nodes // 2, seed=f + level)
    else:
        small, _, _, _ = _level_inputs(6000, f, 256, 1, seed=f)
        prev = sir = None
        active = torch.ones(1, dtype=torch.bool)
    cuts = torch.from_numpy(
        np.sort(rng.standard_normal((f, 255)), 1).astype(np.float32))
    mono = tuple(int(c) for c in rng.choice([-1, 0, 0, 1], f))
    groups = tuple(tuple(sorted(set(rng.choice(f, rng.integers(1, 6)))))
                   for _ in range(40))
    # reg_alpha 0 with max_delta_step on: the children's other fma order
    p = ts.SplitParams(min_child_weight=2.0, reg_alpha=0.0,
                       max_delta_step=0.5 if level % 2 else 0.0)
    heap = (2 << level) - 1
    tree_p = tg.empty_tree(heap, "cpu")
    _ancestors(tree_p, level, f, rng)
    tree_k = tg.Tree(*[t.to(cuda) for t in tree_p])
    lo, hi = _level_bounds(n_nodes, bounds, rng)
    mask = (torch.from_numpy(rng.random((n_nodes, f)) < 0.6)
            if masked else None)
    cons_p = ts.TreeConstraints(mono, groups, f, "cpu")
    cons_k = ts.TreeConstraints(mono, groups, f, cuda)
    sp = ts.split_level(small, prev, sir, active,
                        ts.TreeRecords(tree_p, cuts, None, p, cons_p),
                        feature_mask=mask, bounds=(lo, hi))
    ts.split_level.launches_constrained = 0
    ts.split_level.launches_masked = 0
    dev = [None if t is None else t.to(cuda)
           for t in (small, prev, sir, active, mask, lo, hi)]
    sk = ts.split_level(*dev[:4],
                        ts.TreeRecords(tree_k, cuts.to(cuda), None, p,
                                       cons_k),
                        feature_mask=dev[4], bounds=(dev[5], dev[6]))
    assert ts.split_level.launches_constrained == 1
    assert ts.split_level.launches_masked == int(masked)
    for name in sp.splits._fields:
        assert _same_bits(getattr(sk.splits, name),
                          getattr(sp.splits, name)), name
    for name in ("node_value", "state", "active", "hist"):
        assert _same_bits(getattr(sk, name), getattr(sp, name)), name
    for a, b in zip(sk.bounds, sp.bounds):
        assert _same_bits(a, b)
    for name in tg.Tree._fields:
        assert _same_bits(getattr(tree_k, name), getattr(tree_p, name)), name
    # the next level as a final one: leaf values clamped to its bounds
    gh = torch.from_numpy(np.stack([rng.standard_normal(2 * n_nodes),
                                    rng.uniform(0, 3, 2 * n_nodes)], 1)
                          .astype(np.float32))
    big = tg.empty_tree((4 << level) - 1, "cpu")
    big_k = tg.empty_tree((4 << level) - 1, cuda)
    vp = ts.leaf_records(gh, sp.active,
                         ts.TreeRecords(big, cuts, None, p, cons_p),
                         sp.bounds)
    vk = ts.leaf_records(gh.to(cuda), sk.active,
                         ts.TreeRecords(big_k, cuts.to(cuda), None, p,
                                        cons_k), sk.bounds)
    for a, b in zip(vk, vp):
        assert _same_bits(a, b)
    for name in tg.Tree._fields:
        assert _same_bits(getattr(big_k, name), getattr(big, name)), name


@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("n", [8192, 70_001])
@pytest.mark.parametrize("with_gh", [True, False])
def test_softmax_tree_add_bitwise(cuda, k, t, n, with_gh):
    """The softmax pass over a round's K x T trees: margins and gradients
    bitwise the plain version's, sums within 1e-5 relative."""
    rng = np.random.default_rng(k * t + n)
    m = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    rv = torch.from_numpy(rng.standard_normal((k * t, n)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, k, n).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
    mp, mk = m.clone(), m.cuda()
    ghp, sp = to.softmax_update(mp, rv, y, w, with_gh)
    to.softmax_update.tree_launches = 0
    ghk, sk = to.softmax_update(mk, rv.cuda(), y.cuda(), w.cuda(), with_gh)
    assert to.softmax_update.tree_launches == 1
    assert _same_bits(mk, mp)
    if with_gh:
        assert _same_bits(ghk, ghp)
    np.testing.assert_allclose(sk.cpu().numpy(), sp.numpy(), rtol=1e-5)


@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("n", [8192, 70_001])
@pytest.mark.parametrize("with_gh", [True, False])
def test_quantile_tree_add_bitwise(cuda, k, t, n, with_gh):
    """K4's K-output kernel over a round's K x T trees (K alphas): margins
    and gradients bitwise the plain version's, sums within 1e-5
    relative."""
    rng = np.random.default_rng(k * t + n + 1)
    obj = to.get_objective("reg:quantileerror",
                           quantile_alpha=[float(a) for a in
                                           np.linspace(0.1, 0.9, k)])
    m = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    rv = torch.from_numpy(rng.standard_normal((k * t, n)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
    metrics = ["quantile"]
    mp, mk = m.clone(), m.cuda()
    ghp, sp = to.round_update_multi(mp, rv, y, w, obj, with_gh, metrics)
    to.round_update.tree_launches = 0
    ghk, sk = to.round_update_multi(mk, rv.cuda(), y.cuda(), w.cuda(), obj,
                                    with_gh, metrics)
    assert to.round_update.tree_launches == 1
    assert _same_bits(mk, mp)
    if with_gh:
        assert _same_bits(ghk, ghp)
    np.testing.assert_allclose(sk.cpu().numpy(), sp.numpy(), rtol=1e-5,
                               atol=1e-6)


CONSTRAINED = {
    "monotone": dict(monotone_constraints="(1,-1,0,1,0,0,-1)"),
    "interaction": dict(interaction_constraints=[[0, 1], [2, 3, 4],
                                                 [1, 5, 6, 7, 8]]),
    "both_masked": dict(monotone_constraints=(1, 0, -1),
                        interaction_constraints=[[0, 1], [2, 3, 4],
                                                 [1, 5, 6, 7, 8]],
                        colsample_bynode=0.8, subsample=0.8),
    "softprob_forest": dict(objective="multi:softprob", num_class=3,
                            num_parallel_tree=3, subsample=0.8,
                            monotone_constraints="(1,0,-1)"),
    "quantile_forest": dict(objective="reg:quantileerror",
                            quantile_alpha=[0.1, 0.5, 0.9],
                            num_parallel_tree=2),
}


@pytest.mark.parametrize("name", list(CONSTRAINED))
def test_constrained_training_on_card(cuda, name, monkeypatch):
    """train() with constraints, and with parallel trees of K outputs, on
    the card reruns bit for bit and equals the CPU path summing K1's
    histograms in the card's fixed point (dumps equal, history within
    1e-6)."""
    import xgboost_ray_tpu_torch as tx
    from xgboost_ray_tpu_torch import engine as E
    from xgboost_ray_tpu_torch.ops import grow as G

    rng = np.random.default_rng(1)
    n, f = 30_001, 9
    x = rng.standard_normal((n, f)).astype(np.float32)
    lin = x[:, 0] + 0.5 * x[:, 1] - 0.3 * x[:, 6]
    y = (lin + rng.standard_normal(n) > 0).astype(np.float32)
    params = {"objective": "binary:logistic", "max_depth": 5, "seed": 3,
              **CONSTRAINED[name]}
    if params["objective"] == "multi:softprob":
        y = np.clip(np.round(lin + 1.0), 0, 2).astype(np.float32)
    if params["objective"] == "reg:quantileerror":
        y = (lin + rng.standard_normal(n)).astype(np.float32)

    def run(device):
        dm = tx.RayDMatrix(x, y)
        ev = {}
        bst = tx.train(params, dm, 3, evals=[(dm, "train")], evals_result=ev,
                       ray_params=tx.RayParams(num_actors=2), device=device)
        return bst, ev

    E.reset_kernel_launches()
    bk, evk = run("cuda")
    launches = E.kernel_launches()
    bk2, _ = run("cuda")
    assert bk.get_dump(with_stats=True) == bk2.get_dump(with_stats=True)
    constrained = "monotone_constraints" in params or (
        "interaction_constraints" in params)
    assert (launches["K2cons"] > 0) == constrained
    if params.get("num_parallel_tree", 1) > 1:
        key = "SMXtrees" if name.startswith("softprob") else "K4trees"
        assert launches[key] == 3

    def fixed(bins, gh, rows, seg, n_nodes, nbt, with_hist=True, qscale=None):
        return th.build_histogram_fixed_plain(bins, gh, rows, seg, n_nodes,
                                              nbt, qscale, with_hist)

    monkeypatch.setattr(G, "build_histogram", fixed)
    monkeypatch.setattr(G, "dequantize", th.dequantize_plain)
    monkeypatch.setattr(E.TorchEngine, "_scales", lambda e: th.quant_scales(
        e.gh, e.n_global, e.coll.max))
    monkeypatch.setattr(E.TorchEngine, "_tree_scales", lambda e, g:
                        th.quant_scales(g, e.sample_rows_global, e.coll.max))
    bc, evc = run("cpu")
    assert bk.get_dump(with_stats=True) == bc.get_dump(with_stats=True)
    for m in evc["train"]:
        np.testing.assert_allclose(evk["train"][m], evc["train"][m],
                                   rtol=1e-6, atol=1e-6)
