"""The port's hand-written kernels against their plain versions on a CUDA
device, at shapes off the main path (feature tiles, uint8 bins, 1024 bins,
few bins, empty nodes). Every test skips without a CUDA device; run them on
the card with ``python -m pytest tests/test_torch_cuda.py -q``.

Tolerances: K1 sums in fixed point, so its int64 histogram and totals and
their dequantised f32 values are bitwise equal to
``build_histogram_fixed_plain``'s, with integer and random gh alike; with
integer-valued gh every sum is exact, so K1's dequantised output also
equals the f32 plain sums and K2 is bitwise (K2's level step on every
output, its records and the formed
histogram included, and its final-level records on random totals); K3's
outputs, in both modes and with the smaller children chosen from merged
counts, are integers and copies (bitwise); K4's gradients
within 1e-6 and its metric sums within 1e-5 relative; whole trees grown on
the card and on the CPU from integer gh are bitwise on every field; B8's
leaf indices, margins and values (every mapping and option: base, tree
weights, ntree_limit, num_parallel_tree, K = 3, a categorical feature, NaN,
both layouts) are bitwise equal to the plain version's (values: a NaN
matches any NaN, whose payload differs between CPU and card). Training on
the card reruns bit for bit, and a 2-rank gloo world on one card gives the
1-rank model and margins bit for bit.
"""

import numpy as np
import pytest
import torch

from xgboost_ray_tpu_torch.ops import grow as tg
from xgboost_ray_tpu_torch.ops import histogram as th
from xgboost_ray_tpu_torch.ops import objectives as to
from xgboost_ray_tpu_torch.ops import predict as tp
from xgboost_ray_tpu_torch.ops import split as ts


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _level(n, f, max_bin, n_nodes, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, max_bin + 1, (n, f))
    bins = bins.astype(np.uint8 if max_bin + 1 <= 256 else np.int16)
    gh = np.stack([rng.integers(-3, 4, n), rng.integers(1, 5, n)], 1)
    pos = rng.integers(0, n_nodes, n)
    if n_nodes > 2:
        pos[pos == 1] = 0  # an empty node
    order = np.argsort(pos, kind="stable").astype(np.int32)
    seg = np.concatenate([[0], np.cumsum(np.bincount(pos, minlength=n_nodes))])
    return [torch.from_numpy(a) for a in
            (bins, gh.astype(np.float32), order, seg.astype(np.int32))]


SHAPES = [(5000, 7, 256, 4), (3000, 60, 64, 3), (2000, 5, 1024, 8),
          (4000, 3, 16, 1), (70000, 28, 256, 32),
          # K1 takes at most 32 features per CTA: F = 33 is two feature
          # tiles (17 + 16), F = 75 three of 25; F = 7 with uint8 bins has
          # rows 7 bytes wide, unaligned
          (20000, 33, 255, 4), (30000, 7, 200, 5), (6000, 75, 256, 3)]


def _k1_against_fixed_plain(cpu, dev, n_nodes, nbt):
    """K1 (raw int64 and dequantised by the kernel) against the fixed-point
    plain version, bitwise; returns the card's dequantised hist, totals."""
    qs = th.quant_scales(dev[1], dev[1].shape[0])
    hk, tk = th.build_histogram(*dev, n_nodes, nbt, qscale=qs)
    hq, tq = th.build_histogram_fixed_plain(*cpu, n_nodes, nbt, qs.cpu())
    assert hk.dtype == tk.dtype == torch.int64
    assert torch.equal(hk.cpu(), hq) and torch.equal(tk.cpu(), tq)
    _, tk2 = th.build_histogram(*dev, n_nodes, nbt, with_hist=False,
                                qscale=qs)
    assert torch.equal(tk2.cpu(), tq)
    dk, dtk = th.dequantize(hk, qs), th.dequantize(tk, qs)
    assert _same_bits(dk, th.dequantize_plain(hq, qs.cpu()))
    assert _same_bits(dtk, th.dequantize_plain(tq, qs.cpu()))
    return dk, dtk


@pytest.mark.parametrize("n,f,max_bin,n_nodes", SHAPES)
def test_histogram_and_split_bitwise(cuda, n, f, max_bin, n_nodes):
    cpu = _level(n, f, max_bin, n_nodes)
    dev = [t.to(cuda) for t in cpu]
    nbt = max_bin + 1
    hk, tk = _k1_against_fixed_plain(cpu, dev, n_nodes, nbt)
    # integer gh: the dequantised sums are exact, the f32 plain sums too
    hp, tp = th.build_histogram_plain(*cpu, n_nodes, nbt)
    assert torch.equal(hk.cpu(), hp) and torch.equal(tk.cpu(), tp)
    p = ts.SplitParams(min_child_weight=2.0)
    sk = ts.find_splits(hk, p)
    sp = ts.find_splits_plain(hp, p)
    for name in sp._fields:
        assert torch.equal(getattr(sk, name).cpu(), getattr(sp, name)), name


@pytest.mark.parametrize("dtype", [torch.int16, torch.uint8])
def test_histogram_root_identity_order(cuda, dtype):
    """K1's heaviest launch on the main path: one node, rows in id order."""
    n, f, nbt = 300000, 28, 257 if dtype == torch.int16 else 256
    rng = np.random.default_rng(5)
    bins = torch.from_numpy(rng.integers(0, nbt, (n, f))).to(dtype)
    gh = torch.from_numpy(np.stack([rng.integers(-3, 4, n),
                                    rng.integers(1, 5, n)], 1).astype(np.float32))
    order = torch.arange(n, dtype=torch.int32)
    seg = torch.tensor([0, n], dtype=torch.int32)
    cpu = [bins, gh, order, seg]
    hk, tk = _k1_against_fixed_plain(cpu, [t.to(cuda) for t in cpu], 1, nbt)
    hp, tp = th.build_histogram_plain(bins, gh, order, seg, 1, nbt)
    assert torch.equal(hk.cpu(), hp) and torch.equal(tk.cpu(), tp)


@pytest.mark.parametrize("n,f,max_bin,n_nodes", SHAPES)
def test_histogram_fixed_point_random_gh_bitwise(cuda, n, f, max_bin, n_nodes):
    """Random gh over a wide range of magnitudes: K1's int64 sums and their
    dequantised values bitwise equal to the fixed-point plain version's,
    and within 1e-5 x sum |v| of the f32 plain sums."""
    bins, _, order, seg = _level(n, f, max_bin, n_nodes, seed=3)
    rng = np.random.default_rng(4)
    gh = np.stack([rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n)),
                   rng.uniform(0.0, 0.25, n)], 1).astype(np.float32)
    cpu = [bins, torch.from_numpy(gh), order, seg]
    hk, tk = _k1_against_fixed_plain(cpu, [t.to(cuda) for t in cpu],
                                     n_nodes, max_bin + 1)
    hp, tp = th.build_histogram_plain(*cpu, n_nodes, max_bin + 1)
    habs, tabs = th.build_histogram_plain(bins, cpu[1].abs(), order, seg,
                                          n_nodes, max_bin + 1)
    assert bool(((hk.cpu() - hp).abs() <= 1e-5 * habs).all())
    assert bool(((tk.cpu() - tp).abs() <= 1e-5 * tabs).all())


@pytest.mark.parametrize("n,f,max_bin,n_nodes", SHAPES)
def test_partition_bitwise(cuda, n, f, max_bin, n_nodes):
    bins, _, order, seg = _level(n, f, max_bin, n_nodes, seed=1)
    rng = np.random.default_rng(2)
    feature = torch.from_numpy(rng.integers(0, f, n_nodes).astype(np.int32))
    sbin = torch.from_numpy(rng.integers(0, max_bin - 1, n_nodes).astype(np.int32))
    dl = torch.from_numpy(rng.random(n_nodes) < 0.5)
    state = torch.from_numpy(rng.integers(0, 3, n_nodes).astype(np.uint8))
    nval = torch.from_numpy(rng.standard_normal(n_nodes).astype(np.float32))
    def other_rank(c):  # merged with a rank holding twice the siblings
        return c + 2 * c.view(-1, 2).flip(1).reshape(-1)

    for write_small, merge in ((True, None), (False, None),
                               (True, other_rank)):
        rv_p = torch.zeros(n)
        rv_k = torch.zeros(n, device=cuda)
        pp = th.partition_level(order, seg, bins, feature, sbin, dl, state,
                                nval, rv_p, write_small, max_bin,
                                merge_counts=merge)
        pk = th.partition_level(*(t.to(cuda) for t in (
            order, seg, bins, feature, sbin, dl, state, nval)), rv_k,
            write_small, max_bin, merge_counts=merge)
        m = int(pp.small_seg[-1])
        if merge is not None:
            assert pk.small_rows.shape == (n,)
        assert torch.equal(pk.order.cpu(), pp.order)
        assert torch.equal(pk.seg.cpu(), pp.seg)
        assert torch.equal(pk.small_seg.cpu(), pp.small_seg)
        assert torch.equal(pk.small_is_right.cpu(), pp.small_is_right)
        if write_small:
            assert torch.equal(pk.small_rows[:m].cpu(), pp.small_rows[:m])
        assert torch.equal(rv_k.cpu(), rv_p)


@pytest.mark.parametrize("n,n_nodes", [(50001, 64), (3000, 8), (7, 2)])
def test_partition_leaf_values_bitwise(cuda, n, n_nodes):
    _, _, order, seg = _level(n, 3, 16, n_nodes, seed=6)
    rng = np.random.default_rng(7)
    state = torch.from_numpy(np.where(rng.random(n_nodes) < 0.8, th.LEAF,
                                      th.INACTIVE).astype(np.uint8))
    nval = torch.from_numpy(rng.standard_normal(n_nodes).astype(np.float32))
    rv_p = torch.full((n,), 3.0)
    rv_k = rv_p.to(cuda)
    th.partition_leaf_values(order, seg, state, nval, rv_p)
    th.partition_leaf_values(*(t.to(cuda) for t in (order, seg, state, nval)),
                             rv_k)
    assert torch.equal(rv_k.cpu(), rv_p)


@pytest.mark.parametrize("logistic", [True, False])
def test_round_update(cuda, logistic):
    rng = np.random.default_rng(3)
    n = 100003
    m = torch.from_numpy((rng.standard_normal(n) * 4).astype(np.float32))
    rv = torch.from_numpy((rng.standard_normal(n) * 0.2).astype(np.float32))
    y = torch.from_numpy((rng.random(n) > 0.5).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 2, n).astype(np.float32))
    mp = m.clone()
    ghp, sp = to.round_update(mp, rv, y, w, logistic, 1.5)
    mk = m.to(cuda)
    ghk, sk = to.round_update(mk, rv.to(cuda), y.to(cuda), w.to(cuda),
                              logistic, 1.5)
    assert torch.equal(mk.cpu(), mp)
    assert float((ghk.cpu() - ghp).abs().max()) <= 1e-6
    assert torch.allclose(sk.cpu(), sp, rtol=1e-5, atol=0)


def _bits(t):
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_bits(a, b):
    return torch.equal(_bits(a), _bits(b))


def _level_step_inputs(n, f, max_bin, n_par, sibling, seed):
    """Integer-gh histograms of a level: with ``sibling``, the n_par
    parents' (prev) and a row subset of each (the smaller children), else
    the level's own n_par nodes; small_is_right, active (some inactive)."""
    bins, gh, order, seg = _level(n, f, max_bin, n_par, seed=seed)
    nbt = max_bin + 1
    prev, _ = th.build_histogram_plain(bins, gh, order, seg, n_par, nbt)
    rng = np.random.default_rng(seed + 100)
    if not sibling:
        active = torch.from_numpy(rng.random(n_par) < 0.8)
        return prev, None, None, active
    keep = torch.from_numpy(rng.random(n) < 0.4)
    gh_small = gh * keep[:, None].float()
    small, _ = th.build_histogram_plain(bins, gh_small, order, seg, n_par, nbt)
    sir = torch.from_numpy(rng.random(n_par) < 0.5)
    active = torch.from_numpy(rng.random(2 * n_par) < 0.8)
    return small, prev, sir, active


@pytest.mark.parametrize("sibling", [True, False])
@pytest.mark.parametrize("n,f,max_bin,n_nodes", SHAPES)
def test_split_level_bitwise(cuda, n, f, max_bin, n_nodes, sibling):
    hist, prev, sir, active = _level_step_inputs(n, f, max_bin, n_nodes,
                                                 sibling, seed=9)
    rng = np.random.default_rng(10)
    cuts = torch.from_numpy(
        np.sort(rng.standard_normal((f, max_bin - 1)), 1).astype(np.float32))
    fhm_mixed = torch.from_numpy(rng.random(f) < 0.5)
    params = (ts.SplitParams(min_child_weight=2.0),
              ts.SplitParams(reg_lambda=0.5, reg_alpha=0.7, gamma=1.5,
                             min_child_weight=3.0, max_delta_step=0.5,
                             learning_rate=0.1))
    heap = 2 * active.shape[0] + 1
    for fhm, p in ((fhm_mixed, params[0]), (None, params[1])):
        tree_p = tg.empty_tree(heap, "cpu")
        tree_k = tg.empty_tree(heap, cuda)
        dev = lambda t: None if t is None else t.to(cuda)  # noqa: E731
        sp = ts.split_level(hist.clone(), prev, sir, active,
                            ts.TreeRecords(tree_p, cuts, fhm, p))
        sk = ts.split_level(dev(hist), dev(prev), dev(sir), dev(active),
                            ts.TreeRecords(tree_k, dev(cuts), dev(fhm), p))
        for name in sp.splits._fields:
            assert _same_bits(getattr(sk.splits, name),
                              getattr(sp.splits, name)), name
        for name in ("node_value", "state", "active", "hist"):
            assert _same_bits(getattr(sk, name), getattr(sp, name)), name
        for name in tg.Tree._fields:
            assert _same_bits(getattr(tree_k, name), getattr(tree_p, name)), name
        # the last split level keeps no histogram
        none = ts.split_level(dev(hist), dev(prev), dev(sir), dev(active),
                              ts.TreeRecords(tree_k, dev(cuts), dev(fhm), p),
                              keep_hist=False)
        assert none.hist is None
        assert _same_bits(none.splits.gain, sp.splits.gain)


@pytest.mark.parametrize("n_nodes", [1, 64, 300])
def test_leaf_records_bitwise(cuda, n_nodes):
    rng = np.random.default_rng(n_nodes)
    node_gh = torch.from_numpy(np.stack(
        [rng.standard_normal(n_nodes) * 5,
         rng.uniform(0.0, 3.0, n_nodes)], 1).astype(np.float32))
    node_gh[0] = torch.tensor([-0.0, 0.0])
    active = torch.from_numpy(rng.random(n_nodes) < 0.7)
    for p in (ts.SplitParams(),
              ts.SplitParams(reg_alpha=0.4, max_delta_step=0.3,
                             learning_rate=0.05)):
        tree_p = tg.empty_tree(2 * n_nodes - 1, "cpu")
        tree_k = tg.empty_tree(2 * n_nodes - 1, cuda)
        cuts = torch.zeros(2, 7)
        vp, stp = ts.leaf_records(node_gh, active,
                                  ts.TreeRecords(tree_p, cuts, None, p))
        vk, stk = ts.leaf_records(node_gh.to(cuda), active.to(cuda),
                                  ts.TreeRecords(tree_k, cuts.to(cuda), None, p))
        assert _same_bits(vk, vp) and _same_bits(stk, stp)
        for name in tg.Tree._fields:
            assert _same_bits(getattr(tree_k, name), getattr(tree_p, name)), name


TREE_CASES = {
    "default": (256, dict(), True),
    "regularized": (256, dict(reg_lambda=2.0, reg_alpha=0.3, gamma=0.5,
                              max_delta_step=0.7, learning_rate=0.1), True),
    "early_leaves": (256, dict(min_child_weight=2000.0), True),
    "uint8_max_bin_64": (64, dict(), True),
    "no_sibling_subtraction": (256, dict(reg_alpha=0.1), False),
}


@pytest.mark.parametrize("case", sorted(TREE_CASES))
def test_build_tree_card_equals_cpu(cuda, case):
    max_bin, split, sibling = TREE_CASES[case]
    bins, gh, _, _ = _level(20000, 9, max_bin, 1, seed=4)
    # features 0, 2, ... have no missing value
    bins[:, ::2] = bins[:, ::2].clamp(max=max_bin - 1)
    fhm = (bins == max_bin).any(0)
    assert fhm.any() and not fhm.all()
    cuts = torch.sort(torch.randn(9, max_bin - 1), dim=1).values
    cfg = tg.GrowConfig(max_depth=6, max_bin=max_bin,
                        split=ts.SplitParams(**split), sibling_subtract=sibling)
    tc, rc = tg.build_tree(bins, gh, cuts, cfg, feat_has_missing=fhm)
    tk, rk = tg.build_tree(bins.to(cuda), gh.to(cuda), cuts.to(cuda), cfg,
                           feat_has_missing=fhm.to(cuda))
    for name in tg.Tree._fields:
        assert _same_bits(getattr(tk, name), getattr(tc, name)), name
    assert _same_bits(rk, rc)
    if case == "early_leaves":  # nodes stop above the last level
        assert bool(tc.is_leaf[:31].any())


def test_wrappers_reject_bad_inputs(cuda):
    bins, gh, order, seg = [t.to(cuda) for t in _level(1000, 4, 256, 2)]
    qs = th.quant_scales(gh, 1000)
    with pytest.raises(ValueError):
        th.build_histogram(bins.float(), gh, order, seg, 2, 257, qscale=qs)
    with pytest.raises(ValueError):
        th.build_histogram(bins, gh.double(), order, seg, 2, 257, qscale=qs)
    unaligned = torch.zeros(2 * 1000 + 1, device=cuda)[1:].view(1000, 2)
    with pytest.raises(ValueError):
        th.build_histogram(bins, unaligned, order, seg, 2, 257, qscale=qs)
    with pytest.raises(ValueError, match="fixed point"):  # K1 needs qscale
        th.build_histogram(bins, gh, order, seg, 2, 257)
    with pytest.raises(ValueError, match="fixed point"):
        th.build_histogram(bins, gh, order, seg, 2, 257, qscale=qs.double())
    sums = torch.zeros(2, 4, 257, 2, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        th.dequantize(sums.float(), qs)
    with pytest.raises(ValueError):
        th.dequantize(sums, qs[:2].contiguous())
    with pytest.raises(ValueError):  # order must be 16-byte aligned
        th.partition_leaf_values(
            torch.zeros(1001, dtype=torch.int32, device=cuda)[1:], seg,
            torch.full((2,), th.LEAF, dtype=torch.uint8, device=cuda),
            torch.zeros(2, device=cuda), torch.zeros(1000, device=cuda))
    with pytest.raises(ValueError):
        ts.find_splits(torch.zeros(2, 4, 257, 2, device=cuda).double(),
                       ts.SplitParams())
    with pytest.raises(ValueError):  # float2 loads: 8-byte aligned
        ts.find_splits(torch.zeros(2 * 4 * 257 * 2 + 1, device=cuda)[1:]
                       .view(2, 4, 257, 2), ts.SplitParams())
    rec = ts.TreeRecords(tg.empty_tree(7, cuda),
                         torch.zeros(4, 255, device=cuda), None,
                         ts.SplitParams())
    hist = torch.zeros(2, 4, 257, 2, device=cuda)
    act = torch.ones(4, dtype=torch.bool, device=cuda)
    sir = torch.ones(2, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):  # active must be bool
        ts.split_level(hist, hist, sir, act.to(torch.uint8), rec)
    with pytest.raises(ValueError):  # prev_hist of another shape
        ts.split_level(hist, hist[:1], sir, act, rec)
    with pytest.raises(ValueError):  # n_nodes / 2 nodes without prev_hist
        ts.split_level(hist, None, None, act, rec)
    with pytest.raises(ValueError):  # cuts of another width
        ts.split_level(hist, None, None, act[:2],
                       ts.TreeRecords(tg.empty_tree(7, cuda),
                                      torch.zeros(4, 100, device=cuda), None,
                                      ts.SplitParams()))
    with pytest.raises(ValueError):  # tree arrays of the wrong type
        bad = tg.empty_tree(7, cuda)._replace(
            value=torch.zeros(7, dtype=torch.float64, device=cuda))
        ts.split_level(hist, None, None, act[:2],
                       ts.TreeRecords(bad, torch.zeros(4, 255, device=cuda),
                                      None, ts.SplitParams()))
    with pytest.raises(ValueError):
        ts.leaf_records(torch.zeros(4, 2, device=cuda).double(), act, rec)
    with pytest.raises(ValueError):  # a tree too small for the level
        ts.leaf_records(torch.zeros(8, 2, device=cuda),
                        torch.ones(8, dtype=torch.bool, device=cuda), rec)
    with pytest.raises(ValueError):
        to.round_update(torch.zeros(5, device=cuda), torch.zeros(4, device=cuda),
                        torch.zeros(5, device=cuda), torch.ones(5, device=cuda),
                        True)


def _card_train(x, y, rounds, params=None):
    """train() on the card; (dump, final training margins, evals_result)."""
    import xgboost_ray_tpu_torch as tx
    from xgboost_ray_tpu_torch.distributed import _KeepEngine

    keep = _KeepEngine()
    dm = tx.RayDMatrix(x, y)
    ev = {}
    bst = tx.train(params or {"objective": "binary:logistic",
                              "eval_metric": ["logloss"]},
                   dm, rounds, evals=[(dm, "train")], evals_result=ev,
                   callbacks=[keep], ray_params=tx.RayParams(num_actors=1))
    return bst.get_dump(), keep.engine.get_margins()[:, 0], ev


def _card_set(n=60000, f=10, seed=21):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, f)) * rng.uniform(0.1, 50, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.03] = np.nan
    logit = np.nan_to_num(x[:, 0]) / 20 - np.nan_to_num(x[:, 3]) / 7
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return x, y


def test_training_reruns_bitwise(cuda):
    """Training twice on the card (random gradients from the objective):
    the same dump and bitwise the same margins (K1's fixed point)."""
    x, y = _card_set()
    d1, m1, e1 = _card_train(x, y, 6)
    d2, m2, e2 = _card_train(x, y, 6)
    assert d1 == d2
    assert np.array_equal(m1.view(np.int32), m2.view(np.int32))
    assert e1 == e2


def test_gloo_world_on_one_card_equals_one_rank(cuda):
    """Two ranks sharing the card over gloo (int64 CUDA all-reduces): the
    1-rank model and margins, bit for bit."""
    from xgboost_ray_tpu_torch import distributed as D
    from xgboost_ray_tpu_torch.matrix import RayShardingMode, combine_data

    x, y = _card_set(seed=22)
    d1, m1, _ = _card_train(x, y, 5)
    out = D.launch_world(D._train_rank, 2, "cuda",
                         D.share({"x": x, "label": y}),
                         {"objective": "binary:logistic",
                          "eval_metric": ["logloss"]}, 5,
                         backend="gloo")
    import xgboost_ray_tpu_torch as tx

    # each rank's kernels, counted from 0 just before its train(): the
    # main path's launches (depth 6, 5 rounds; K3 chose from merged counts)
    expect = {"K1": 35, "K1deq": 35, "K2": 0, "K2level": 30, "K2leaf": 5,
              "K3": 30, "K3leaf": 5, "K4": 6}
    # int64 histograms and totals, int64 child counts, the f32 MAX of
    # (max|g|, max|h|) for the round's scales, the four f64 metric sums
    hist_cells = 10 * 257 * 2 * (1 + sum(1 << (d - 1) for d in range(1, 6)))
    ring_bytes = (hist_cells * 8 + sum(2 * (1 << d) * 8 for d in range(5))
                  + 64 * 2 * 8 + 2 * 4 + 4 * 8)
    for o in out:
        assert tx.RayXGBoostBooster.load_raw(o["model"]).get_dump() == d1
        extra = o["additional_results"]
        assert extra["backend"] == "gloo" and extra["world_size"] == 2
        assert extra["allreduce_bytes_per_round"] == ring_bytes
        assert o["launches"] == expect
    m2 = combine_data(RayShardingMode.INTERLEAVED, [o["margins"] for o in out])
    assert np.array_equal(m2.view(np.int32), m1.view(np.int32))


# --------------------------------------------------------------------------
# B8: the forest walk
# --------------------------------------------------------------------------

_THRESHOLDS = np.array([-1.0, -0.5, 0.0, 0.5, 1.0], np.float32)


def _forest(rng, n_trees, depth, n_features, cat=(), p_leaf=0.15):
    """Random padded-heap forest, level by level: leaves above the last
    level, last-level nodes some of which are not marked leaves, unused
    slots (feature -1) below leaves."""
    heap = (2 << depth) - 1
    feature = np.full((n_trees, heap), -1, np.int32)
    split_bin = np.zeros((n_trees, heap), np.int32)
    threshold = np.zeros((n_trees, heap), np.float32)
    default_left = np.zeros((n_trees, heap), bool)
    is_leaf = np.zeros((n_trees, heap), bool)
    value = np.zeros((n_trees, heap), np.float32)
    live = np.ones((n_trees, 1), bool)
    for k in range(depth + 1):
        sl = slice((1 << k) - 1, (2 << k) - 1)
        shape = (n_trees, 1 << k)
        value[:, sl] = np.where(live, rng.standard_normal(shape) * 0.3, 0.0)
        if k == depth:
            is_leaf[:, sl] = live & (rng.random(shape) < 0.7)
            break
        leaf = live & (rng.random(shape) < (p_leaf if k else 0.0))
        split = live & ~leaf
        f = rng.integers(0, n_features, shape)
        is_leaf[:, sl] = leaf
        feature[:, sl] = np.where(split, f, -1)
        threshold[:, sl] = np.where(split, rng.choice(_THRESHOLDS, shape), 0.0)
        code = np.where(np.isin(f, cat), rng.integers(0, 5, shape),
                        rng.integers(0, 255, shape))
        split_bin[:, sl] = np.where(split, code, 0)
        default_left[:, sl] = split & (rng.random(shape) < 0.5)
        live = np.repeat(split, 2, axis=1)
    z = np.zeros((n_trees, heap), np.float32)
    return tg.Tree(feature, split_bin, threshold, default_left, is_leaf,
                   value, z, z, z)


def _rows(rng, n, n_features, cat=()):
    x = rng.standard_normal((n, n_features)).astype(np.float32)
    ties = rng.random((n, n_features)) < 0.2
    x[ties] = rng.choice(_THRESHOLDS, int(ties.sum()))
    x[rng.random((n, n_features)) < 0.1] = np.nan
    for c in cat:  # codes with halves that round to even
        x[:, c] = rng.choice(np.array([0, 1, 2, 2.5, 3, 3.5, 4, np.nan],
                                      np.float32), n)
    return x


def _bits(t):
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


B8_CASES = [(f, t, d) for f in (1, 28, 300) for t in (1, 7, 500)
            for d in (1, 6, 10)] + [(28, 40, 13)]


def _pf(fo, depth, layout, f, cat, device="cpu"):
    return tp.device_forest(fo, depth, layout, device, num_features=f,
                            cat_features=cat)


#: SM counts that make the wrappers take each mapping at any batch size: on
#: one SM every batch fills the card in rows; on a vast card none does
_SMS_FOR = {"rows": 1, "windows": 1 << 30}


def _force(mp, mapping):
    mp.setattr(tp, "_sm_count", lambda index: _SMS_FOR[mapping])


@pytest.mark.parametrize("f,n_trees,depth", B8_CASES)
def test_predict_walk_bitwise(cuda, monkeypatch, f, n_trees, depth):
    """Every mapping (rows over staged tiles, rows reading device memory
    where tiles do not fit: F = 300 or depth 13, windows), every mode
    (leaf indices, margins, values) and option against the plain version."""
    rng = np.random.default_rng(f * 1000 + n_trees * 10 + depth)
    cat = (f // 2,) if f > 1 else ()
    n = (5003, 300, 1)[(f + n_trees + depth) % 3]  # never a multiple of 8
    fo = _forest(rng, n_trees, depth, f, cat)
    x = torch.from_numpy(_rows(rng, n, f, cat))
    base = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    tw = torch.from_numpy(rng.uniform(0.2, 1.5, n_trees).astype(np.float32))
    xk = x.to(cuda)
    for layout in tp.LAYOUTS:
        pc = _pf(fo, depth, layout, f, cat)
        pk = _pf(fo, depth, layout, f, cat, cuda)
        ref_leaf = tp.predict_leaf_index(pc, x)
        for mapping in tp.MAPPINGS:
            _force(monkeypatch, mapping)
            leaf = tp.predict_leaf_index(pk, xk)
            assert torch.equal(leaf.cpu(), ref_leaf), (layout, mapping)
            for opts in (dict(base0=0.25),
                         dict(base=base[:, :1], tree_weights=tw,
                              ntree_limit=max(1, n_trees - 3)),
                         dict(base=base[:, :1], tree_weights=tw,
                              transform="binary:logistic"),
                         dict(base=base, num_outputs=3, num_parallel_tree=2)):
                ko = {k: (v.to(cuda) if torch.is_tensor(v) else v)
                      for k, v in opts.items()}
                got = tp.predict_margin(pk, xk, **ko)
                ref = tp.predict_margin_plain(pc, x, **opts)
                torch.cuda.synchronize()
                assert torch.equal(_bits(got), _bits(ref)), (layout, mapping,
                                                             opts)


@pytest.mark.parametrize("n", [1, 2, 7, 300, 2500, 5003, 40001, 70001])
def test_predict_walk_every_row_tile(cuda, monkeypatch, n):
    """Every rows-per-CTA choice of the windows mapping (8, 4, 2, 1 by batch
    size), the rows mapping's 512-row tiles, each mapping forced, and the
    ragged last CTA; values of margins near and past the sigmoid's ends."""
    rng = np.random.default_rng(n)
    fo = _forest(rng, 40, 6, 28, (3,))
    x = torch.from_numpy(_rows(rng, n, 28, (3,)))
    base = torch.from_numpy((rng.standard_normal((n, 1)) * 60).astype(
        np.float32))
    base[: min(n, 4), 0] = torch.tensor([np.nan, np.inf, -88.4, -103.0])[
        : min(n, 4)]
    for layout in tp.LAYOUTS:
        pc = _pf(fo, 6, layout, 28, (3,))
        pk = _pf(fo, 6, layout, 28, (3,), cuda)
        ref = tp.predict_margin_plain(pc, x, base0=-0.5)
        ref_v = tp.predict_margin_plain(pc, x, base, transform=LOGISTIC)
        ref_l = tp.predict_leaf_index_plain(pc, x)
        for mapping in (None,) + tp.MAPPINGS:
            with monkeypatch.context() as mp:
                if mapping is not None:
                    _force(mp, mapping)
                got = tp.predict_margin(pk, x.to(cuda), base0=-0.5)
                assert torch.equal(_bits(got), _bits(ref)), mapping
                got = tp.predict_margin(pk, x.to(cuda), base.to(cuda),
                                        transform=LOGISTIC)
                assert _same_nan(got.cpu(), ref_v), mapping
                leaf = tp.predict_leaf_index(pk, x.to(cuda))
                assert torch.equal(leaf.cpu(), ref_l), mapping
    assert tp.predict_margin.launches > 0 and tp.predict_leaf_index.launches > 0
    assert tp.predict_margin.launches_by_mode["value"] > 0


@pytest.mark.parametrize("n_trees,n", [(10_000, 10_000), (60_000, 300)])
def test_predict_walk_large_forest(cuda, n_trees, n):
    """Forests whose windows sums take most of a CTA's shared memory: 10,000
    trees at 10,000 rows (fewer rows a CTA than the batch size alone would
    give) and 60,000 trees, whose sums fit no CTA (the rows mapping at a
    serve-sized batch); margins, values and leaf indices bitwise."""
    rng = np.random.default_rng(n_trees + n)
    fo = _forest(rng, n_trees, 2, 28, (3,))
    x = torch.from_numpy(_rows(rng, n, 28, (3,)))
    pc = _pf(fo, 2, "heap", 28, (3,))
    pk = _pf(fo, 2, "heap", 28, (3,), cuda)
    plan = tp.launch_plan(n, 1, pk, False, cuda)
    assert plan.mapping == ("windows" if n_trees < 54_000 else "rows")
    assert plan.shared_bytes <= tp._SHARED_MAX
    got = tp.predict_margin(pk, x.to(cuda), base0=0.5)
    assert torch.equal(_bits(got), _bits(tp.predict_margin_plain(
        pc, x, base0=0.5)))
    got = tp.predict_margin(pk, x.to(cuda), transform=LOGISTIC)
    assert _same_nan(got.cpu(), tp.predict_margin_plain(pc, x,
                                                        transform=LOGISTIC))
    leaf = tp.predict_leaf_index(pk, x.to(cuda))
    assert torch.equal(leaf.cpu(), tp.predict_leaf_index_plain(pc, x))


LOGISTIC = "binary:logistic"


def _same_nan(a, b):
    """Bitwise, a NaN matching any NaN."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(_bits(a[~nan]), _bits(b[~nan])))


def test_predict_wrappers_reject_bad_inputs(cuda):
    rng = np.random.default_rng(0)
    fo = _forest(rng, 7, 3, 4)
    pk = _pf(fo, 3, "heap", 4, (), cuda)
    x = torch.from_numpy(_rows(rng, 50, 4)).to(cuda)
    with pytest.raises(ValueError):  # f64 rows
        tp.predict_margin(pk, x.double())
    with pytest.raises(ValueError):  # a strided view
        tp.predict_margin(pk, torch.zeros(50, 8, device=cuda)[:, ::2])
    with pytest.raises(ValueError):  # rows of another width than packed for
        tp.predict_margin(pk, torch.zeros(50, 5, device=cuda))
    with pytest.raises(ValueError):  # the forest on another device
        tp.predict_margin(_pf(fo, 3, "heap", 4, ()), x)
    with pytest.raises(ValueError):  # base of another shape
        tp.predict_margin(pk, x, torch.zeros(50, 2, device=cuda))
    with pytest.raises(ValueError):  # one weight per tree
        tp.predict_margin(pk, x, tree_weights=torch.ones(6, device=cuda))
    with pytest.raises(ValueError):  # out of the wrong dtype
        tp.predict_leaf_index(pk, x, out=torch.zeros(50, 7, device=cuda))
    with pytest.raises(ValueError):  # more classes than a grid has rows
        tp.predict_margin(pk, x, num_outputs=1 << 16)
    with pytest.raises(NotImplementedError):  # an objective outside the port
        tp.predict_margin(pk, x, transform="multi:softprob")
    with pytest.raises(NotImplementedError):  # a transform of K = 3
        tp.predict_margin(pk, x, torch.zeros(50, 3, device=cuda),
                          num_outputs=3, transform=LOGISTIC)
    with pytest.raises(ValueError):
        _pf(fo, 4, "heap", 4, (), cuda)  # heap of another depth
    with pytest.raises(ValueError):  # 2^24 features do not pack
        _pf(fo, 3, "heap", 1 << 24, (), cuda)
    empty = tp.predict_margin(pk, x[:0])
    assert empty.shape == (0, 1)
