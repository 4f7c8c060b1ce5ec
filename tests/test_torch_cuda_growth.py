"""Categorical splits and lossguide growth against their plain versions on a
CUDA device: K2's categorical level step (unmasked, masked, constrained,
masked and constrained; levels 0-5; F = 9, 28 and 54 with 1-6 categorical
features, empty slots, an all-missing categorical feature, code
``max_bin - 2``), its bare search and its records-free form
(``split_nodes``), K3's categorical route and B4's categorical walk on
trees mixing numeric and categorical splits, the frontier step (ties, an
exhausted frontier, the leaves' row order), and ``train()`` with
categorical features and with lossguide growth against the CPU path that
sums K1's histograms in the card's fixed point. Every test skips without a
CUDA device (the kernels have no CPU mode); run them on the card with
``python -m pytest tests/test_torch_cuda_growth.py -q --noconftest``.

Tolerances: every kernel output is bitwise its plain version's; the
trained models' dumps equal the fixed-point CPU path's, their histories
within 1e-6 (K4's partial sums are f32 per CTA).
"""

import numpy as np
import pytest
import torch

from xgboost_ray_tpu_torch.ops import grow as tg
from xgboost_ray_tpu_torch.ops import grow_lossguide as lg
from xgboost_ray_tpu_torch.ops import histogram as th
from xgboost_ray_tpu_torch.ops import split as ts


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b):
    return torch.equal(_bits(a), _bits(b))


def _cat(f, n_cat, rng):
    cat = np.zeros(f, bool)
    cat[rng.choice(f, n_cat, replace=False)] = True
    return torch.from_numpy(cat)


def _level(n, f, n_par, seed, max_bin=256):
    """A level's inputs with integer gradients (exact sums): the smaller
    children's histogram, the parents', the choice, the active nodes;
    categorical-style bins (few codes, empty slots, code max_bin - 2),
    feature 1 missing in every row."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, 12, (n, f))
    bins[rng.random((n, f)) < 0.05] = max_bin - 2
    bins[rng.random((n, f)) < 0.1] = max_bin
    bins[:, 1] = max_bin
    bins = torch.from_numpy(bins.astype(np.int16))
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
    return small, prev, sir, active, bins, gh


@pytest.mark.parametrize("f,n_cat", [(9, 6), (28, 3), (54, 1)])
@pytest.mark.parametrize("level", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("constrained", [False, True])
def test_split_level_categorical_bitwise(cuda, f, n_cat, level, masked,
                                         constrained):
    """K2's categorical instantiations against the plain level step: every
    output, the records and, constrained (monotone signs on numeric
    features, interaction groups holding categorical ones), the next
    level's bounds, bitwise."""
    rng = np.random.default_rng(1000 * f + 10 * level + 2 * masked
                                + constrained)
    n_nodes = 1 << level
    if level:
        small, prev, sir, active, _, _ = _level(
            4000 + 2000 * n_nodes, f, n_nodes // 2, f + level)
    else:
        small, _, _, _, _, _ = _level(4000, f, 1, f)
        prev = sir = None
        active = torch.ones(1, dtype=torch.bool)
    cat = _cat(f, n_cat, rng)
    cat[1] = True  # every row missing
    cuts = torch.from_numpy(
        np.sort(rng.standard_normal((f, 255)), 1).astype(np.float32))
    p = ts.SplitParams(min_child_weight=1.0)
    cons_p = cons_k = None
    bounds_p = bounds_k = None
    if constrained:
        mono = tuple(0 if cat[i] else int(rng.choice([-1, 0, 1]))
                     for i in range(f))
        groups = tuple(tuple(sorted(set(rng.choice(f, 4)))) for _ in range(6))
        cons_p = ts.TreeConstraints(mono, groups, f, "cpu")
        cons_k = ts.TreeConstraints(mono, groups, f, cuda)
        if cons_p.monotone is not None:
            lo = torch.full((n_nodes,), float("-inf"))
            hi = torch.full((n_nodes,), float("inf"))
            lo[::2] = -0.3
            bounds_p, bounds_k = (lo, hi), (lo.to(cuda), hi.to(cuda))
    heap = (2 << level) - 1
    tree_p = tg.empty_tree(heap, "cpu")
    top = (1 << level) - 1
    feat = rng.integers(0, f, top)
    feat[rng.random(top) < 0.2] = -1
    tree_p.feature[:top] = torch.from_numpy(feat.astype(np.int32))
    tree_k = tg.Tree(*[t.to(cuda) for t in tree_p])
    mask = (torch.from_numpy(rng.random((n_nodes, f)) < 0.6)
            if masked else None)
    sp = ts.split_level(small, prev, sir, active,
                        ts.TreeRecords(tree_p, cuts, None, p, cons_p, cat),
                        feature_mask=mask, bounds=bounds_p)
    ts.split_level.launches_categorical = 0
    dev = [None if t is None else t.to(cuda)
           for t in (small, prev, sir, active, mask)]
    sk = ts.split_level(*dev[:4],
                        ts.TreeRecords(tree_k, cuts.to(cuda), None, p,
                                       cons_k, cat.to(cuda)),
                        feature_mask=dev[4], bounds=bounds_k)
    assert ts.split_level.launches_categorical == 1
    for name in sp.splits._fields:
        assert _same(getattr(sk.splits, name), getattr(sp.splits, name)), name
    for name in ("node_value", "state", "active", "hist"):
        assert _same(getattr(sk, name), getattr(sp, name)), name
    for a, b in zip(sk.bounds or (), sp.bounds or ()):
        assert _same(a, b)
    for name in tg.Tree._fields:
        assert _same(getattr(tree_k, name), getattr(tree_p, name)), name


@pytest.mark.parametrize("f,n_cat", [(9, 6), (28, 3)])
def test_find_splits_and_split_nodes_categorical_bitwise(cuda, f, n_cat):
    """K2's bare search and its records-free form (the lossguide grower's
    two children from the parent's formed histogram, and its root) with
    categorical features: bitwise, the formed histogram too."""
    rng = np.random.default_rng(f)
    small, prev, sir, _, _, _ = _level(8000, f, 1, f + 7)
    cat = _cat(f, n_cat, rng)
    hp = torch.cat([prev, small])
    a = ts.find_splits(hp, ts.SplitParams(), cat=cat)
    b = ts.find_splits(hp.to(cuda), ts.SplitParams(), cat=cat.to(cuda))
    for name in a._fields:
        assert _same(getattr(b, name), getattr(a, name)), name
    cuts = torch.from_numpy(
        np.sort(rng.standard_normal((f, 255)), 1).astype(np.float32))
    mask = torch.from_numpy(rng.random(f) < 0.7)
    for args in ((small, prev, sir), (prev, None, None)):
        n_out = 2 if args[1] is not None else 1
        out_p = torch.zeros((n_out, f, 257, 2))
        out_k = torch.zeros((n_out, f, 257, 2), device=cuda)
        rec_p = ts.TreeRecords(tg.empty_tree(15, "cpu"), cuts, None,
                               ts.SplitParams(), None, cat)
        rec_k = ts.TreeRecords(tg.empty_tree(15, cuda), cuts.to(cuda), None,
                               ts.SplitParams(), None, cat.to(cuda))
        sp = ts.split_nodes(*args, rec_p, out_p, mask)
        sk = ts.split_nodes(*[None if t is None else t.to(cuda)
                              for t in args], rec_k, out_k, mask.to(cuda))
        for name in sp._fields:
            assert _same(getattr(sk, name), getattr(sp, name)), name
        assert _same(out_k, out_p)


def _mixed_tree(f, depth, cat, rng, max_bin=256):
    """A random tree whose even nodes split on categorical features and odd
    ones on numeric features (some inner nodes leaves below depth 3)."""
    heap = (2 << depth) - 1
    cats, nums = np.nonzero(cat)[0], np.nonzero(~cat)[0]
    feat = np.where(np.arange(heap) % 2 == 0, rng.choice(cats, heap),
                    rng.choice(nums, heap)).astype(np.int32)
    sbin = rng.integers(0, 12, heap).astype(np.int32)
    sbin[rng.random(heap) < 0.1] = max_bin - 2
    leaf = np.zeros(heap, bool)
    leaf[(1 << depth) - 1:] = True
    if depth > 2:
        leaf[rng.choice(np.arange(3, (1 << depth) - 1), 2, replace=False)] = True
    feat[leaf] = -1
    tree = tg.empty_tree(heap, "cpu")._replace(
        feature=torch.from_numpy(feat), split_bin=torch.from_numpy(sbin),
        default_left=torch.from_numpy(rng.random(heap) < 0.5),
        is_leaf=torch.from_numpy(leaf),
        value=torch.from_numpy(rng.standard_normal(heap).astype(np.float32)))
    return tree


@pytest.mark.parametrize("n_par", [1, 4, 16])
@pytest.mark.parametrize("merge", [False, True])
def test_partition_categorical_bitwise(cuda, n_par, merge):
    """K3's categorical route against the plain partition: new order,
    segments, the smaller children's rows, the choice and the leaf values
    bitwise (at one rank, and with the counts merged as above it)."""
    f = 9
    rng = np.random.default_rng(n_par + 10 * merge)
    n = 20_000 + 3 * n_par
    _, _, _, _, bins, _ = _level(n, f, n_par, n_par)
    cat = _cat(f, 5, rng)
    cat[1] = True
    pos = rng.integers(0, n_par, n)
    order = torch.from_numpy(np.argsort(pos, kind="stable").astype(np.int32))
    seg = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(pos, minlength=n_par))]).astype(np.int32))
    feature = torch.from_numpy(rng.integers(0, f, n_par).astype(np.int32))
    split_bin = torch.from_numpy(rng.integers(0, 12, n_par).astype(np.int32))
    split_bin[0] = 254
    dl = torch.from_numpy(rng.random(n_par) < 0.5)
    state = torch.from_numpy(rng.choice([0, 1, 1, 2], n_par).astype(np.uint8))
    state[0] = 1
    value = torch.from_numpy(rng.standard_normal(n_par).astype(np.float32))
    counts = (lambda c: c * 3) if merge else None
    rv_p = torch.zeros(n)
    pp = th.partition_level(order, seg, bins, feature, split_bin, dl, state,
                            value, rv_p, True, 256, counts, cat=cat)
    rv_k = torch.zeros(n, device=cuda)
    pk = th.partition_level(
        *[t.to(cuda) for t in (order, seg, bins, feature, split_bin, dl,
                               state, value)], rv_k, True, 256, counts,
        cat=cat.to(cuda))
    used = int(pp.small_seg[-1])
    for name in ("order", "seg", "small_seg", "small_is_right"):
        assert _same(getattr(pk, name), getattr(pp, name)), name
    assert _same(pk.small_rows[:used], pp.small_rows[:used])
    assert _same(rv_k, rv_p)


@pytest.mark.parametrize("depth", [1, 4, 8])
@pytest.mark.parametrize("mapping", ["tiled", "gather"])
def test_walk_categorical_bitwise(cuda, depth, mapping):
    """B4's categorical records: the walk of trees mixing numeric and
    categorical splits (code 254, an all-missing categorical column) over
    int16 bins, one tree and three, bitwise the plain walk."""
    f = 9
    rng = np.random.default_rng(depth)
    _, _, _, _, bins, _ = _level(30_000, f, 1, depth)
    cat = _cat(f, 5, rng)
    cat[1] = True
    trees = [_mixed_tree(f, depth, cat.numpy(), rng) for _ in range(3)]
    for tree in (trees[0], tg.Tree(*[torch.stack(a) for a in zip(*trees)])):
        ref = tg.predict_tree_binned(tree, bins, depth, 256, cat=cat)
        plan = tg.walk_plan(f, 2, tree.feature.shape[0] if
                            tree.feature.dim() == 2 else 1, depth, mapping)
        got = tg.predict_tree_binned(tg.Tree(*[t.to(cuda) for t in tree]),
                                     bins.to(cuda), depth, 256, plan=plan,
                                     cat=cat.to(cuda))
        assert _same(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frontier_step_bitwise(cuda, seed):
    """The frontier step against its plain version over a whole budget:
    random children (gains with ties, invalid ones, a heap the budget
    outgrows, so the frontier runs dry), then the finishing step's leaves
    in row order (empty segments among them): the entries, K3's inputs, the
    parent's histogram, the records and the leaves bitwise."""
    rng = np.random.default_rng(seed)
    depth, leaves, f, nbt, n = 3, 12, 5, 9, 1000
    p = ts.SplitParams(learning_rate=0.3, max_delta_step=0.7 * seed)
    cuts = torch.from_numpy(np.sort(rng.standard_normal((f, nbt - 2)), 1)
                            .astype(np.float32))
    recs, frs = [], []
    for dev in ("cpu", cuda):
        recs.append(ts.TreeRecords(tg.empty_tree(15, dev), cuts.to(dev),
                                   None, p))
        fr = lg.new_frontier(leaves, n, f, nbt, dev)
        fr.store.copy_(torch.randn(fr.store.shape, generator=torch.Generator()
                                   .manual_seed(seed)).to(dev))
        frs.append(fr)

    def search(k):
        gain = rng.choice([1.0, 2.0, 2.0, -np.inf], k).astype(np.float32)
        return ts.LevelSplits(
            torch.from_numpy(gain),
            torch.from_numpy(rng.integers(0, f, k).astype(np.int32)),
            torch.from_numpy(rng.integers(0, nbt - 2, k).astype(np.int32)),
            torch.from_numpy(rng.random(k) < 0.5),
            torch.from_numpy(np.isfinite(gain) & (rng.random(k) < 0.9)),
            torch.from_numpy(np.stack([rng.standard_normal(k),
                                       rng.uniform(0, 4, k)], 1)
                             .astype(np.float32)))

    def both(sp, new_seg, t, select, finish):
        lg.frontier_step(frs[0], recs[0], sp, new_seg, t, select, finish)
        lg.frontier_step(frs[1], recs[1],
                         ts.LevelSplits(*[a.to(cuda) for a in sp]),
                         None if new_seg is None else new_seg.to(cuda),
                         t, select, finish)
        for a, b in zip(frs[1], frs[0]):
            assert _same(a, b)
        for a, b in zip(recs[1].tree, recs[0].tree):
            assert _same(a, b)

    lg.frontier_step.launches = 0
    both(search(1), None, 0, True, False)
    for t in range(leaves - 1):
        s, e = int(frs[0].seg[1]), int(frs[0].seg[2])
        mid = int(rng.integers(s, e + 1))  # an empty child now and then
        new_seg = torch.tensor([0, s, s, mid, e, e, n], dtype=torch.int32)
        both(search(2), new_seg, t + 1, t + 2 < leaves, t + 2 == leaves)
    assert lg.frontier_step.launches == leaves


_DATA = {}


def _data():
    if not _DATA:
        rng = np.random.default_rng(5)
        n = 30_001
        x = rng.standard_normal((n, 6)).astype(np.float32)
        x[:, 1] = rng.integers(0, 12, n)
        x[:, 3] = rng.integers(0, 200, n)
        x[:, 4] = rng.integers(0, 5, n)
        x[rng.random(n) < 0.1, 3] = np.nan
        x[rng.random(n) < 0.05, 0] = np.nan
        lin = (np.isin(x[:, 1], [2, 7]) + 0.01 * np.nan_to_num(x[:, 3]) % 3
               + x[:, 2] - 0.5 * (x[:, 4] == 1))
        y = (lin + rng.standard_normal(n) > 1).astype(np.float32)
        yk = np.clip(np.round(lin), 0, 2).astype(np.float32)
        _DATA.update(x=x, y=y, yk=yk)
    return _DATA


FT = ["q", "c", "q", "c", "c", "q"]
RUNS = {
    "categorical": {"objective": "binary:logistic", "max_depth": 5},
    "categorical_constrained": {
        "objective": "binary:logistic", "max_depth": 5,
        "monotone_constraints": "(1,0,-1,0,0,0)",
        "interaction_constraints": "[[0, 1, 3], [1, 2, 4, 5]]",
        "colsample_bynode": 0.8},
    "categorical_softprob": {"objective": "multi:softprob", "num_class": 3,
                             "max_depth": 4, "subsample": 0.8},
    "lossguide": {"objective": "binary:logistic", "max_depth": 6,
                  "grow_policy": "lossguide", "max_leaves": 20},
    "lossguide_categorical_sampled": {
        "objective": "binary:logistic", "max_depth": 8,
        "grow_policy": "lossguide", "max_leaves": 40, "subsample": 0.8,
        "colsample_bytree": 0.8},
    "lossguide_softprob": {"objective": "multi:softprob", "num_class": 3,
                           "max_depth": 5, "grow_policy": "lossguide",
                           "max_leaves": 10},
}


@pytest.mark.parametrize("name", list(RUNS))
def test_training_on_card(cuda, name, monkeypatch):
    """train() with categorical features and with lossguide growth on the
    card reruns bit for bit, launches the categorical and lossguide
    kernels, and equals the CPU path summing K1's histograms in the card's
    fixed point (dumps equal, history within 1e-6), at ``num_actors`` 2
    folded onto the card."""
    import xgboost_ray_tpu_torch as tx
    from xgboost_ray_tpu_torch import engine as E
    from xgboost_ray_tpu_torch.ops import grow as G

    d = _data()
    params = {"seed": 3, **RUNS[name]}
    y = d["yk"] if params["objective"] == "multi:softprob" else d["y"]
    ft = FT if "categorical" in name else None

    def run(device):
        dm = tx.RayDMatrix(d["x"], y, feature_types=ft)
        ev = {}
        bst = tx.train(params, dm, 3, evals=[(dm, "train")], evals_result=ev,
                       ray_params=tx.RayParams(num_actors=2), device=device)
        return bst, ev

    E.reset_kernel_launches()
    bk, evk = run("cuda")
    launches = E.kernel_launches()
    bk2, _ = run("cuda")
    assert bk.get_dump(with_stats=True) == bk2.get_dump(with_stats=True)
    lossguide = params.get("grow_policy") == "lossguide"
    assert (launches["LGstep"] > 0) == lossguide
    assert (launches["K2level"] > 0) != lossguide
    if ft is not None:
        key = "K2nodescat" if lossguide else "K2cat"
        assert launches[key] > 0 and launches["K3cat"] > 0

    def fixed(bins, gh, rows, seg, n_nodes, nbt, with_hist=True, qscale=None):
        return th.build_histogram_fixed_plain(bins, gh, rows, seg, n_nodes,
                                              nbt, qscale, with_hist)

    for mod in (G, lg):
        monkeypatch.setattr(mod, "build_histogram", fixed)
        monkeypatch.setattr(mod, "dequantize", th.dequantize_plain)
    monkeypatch.setattr(E.TorchEngine, "_scales", lambda e: th.quant_scales(
        e.gh, e.n_global, e.coll.max))
    monkeypatch.setattr(E.TorchEngine, "_tree_scales", lambda e, g:
                        th.quant_scales(g, e.sample_rows_global, e.coll.max))
    bc, evc = run("cpu")
    assert bk.get_dump(with_stats=True) == bc.get_dump(with_stats=True)
    for m in evc["train"]:
        np.testing.assert_allclose(evk["train"][m], evc["train"][m],
                                   rtol=1e-6, atol=1e-6)
