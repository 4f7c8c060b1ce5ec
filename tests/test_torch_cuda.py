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
counts, are integers and copies (bitwise); K4's margins and gradients
bitwise (0 ulps, at the sigmoid's edges too; NaN where the plain version's
is NaN), its metric sums within 1e-5 relative and bitwise on a rerun, one
launch a call; whole trees grown on
the card and on the CPU from integer gh are bitwise on every field; B8's
leaf indices, margins and values (every mapping and option: base, tree
weights, ntree_limit, num_parallel_tree, K = 3, a categorical feature, NaN,
both layouts) are bitwise equal to the plain version's (values: a NaN
matches any NaN, whose payload differs between CPU and card). Training on
the card reruns bit for bit, and a 2-rank gloo world on one card gives the
1-rank model and margins bit for bit (with a held-out eval set too, whose
history is world 1's within 1e-6: K4's metric partials are f32 sums per
CTA of each rank's rows). B4's row values are bitwise its plain
version's (every bin dtype, both mappings, the forest staged whole, in
groups or not at all, depths 1-12, T trees of a round in one launch, row
counts at tile boundaries); K4's eval mode gives bitwise the margins and
partial sums of its gh mode; a weighted sketch on the card gives the same
cuts on a rerun and from two shards (ROADMAP C2). The softmax pass (K
outputs, 2-1000: both paths) gives bitwise the plain version's margins,
gradients, probabilities and classes (NaN where the plain version's is
NaN), its partial sums within 1e-5 relative (f32 sums per CTA) and
bitwise from rerun to rerun, and its eval mode the training mode's
margins and sums bit for bit; multiclass training on the card reruns bit
for bit, with its rows in two shards folded too.
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
          # Covertype's width: K1 takes two feature tiles of 27
          (60000, 54, 256, 16),
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


#: K4's row counts at its vector (4 rows), warp (128 rows) and tile (2,048
#: rows) boundaries, HIGGS's test set plus one, and more tiles than the
#: grid holds (each CTA walks two)
K4_NS = [0, 1, 3, 4, 5, 127, 129, 2047, 2048, 2049, 100003, 500001,
         1000003]
#: the rows of the edge-margin calls: the first vector path's tile and the
#: scalar tail, two CTAs (their partial sums are NaN or swamped by 1e30)
K4_EDGE_NS = [2048, 2049]
#: margins at the sigmoid's edges: +-87, where p turns subnormal and is
#: flushed (-87.3 .. -88.0), past the exp's clamp (+-88.5, +-100), NaN,
#: +-inf, signed zeros, subnormal margins
K4_EDGES = [87.0, -87.0, 87.3, -87.3, -87.34, -87.35, -87.4, -88.0, -88.38,
            88.5, -88.5, 100.0, -100.0, float("nan"), float("inf"),
            float("-inf"), 0.0, -0.0, 1e-40, -1e-40]


def _k4_rows(n, seed, edges=False):
    """Seeded K4 inputs on the CPU; with ``edges`` the first rows take the
    edge margins (a zero row value), a soft label and subnormal operands."""
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal(n) * 4).astype(np.float32)
    rv = (rng.standard_normal(n) * 0.2).astype(np.float32)
    y = (rng.random(n) > 0.5).astype(np.float32)
    w = rng.uniform(0.5, 2, n).astype(np.float32)
    if edges:
        k = len(K4_EDGES)
        m[:k], rv[:k] = K4_EDGES, 0.0
        m[k:k + 200] = np.float32(-87.25) - np.arange(200, dtype=np.float32) * 0.005
        rv[k:k + 200] = 0.0
        y[k + 200:k + 203] = [0.3, 1e-40, 0.7]
        w[k + 203:k + 206] = [1e-40, 1e-39, 1e30]
    return [torch.from_numpy(a) for a in (m, rv, y, w)]


def _ulps(a, b):
    """The most ulps between two f32 tensors where neither is NaN."""
    ok = ~(torch.isnan(a) | torch.isnan(b))
    d = (_bits(a[ok]).long() - _bits(b[ok]).long()).abs()
    return int(d.max()) if d.numel() else 0


def _k4_hold(m, rv, y, w, cuda, logistic, spw=1.5, edges=False):
    """K4 on the card against its plain version on the CPU: margins and
    gradients bitwise (0 ulps on g and h; NaN where the plain version's is
    NaN). Without ``edges`` all four partials are finite and within 1e-5
    relative of the plain sums; with them (NaN margins, a weight of 1e30)
    the partials are NaN where the plain ones are and elsewhere within
    1e-5 relative. Returns the card's (margins, gh, partials)."""
    mp = m.clone()
    ghp, sp = to.round_update(mp, rv, y, w, logistic, spw)
    mk = m.to(cuda)
    ghk, sk = to.round_update(mk, rv.to(cuda), y.to(cuda), w.to(cuda),
                              logistic, spw)
    what = f"n = {m.shape[0]}, logistic = {logistic}"
    assert _same_nan(mk.cpu(), mp), what
    assert _same_nan(ghk.cpu(), ghp), (
        f"{what}: gradients {_ulps(ghk.cpu(), ghp)} ulps from the plain "
        f"version's")
    if not edges:
        assert bool(torch.isfinite(sp).all()), what
        assert torch.allclose(sk.cpu(), sp, rtol=1e-5, atol=0), (
            f"{what}: partials {sk.cpu().tolist()} against {sp.tolist()}")
        return mk, ghk, sk
    nan = torch.isnan(sp)
    assert torch.equal(torch.isnan(sk.cpu()), nan)
    assert torch.allclose(sk.cpu()[~nan], sp[~nan], rtol=1e-5, atol=0)
    return mk, ghk, sk


@pytest.mark.parametrize("logistic", [True, False])
def test_round_update(cuda, logistic):
    """K4's gh mode against its plain version at row counts on its vector
    and tile boundaries, up to grids of 245 and 264 CTAs (finite sums that
    no one weight swamps), and, in calls of their own, at the sigmoid's
    edges: margins and gradients bitwise (0 ulps), partials within 1e-5
    relative and bitwise on a rerun, one launch a call."""
    cases = ([(n, False) for n in K4_NS]
             + [(n, True) for n in K4_EDGE_NS])
    for n, edges in cases:
        m, rv, y, w = _k4_rows(n, seed=n, edges=edges)
        before = to.round_update.launches
        mk, ghk, sk = _k4_hold(m, rv, y, w, cuda, logistic, edges=edges)
        assert to.round_update.launches == before + 1
        m2 = m.to(cuda)
        gh2, s2 = to.round_update(m2, rv.to(cuda), y.to(cuda), w.to(cuda),
                                  logistic, 1.5)
        assert _same_bits(m2, mk) and _same_bits(gh2, ghk)
        assert torch.equal(s2.view(torch.int64), sk.view(torch.int64)), n


def test_round_update_unaligned_rows(cuda):
    """Inputs 4 bytes off 16-byte alignment take the kernel's scalar path:
    the same margins, gradients and partials bit for bit as the aligned
    vector path, and both the plain version's: over 49 CTAs of ordinary
    rows (all four sums held) and, apart, two CTAs with the edge rows."""
    for n, edges in ((100003, False), (2049, True)):
        _k4_unaligned(cuda, n, edges)


def _k4_unaligned(cuda, n, edges):
    m, rv, y, w = _k4_rows(n, seed=9, edges=edges)
    for logistic in (True, False):
        mk, ghk, sk = _k4_hold(m, rv, y, w, cuda, logistic, edges=edges)
        off = [torch.zeros(n + 1, device=cuda)[1:] for _ in range(4)]
        for dst, src in zip(off, (m, rv, y, w)):
            dst.copy_(src)
        gho, so = to.round_update(*off, logistic, 1.5)
        assert _same_bits(off[0], mk) and _same_bits(gho, ghk)
        assert torch.equal(so.view(torch.int64), sk.view(torch.int64))


def test_round_update_one_launch(cuda):
    """One CUDA launch a call in both modes (the sums come out of the
    kernel: no reduction launch after it), as torch.profiler counts them."""
    from torch.profiler import ProfilerActivity, profile

    m, rv, y, w = (t.to(cuda) for t in _k4_rows(500001, seed=2))
    for with_gh in (True, False):
        to.round_update(m, rv, y, w, True, with_gh=with_gh)  # the workspace
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            to.round_update(m, rv, y, w, True, with_gh=with_gh)
            torch.cuda.synchronize()
        on_card = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(on_card) == 1 and "xrt_k4" in on_card[0], on_card


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


def _held_out_train(x, y, xv, yv, rounds, **kw):
    """train() on the card with (x, y) and the held-out (xv, yv): (dump,
    final training margins, evals_result, kernel launches)."""
    import xgboost_ray_tpu_torch as tx
    from xgboost_ray_tpu_torch.distributed import _KeepEngine
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )

    keep = _KeepEngine()
    dm, dv = tx.RayDMatrix(x, y), tx.RayDMatrix(xv, yv)
    ev = {}
    reset_kernel_launches()
    bst = tx.train({"objective": "binary:logistic",
                    "eval_metric": ["error", "logloss"]},
                   dm, rounds, evals=[(dm, "train"), (dv, "valid")],
                   evals_result=ev, callbacks=[keep],
                   ray_params=tx.RayParams(num_actors=1), **kw)
    launches = kernel_launches()
    return bst, keep.engine.get_margins()[:, 0], ev, launches


def test_held_out_eval_on_the_card(cuda):
    """A held-out set: one B4 and one eval-mode K4 launch a round, its
    history equal to the plain path's within 1e-6, its final margins within
    1e-5 of the booster's own prediction; a rerun is bitwise; early
    stopping and a warm start run on the card."""
    x, y = _card_set(seed=23)
    xv, yv = _card_set(n=7001, seed=24)
    bst, m1, ev, launches = _held_out_train(x, y, xv, yv, 6)
    assert launches["B4"] == 6 and launches["K4eval"] == 6
    assert launches["K4"] == 7 + 6
    _, m2, ev2, _ = _held_out_train(x, y, xv, yv, 6)
    assert ev2 == ev and np.array_equal(m1.view(np.int32), m2.view(np.int32))
    assert ev["valid"]["logloss"][-1] < ev["valid"]["logloss"][0]
    import xgboost_ray_tpu_torch as tx

    dm, dv, cpu_ev = tx.RayDMatrix(x, y), tx.RayDMatrix(xv, yv), {}
    tx.train({"objective": "binary:logistic",
              "eval_metric": ["error", "logloss"]}, dm, 6, device="cpu",
             evals=[(dm, "train"), (dv, "valid")], evals_result=cpu_ev,
             ray_params=tx.RayParams(num_actors=1))
    np.testing.assert_allclose(ev["valid"]["logloss"],
                               cpu_ev["valid"]["logloss"], rtol=0, atol=1e-6)
    early, _, eev, _ = _held_out_train(x, y, xv, yv, 40,
                                       early_stopping_rounds=2)
    hist = eev["valid"]["logloss"]
    assert early.best_iteration == int(np.argmin(hist))
    assert len(hist) in (40, early.best_iteration + 3)
    warm, _, _, _ = _held_out_train(x, y, xv, yv, 3, xgb_model=bst)
    assert warm.num_boosted_rounds() == 9
    assert warm.get_dump()[:6] == bst.get_dump()


@pytest.mark.parametrize("dtype,max_bin", [(torch.uint8, 255),
                                           (torch.int16, 256),
                                           (torch.int16, 1000)])
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 6, 7, 8, 11])
def test_binned_walk_bitwise(cuda, dtype, max_bin, depth):
    """B4 against its plain version: trees with leaves at every depth,
    unused nodes below them, the missing bin both ways (the launch plan's
    choice: depths 1-11 staged whole beside the row tiles)."""
    rng = np.random.default_rng(depth * 7 + max_bin)
    n, f = 20011, 13
    heap = (1 << (depth + 1)) - 1
    bins = rng.integers(0, max_bin + 1, (n, f))
    bins[rng.random((n, f)) < 0.1] = max_bin
    bins = torch.from_numpy(bins).to(dtype)
    feature = np.full(heap, -1, np.int32)
    is_leaf = np.zeros(heap, bool)
    live = np.zeros(heap, bool)
    live[0] = True
    for i in range(heap):
        if not live[i]:
            continue
        if i >= heap // 2 or (i > 0 and rng.random() < 0.25):
            is_leaf[i] = True
            continue
        feature[i] = rng.integers(0, f)
        live[2 * i + 1] = live[2 * i + 2] = True
    tree = tg.Tree(
        feature=torch.from_numpy(feature),
        split_bin=torch.from_numpy(rng.integers(0, max_bin, heap).astype(np.int32)),
        threshold=torch.zeros(heap),
        default_left=torch.from_numpy(rng.random(heap) < 0.5),
        is_leaf=torch.from_numpy(is_leaf),
        value=torch.from_numpy(rng.standard_normal(heap).astype(np.float32)),
        gain=torch.zeros(heap), cover=torch.zeros(heap),
        base_weight=torch.zeros(heap))
    ref = tg.predict_tree_binned_plain(tree, bins, depth, max_bin)
    before = tg.predict_tree_binned.launches
    got = tg.predict_tree_binned(tg.Tree(*[t.to(cuda) for t in tree]),
                                 bins.to(cuda), depth, max_bin)
    assert tg.predict_tree_binned.launches == before + 1
    assert _same_bits(got, ref)


def test_round_update_eval_mode_bitwise(cuda):
    """K4's eval mode: no gradients, and bitwise the margins and partial
    sums of the gh mode on the same inputs."""
    rng = np.random.default_rng(5)
    n = 500001
    m = torch.from_numpy((rng.standard_normal(n) * 4).astype(np.float32)).to(cuda)
    rv, y, w = (torch.from_numpy(a).to(cuda) for a in (
        (rng.standard_normal(n) * 0.2).astype(np.float32),
        (rng.random(n) > 0.5).astype(np.float32),
        rng.uniform(0.5, 2, n).astype(np.float32)))
    for logistic in (True, False):
        mg, me = m.clone(), m.clone()
        _, sg = to.round_update(mg, rv, y, w, logistic, 1.5)
        before = to.round_update.eval_launches
        gh, se = to.round_update(me, rv, y, w, logistic, 1.5, with_gh=False)
        assert gh is None and to.round_update.eval_launches == before + 1
        assert _same_bits(me, mg)
        assert torch.equal(se, sg)


def test_weighted_sketch_reruns_and_shards_bitwise(cuda):
    """ROADMAP C2: the sketch's weighted sums are int64 fixed point on the
    card, so a rerun and the rows in two shards folded give the same cuts
    (and, with unit weights, the CPU's f32 cuts)."""
    from xgboost_ray_tpu_torch.ops import binning as tb

    rng = np.random.default_rng(9)
    n, f = 300000, 12
    x = (rng.standard_normal((n, f)) * rng.uniform(0.1, 50, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.05] = np.nan
    w = rng.uniform(0.01, 3.0, n).astype(np.float32)
    xd, wd = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    _, c1, m1 = tb.sketch_and_bin(xd, wd, 256)
    _, c2, _ = tb.sketch_and_bin(xd, wd, 256)
    order = np.concatenate([np.arange(n)[0::2], np.arange(n)[1::2]])
    _, c3, m3 = tb.sketch_and_bin(xd[order], wd[order], 256)
    assert _same_bits(c1, c2) and _same_bits(c1, c3)
    assert torch.equal(m1, m3)
    _, cu, _ = tb.sketch_and_bin(xd, torch.ones_like(wd), 256)
    _, cc, _ = tb.sketch_and_bin(torch.from_numpy(x), torch.ones(n), 256)
    assert _same_bits(cu, cc)


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
              "K3": 30, "K3leaf": 5, "K4": 6, "B4": 0, "K4eval": 0,
              "SMX": 0, "SMXeval": 0}
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


def test_gloo_world_with_held_out_set_equals_one_rank(cuda):
    """Two ranks sharing the card, each on its shard of the training and
    the held-out matrix: world 1's model and training margins bit for bit,
    its eval history within 1e-6, B4 and K4's eval mode launched once a
    round on each."""
    from xgboost_ray_tpu_torch import distributed as D
    from xgboost_ray_tpu_torch.matrix import RayShardingMode, combine_data

    x, y = _card_set(seed=25)
    xv, yv = _card_set(n=9001, seed=26)
    bst, m1, ev, _ = _held_out_train(x, y, xv, yv, 4)
    out = D.launch_world(
        D._train_rank, 2, "cuda", D.share({"x": x, "label": y}),
        {"objective": "binary:logistic", "eval_metric": ["error", "logloss"]},
        4, {"eval_names": ["train", "valid"],
            "eval_data": [None, dict(D.share({"x": xv, "label": yv}),
                                     sharding="INTERLEAVED")]},
        backend="gloo")
    import xgboost_ray_tpu_torch as tx

    for o in out:
        assert tx.RayXGBoostBooster.load_raw(o["model"]).get_dump() == bst.get_dump()
        # K4's metric partials are f32 sums per CTA of each rank's rows
        for s in ("train", "valid"):
            for m in ("error", "logloss"):
                np.testing.assert_allclose(o["evals_result"][s][m], ev[s][m],
                                           rtol=0, atol=1e-6)
        assert o["launches"]["B4"] == 4 and o["launches"]["K4eval"] == 4
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
    # multi:softprob's values: B8's margins, then the softmax pass
    probs = tp.predict_margin(pk, x, num_outputs=7, transform="multi:softprob")
    margins = tp.predict_margin(pk, x, num_outputs=7)
    assert probs.shape == (50, 7)
    assert _same_bits(probs, to.softmax_transform_plain(margins.cpu(), True))
    with pytest.raises(NotImplementedError):  # an objective outside the port
        tp.predict_margin(pk, x, transform="reg:gamma")
    with pytest.raises(NotImplementedError):  # a transform of K = 3
        tp.predict_margin(pk, x, torch.zeros(50, 3, device=cuda),
                          num_outputs=3, transform=LOGISTIC)
    with pytest.raises(ValueError):
        _pf(fo, 4, "heap", 4, (), cuda)  # heap of another depth
    with pytest.raises(ValueError):  # 2^24 features do not pack
        _pf(fo, 3, "heap", 1 << 24, (), cuda)
    empty = tp.predict_margin(pk, x[:0])
    assert empty.shape == (0, 1)


def _softmax_rows(n, k, seed):
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal((n, k)) * rng.choice([0.1, 3.0, 40.0], (n, 1))
         ).astype(np.float32)
    m[:min(n, 50)] = np.round(m[:min(n, 50)])  # ties inside a row
    rv = (rng.standard_normal((k, n)) * 0.3).astype(np.float32)
    y = rng.integers(0, k, n).astype(np.float32)
    w = rng.uniform(0.2, 3.0, n).astype(np.float32)
    return [torch.from_numpy(a) for a in (m, rv, y, w)]


#: K: every register-path bound, the wide path; N: one row, a ragged
#: count, a CTA's 256 rows and one either side, many CTAs
SMX_KS = [2, 3, 7, 16, 32, 33, 100, 1000]
SMX_NS = [1, 777, 255, 256, 257, 100003]


def _plain_reference(n, k):
    """Where the softmax pass's plain version runs for a comparison: on the
    CPU, or for large inputs on the card (its ops are the same IEEE float32
    and float64 arithmetic there; test_softmax_plain_on_card_is_plain_on_cpu
    holds the two together)."""
    return "cuda" if n * k > 4_000_000 else "cpu"


@pytest.mark.parametrize("k", SMX_KS)
@pytest.mark.parametrize("n", SMX_NS)
def test_softmax_update_bitwise(cuda, n, k):
    """The softmax pass's training mode against its plain version: margins
    and gradients bitwise, partial sums within 1e-5 relative and bitwise
    from rerun to rerun; its eval mode the same margins and sums bit for
    bit, no gradients."""
    m, rv, y, w = _softmax_rows(n, k, seed=n + k)
    dev = _plain_reference(n, k)
    mp = m.to(dev, copy=True)
    ghp, sp = to.softmax_update_plain(mp, rv.to(dev), y.to(dev), w.to(dev))
    mk = m.to(cuda)
    before = to.softmax_update.launches
    ghk, sk = to.softmax_update(mk, rv.to(cuda), y.to(cuda), w.to(cuda))
    assert to.softmax_update.launches == before + 1
    assert _same_bits(mk, mp.cpu())
    assert _same_bits(ghk, ghp.cpu())
    assert torch.allclose(sk.cpu(), sp.cpu(), rtol=1e-5, atol=1e-6)
    m2 = m.to(cuda)
    _, s2 = to.softmax_update(m2, rv.to(cuda), y.to(cuda), w.to(cuda))
    assert torch.equal(s2, sk)  # reruns: the same f32 sums per CTA
    me = m.to(cuda)
    gh, se = to.softmax_update(me, rv.to(cuda), y.to(cuda), w.to(cuda),
                               with_gh=False)
    assert gh is None and _same_bits(me, mk) and torch.equal(se, sk)


def test_softmax_plain_on_card_is_plain_on_cpu(cuda):
    """The plain pass gives the same bits on the card as on the CPU (the
    reference the larger card tests take), at both paths' K."""
    for k in (7, 100):
        m, rv, y, w = _softmax_rows(3001, k, seed=k)
        mc, mg = m.clone(), m.to(cuda)
        ghc, _ = to.softmax_update_plain(mc, rv, y, w)
        ghg, _ = to.softmax_update_plain(mg, rv.to(cuda), y.to(cuda),
                                         w.to(cuda))
        assert _same_bits(mg, mc) and _same_bits(ghg, ghc)
        for prob in (True, False):
            assert _same_bits(to.softmax_transform_plain(m.to(cuda), prob),
                              to.softmax_transform_plain(m, prob))


@pytest.mark.parametrize("k", [3, 8, 33])
def test_softmax_special_margins(cuda, k):
    """NaN, +-inf and +-1e30 margins and labels outside [0, K): every
    output where the plain version's is NaN is NaN (payloads differ between
    CPU and card), every other output bitwise; the partials NaN where the
    plain ones are."""
    m, rv, y, w = _softmax_rows(2000, k, seed=40 + k)
    m[0, 1] = float("nan")
    m[1, 0] = float("inf")
    m[2, -1] = float("-inf")
    m[3] = float("-inf")
    m[4, :2] = float("inf")
    m[5, 0], m[5, -1] = 1e30, -1e30
    m[6] = 1e30
    m[7, 0] = -1e30
    y[8:14] = torch.tensor([-1.0, float(k), 2.5, float("nan"), 1e10, -k])
    for lo, hi in ((0, 2000), (8, 2000), (14, 2000)):
        mp, mk = m[lo:hi].clone(), m[lo:hi].to(cuda)
        args = [t[lo:hi] for t in (y, w)]
        ghp, sp = to.softmax_update_plain(mp, rv[:, lo:hi].contiguous(),
                                          *args)
        ghk, sk = to.softmax_update(mk, rv[:, lo:hi].contiguous().to(cuda),
                                    *[t.to(cuda) for t in args])
        assert _same_nan(mk.cpu(), mp) and _same_nan(ghk.cpu(), ghp)
        assert torch.equal(torch.isnan(sk.cpu()), torch.isnan(sp))
        ok = ~torch.isnan(sp)
        assert torch.allclose(sk.cpu()[ok], sp[ok], rtol=1e-5)
        for prob in (True, False):
            assert _same_nan(
                to.softmax_transform(m[lo:hi].to(cuda), prob).cpu(),
                to.softmax_transform_plain(m[lo:hi], prob))


def test_softmax_update_labels_out_of_range(cuda):
    """Labels outside [0, K): no one-hot entry (the gradient row is p w),
    the mlogloss partial NaN as the plain version's, merror counts them."""
    m, rv, y, w = _softmax_rows(4000, 3, seed=9)
    y[:6] = torch.tensor([-1.0, 3.0, 2.5, float("nan"), 1e10, -3.0])
    mp = m.clone()
    ghp, sp = to.softmax_update_plain(mp, rv, y, w)
    mk = m.to(cuda)
    ghk, sk = to.softmax_update(mk, rv.to(cuda), y.to(cuda), w.to(cuda))
    assert _same_bits(ghk, ghp) and _same_bits(mk, mp)
    assert torch.isnan(sk[0]) and torch.isnan(sp[0])
    assert torch.allclose(sk[1:].cpu(), sp[1:], rtol=1e-5)


@pytest.mark.parametrize("prob", [True, False])
@pytest.mark.parametrize("k", SMX_KS)
@pytest.mark.parametrize("n", SMX_NS)
def test_softmax_transform_bitwise_on_card(cuda, n, k, prob):
    m, _, _, _ = _softmax_rows(n, k, seed=k)
    dev = _plain_reference(n, k)
    ref = to.softmax_transform_plain(m.to(dev), prob).cpu()
    before = to.softmax_transform.launches
    got = to.softmax_transform(m.to(cuda), prob)
    assert to.softmax_transform.launches == before + 1
    assert got.shape == ref.shape and _same_bits(got, ref)
    out = torch.empty_like(got)
    assert to.softmax_transform(m.to(cuda), prob, out=out) is out
    assert _same_bits(out, ref)


def _random_forest_heaps(rng, t, depth, f, max_bin):
    """T random heaps of one depth (leaves at every depth, unused nodes
    below them) as a tree of [T, heap] fields."""
    heap = (1 << (depth + 1)) - 1
    feature = np.full((t, heap), -1, np.int32)
    is_leaf = np.zeros((t, heap), bool)
    for j in range(t):
        live = np.zeros(heap, bool)
        live[0] = True
        for i in range(heap):
            if not live[i]:
                continue
            if i >= heap // 2 or (i > 0 and rng.random() < 0.2):
                is_leaf[j, i] = True
                continue
            feature[j, i] = rng.integers(0, f)
            live[2 * i + 1] = live[2 * i + 2] = True
    return tg.Tree(
        feature=torch.from_numpy(feature),
        split_bin=torch.from_numpy(
            rng.integers(0, max_bin, (t, heap)).astype(np.int32)),
        threshold=torch.zeros(t, heap),
        default_left=torch.from_numpy(rng.random((t, heap)) < 0.5),
        is_leaf=torch.from_numpy(is_leaf),
        value=torch.from_numpy(
            rng.standard_normal((t, heap)).astype(np.float32)),
        gain=torch.zeros(t, heap), cover=torch.zeros(t, heap),
        base_weight=torch.zeros(t, heap))


@pytest.mark.parametrize("t,depth", [(3, 4), (7, 6), (7, 9), (1, 6)])
def test_binned_walk_trees_bitwise(cuda, t, depth):
    """B4 over T trees in one launch ([T, N]) against T calls of the plain
    walk (the launch plan's choice)."""
    rng = np.random.default_rng(t * 10 + depth)
    n, f, max_bin = 30011, 54, 256
    bins = rng.integers(0, max_bin + 1, (n, f))
    bins[rng.random((n, f)) < 0.1] = max_bin
    bins = torch.from_numpy(bins).to(torch.int16)
    forest = _random_forest_heaps(rng, t, depth, f, max_bin)
    ref = tg.predict_tree_binned_plain(forest, bins, depth, max_bin)
    before = tg.predict_tree_binned.launches
    got = tg.predict_tree_binned(tg.Tree(*[a.to(cuda) for a in forest]),
                                 bins.to(cuda), depth, max_bin)
    assert tg.predict_tree_binned.launches == before + 1
    assert got.shape == (t, n) and _same_bits(got, ref)


#: (F, T, depth): one feature; HIGGS's and Covertype's widths; forests
#: staged whole, in groups, and (depth 12 x 7 trees) one tree a group; a
#: 100-tree round; rows too wide to tile (F = 2000: the gather mapping)
WALK_CASES = [(1, 1, 1), (28, 1, 6), (54, 7, 6), (28, 20, 9), (54, 100, 6),
              (1, 100, 1), (28, 7, 12), (54, 1, 12), (2000, 7, 6),
              (2000, 20, 9)]


def _walk_plans(f, bb, t, depth):
    """Every mapping the shape allows, each with the plan's forest, with
    the forest in groups of about a third and with it unstaged."""
    plans = []
    for mapping in tg.WALK_MAPPINGS:
        try:
            plan = tg.walk_plan(f, bb, t, depth, mapping)
        except ValueError:  # rows too wide to tile
            continue
        heap = (2 << depth) - 1
        tiles = plan.shared_bytes - (-(-12 * plan.trees_per_group * heap
                                       // 16) * 16)
        plans.append(plan)
        if t > 1:
            g = -(-t // 3)
            groups = plan._replace(
                trees_per_group=g, n_groups=-(-t // g),
                shared_bytes=tiles + -(-12 * g * heap // 16) * 16)
            if groups.shared_bytes <= tg.WALK_SHARED_MAX:
                plans.append(groups)
        plans.append(plan._replace(trees_per_group=0, n_groups=1,
                                   shared_bytes=tiles))
    return plans


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16])
@pytest.mark.parametrize("f,t,depth", WALK_CASES)
def test_binned_walk_plans_bitwise(cuda, dtype, f, t, depth):
    """B4 on both mappings and every forest staging (whole, in groups,
    unstaged) against its plain version, at row counts on either side of a
    tile (1, R - 1, R, R + 1, 5R + 3) and at enough rows for every CTA of
    the persistent grid to walk several tiles."""
    max_bin = 255 if dtype == torch.uint8 else 256
    bb = 1 if dtype == torch.uint8 else 2
    rng = np.random.default_rng(f * 1000 + t * 10 + depth)
    n_max = min(2_000_003, (48 << 20) // (f * bb), 3_000_000 // t)
    bins = rng.integers(0, max_bin + 1, (n_max, f))
    bins[rng.random((n_max, f)) < 0.1] = max_bin
    bins = torch.from_numpy(bins).to(dtype)
    forest = _random_forest_heaps(rng, t, depth, f, max_bin)
    ref = tg.predict_tree_binned_plain(forest, bins, depth, max_bin)
    gforest = tg.Tree(*[a.to(cuda) for a in forest])
    gbins = bins.to(cuda)
    for plan in _walk_plans(f, bb, t, depth):
        r = plan.rows_per_tile
        for n in sorted({1, r - 1, r, r + 1, 5 * r + 3, n_max}):
            if n > n_max:
                continue
            before = tg.predict_tree_binned.launches_by_mapping[plan.mapping]
            got = tg.predict_tree_binned(gforest, gbins[:n], depth, max_bin,
                                         plan=plan)
            assert (tg.predict_tree_binned.launches_by_mapping[plan.mapping]
                    == before + 1)
            assert got.shape == (t, n), (plan, n)
            assert _same_bits(got, ref[:, :n]), (plan, n)


def _multiclass_set(n=40000, k=5, seed=31):
    rng = np.random.default_rng(seed)
    cont = rng.standard_normal((n, 10)).astype(np.float32)
    group = rng.integers(0, 4, n)
    x = np.concatenate([cont, np.eye(4, dtype=np.float32)[group]], axis=1)
    score = cont[:, :k] + rng.standard_normal((4, k))[group]
    y = np.argmax(score + 0.5 * rng.standard_normal((n, k)), 1)
    return x, y.astype(np.float32)


def _multiclass_train(x, y, rounds, actors=1, held_out=None, **params):
    """train() of multi:softprob on the card: (booster, final training
    margins [N, K] in row order, evals_result, kernel launches)."""
    import xgboost_ray_tpu_torch as tx
    from xgboost_ray_tpu_torch.distributed import _KeepEngine
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )
    from xgboost_ray_tpu_torch.matrix import RayShardingMode, combine_data

    keep, ev = _KeepEngine(), {}
    dm = tx.RayDMatrix(x, y)
    evals = [(dm, "train")]
    if held_out is not None:
        evals.append((tx.RayDMatrix(*held_out), "valid"))
    reset_kernel_launches()
    bst = tx.train({"objective": "multi:softprob", "num_class": 5,
                    "eval_metric": ["merror", "mlogloss"], **params},
                   dm, rounds, evals=evals, evals_result=ev,
                   callbacks=[keep], device="cuda:0",
                   ray_params=tx.RayParams(num_actors=actors))
    launches = kernel_launches()
    m = keep.engine.get_margins()
    sizes = [len(range(r, x.shape[0], actors)) for r in range(actors)]
    m = combine_data(RayShardingMode.INTERLEAVED,
                     np.split(m, np.cumsum(sizes)[:-1]))
    return bst, m, ev, launches


def test_multiclass_training_reruns_bitwise(cuda):
    """multi:softprob (K = 5) on the card: K trees a round through K1-K3,
    one softmax pass a round (and round 0's); a rerun and two shards folded
    give the same dump and bitwise margins; with a held-out set one B4 over
    the round's K trees and one eval-mode pass a round; the held-out
    history is the CPU path's within 1e-5."""
    x, y = _multiclass_set()
    b1, m1, e1, l1 = _multiclass_train(x, y, 4)
    assert l1["SMX"] == 5 and l1["SMXeval"] == 0 and l1["K4"] == 0
    assert l1["K1"] == 4 * 5 * 7 and l1["K3leaf"] == 4 * 5
    assert b1.num_trees == 20 and m1.shape == (x.shape[0], 5)
    b2, m2, e2, _ = _multiclass_train(x, y, 4)
    b3, m3, e3, _ = _multiclass_train(x, y, 4, actors=2)
    assert b1.get_dump() == b2.get_dump() == b3.get_dump()
    assert _same_bits(torch.from_numpy(m2), torch.from_numpy(m1))
    assert _same_bits(torch.from_numpy(m3), torch.from_numpy(m1))
    # the metric partials are f32 sums per CTA of the rows in shard order
    assert e1 == e2
    for name in e1["train"]:
        np.testing.assert_allclose(e3["train"][name], e1["train"][name],
                                   rtol=1e-6)
    xv, yv = _multiclass_set(n=9001, seed=32)
    bh, _, eh, lh = _multiclass_train(x, y, 4, held_out=(xv, yv))
    assert bh.get_dump() == b1.get_dump()
    assert lh["B4"] == 4 and lh["SMXeval"] == 4 and lh["SMX"] == 9
    assert eh["valid"]["mlogloss"][-1] < eh["valid"]["mlogloss"][0]
    import xgboost_ray_tpu_torch as tx

    dm, dv, cpu_ev = tx.RayDMatrix(x, y), tx.RayDMatrix(xv, yv), {}
    tx.train({"objective": "multi:softprob", "num_class": 5,
              "eval_metric": ["merror", "mlogloss"]}, dm, 4, device="cpu",
             evals=[(dm, "train"), (dv, "valid")], evals_result=cpu_ev,
             ray_params=tx.RayParams(num_actors=1))
    np.testing.assert_allclose(eh["valid"]["mlogloss"],
                               cpu_ev["valid"]["mlogloss"], rtol=0, atol=1e-5)
    vals = bh.predict(xv)
    assert vals.shape == (9001, 5)
    assert np.array_equal(vals, bh.predict(xv, device="cpu"))
