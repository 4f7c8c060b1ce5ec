"""The port's hand-written kernels against their plain versions on a CUDA
device, at shapes off the main path (feature tiles, uint8 bins, 1024 bins,
few bins, empty nodes). Every test skips without a CUDA device; run them on
the card with ``python -m pytest tests/test_torch_cuda.py -q``.

Tolerances: with integer-valued gh every f32 sum is exact, so K1 and K2 are
bitwise; K3's outputs, in both modes, are integers and copies (bitwise);
K4's gradients within 1e-6 and its metric sums within 1e-5 relative; whole
trees grown on the card and on the CPU from integer gh are bitwise.
"""

import numpy as np
import pytest
import torch

from xgboost_ray_tpu_torch.ops import grow as tg
from xgboost_ray_tpu_torch.ops import histogram as th
from xgboost_ray_tpu_torch.ops import objectives as to
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


@pytest.mark.parametrize("n,f,max_bin,n_nodes", SHAPES)
def test_histogram_and_split_bitwise(cuda, n, f, max_bin, n_nodes):
    cpu = _level(n, f, max_bin, n_nodes)
    dev = [t.to(cuda) for t in cpu]
    nbt = max_bin + 1
    hk, tk = th.build_histogram(*dev, n_nodes, nbt)
    hp, tp = th.build_histogram_plain(*cpu, n_nodes, nbt)
    assert torch.equal(hk.cpu(), hp) and torch.equal(tk.cpu(), tp)
    _, tk2 = th.build_histogram(*dev, n_nodes, nbt, with_hist=False)
    assert torch.equal(tk2.cpu(), tp)
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
    hk, tk = th.build_histogram(bins.to(cuda), gh.to(cuda), order.to(cuda),
                                seg.to(cuda), 1, nbt)
    hp, tp = th.build_histogram_plain(bins, gh, order, seg, 1, nbt)
    assert torch.equal(hk.cpu(), hp) and torch.equal(tk.cpu(), tp)


@pytest.mark.parametrize("n,f,max_bin,n_nodes", SHAPES)
def test_partition_bitwise(cuda, n, f, max_bin, n_nodes):
    bins, _, order, seg = _level(n, f, max_bin, n_nodes, seed=1)
    rng = np.random.default_rng(2)
    feature = torch.from_numpy(rng.integers(0, f, n_nodes).astype(np.int32))
    sbin = torch.from_numpy(rng.integers(0, max_bin - 1, n_nodes).astype(np.int32))
    dl = torch.from_numpy(rng.random(n_nodes) < 0.5)
    state = torch.from_numpy(rng.integers(0, 3, n_nodes).astype(np.uint8))
    nval = torch.from_numpy(rng.standard_normal(n_nodes).astype(np.float32))
    for write_small in (True, False):
        rv_p = torch.zeros(n)
        rv_k = torch.zeros(n, device=cuda)
        pp = th.partition_level(order, seg, bins, feature, sbin, dl, state,
                                nval, rv_p, write_small, max_bin)
        pk = th.partition_level(*(t.to(cuda) for t in (
            order, seg, bins, feature, sbin, dl, state, nval)), rv_k,
            write_small, max_bin)
        m = int(pp.small_seg[-1])
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


def test_build_tree_card_equals_cpu(cuda):
    bins, gh, _, _ = _level(20000, 9, 256, 1, seed=4)
    cuts = torch.sort(torch.randn(9, 255), dim=1).values
    cfg = tg.GrowConfig(max_depth=6, max_bin=256)
    tc, rc = tg.build_tree(bins, gh, cuts, cfg)
    tk, rk = tg.build_tree(bins.to(cuda), gh.to(cuda), cuts.to(cuda), cfg)
    for name in tg.Tree._fields:
        assert torch.equal(getattr(tk, name).cpu(), getattr(tc, name)), name
    assert torch.equal(rk.cpu(), rc)


def test_wrappers_reject_bad_inputs(cuda):
    bins, gh, order, seg = [t.to(cuda) for t in _level(1000, 4, 256, 2)]
    with pytest.raises(ValueError):
        th.build_histogram(bins.float(), gh, order, seg, 2, 257)
    with pytest.raises(ValueError):
        th.build_histogram(bins, gh.double(), order, seg, 2, 257)
    unaligned = torch.zeros(2 * 1000 + 1, device=cuda)[1:].view(1000, 2)
    with pytest.raises(ValueError):
        th.build_histogram(bins, unaligned, order, seg, 2, 257)
    with pytest.raises(ValueError):  # order must be 16-byte aligned
        th.partition_leaf_values(
            torch.zeros(1001, dtype=torch.int32, device=cuda)[1:], seg,
            torch.full((2,), th.LEAF, dtype=torch.uint8, device=cuda),
            torch.zeros(2, device=cuda), torch.zeros(1000, device=cuda))
    with pytest.raises(ValueError):
        ts.find_splits(torch.zeros(2, 4, 257, 2, device=cuda).double(),
                       ts.SplitParams())
    with pytest.raises(ValueError):
        to.round_update(torch.zeros(5, device=cuda), torch.zeros(4, device=cuda),
                        torch.zeros(5, device=cuda), torch.ones(5, device=cuda),
                        True)
