"""dart's and gblinear's kernels on a CUDA device: B4w (B4's
weighted-forest mode, ``xrt_walk_weighted``) and B16 (the gblinear
coordinate-descent round, ``xrt_linear``), each against its plain version,
and ``train()`` on the card. Every test skips without a CUDA device (the
kernels have no CPU mode); run them on the card with ``python -m pytest
tests/test_torch_cuda_linear.py -q --noconftest``.

Tolerances: every kernel output is bitwise its plain version's. A gblinear
model trained on the card equals the port's CPU path bit for bit (K4's
gradients, the margins' elementwise sums and B16 are bitwise there); B16's
split world mode (one launch for the bias's sums, then one a coordinate)
with an identity all-reduce equals its one-launch round.
"""

import numpy as np
import pytest
import torch

import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu_torch.engine import (
    kernel_launches,
    reset_kernel_launches,
)
from xgboost_ray_tpu_torch.ops import grow as tg
from xgboost_ray_tpu_torch.ops import linear as tl


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


def _forest(t_cap, n_trees, depth, nf, max_bin, seed):
    rng = np.random.default_rng(seed)
    heap = (2 << depth) - 1
    fo = tg.empty_tree(heap, "cpu", t_cap)
    fo.feature[:n_trees] = torch.from_numpy(
        rng.integers(0, nf, (n_trees, heap)).astype(np.int32))
    fo.split_bin[:n_trees] = torch.from_numpy(
        rng.integers(0, max_bin, (n_trees, heap)).astype(np.int32))
    fo.default_left[:n_trees] = torch.from_numpy(
        rng.random((n_trees, heap)) < 0.5)
    leaf = np.zeros((n_trees, heap), bool)
    leaf[:, heap // 2:] = True
    leaf[:, 1:heap // 2] |= rng.random((n_trees, heap // 2 - 1)) < 0.15
    fo.is_leaf[:n_trees] = torch.from_numpy(leaf)
    fo.is_leaf[n_trees:, 0] = True
    fo.value[:n_trees] = torch.from_numpy(
        rng.standard_normal((n_trees, heap)).astype(np.float32))
    return fo


@pytest.mark.parametrize("t_cap,n_trees,k,depth", [
    (1, 1, 1, 6), (10, 10, 1, 6), (20, 13, 1, 6), (70, 70, 7, 6),
    (48, 30, 3, 8), (60, 45, 1, 3)])
@pytest.mark.parametrize("bin_dtype", [np.uint8, np.int16])
@pytest.mark.parametrize("n", [1, 257, 100_003])
def test_b4w_bitwise(cuda, t_cap, n_trees, k, depth, bin_dtype, n):
    rng = np.random.default_rng(n + t_cap)
    nf, max_bin = 28, 64
    fo = _forest(t_cap, n_trees, depth, nf, max_bin, seed=t_cap + k)
    bins = torch.from_numpy(rng.integers(0, max_bin + 1, (n, nf))
                            .astype(bin_dtype))
    base = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.1, 1.2, t_cap).astype(np.float32))
    cat = torch.zeros(nf, dtype=torch.bool)
    cat[[3, 7]] = True
    for c in (None, cat):
        want = tg.predict_forest_weighted(fo, n_trees, bins, base, w, depth,
                                          max_bin, c)
        fc = tg.Tree(*[f.to(cuda) for f in fo])
        before = tg.predict_forest_weighted.launches
        got = tg.predict_forest_weighted(
            fc, n_trees, bins.to(cuda), base.to(cuda), w.to(cuda), depth,
            max_bin, None if c is None else c.to(cuda))
        assert tg.predict_forest_weighted.launches == before + 1
        assert _same(got, want)


def _linear_inputs(n, nf, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nf, n)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = 0.0
    g = rng.standard_normal((k, n)).astype(np.float32)
    h = rng.uniform(0.0, 0.3, (k, n)).astype(np.float32)
    gh = torch.from_numpy(np.stack([g, h], axis=2))
    w = torch.from_numpy(rng.standard_normal((nf, k)).astype(np.float32)
                         * 0.1)
    w[nf // 2:] = 0.0  # weights at 0 the L1 clamp holds there
    b = torch.from_numpy(rng.standard_normal(k).astype(np.float32))
    return torch.from_numpy(x), gh, w, b


@pytest.mark.parametrize("n,nf,k", [(1, 3, 1), (1023, 5, 1), (1025, 28, 1),
                                    (300_001, 28, 1), (50_000, 54, 7),
                                    (4096, 0, 2)])
@pytest.mark.parametrize("lam,alp", [(0.0, 0.0), (5.0, 40.0)])
def test_b16_bitwise(cuda, n, nf, k, lam, alp):
    xt, gh, w, b = _linear_inputs(n, nf, k, seed=n + nf)
    gh_plain = gh.clone()
    wp, bp = tl.linear_round(xt, gh_plain, w, b, 0.5, lam, alp)
    for split in (False, True):
        ghc = gh.to(cuda)
        before = tl.linear_round.launches
        wc, bc = tl.linear_round(
            xt.to(cuda), ghc, w.to(cuda), b.to(cuda), 0.5, lam, alp,
            (lambda t: t) if split else None)
        assert tl.linear_round.launches - before == (nf + 2 if split else 1)
        assert _same(wc, wp) and _same(bc, bp)
        assert _same(ghc, gh_plain)


def test_b16_reruns_bitwise(cuda):
    xt, gh, w, b = _linear_inputs(2_000_000, 28, 1, seed=3)
    outs = [tl.linear_round(xt.to(cuda), gh.to(cuda), w.to(cuda),
                            b.to(cuda), 0.5, 10.0, 1.0) for _ in range(3)]
    for wc, bc in outs[1:]:
        assert _same(wc, outs[0][0]) and _same(bc, outs[0][1])


def _data(n=20_000, nf=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, nf)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    y = (np.nan_to_num(x[:, 0] - 0.5 * x[:, 1]) > 0).astype(np.float32)
    return x, y


@pytest.mark.parametrize("objective", ["binary:logistic", "multi:softprob"])
def test_gblinear_train_card_equals_cpu(cuda, objective):
    x, y = _data()
    if objective == "multi:softprob":
        y = (np.nan_to_num(x[:, 2]) > 0).astype(np.float32) + y
    params = {"booster": "gblinear", "objective": objective, "eta": 0.5,
              "reg_alpha": 0.001, "reg_lambda": 0.01}
    if objective == "multi:softprob":
        params["num_class"] = 3
    out = {}
    for dev in ("cpu", "cuda:0"):
        reset_kernel_launches()
        ev = {}
        bst = tx.train(params, tx.RayDMatrix(x[:15000], y[:15000]), 4,
                       evals=[(tx.RayDMatrix(x[15000:], y[15000:]), "t")],
                       evals_result=ev, device=dev,
                       ray_params=tx.RayParams(num_actors=1))
        out[dev] = (bst, ev, kernel_launches())
    (cb, cev, _), (gb, gev, launches) = out["cpu"], out["cuda:0"]
    np.testing.assert_array_equal(gb.weights, cb.weights)
    np.testing.assert_array_equal(gb.bias, cb.bias)
    assert launches["B16"] == 4
    np.testing.assert_allclose(gev["t"][next(iter(gev["t"]))],
                               cev["t"][next(iter(cev["t"]))], rtol=1e-6)
    np.testing.assert_allclose(gb.predict(x), cb.predict(x, device="cpu"),
                               rtol=1e-5, atol=1e-6)


def test_dart_train_launches(cuda):
    """A dart round launches B4w twice over the training rows and once a
    held-out set, but for the first round's margins under the drops (no
    tree yet: the static margins, no launch); the model trains and
    predicts on the card."""
    x, y = _data()
    params = {"booster": "dart", "objective": "binary:logistic",
              "rate_drop": 0.3, "max_depth": 4, "seed": 1}
    dtrain = tx.RayDMatrix(x[:15000], y[:15000])
    reset_kernel_launches()
    bst = tx.train(params, dtrain, 5,
                   evals=[(dtrain, "train"),
                          (tx.RayDMatrix(x[15000:], y[15000:]), "test")],
                   device="cuda:0", ray_params=tx.RayParams(num_actors=1))
    launches = kernel_launches()
    assert launches["B4w"] == 5 * 3 - 1
    assert bst.tree_weights.shape == (5,)
    p = bst.predict(x)
    assert p.shape == (x.shape[0],) and np.isfinite(p).all()
