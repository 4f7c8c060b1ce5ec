"""Leaf-wise growth of the port against the JAX package under
``survival:aft`` and ``reg:quantileerror`` (2,400 rows x 8 features, 8 %
NaN, ``max_bin`` 64, seed 1, 4 rounds; the quantile case with two
categorical columns), on the CPU at ``num_actors`` 1.

What bounds the comparison (ROADMAP C10): the structure is exact (but for
the missing direction at nodes no missing row reaches, C8's case), covers,
leaf values, the history and ``predict`` within ``LG_RTOL``; a split's gain
within ``C10_GAIN_RTOL`` = 5e-4 relative. The gain is a small difference of
large scores (``G_L^2 / (H_L + lambda) + G_R^2 / (H_R + lambda) - G^2 / (H
+ lambda)``): where the parent's score is tens of times the gain, the
reference's one-hot histogram (C8: its sums within ~1e-5 of the rows' exact
sums) moves the gain by that factor more. Measured: against gains from an
f64 histogram of the same rows and gradients, the port's first tree is
within 5e-6 relative at every split (``test_first_tree_gains_vs_f64``
holds it to ``LG_RTOL``), the reference's up to 2.1e-4 (the quantile
case's node 4: parent score 670.9, gain 19.19); AFT's gains differ by up
to 4.3e-5. The port is not at fault, so the bound on the gains is the
oracle's, not a wider ``LG_RTOL``.
"""

import functools
import re
import warnings

import numpy as np
import pytest
import torch

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu_torch.distributed import _KeepEngine
from xgboost_ray_tpu_torch.ops.objectives import (
    grad_hess,
    objective_from_params,
    quantile_grad_hess,
)
from xgboost_ray_tpu_torch.params import parse_params

from test_torch_lossguide import LG_RTOL, _dry_nodes, _lg_close, _structure

#: the gains' bound against the reference (module docstring)
C10_GAIN_RTOL = 5e-4
ROUNDS = 4
N, F, MAX_BIN = 2400, 8, 64
_STAT = re.compile(r"(gain|cover|leaf)=([-0-9.e+]+)")


def _data():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, F)).astype(np.float32)
    x[rng.random(x.shape) < 0.08] = np.nan
    t = np.exp(0.5 * np.nan_to_num(x[:, 0]) - 0.3 * np.nan_to_num(x[:, 1])
               + 0.2 * rng.standard_normal(N)).astype(np.float32)
    censored = rng.random(N) < 0.3
    hi = np.where(censored, np.inf, t).astype(np.float32)
    xq = x.copy()
    xq[:, 6] = rng.integers(0, 5, N)
    xq[:, 7] = rng.integers(0, 7, N)
    xq[rng.random(N) < 0.08, 6] = np.nan
    yq = (np.nan_to_num(x[:, 0]) + np.where(xq[:, 6] == 2, 1.0, 0.0)
          + 0.5 * rng.standard_normal(N)).astype(np.float32)
    return x, t, hi, xq, yq


X, T, HI, XQ, YQ = _data()
FT = ["q"] * 6 + ["c", "c"]

CASES = {
    "aft": {"objective": "survival:aft",
            "aft_loss_distribution": "logistic",
            "aft_loss_distribution_scale": 1.2, "max_leaves": 16},
    "quantile": {"objective": "reg:quantileerror",
                 "quantile_alpha": [0.2, 0.8], "max_leaves": 12},
}


def _params(name):
    return {"grow_policy": "lossguide", "max_bin": MAX_BIN, "seed": 1,
            "max_depth": 6, **CASES[name]}


def _matrix(pkg, name):
    if name == "aft":
        return pkg.RayDMatrix(X, label_lower_bound=T, label_upper_bound=HI)
    return pkg.RayDMatrix(XQ, YQ, feature_types=FT)


def _rows(name):
    return X if name == "aft" else XQ


def _train(pkg, name, **kw):
    dm = _matrix(pkg, name)
    ev = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        bst = pkg.train(_params(name), dm, ROUNDS, evals=[(dm, "train")],
                        evals_result=ev,
                        ray_params=pkg.RayParams(num_actors=1), **kw)
    return bst, ev


@functools.lru_cache(maxsize=None)
def _jax(name):
    return _train(jx, name)


@functools.lru_cache(maxsize=None)
def _port(name):
    keep = _KeepEngine()
    bst, ev = _train(tx, name, device="cpu", callbacks=[keep])
    return bst, ev, keep.engine.bins.numpy().astype(np.int64)


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_matches_jax(name):
    """Structure exact, gains within ``C10_GAIN_RTOL``, covers and leaf
    values within ``LG_RTOL``."""
    jb, jev = _jax(name)
    tb, tev, _ = _port(name)
    jd, td = jb.get_dump(with_stats=True), tb.get_dump(with_stats=True)
    dry = _dry_nodes(tb, _rows(name))
    assert [_structure(d, s) for d, s in zip(td, dry)] == [
        _structure(d, s) for d, s in zip(jd, dry)]
    for kind in ("cover", "leaf"):
        _lg_close([float(v) for d in td for k, v in _STAT.findall(d)
                   if k == kind],
                  [float(v) for d in jd for k, v in _STAT.findall(d)
                   if k == kind], kind)
    got = np.array([float(v) for d in td for k, v in _STAT.findall(d)
                    if k == "gain"])
    ref = np.array([float(v) for d in jd for k, v in _STAT.findall(d)
                    if k == "gain"])
    assert got.shape == ref.shape
    assert (np.abs(got - ref)
            <= C10_GAIN_RTOL * np.maximum(np.abs(ref), 1.0)).all(), (
        np.abs(got - ref).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_history_and_predict_match_jax(name):
    """The history and ``predict`` within ``LG_RTOL``."""
    jb, jev = _jax(name)
    tb, tev, _ = _port(name)
    assert tev.keys() == jev.keys()
    for s in jev:
        for m in jev[s]:
            _lg_close(tev[s][m], jev[s][m], f"{s}-{m}")
    x = _rows(name)
    _lg_close(tb.predict(x, device="cpu"), np.asarray(jb.predict(x)),
              "predict")


def _round0_gh(name):
    """The first round's (g, h) [N] of output 0 in f64 (the f32 gradients
    at the base margin, as both packages compute them)."""
    p = parse_params(_params(name))
    obj = objective_from_params(p)
    m = torch.full((N,), float(obj.base_score_to_margin(0.5)),
                   dtype=torch.float32)
    w = torch.ones(N, dtype=torch.float32)
    if name == "aft":
        g, h = grad_hess(m, torch.from_numpy(T), w, obj,
                         lower=torch.from_numpy(T),
                         upper=torch.from_numpy(HI))
    else:
        g, h = quantile_grad_hess(m[:, None].repeat(1, 2),
                                  torch.from_numpy(YQ), w, obj.alphas)
        g, h = g[:, 0], h[:, 0]
    return g.double().numpy(), h.double().numpy()


def _gains64(bst, bins, name):
    """Per split node of the first tree: (node, the gain from f64 sums of
    the round-0 gradients of the rows the tree routes through it)."""
    g, h = _round0_gh(name)
    fo = bst.forest
    feat, leaf = np.asarray(fo.feature[0]), np.asarray(fo.is_leaf[0])
    sb, dl = np.asarray(fo.split_bin[0]), np.asarray(fo.default_left[0])
    cat = np.zeros(F, bool)
    cat[list(bst.cat_features)] = True
    lam = float(bst.params.reg_lambda)
    rows = np.arange(N)
    pos = np.zeros(N, np.int64)
    at = {}
    for _ in range(16):
        for node in np.unique(pos):
            at.setdefault(int(node), pos == node)
        live = ~leaf[pos] & (feat[pos] >= 0)
        f = np.maximum(feat[pos], 0)
        b = bins[rows, f]
        right = np.where(b == MAX_BIN, ~dl[pos],
                         np.where(cat[f], b != sb[pos], b > sb[pos]))
        pos = np.where(live, 2 * pos + 1 + right, pos)

    def score(gs, hs):
        return gs * gs / (hs + lam)

    out = []
    for node in np.nonzero((feat >= 0) & ~leaf)[0]:
        r = at[int(node)]
        b = bins[r, feat[node]]
        left = np.where(b == MAX_BIN, dl[node],
                        (b == sb[node]) if cat[feat[node]]
                        else (b <= sb[node]))
        gs, hs = g[r].sum(), h[r].sum()
        gl, hl = g[r][left].sum(), h[r][left].sum()
        out.append((int(node), score(gl, hl) + score(gs - gl, hs - hl)
                    - score(gs, hs)))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_first_tree_gains_vs_f64(name):
    """C10's cause: the port's first-tree gains are within ``LG_RTOL`` of
    gains from f64 sums of the same rows (measured: 5e-6); the reference's
    are not tighter than ``C10_GAIN_RTOL`` (measured: up to 2.1e-4)."""
    tb, _, bins = _port(name)
    jb, _ = _jax(name)
    tg = np.asarray(tb.forest.gain[0])
    jg = np.asarray(jb.forest.gain[0])
    exact = _gains64(tb, bins, name)
    assert exact
    for node, g64 in exact:
        assert abs(tg[node] - g64) <= LG_RTOL * max(abs(g64), 1.0), (
            node, tg[node], g64)
        assert abs(jg[node] - g64) <= C10_GAIN_RTOL * max(abs(g64), 1.0), (
            node, jg[node], g64)
