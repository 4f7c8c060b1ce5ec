"""K4 (``csrc/objective.cu``) on the CPU: its launch plan, the arguments its
wrapper passes, the identity its error term rests on, and its plain
version against the JAX package at the sigmoid's edges.

Tolerances: the plan's tiles cover every row exactly once; gradients and
hessians bitwise against the JAX package's compiled ``grad_hess`` (a NaN
matches any NaN: payloads are not part of the contract).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgboost_ray_tpu.ops import objectives as jo
from xgboost_ray_tpu_torch.ops import _build
from xgboost_ray_tpu_torch.ops import objectives as to

#: row counts at K4's vector (4 rows) and tile boundaries, HIGGS's test
#: set plus one, HIGGS's training set
PLAN_NS = [0, 1, 3, 4, 5, 2047, 2048, 2049, 500_001, 11_000_000]


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("n", PLAN_NS)
def test_k4_plan_covers_every_row_once(n, sms):
    """CTA c takes tiles c, c + grid, ... and thread t of a tile its rows
    4 t .. 4 t + 3 (``csrc/objective.cu``): every row lies in exactly one
    (CTA, tile, thread), and no CTA is idle but the one of an empty set."""
    plan = to.k4_plan(n, sms)
    tile_rows = to.K4_TILE_ROWS
    assert tile_rows == 512 * 4  # kThreads x 4 rows of csrc/objective.cu
    assert plan.tiles == -(-n // tile_rows)
    assert 1 <= plan.grid <= max(1, min(plan.tiles, sms * to.K4_CTAS_PER_SM))
    if n:
        assert plan.grid == min(plan.tiles, sms * to.K4_CTAS_PER_SM)
    # thread t's rows of a tile: 4 t + j, j < 4 (one 16-byte vector)
    in_tile = (4 * np.arange(512)[:, None] + np.arange(4)[None, :]).ravel()
    rows = []
    for c in range(plan.grid):
        tiles = np.arange(c, plan.tiles, plan.grid, dtype=np.int64)
        if n:
            assert tiles.size, f"CTA {c} has no tile"
        rows.append((tiles[:, None] * tile_rows + in_tile).ravel())
    rows = np.concatenate(rows)
    hits = np.bincount(rows[rows < n], minlength=n)
    assert hits.shape == (n,) and np.all(hits == 1)


@pytest.mark.parametrize("n", [0, 5, 500_001])
def test_k4_grid_is_the_same_in_both_modes(n):
    """The launch's grid and rows come from ``k4_plan`` alone: the gh and
    eval modes of one set sum the same rows in the same CTAs (their partials
    are bitwise equal on the card)."""
    plan = to.k4_plan(n, 132)
    m, rv, y, w = (torch.zeros(n) for _ in range(4))
    part = torch.zeros(plan.grid, 4)
    ticket = torch.zeros(1, dtype=torch.int32)
    out = torch.zeros(4, dtype=torch.float64)
    args = {}
    for mode, gh, logistic in (("logistic", torch.zeros(n, 2), True),
                               ("squared", torch.zeros(n, 2), False),
                               ("eval", None, True), ("eval", None, False)):
        a = to._k4_args(plan, m, rv, y, w, gh, part, ticket, out, logistic,
                        2.5)
        args.setdefault(mode, []).append(a)
        assert (a.n, a.grid, a.mode) == (n, plan.grid, to._K4_MODES[mode])
        assert a.scale_pos_weight == 2.5
        assert (a.gh is None) == (gh is None or n == 0)  # empty: no pointer
    grids = {a.grid for v in args.values() for a in v}
    assert grids == {plan.grid}
    assert {f for f, _ in _build.K4Args._fields_} >= {
        "margin", "row_value", "label", "weight", "gh", "part", "ticket",
        "out", "n", "grid", "mode", "scale_pos_weight"}


#: kHalfMargin of csrc/objective.cu: the least float32 m with sigmoid(m) >
#: 0.5, as its bits
HALF_MARGIN = np.array([0x33C00001], np.int32).view(np.float32)[0]


def test_error_term_threshold():
    """The kernel's error term takes sigmoid(m) > 0.5 as m >= kHalfMargin
    (8.94e-8, no exp): the plain sigmoid agrees on every float32 within
    2^16 ulps of it and of zero on either side, on margins over the whole
    range, at the clamp, infinities and NaN."""
    rng = np.random.default_rng(0)
    base = np.array([HALF_MARGIN, 0.0, -0.0], np.float32).view(np.int32)
    near = (base[:, None].astype(np.int64)
            + np.arange(-(1 << 16), 1 << 16)[None, :])
    near = near[(near >= 0) & (near < 1 << 31)].astype(np.int32)
    m = np.concatenate([
        near.view(np.float32), -near.view(np.float32),
        rng.standard_normal(200_000).astype(np.float32)
        * np.float32(10.0) ** rng.integers(-38, 38, 200_000).astype(np.float32),
        np.array([88.5, -88.5, 1e30, -1e30, np.inf, -np.inf, np.nan],
                 np.float32)])
    m = torch.from_numpy(m)
    assert torch.equal(to.sigmoid(m) > 0.5, m >= float(HALF_MARGIN))
    below = np.nextafter(HALF_MARGIN, np.float32(0))
    assert float(to.sigmoid(torch.tensor([below]))) == 0.5


#: margins at the sigmoid's edges: +-87 (the last normal p), where p turns
#: subnormal and is flushed (-87.3 .. -88.0), past the exp's clamp (+-88.5,
#: +-100), NaN, +-inf, signed zeros and subnormal margins
EDGE_MARGINS = [87.0, -87.0, 87.3, -87.3, -87.33, -87.34, -87.35, -87.4,
                -88.0, -88.37, -88.38, 88.5, -88.5, 100.0, -100.0, 103.9,
                -103.9, float("nan"), float("inf"), float("-inf"), 0.0, -0.0,
                1e-40, -1e-40, 1e-30, -1e-30]


def _edge_rows(label):
    m = np.array(EDGE_MARGINS, np.float32)
    m = np.concatenate([m, np.float32(-87.25) - np.arange(200, dtype=np.float32)
                        * np.float32(0.005)])  # p crosses into subnormals
    n = m.shape[0]
    y = np.full(n, label, np.float32)
    w = np.linspace(0.25, 3.0, n).astype(np.float32)
    return m, y, w


def _same_nan(a, b):
    nan = np.isnan(a)
    return bool(np.array_equal(nan, np.isnan(b)) and np.array_equal(
        a[~nan].view(np.int32), b[~nan].view(np.int32)))


@pytest.mark.parametrize("label", [0.0, 1.0, 0.3, 1e-40])
@pytest.mark.parametrize("name,spw", [
    ("binary:logistic", 1.0), ("binary:logistic", 2.5),
    ("reg:squarederror", 1.0)])
def test_plain_k4_edge_margins_bitwise(name, spw, label):
    """The plain K4 (``round_update`` on CPU tensors) against the JAX
    package's compiled ``grad_hess`` at the margins where its exp clamps,
    where p turns subnormal, NaN and infinities, with soft and subnormal
    labels: g and h bitwise (NaN where the JAX package's is NaN). The
    reference's CPU program reads subnormal operands as zero and flushes
    subnormal products: at m = -87, p w is a subnormal it gives as 0."""
    m, y, w = _edge_rows(label)
    obj = jo.get_objective(name, scale_pos_weight=spw)
    new = m + np.float32(0.0)  # the margins after K4's add (-0 + 0 = +0)
    g, h = jax.jit(obj.grad_hess)(jnp.asarray(new[:, None]), jnp.asarray(y),
                                  jnp.asarray(w))
    margin = torch.from_numpy(m.copy())
    gh, _ = to.round_update(margin, torch.zeros(m.shape[0]),
                            torch.from_numpy(y), torch.from_numpy(w),
                            name == "binary:logistic", spw)
    assert _same_nan(margin.numpy(), new)
    assert _same_nan(gh[:, 0].numpy(), np.asarray(g)[:, 0])
    assert _same_nan(gh[:, 1].numpy(), np.asarray(h)[:, 0])


@pytest.mark.parametrize("name", ["binary:logistic", "reg:squarederror"])
def test_plain_k4_subnormal_weights_bitwise(name):
    """Subnormal and huge weights and margins: an operand the reference
    reads as zero gives a zero product even where the exact one is normal
    (1e20 x 1e-40); the squared error's h is the weight itself, unflushed."""
    m = np.array([1e20, 1e-40, 5.0, 0.0, -87.0, -87.0, 3.0, -2.0], np.float32)
    y = np.array([0.0, 0.0, 1e-40, 0.0, 0.0, 1e-40, 1.0, 0.0], np.float32)
    w = np.array([1e-40, 1e30, 1.0, 1e-40, 1e-40, 1.0, 1e-39, 1e38],
                 np.float32)
    obj = jo.get_objective(name, scale_pos_weight=3.0)
    g, h = jax.jit(obj.grad_hess)(jnp.asarray(m[:, None]), jnp.asarray(y),
                                  jnp.asarray(w))
    tg, th = to.grad_hess(torch.from_numpy(m), torch.from_numpy(y),
                          torch.from_numpy(w), name == "binary:logistic", 3.0)
    assert _same_nan(tg.numpy(), np.asarray(g)[:, 0])
    assert _same_nan(th.numpy(), np.asarray(h)[:, 0])
