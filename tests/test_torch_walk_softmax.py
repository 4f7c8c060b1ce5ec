"""B4's plain walk against the JAX ``predict_tree_binned`` at shapes beyond
the eval tests' (20 trees of depth 8, 2,000 features, uint8 bins), and the
host side of the two CUDA kernels' launches: the softmax pass's path for
each K (``ops/objectives.softmax_plan``) and B4's mapping, rows a tile and
tree groups (``ops/grow.walk_plan``), their shared memory held against what
a CTA may take.

Tolerances: the walk's row values bitwise; the wide softmax path's class
sum, carried up its window tree as the kernel carries it, bitwise
``ops/split.tree_sum`` (the reference's reduce).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgboost_ray_tpu.ops import grow as jg
from xgboost_ray_tpu_torch.ops import grow as tg
from xgboost_ray_tpu_torch.ops import objectives as to
from xgboost_ray_tpu_torch.ops.predict import tree_windows
from xgboost_ray_tpu_torch.ops.split import tree_sum

#: what a CTA may take after the opt-in attribute
SHARED_MAX = 227 * 1024


def _random_heaps(rng, t, depth, f, max_bin):
    """T heaps with leaves at every depth and unused nodes below them."""
    heap = (2 << depth) - 1
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
    return dict(feature=feature,
                split_bin=rng.integers(0, max_bin, (t, heap)).astype(np.int32),
                default_left=rng.random((t, heap)) < 0.5, is_leaf=is_leaf,
                value=rng.standard_normal((t, heap)).astype(np.float32))


@pytest.mark.parametrize("n,f,t,depth", [(3000, 13, 20, 8),
                                         (1500, 2000, 3, 6)])
def test_b4_plain_matches_jax_uint8(n, f, t, depth):
    """The plain walk of T trees in one call ([T, N]) against the JAX walk
    of each tree, uint8 bins with the missing bin 255."""
    max_bin = 255
    rng = np.random.default_rng(n + f + t)
    bins = rng.integers(0, max_bin + 1, (n, f)).astype(np.uint8)
    bins[rng.random((n, f)) < 0.1] = max_bin
    fields = _random_heaps(rng, t, depth, f, max_bin)
    zeros = np.zeros_like(fields["value"])
    forest = tg.Tree(threshold=torch.from_numpy(zeros),
                     gain=torch.from_numpy(zeros),
                     cover=torch.from_numpy(zeros),
                     base_weight=torch.from_numpy(zeros),
                     **{k: torch.from_numpy(v) for k, v in fields.items()})
    got = tg.predict_tree_binned(forest, torch.from_numpy(bins), depth,
                                 max_bin)
    assert got.shape == (t, n) and got.dtype == torch.float32
    for j in range(t):
        jtree = jg.Tree(threshold=jnp.zeros(zeros.shape[1]),
                        gain=jnp.zeros(zeros.shape[1]),
                        cover=jnp.zeros(zeros.shape[1]),
                        base_weight=jnp.zeros(zeros.shape[1]),
                        **{k: jnp.asarray(v[j]) for k, v in fields.items()})
        ref = np.asarray(jg.predict_tree_binned(jtree, jnp.asarray(bins),
                                                depth, max_bin))
        assert np.array_equal(got[j].numpy().view(np.int32),
                              ref.view(np.int32)), j


# --------------------------------------------------------------------------
# the softmax pass's launch plan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k", list(range(2, 34)) + [64, 100, 1000, 1024,
                                                     1025, 40000])
def test_softmax_plan_path_for_each_k(k):
    """Up to 32 classes the register path of the least bound at or above K,
    the rows at an odd pitch of at least K floats (a warp's reads of its 32
    rows at one class fall in 32 banks), two stage buffers within a CTA's
    shared memory; above, the wide path with the window tree of the reference's
    class sum. Training and eval mode stage the rows' K row values, labels
    and weights beside their margins; the transforms stage margins only."""
    plan = to.softmax_plan(k)
    if k <= 32:
        assert plan.kmax == min(b for b in to.SMX_KMAX if b >= k)
        assert plan.pitch in (k, k + 1) and plan.pitch % 2 == 1
        assert len({(r * plan.pitch) % 32 for r in range(32)}) == 32
        for mode, staged in (("train", k + 2), ("eval", k + 2), ("prob", 0),
                             ("class", 0)):
            got = to.softmax_plan(k, mode)
            assert got._replace(shared_bytes=0) == plan._replace(
                shared_bytes=0)
            assert got.shared_bytes == 2 * 4 * to.SMX_ROWS_PER_CTA * (
                plan.pitch + staged)
            assert got.shared_bytes <= SHARED_MAX
    else:
        front0, _, top, _, front = tree_windows(k)
        assert plan.kmax == 0 and plan.shared_bytes == 0
        assert (plan.front0, plan.top) == (front0, top)
        assert plan.front[:len(front)] == tuple(front)


def _window_sum(e, plan):
    """The wide path's class sum as ``csrc/softmax.cu`` carries it: each
    window of 32 summed in order, its sum pushed up the window tree, closing
    every window it ends (``xrt_push``), the open ones closed at the end
    (``xrt_total``); float32 adds."""
    f32 = np.float32
    levels = len(plan.front)
    part = [f32(0)] * levels
    ws = f32(0)
    for c, x in enumerate(e):
        ws = f32(ws + x)
        if (plan.front0 + c) % 32 == 31:
            j = (plan.front0 + c) // 32
            part[1] = f32(part[1] + ws)
            for lv in range(1, levels - 1):
                if lv >= plan.top or (j + plan.front[lv] + 1) % 32:
                    break
                part[lv + 1] = f32(part[lv + 1] + part[lv])
                part[lv] = f32(0)
                j = (j + plan.front[lv]) // 32
            ws = f32(0)
    part[1] = f32(part[1] + ws)
    for lv in range(1, levels - 1):
        if lv < plan.top:
            part[lv + 1] = f32(part[lv + 1] + part[lv])
    return part[plan.top]


@pytest.mark.parametrize("k", [33, 63, 64, 65, 100, 1000, 1024, 1025, 1100,
                               40000])
def test_softmax_plan_window_tree_sums_as_the_reference(k):
    """The wide path's window tree, carried as the kernel carries it, sums
    K values of every magnitude to ``tree_sum``'s bits (the reference's
    reduce over the class axis)."""
    plan = to.softmax_plan(k)
    rng = np.random.default_rng(k)
    for _ in range(3):
        e = (rng.random(k) * 10.0 ** rng.uniform(-30, 3, k)).astype(
            np.float32)
        ref = tree_sum(torch.from_numpy(e)[None])[0].numpy()
        got = _window_sum(e, plan)
        assert np.float32(got).view(np.int32) == ref.view(np.int32)


def test_softmax_plan_rejects_one_class():
    with pytest.raises(ValueError):
        to.softmax_plan(1)


# --------------------------------------------------------------------------
# B4's launch plan
# --------------------------------------------------------------------------


def _round16(b):
    return -(-b // 16) * 16


@pytest.mark.parametrize("bb", [1, 2])
@pytest.mark.parametrize("f", [1, 28, 54, 1600, 2000, 5000])
@pytest.mark.parametrize("t", [1, 7, 100, 1000])
@pytest.mark.parametrize("depth", [1, 6, 12, 14])
def test_walk_plan_for_each_shape(bb, f, t, depth):
    """Tiled where 32 rows take at most 100 KB, with the most rows (a
    power of two, 32-1024) whose tile holds 32 KB; the forest staged whole
    where it fits beside the two tiles, else in groups that cover the T
    trees, else not at all; the shared memory of forest and tiles within
    the 227 KB a CTA may take after the opt-in."""
    plan = tg.walk_plan(f, bb, t, depth)
    heap = (2 << depth) - 1
    row = f * bb
    assert plan.mapping == ("tiled" if 32 * row <= 100 * 1024 else "gather")
    r = plan.rows_per_tile
    assert r & (r - 1) == 0
    if plan.mapping == "tiled":
        assert 32 <= r <= 1024
        assert r * row <= 32 * 1024 or r == 32
        assert r == 1024 or r == 32 or 2 * r * row > 32 * 1024
        tiles = 2 * _round16(r * row)
    else:
        tiles = 0
    forest = _round16(12 * plan.trees_per_group * heap)
    assert plan.shared_bytes == tiles + forest <= tg.WALK_SHARED_MAX
    if tiles + _round16(12 * t * heap) <= tg.WALK_SHARED_MAX:
        assert (plan.trees_per_group, plan.n_groups) == (t, 1)
    elif tiles + _round16(12 * heap) <= tg.WALK_SHARED_MAX:
        g, ng = plan.trees_per_group, plan.n_groups
        assert 1 <= g < t and g * ng >= t > g * (ng - 1)
        # the fewest groups: one more tree a group would not fit
        most = (tg.WALK_SHARED_MAX - tiles - 15) // (12 * heap)
        assert ng == -(-t // most)
    else:
        assert (plan.trees_per_group, plan.n_groups) == (0, 1)


def test_walk_plan_forced_mappings():
    """Either mapping can be asked for where the rows tile; the gather
    mapping stages no rows; a name outside the two raises."""
    tiled = tg.walk_plan(28, 2, 1, 6, "tiled")
    gather = tg.walk_plan(28, 2, 1, 6, "gather")
    assert tiled.mapping == "tiled" and gather.mapping == "gather"
    assert gather.shared_bytes == _round16(12 * 127)
    assert tiled.shared_bytes == gather.shared_bytes + 2 * 512 * 56
    assert tg.walk_plan(28, 2, 1, 6) == tiled
    with pytest.raises(ValueError):
        tg.walk_plan(28, 2, 1, 6, "rows")


def test_walk_wrapper_on_cpu_is_the_plain_walk():
    """On the CPU the wrapper is the plain walk whatever plan it is given,
    and launches nothing."""
    rng = np.random.default_rng(3)
    bins = torch.from_numpy(rng.integers(0, 257, (500, 9))).to(torch.int16)
    fields = _random_heaps(rng, 4, 5, 9, 256)
    zeros = torch.zeros(4, 63)
    forest = tg.Tree(threshold=zeros, gain=zeros, cover=zeros,
                     base_weight=zeros,
                     **{k: torch.from_numpy(v) for k, v in fields.items()})
    before = dict(tg.predict_tree_binned.launches_by_mapping)
    ref = tg.predict_tree_binned_plain(forest, bins, 5, 256)
    for plan in (None, tg.walk_plan(9, 2, 4, 5, "gather")):
        got = tg.predict_tree_binned(forest, bins, 5, 256, plan=plan)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert tg.predict_tree_binned.launches_by_mapping == before
