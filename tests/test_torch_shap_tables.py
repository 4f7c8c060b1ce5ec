"""The tables and the launch plan of B15's exact and interaction kernels
(``ops/shap.py``), on the CPU.

The node bits (each tree's split nodes by ordinal and every path step's
ordinal) give, by a plain function that tests each split once a tree,
exactly the merged indicators ``o`` that ``_leaf_paths`` computes by
re-testing every step (bitwise: both are products of 0s and 1s), on random
forests with NaN features, categorical splits, depths 1, 6 and 9 and trees
of more than 64 split nodes. The kernel's tree blobs decode to the same
tables. The launch plan is a pure function of the row count, the shapes
and the SM count.
"""

import numpy as np
import pytest
import torch

from xgboost_ray_tpu_torch.ops import shap as tsh
from xgboost_ray_tpu_torch.ops.grow import Tree


def _forest(seed, n_trees, depth, nf, p_leaf):
    """A padded-heap forest with consistent node statistics: random splits,
    early leaves with probability p_leaf, every node's cover the sum of its
    children's."""
    rng = np.random.default_rng(seed)
    heap = (2 << depth) - 1
    f = {k: np.zeros((n_trees, heap), dt) for k, dt in (
        ("feature", np.int32), ("split_bin", np.int32),
        ("threshold", np.float32), ("default_left", bool),
        ("is_leaf", bool), ("value", np.float32), ("gain", np.float32),
        ("cover", np.float32), ("base_weight", np.float32))}
    f["feature"][:] = -1

    def grow(t, i, level):
        f["base_weight"][t, i] = rng.normal() * 0.3
        if level == depth or (level > 0 and rng.random() < p_leaf):
            f["is_leaf"][t, i] = True
            f["value"][t, i] = rng.normal() * 0.3
            f["cover"][t, i] = rng.uniform(1.0, 50.0)
            return f["cover"][t, i]
        f["feature"][t, i] = int(rng.integers(nf))
        f["threshold"][t, i] = rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0])
        f["split_bin"][t, i] = int(rng.integers(0, 4))
        f["default_left"][t, i] = rng.random() < 0.5
        c = grow(t, 2 * i + 1, level + 1) + grow(t, 2 * i + 2, level + 1)
        f["cover"][t, i] = c
        return c

    for t in range(n_trees):
        grow(t, 0, 0)
    return Tree(**f)


def _rows(seed, n, nf, cat=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, nf)).astype(np.float32)
    x[rng.random((n, nf)) < 0.1] = np.nan
    for c in cat:
        x[:, c] = rng.integers(0, 5, n) + np.where(rng.random(n) < 0.2, 0.5,
                                                   0.0)
    return torch.from_numpy(x)


# (trees, depth, features, categorical, p_leaf)
TABLE_CASES = {
    "depth6_nan": (6, 6, 28, (), 0.2),
    "categorical": (5, 4, 9, (2, 5), 0.2),
    "stump": (4, 1, 5, (), 0.0),
    "depth9": (2, 9, 10, (), 0.45),
    "over_64_splits": (2, 7, 12, (3,), 0.0),
}


def _sf(name):
    t, depth, nf, cat, p_leaf = TABLE_CASES[name]
    forest = _forest(len(name), t, depth, nf, p_leaf)
    sf = tsh.shap_forest(forest, depth, "cpu", num_features=nf,
                         cat_features=cat)
    return sf, _rows(len(name) + 1, 64, nf, cat)


@pytest.mark.parametrize("name", list(TABLE_CASES))
def test_node_bits_give_leaf_paths_indicators(name):
    sf, x = _sf(name)
    t = sf.n_trees
    if name == "over_64_splits":
        assert int(sf.n_splits.max()) > 64
    # every step's ordinal names its own node's record
    heap = sf.heap
    st = sf.steps.numpy()
    ords = sf.step_ord.numpy()
    assert np.array_equal(ords >= 0, st >= 0)
    for tt in range(t):
        live = st[tt] >= 0
        node = st[tt][live] & ((1 << 24) - 1)
        rec = sf.split_nodes[tt].numpy()[ords[tt][live]]
        assert np.array_equal(rec, sf.nodes.numpy()[tt * heap + node])
        assert len(np.unique(node)) == int(sf.n_splits[tt])
    for l in range(sf.max_leaves):
        o_ref = tsh._leaf_paths(sf, x, 0, t, l)[0]
        o_bits = tsh.leaf_indicators_plain(sf, x, 0, t, l)
        assert torch.equal(o_bits, o_ref), (name, l)


@pytest.mark.parametrize("name", list(TABLE_CASES))
def test_tree_blobs_decode_to_the_tables(name):
    sf, _ = _sf(name)
    if sf.max_depth > tsh.TAB_MAX_DEPTH:
        assert sf.tree_tab is None
        return
    feat_off, node_off, leaf_off, width = tsh.tab_layout(
        sf.max_feats, sf.max_splits, sf.max_leaves)
    assert sf.tree_tab.shape == (sf.n_trees, width)
    assert feat_off % 4 == node_off % 4 == leaf_off % 4 == width % 4 == 0
    tab = sf.tree_tab.numpy().view(np.uint32)
    for t in range(sf.n_trees):
        ns, nl, nu = (int(v) for v in tab[t, :3])
        assert (ns, nl, nu) == (int(sf.n_splits[t]), int(sf.n_leaves[t]),
                                int(sf.n_feats[t]))
        assert np.array_equal(tab[t, feat_off:feat_off + nu].view(np.int32),
                              sf.tree_feats[t, :nu].numpy())
        assert np.array_equal(
            tab[t, node_off:node_off + 2 * ns].view(np.int32),
            sf.split_nodes[t, :ns].numpy().reshape(-1))
        for l in range(nl):
            w = tsh.LEAF_WORDS
            rec = tab[t, leaf_off + w * l:leaf_off + w * (l + 1)]
            m = int(rec[0] & 0xFF)
            n_steps = int(rec[0] >> 8 & 0xFF)
            steps = sf.steps[t, l].numpy()
            assert m == int(sf.leaf_m[t, l])
            assert n_steps == int((steps >= 0).sum())
            assert rec[1:2].view(np.float32)[0] == sf.leaf_value[t, l]
            assert np.array_equal(rec[2:2 + m].view(np.float32),
                                  sf.elem_z[t, l, :m].numpy())
            slots = rec[10:12].view(np.uint8)
            assert np.array_equal(slots[:m], sf.elem_slot[t, l, :m].numpy())
            halves = rec[12:16].view(np.uint16)[:n_steps].astype(np.int64)
            assert np.array_equal(halves & 0xFF,
                                  sf.step_ord[t, l, :n_steps].numpy())
            assert np.array_equal(halves >> 8 & 1,
                                  steps[:n_steps] >> 24 & 1)
            assert np.array_equal(halves >> 9, steps[:n_steps] >> 25)
            pad = rec[12:16].view(np.uint16)[n_steps:]
            assert (pad == 8 << 9).all()
            z = sf.elem_z[t, l, :m].numpy()
            assert np.array_equal(rec[16:16 + m].view(np.float32),
                                  np.float32(1) / np.maximum(
                                      z, np.float32(1e-12)))


def test_shap_plan_is_a_function_of_the_shapes():
    """The plan of the HIGGS-shaped forest (depth 6, F = 28) on a 132-SM
    card: both kernels take the lanes mapping for a serve batch and the
    rows mapping for a million rows (the exact one with x and the tree's
    sums on chip in five CTAs an SM); more SMs move the switch; a forest
    deeper than 8 takes the deep kernel and refuses the others."""
    sf, _ = _sf("depth6_nan")
    f = 28
    small = tsh.shap_plan(sf, "exact", 37, f, 1, 132)
    big = tsh.shap_plan(sf, "exact", 1 << 20, f, 1, 132)
    assert small.mapping == "lanes" and small.grid == 37
    assert small.threads == 32 * tsh.LANES_WARPS
    assert big.mapping == "rows" and big.grid == (1 << 20) // tsh.ROWS_CTA
    assert min(big.off_x, big.off_sums) >= 0 and big.shared_bytes <= 44 << 10
    edge = tsh.LANES_ROWS_PER_SM["exact"] * 132
    assert tsh.shap_plan(sf, "exact", edge - 1, f, 1, 132).mapping == "lanes"
    assert tsh.shap_plan(sf, "exact", edge, f, 1, 132).mapping == "rows"
    assert tsh.shap_plan(sf, "exact", edge, f, 1, 264).mapping == "lanes"
    inter = tsh.shap_plan(sf, "interactions", 37, f, 1, 132)
    assert inter.mapping == "lanes" and inter.scratch_words == 0
    edge_i = tsh.LANES_ROWS_PER_SM["interactions"] * 132
    assert tsh.shap_plan(sf, "interactions", edge - 1, f, 1,
                         132).mapping == "lanes"
    assert tsh.shap_plan(sf, "interactions", edge_i, f, 1,
                         132).mapping == "rows"
    inter_big = tsh.shap_plan(sf, "interactions", 1 << 16, f, 1, 132)
    assert inter_big.mapping == "rows" and inter_big.off_sums == -1
    # a plan is the same for the same inputs, and forcing its own mapping
    # gives it back
    assert tsh.shap_plan(sf, "exact", 1 << 20, f, 1, 132) == big
    assert tsh.shap_plan(sf, "exact", 37, f, 1, 132, "lanes") == small
    # every mapping's buffers fit and do not overlap
    for plan in (small, big, inter, inter_big):
        assert plan.shared_bytes <= 200 << 10
        assert plan.scratch_words == (
            (plan.acc_words if plan.off_acc < 0 else 0)
            + (plan.sums_words if plan.off_sums < 0
               and plan.mapping == "rows" else 0))
    deep, _ = _sf("depth9")
    assert tsh.shap_plan(deep, "exact", 37, 10, 1, 132).mapping == "deep"
    for mapping in ("rows", "lanes"):
        with pytest.raises(ValueError, match="depth 8"):
            tsh.shap_plan(deep, "exact", 37, 10, 1, 132, mapping)
    with pytest.raises(ValueError, match="mapping"):
        tsh.shap_plan(sf, "exact", 37, f, 1, 132, "warps")


def test_scratch_floats_follows_the_plan():
    """A caller's scratch (``scratch_floats(..., n)`` words a row) is what
    the plan of n rows keeps in device memory; without n, the most any plan
    takes (what a chunk of rows budgets)."""
    sf, _ = _sf("depth6_nan")
    f, k = 28, 7
    for mode in ("exact", "interactions"):
        most = tsh.scratch_floats(sf, f, k, mode)
        for n in (8, 256, 1 << 20):
            got = tsh.scratch_floats(sf, f, k, mode, n)
            assert got == tsh.shap_plan(sf, mode, n, f, k, 132).scratch_words
            assert got <= most
    assert tsh.scratch_floats(sf, f, 1, "exact", 1 << 20) == f
    assert tsh.scratch_floats(sf, f, 1, "exact", 8) == 0
    assert tsh.scratch_floats(sf, f, 1, "saabas", 8) == f
