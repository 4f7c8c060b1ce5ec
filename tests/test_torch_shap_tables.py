"""The tables and the launch plans of B15's kernels (``ops/shap.py``), on
the CPU.

The node bits (each tree's split nodes by ordinal and every path step's
ordinal) give, by a plain function that tests each split once a tree,
exactly the merged indicators ``o`` that ``_leaf_paths`` computes by
re-testing every step (bitwise: both are products of 0s and 1s), on random
forests with NaN features, categorical splits, depths 1, 6 and 9 and trees
of more than 64 split nodes. The kernel's tree blobs decode to the same
tables. The Saabas walk tables, read by a plain function that walks each
row to a last-level position and folds that entry's pairs in tree order
(the Saabas kernel's arithmetic), give ``predict_contribs_plain``'s values
bit for bit on forests with NaN, categorical splits, depths 0, 1, 6, 9 and
10, features repeated on a path, early leaves, K = 3 interleaved classes,
``num_parallel_tree``, ``ntree_limit`` and tree weights; each entry holds
the leaf's path features once, in order of first occurrence. The
operations that bound Saabas are counted from the leaf each row reaches.
The launch plans are pure functions of the row count, the shapes and the
SM count.
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


# (trees, depth, features, categorical, p_leaf, classes, npt, weights, limit)
SAABAS_CASES = {
    "depth6_nan": (6, 6, 28, (), 0.2, 1, 1, False, 0),
    "categorical": (5, 4, 9, (2, 5), 0.2, 1, 1, False, 0),
    "stump": (4, 1, 5, (), 0.0, 1, 1, False, 0),
    "root_leaf": (3, 0, 4, (), 0.0, 1, 1, False, 0),
    "depth9": (3, 9, 10, (), 0.45, 1, 1, False, 0),
    "depth10": (3, 10, 10, (3,), 0.45, 1, 1, False, 0),
    "repeated_features": (8, 6, 3, (), 0.1, 1, 1, False, 0),
    "early_leaves": (10, 5, 12, (4,), 0.6, 1, 1, False, 0),
    "classes3_npt2": (18, 4, 9, (2,), 0.2, 3, 2, False, 0),
    "limit_weights": (12, 6, 28, (), 0.2, 3, 1, True, 7),
}


def _saabas_case(name, n=300):
    t, depth, nf, cat, p_leaf, k, npt, tw, limit = SAABAS_CASES[name]
    forest = _forest(3 * len(name) + t, t, depth, nf, p_leaf)
    sf = tsh.shap_forest(forest, depth, "cpu", num_features=nf,
                         cat_features=cat)
    weights = (np.random.default_rng(t).uniform(0.2, 1.5, t)
               .astype(np.float32) if tw else None)
    return sf, tsh.tree_scales(sf, k, npt, limit, weights), _rows(
        len(name), n, nf, cat)


def saabas_table_plain(sf, x, sc):
    """Saabas contributions [N, K, F + 1] read from the walk tables, the
    arithmetic of the kernel's ``rows`` mapping: each row walks to a
    last-level position p of each tree's table (``tsh.saabas_walk``), then
    adds entry p's pairs ``credit * scale_t`` into its class's accumulators,
    trees in order. Bitwise ``predict_contribs_plain`` where the entry holds
    the row's nonzero credits with the same bits: the adds the plain
    version makes for the other features add ``+0.0 * scale_t`` (+-0.0) to
    an accumulator that starts at +0.0 and so is never -0.0."""
    n, nf = x.shape
    k = sc.num_outputs
    d = sf.max_depth
    entries, halves, pitch, width = tsh.saabas_layout(d)
    t_read = sc.n_trees
    flat = sf.saabas_tab[:t_read].reshape(-1)
    credits = flat.view(torch.float32)
    p, _ = tsh.saabas_walk(sf, x, t_read)
    acc = torch.zeros((n, k, nf), dtype=torch.float32)
    rows = torch.arange(n)
    cls = sc.tree_class.tolist()
    for t in range(t_read):
        at = t * width + entries + p[:, t] * pitch
        for j in range(max(d, 1)):
            c = credits[at + j]
            f = (flat[at + halves + j // 2] >> (16 * (j % 2))) & tsh.SAABAS_PAD
            live = f != tsh.SAABAS_PAD
            fc = torch.where(live, f, 0).long()
            cur = acc[rows, cls[t], fc]
            acc[rows, cls[t], fc] = torch.where(live, cur + c * sc.scale[t],
                                                cur)
    out = torch.empty((n, k, nf + 1), dtype=torch.float32)
    out[:, :, :nf] = acc
    out[:, :, nf] = sc.bias[0][None, :]
    return out


@pytest.mark.parametrize("name", list(SAABAS_CASES))
def test_saabas_table_gives_plain_contribs(name):
    sf, sc, x = _saabas_case(name)
    assert sf.saabas_tab is not None
    got = saabas_table_plain(sf, x, sc)
    ref = tsh.predict_contribs_plain(sf, x, sc)
    assert torch.isfinite(got).all()
    assert torch.equal(got, ref), (name, float((got - ref).abs().max()))


@pytest.mark.parametrize("name", list(SAABAS_CASES))
def test_saabas_tables_decode(name):
    """Each tree's walk table starts with its node records of levels
    0..D-1; every entry holds distinct features (the pad after them), the
    features of the steps from the root to the leaf above it, each once in
    order of first occurrence; a depth-1 leaf's entries repeat below it."""
    sf, _, _ = _saabas_case(name)
    d = sf.max_depth
    entries, halves, pitch, width = tsh.saabas_layout(d)
    assert sf.saabas_tab.shape == (sf.n_trees, width)
    assert entries % 4 == width % 4 == 0 and pitch % 2 == 1
    assert halves == max(d, 1) and pitch >= halves + -(-halves // 2)
    assert entries + (pitch << d) <= width
    tab = sf.saabas_tab.numpy()
    nodes = sf.nodes.numpy().reshape(sf.n_trees, sf.heap, 2)
    top = (1 << d) - 1
    for t in range(sf.n_trees):
        assert np.array_equal(tab[t, :2 * top].reshape(-1, 2),
                              nodes[t, :top])
        for p in range(1 << d):
            at = entries + p * pitch + halves
            half = tab[t, at:at + -(-halves // 2)].view(np.uint32)
            feats = np.stack([half & 0xFFFF, half >> 16], 1).reshape(-1)[
                :halves]
            live = feats != tsh.SAABAS_PAD
            m = int(live.sum())
            assert live[:m].all() and not live[m:].any()
            # the path of p's bits, as the plain walk takes it
            path, idx = [], 0
            for s in range(d):
                w = int(nodes[t, idx, 1])
                if w & (1 << 24):
                    break
                path.append(w & 0xFFFFFF)
                idx = 2 * idx + 1 + ((p >> (d - 1 - s)) & 1)
            assert list(feats[:m]) == list(dict.fromkeys(path)), (t, p)


@pytest.mark.parametrize("name", list(SAABAS_CASES))
def test_saabas_ops_counts_the_leaf_each_row_reaches(name):
    """``saabas_ops`` (the operations that bound B15 Saabas) is, over the
    trees a call reads, a compare for each split test of each row's walk
    from the root to its leaf in the heap nodes, and a multiply and an add
    for each distinct feature on that path; never more than ``leaf_ops``
    (8 a level, 2 a feature of the tree) counts."""
    sf, sc, x = _saabas_case(name, n=97)
    n, nf = x.shape
    values = sf.nodes[:, 0].view(torch.float32)
    words = sf.nodes[:, 1]
    rows = torch.arange(n)
    want = 0
    for t in range(sc.n_trees):
        idx = torch.zeros(n, dtype=torch.long)
        on_path = torch.zeros((n, nf), dtype=torch.bool)
        for _ in range(sf.max_depth):
            w = words[t * sf.heap + idx]
            stepped = (w & tsh.LEAF) == 0
            f = (w & tsh.FEATURE_MASK).long()
            right = tsh._step_right(sf, values[t * sf.heap + idx], w,
                                    x[rows, f])
            on_path[rows[stepped], f[stepped]] = True
            want += int(stepped.sum())
            idx = torch.where(stepped, 2 * idx + 1 + right.long(), idx)
        want += 2 * int(on_path.sum())
    got = tsh.saabas_ops(sf, x, sc.n_trees, chunk=40)
    assert got == want
    assert got <= tsh.leaf_ops(sf, "saabas", sc.n_trees) * n


@pytest.mark.parametrize("mode", ["exact", "saabas"])
def test_shap_plan_is_a_function_of_the_shapes(mode):
    """The plan of the HIGGS-shaped forest (depth 6, F = 28) on a 132-SM
    card: each kernel takes the lanes mapping for a serve batch and the
    rows mapping for a million rows (exact with x and the tree's sums on
    chip in five CTAs an SM; Saabas with 256 rows a CTA, 2 trees a tile and
    its accumulators on chip; at K = 7, F = 54 with fewer rows a CTA); more
    SMs move the switch; a forest deeper than the tables take takes the
    deep kernel and refuses the others."""
    if mode == "saabas":
        _saabas_plan_cases()
        return
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


def _saabas_plan_cases():
    sf, _ = _sf("depth6_nan")
    f = 28
    small = tsh.shap_plan(sf, "saabas", 37, f, 1, 132)
    big = tsh.shap_plan(sf, "saabas", 1 << 20, f, 1, 132)
    assert small.mapping == "lanes" and small.grid == 37
    assert small.threads == 32 * tsh.LANES_WARPS and small.cta_rows == 1
    # the lanes mapping takes more rows a CTA while every SM keeps 4 CTAs
    mid = tsh.shap_plan(sf, "saabas", 4096, f, 1, 132)
    assert (mid.mapping, mid.cta_rows, mid.grid) == ("lanes", 4, 1024)
    mid8 = tsh.shap_plan(sf, "saabas", 8000, f, 1, 132)
    assert (mid8.mapping, mid8.cta_rows, mid8.grid) == ("lanes", 8, 1000)
    assert big.mapping == "rows" and big.threads == 256
    assert big.grid == (1 << 20) // 256 and big.tile_trees == 2
    assert min(big.off_tab, big.off_x, big.off_acc) >= 0
    assert big.shared_bytes <= 112 << 10
    width = tsh.saabas_layout(6)[3]
    assert big.shared_bytes == 4 * (2 * 2 * width + 2 * f * 256)
    edge = tsh.LANES_ROWS_PER_SM["saabas"] * 132
    assert tsh.shap_plan(sf, "saabas", edge - 1, f, 1,
                         132).mapping == "lanes"
    assert tsh.shap_plan(sf, "saabas", edge, f, 1, 132).mapping == "rows"
    assert tsh.shap_plan(sf, "saabas", edge, f, 1, 264).mapping == "lanes"
    # Covertype's K = 7, F = 54: 378 accumulators a row, fewer rows a CTA
    cov = tsh.shap_plan(sf, "saabas", 116_202, 54, 7, 132)
    assert cov.mapping == "rows" and cov.threads == 32
    assert cov.shared_bytes <= 112 << 10 and cov.off_acc >= 0
    # the same inputs give the same plan, forcing its own mapping gives it
    # back, and no plan of a forest with walk tables takes a scratch but
    # the deep kernel's (its class accumulators)
    assert tsh.shap_plan(sf, "saabas", 1 << 20, f, 1, 132) == big
    assert tsh.shap_plan(sf, "saabas", 37, f, 1, 132, "lanes") == small
    for plan in (small, big, cov):
        assert plan.scratch_words == 0 and plan.shared_bytes <= 200 << 10
    deep_plan = tsh.shap_plan(sf, "saabas", 37, f, 1, 132, "deep")
    assert deep_plan.mapping == "deep" and deep_plan.scratch_words == f
    # the deepest tables (68 KB a tree, 1-tree tiles) take the second
    # shared-memory budget, one CTA an SM
    sf10 = tsh.shap_forest(_forest(4, 2, 10, 6, 0.45), 10, "cpu",
                           num_features=6)
    assert sf10.saabas_tab is not None
    p10 = tsh.shap_plan(sf10, "saabas", 1 << 20, 6, 1, 132)
    width = tsh.saabas_layout(10)[3]
    assert (p10.mapping, p10.tile_trees, p10.threads) == ("rows", 1, 256)
    assert 112 << 10 < p10.shared_bytes <= 227 << 10
    assert p10.shared_bytes == 4 * (2 * width + 2 * 6 * 256)
    assert tsh.shap_plan(sf10, "saabas", 37, 6, 1, 132).mapping == "lanes"
    # a forest deeper than the walk tables take
    deep_sf = tsh.shap_forest(_forest(5, 2, 11, 6, 0.5), 11, "cpu",
                              num_features=6)
    assert deep_sf.saabas_tab is None
    assert tsh.shap_plan(deep_sf, "saabas", 37, 6, 1, 132).mapping == "deep"
    for mapping in ("rows", "lanes"):
        with pytest.raises(ValueError, match="depth 10"):
            tsh.shap_plan(deep_sf, "saabas", 37, 6, 1, 132, mapping)
    with pytest.raises(ValueError, match="mapping"):
        tsh.shap_plan(sf, "saabas", 37, f, 1, 132, "warps")


@pytest.mark.parametrize("mode", ["exact", "saabas"])
def test_scratch_floats_follows_the_plan(mode):
    """A caller's scratch (``scratch_floats(..., n)`` words a row) is what
    the plan of n rows keeps in device memory, and does not fall as n grows;
    without n, the most any plan takes. The Saabas kernel keeps its
    accumulators on chip in both mappings of a forest with walk tables."""
    sf, _ = _sf("depth6_nan")
    f, k = 28, 7
    modes = ("saabas",) if mode == "saabas" else ("exact", "interactions")
    for m in modes:
        most = tsh.scratch_floats(sf, f, k, m)
        last = 0
        for n in (8, 256, 20_000, 1 << 20):
            got = tsh.scratch_floats(sf, f, k, m, n)
            assert got == tsh.shap_plan(sf, m, n, f, k, 132).scratch_words
            assert last <= got <= most
            last = got
    if mode == "saabas":
        assert tsh.scratch_floats(sf, f, 1, "saabas", 8) == 0
        assert tsh.scratch_floats(sf, f, 1, "saabas", 1 << 20) == 0
        assert tsh.scratch_floats(sf, f, 1, "saabas") == f
        return
    assert tsh.scratch_floats(sf, f, 1, "exact", 1 << 20) == f
    assert tsh.scratch_floats(sf, f, 1, "exact", 8) == 0
