"""SHAP values on raw features, and B15, their kernels.

Port of the SHAP half of ``xgboost_ray_tpu/ops/predict.py``:
``predict_contribs`` (``:82-146``, Saabas path attribution),
``predict_contribs_exact`` (exact TreeSHAP: ``_shap_weight_table`` ``:149``,
``_shap_path_data`` ``:164``, ``_poly_extend`` ``:228``, ``_poly_unwind``
``:234``, ``_shap_one_tree`` ``:252``, ``:299-347``) and
``predict_interactions`` (``_shap_interactions_one_tree`` ``:350-446``,
``:449-498``). Rows route by the port's own rule (``ops/predict._step_right``:
threshold compare, categorical code equality, NaN takes the default).

Leaves, not slots. The reference enumerates all ``2^D`` bottom slots of the
padded heap, most of them empty, and keeps one canonical slot per leaf.
:func:`shap_forest` walks each tree once on the host instead and lists its
canonical leaves in slot order (left to right), each with its merged path:
for every unique feature (the reference's repeated-feature rule, ``:205-214``:
a repeat multiplies its cover ratio ``z`` and its indicator ``o`` into the
feature's first occurrence) the ratio ``cover[child] / max(cover[node],
1e-12)`` (0 where ``cover[node]`` is 0), and the (node, branch bit)
conditions whose product is ``o(x)``. A leaf's contributions then run in
the reference's order: EXTEND over the path's elements, UNWIND each one
(synthetic division, ``o == 1``: the downward recurrence; ``o == 0``: the
guarded quotient), ``v (o - z) sum_k r_k w[m][k]`` with the float64-built
weight table cast to f32. Per tree the leaves' contributions sum in slot
order into the tree's features, then ``acc += phi * scale`` with the
tree's scale (``tree_weights``, ``ntree_limit``, ``1 / num_parallel_tree``)
into its class (round-major: tree t is class ``(t // npt) % K``), trees in
order, as the reference's ``lax.scan``. The tree expectations and the
Saabas root weights are row-independent: their class sums (the bias
column) are taken once on the host in that order (:func:`tree_scales`).

Each wrapper sends CPU tensors to its plain PyTorch version and CUDA
tensors to kernel B15 (``csrc/shap.cu``), or raises: there is no
fallback. ``launches`` counts kernel launches, ``launches_by_mode`` by
entry point, ``LAUNCHES_BY_MAPPING`` by (entry point, mapping). The plain
versions are vectorised over rows and groups of trees and loop over leaf
positions and path elements; the tests use them, and ``chip_smoke.py``
holds the kernels against them on the card. Nothing on the card's path
calls them.

The exact and interaction kernels read, for forests up to depth 8, one
blob a tree (``tree_tab``): its split nodes by ordinal, so a row tests
each split once a tree into bits, and its leaves as records whose steps
name those ordinals (:func:`leaf_indicators_plain` is the plain reading of
the same bits). :func:`shap_plan` maps a launch from the row count, the
shapes and the card's SM count: ``rows`` (a thread a row, 128 rows a CTA)
for large batches, ``lanes`` (a row a CTA of 4 warps: warps take trees,
lanes take leaves, every sum on chip) for small ones such as a served
batch, ``deep`` (the rolled thread-a-row kernels) for deeper forests. All
three keep the plain versions' per-leaf operations and fold orders, so
they give the same bits, and a row's result does not depend on the
mapping its batch takes.

The Saabas kernel reads, for forests up to depth :data:`SAABAS_MAX_DEPTH`,
a walk table a tree (``saabas_tab``): its node records, and for every
last-level position of a walk that goes on below leaves the leaf's path
credits, built on the host by the plain version's own f32 operations
(:func:`saabas_walk` finds the entry a row reads). Its
``rows`` mapping walks tiles of staged tables with the class accumulators
on chip and adds each leaf's pairs; its ``lanes`` mapping (a row a CTA)
stages each tree's credit vector and folds it in tree order; ``deep`` is
the thread-a-row kernel of deeper forests.
"""

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from xgboost_ray_tpu_torch.ops import _build
from xgboost_ray_tpu_torch.ops.predict import (
    CATEGORICAL,
    DEFAULT_LEFT,
    FEATURE_MASK,
    LEAF,
    MAX_FEATURES,
    _step_right,
)

#: deepest tree B15 takes: its register arrays hold a path of 16 splits
#: (the heap's own limit in the xgboost-JSON importer)
MAX_DEPTH = 16
#: a path step's word: heap index of the node, then the branch bit and the
#: merged element the step belongs to
_NODE_MASK = (1 << 24) - 1
_BIT_SHIFT = 24
_ELEM_SHIFT = 25
MODES = ("saabas", "exact", "interactions")
#: deepest forest the tree blobs and the two mappings of the exact and
#: interaction kernels take (a split ordinal in a byte, 8 elements a leaf);
#: deeper forests run the rolled kernel of a thread a row ("deep")
TAB_MAX_DEPTH = 8
#: words of a tree blob's header: split nodes, leaves, features, 0
TAB_HEADER = 4
#: words of a leaf record in the blob: m | steps << 8, v, z[8], the slots
#: as 8 bytes, the steps as 8 halves (ordinal | bit << 8 | element << 9;
#: element 8 past the leaf's depth), then RN(1 / max(z, 1e-12))[8], the
#: reciprocals the kernels' quotients start from
LEAF_WORDS = 24
#: the kernels' mappings (``csrc/shap.cu``): a thread a row, a row a CTA
#: (exact and interactions: warps take trees, lanes take leaves; Saabas:
#: threads take trees, lanes take the class accumulators), and the
#: thread-a-row kernels of forests without tree blobs or walk tables
MAPPINGS = ("rows", "lanes", "deep")
#: most f32 elements a plain step holds per tensor ([rows, trees, ...]):
#: 64 MB on the host, 1 GB on a card
_PLAIN_ELEMS = {"cpu": 1 << 24, "cuda": 1 << 28}
#: deepest forest whose Saabas walk tables (``ShapForest.saabas_tab``) are
#: built: a tree's table has an entry for each of its 2^D last-level
#: positions, and two tables of depth 10 (68 KB each) still fit a CTA's
#: shared memory; deeper forests take the thread-a-row kernel ("deep")
SAABAS_MAX_DEPTH = 10
#: a walk-table entry's feature half past the leaf's pairs
SAABAS_PAD = 0xFFFF


class ShapForest(NamedTuple):
    """A forest's SHAP tables on one device (built by :func:`shap_forest`).

    ``nodes`` [T * heap, 2] int32: per heap node the split value's bits and
    a word (feature index | DEFAULT_LEFT | CATEGORICAL, as B8's records;
    ``LEAF`` where the node is a leaf or has no split); ``base_weight``
    [T * heap] f32; per tree t and leaf l (slot order, ``n_leaves[t]`` of
    them): ``steps`` [T, L, D] int32 (node | bit << 24 | element << 25,
    -1 past the leaf's depth), ``elem_slot`` [T, L, D] (the tree's feature
    slot of each merged element), ``elem_z`` [T, L, D] f32, ``leaf_value``
    [T, L] f32 and ``leaf_m`` [T, L] (elements); ``tree_feats`` [T, U] the
    tree's split features ascending (-1 padding), ``n_feats`` [T];
    ``weights`` [D + 1, max(D, 1)] f32 the Shapley weight table. The node
    bits: ``split_nodes`` [T, S, 2] int32, the records of each tree's split
    nodes (those on a leaf's path) by split ordinal, ascending heap index,
    ``n_splits`` [T], and ``step_ord`` [T, L, D] int32 each step's split
    ordinal (-1 past the leaf's depth): a row's go-right bit at every
    ordinal, tested once a tree, gives every leaf's ``o``
    (:func:`leaf_indicators_plain`). ``tree_tab`` [T, W] int32 (trees up to
    depth 8, else None): the kernel's blob of each tree, read whole by a CTA
    (:data:`TAB_HEADER`, then the tree's features, its split records and
    its leaves as 24-word records, see :func:`_leaf_record`).
    ``saabas_tab`` [T, W] int32 (trees up to depth
    :data:`SAABAS_MAX_DEPTH`, else None): the Saabas kernel's walk table of
    each tree (:func:`saabas_layout`): its node records of levels 0..D-1,
    then for every last-level position p of a D-step walk the credits of
    the leaf above p, at most D (feature, credit) pairs. Host arrays:
    ``expectation`` [T] f32 and ``root_weight`` [T] f32."""

    nodes: torch.Tensor
    base_weight: torch.Tensor
    steps: torch.Tensor
    elem_slot: torch.Tensor
    elem_z: torch.Tensor
    leaf_value: torch.Tensor
    leaf_m: torch.Tensor
    n_leaves: torch.Tensor
    tree_feats: torch.Tensor
    n_feats: torch.Tensor
    weights: torch.Tensor
    split_nodes: torch.Tensor
    n_splits: torch.Tensor
    step_ord: torch.Tensor
    tree_tab: Optional[torch.Tensor]
    saabas_tab: Optional[torch.Tensor]
    expectation: np.ndarray
    root_weight: np.ndarray
    n_trees: int
    max_depth: int
    num_features: int
    has_cat: bool

    @property
    def heap(self) -> int:
        return (2 << self.max_depth) - 1

    @property
    def max_leaves(self) -> int:
        return int(self.leaf_value.shape[1])

    @property
    def max_feats(self) -> int:
        return int(self.tree_feats.shape[1])

    @property
    def max_splits(self) -> int:
        return int(self.split_nodes.shape[1])


class TreeScales(NamedTuple):
    """One call's per-tree scales and classes, the trees it reads, and the
    row-independent bias columns, on the forest's device."""

    scale: torch.Tensor  # [T] f32
    tree_class: torch.Tensor  # [T] int32
    #: [2, K] f32: the Saabas bias (root base weights x scale, summed per
    #: class in tree order), then the exact one (tree expectations)
    bias: torch.Tensor
    n_trees: int  # trees before ntree_limit
    num_outputs: int


def weight_table(max_depth: int) -> np.ndarray:
    """``W[m, k] = k! (m - 1 - k)! / m!``, the Shapley weight of a
    coalition of k among m players (0 outside k < m): built in float64,
    stored f32 (the reference's ``_shap_weight_table``)."""
    fact = [1.0]
    for i in range(1, max_depth + 2):
        fact.append(fact[-1] * i)
    tab = np.zeros((max_depth + 1, max(max_depth, 1)), np.float32)
    for m in range(1, max_depth + 1):
        for k in range(m):
            tab[m, k] = fact[k] * fact[m - 1 - k] / fact[m]
    return tab


def _pack_split_nodes(forest, num_features: int, cat_features) -> np.ndarray:
    feature = np.asarray(forest.feature)
    fc = np.clip(feature, 0, num_features - 1).astype(np.int64)
    cat = np.isin(fc, np.asarray(list(cat_features), np.int64))
    code = np.asarray(forest.split_bin).astype(np.float32)
    value = np.where(cat, code, np.asarray(forest.threshold, np.float32))
    word = (fc | np.where(np.asarray(forest.default_left, bool),
                          DEFAULT_LEFT, 0) | np.where(cat, CATEGORICAL, 0))
    no_split = np.asarray(forest.is_leaf, bool) | (feature < 0)
    word = np.where(no_split, word | LEAF, word)
    out = np.empty(feature.shape + (2,), np.int32)
    out[..., 0] = value.astype(np.float32).view(np.int32)
    out[..., 1] = word
    return out.reshape(-1, 2)


def _tree_leaves(feature, is_leaf, cover, value, depth, num_features):
    """The canonical leaves of one tree in slot order, each as (value,
    [(node, bit, element)], [(feature, z)]) with repeats merged."""
    f32 = np.float32
    leaves = []

    def z_of(node, child):
        c = f32(cover[node])
        if not c > 0:
            return f32(0.0)
        return f32(f32(cover[child]) / max(c, f32(1e-12)))

    def rec(node, level, path):
        if is_leaf[node]:
            steps, elems = [], []
            for s, (nd, bit) in enumerate(path):
                f = int(min(max(feature[nd], 0), num_features - 1))
                child = 2 * nd + 1 + bit
                z = z_of(nd, child)
                e = next((i for i, (fe, _) in enumerate(elems) if fe == f),
                         None)
                if e is None:
                    e = len(elems)
                    elems.append((f, z))
                else:
                    elems[e] = (f, f32(elems[e][1] * z))
                steps.append((nd, bit, e))
            leaves.append((f32(value[node]), steps, elems))
            return
        if level == depth:
            return  # a level-depth node not marked leaf: no canonical slot
        rec(2 * node + 1, level + 1, path + [(node, 0)])
        rec(2 * node + 2, level + 1, path + [(node, 1)])

    rec(0, 0, [])
    return leaves


def shap_forest(forest, max_depth: int, device="cpu", *, num_features: int,
                cat_features=()) -> ShapForest:
    """A stacked padded-heap forest (numpy fields ``[T, heap]``, with
    ``cover`` and ``base_weight``) -> its :class:`ShapForest` on
    ``device``."""
    feature = np.asarray(forest.feature)
    n_trees, heap = feature.shape
    d = int(max_depth)
    if heap != (2 << d) - 1:
        raise ValueError(f"heap width {heap} does not match max_depth {d}")
    if not 1 <= num_features < MAX_FEATURES:
        raise ValueError(f"num_features={num_features} out of range")
    is_leaf = np.asarray(forest.is_leaf, bool)
    cover = np.asarray(forest.cover, np.float32)
    value = np.asarray(forest.value, np.float32)
    per_tree = [_tree_leaves(feature[t], is_leaf[t], cover[t], value[t], d,
                             num_features) for t in range(n_trees)]
    n_l = max(1, max((len(lv) for lv in per_tree), default=1))
    dd = max(d, 1)
    steps = np.full((n_trees, n_l, dd), -1, np.int32)
    elem_slot = np.zeros((n_trees, n_l, dd), np.int32)
    elem_z = np.zeros((n_trees, n_l, dd), np.float32)
    leaf_value = np.zeros((n_trees, n_l), np.float32)
    leaf_m = np.zeros((n_trees, n_l), np.int32)
    n_leaves = np.zeros(n_trees, np.int32)
    feats = []
    expectation = np.zeros(n_trees, np.float32)
    for t, leaves in enumerate(per_tree):
        used = sorted({f for _, _, elems in leaves for f, _ in elems})
        slot_of = {f: i for i, f in enumerate(used)}
        feats.append(used)
        n_leaves[t] = len(leaves)
        e_tree = np.float32(0.0)
        for l, (v, st, elems) in enumerate(leaves):
            leaf_value[t, l] = v
            leaf_m[t, l] = len(elems)
            for s, (nd, bit, e) in enumerate(st):
                steps[t, l, s] = nd | (bit << _BIT_SHIFT) | (e << _ELEM_SHIFT)
            e_leaf = v
            for i, (f, z) in enumerate(elems):
                elem_slot[t, l, i] = slot_of[f]
                elem_z[t, l, i] = z
                e_leaf = np.float32(e_leaf * z)
            e_tree = np.float32(e_tree + e_leaf)
        expectation[t] = e_tree
    n_u = max(1, max((len(u) for u in feats), default=1))
    tree_feats = np.full((n_trees, n_u), -1, np.int32)
    for t, used in enumerate(feats):
        tree_feats[t, :len(used)] = used
    n_feats = np.asarray([len(u) for u in feats], np.int32)
    nodes = _pack_split_nodes(forest, num_features, cat_features)
    split_nodes, n_splits, step_ord = _node_bits(nodes.reshape(n_trees, heap,
                                                               2), steps)
    tree_tab = None
    if d <= TAB_MAX_DEPTH:
        tree_tab = _tree_blobs(tree_feats, n_feats, split_nodes, n_splits,
                               n_leaves, steps, step_ord, elem_slot, elem_z,
                               leaf_value, leaf_m)

    saabas_tab = None
    if d <= SAABAS_MAX_DEPTH and num_features < SAABAS_PAD:
        saabas_tab = _saabas_tables(
            nodes.reshape(n_trees, heap, 2),
            np.asarray(forest.base_weight, np.float32), d)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ShapForest(
        nodes=put(nodes),
        base_weight=put(np.asarray(forest.base_weight, np.float32).reshape(-1)),
        steps=put(steps), elem_slot=put(elem_slot), elem_z=put(elem_z),
        leaf_value=put(leaf_value), leaf_m=put(leaf_m),
        n_leaves=put(n_leaves), tree_feats=put(tree_feats),
        n_feats=put(n_feats), weights=put(weight_table(d)),
        split_nodes=put(split_nodes), n_splits=put(n_splits),
        step_ord=put(step_ord),
        tree_tab=None if tree_tab is None else put(tree_tab),
        saabas_tab=None if saabas_tab is None else put(saabas_tab),
        expectation=expectation,
        root_weight=np.asarray(forest.base_weight, np.float32)[:, 0].copy(),
        n_trees=int(n_trees), max_depth=d, num_features=int(num_features),
        has_cat=bool(len(cat_features)))


def _node_bits(nodes: np.ndarray, steps: np.ndarray):
    """Each tree's split nodes (the nodes on its leaves' paths) by ordinal,
    ascending heap index: their records [T, S, 2], their count [T], and
    every path step's ordinal [T, L, D] (-1 where ``steps`` is -1)."""
    n_trees = steps.shape[0]
    valid = steps >= 0
    node = np.where(valid, steps & _NODE_MASK, 0)
    per_tree = [np.unique(node[t][valid[t]]) for t in range(n_trees)]
    n_splits = np.asarray([len(u) for u in per_tree], np.int32)
    s_max = max(1, int(n_splits.max(initial=0)))
    split_nodes = np.zeros((n_trees, s_max, 2), np.int32)
    split_nodes[..., 1] = LEAF
    step_ord = np.full(steps.shape, -1, np.int32)
    for t, used in enumerate(per_tree):
        split_nodes[t, :len(used)] = nodes[t, used]
        ords = np.searchsorted(used, node[t])
        step_ord[t] = np.where(valid[t], ords, -1)
    return split_nodes, n_splits, step_ord


def _leaf_record(m, v, z, slot, steps, ords) -> np.ndarray:
    """One leaf's 24 words in a tree blob (trees up to depth 8): ``m |
    len(steps) << 8``, v's bits, z[0..7]'s bits, the 8 slots a byte each,
    the 8 steps a half each (split ordinal | branch bit << 8 | element
    << 9; element 8 past the leaf's depth), the f32 reciprocals ``1 /
    max(z, 1e-12)`` (IEEE-rounded)."""
    rec = np.zeros(LEAF_WORDS, np.uint32)
    n_steps = int((steps >= 0).sum())
    rec[0] = int(m) | n_steps << 8
    rec[1] = np.float32(v).view(np.uint32)
    rec[2:2 + len(z)] = np.asarray(z, np.float32).view(np.uint32)
    sl = np.zeros(8, np.uint32)
    sl[:m] = slot[:m]
    rec[10] = sl[0] | sl[1] << 8 | sl[2] << 16 | sl[3] << 24
    rec[11] = sl[4] | sl[5] << 8 | sl[6] << 16 | sl[7] << 24
    # a step past the leaf's depth tests ordinal 0 into element 8, a bit
    # no leaf reads: the kernels run all 8 steps without a branch
    half = np.full(8, 8 << 9, np.uint32)
    for s in range(n_steps):
        st = int(steps[s])
        half[s] = (int(ords[s]) | ((st >> _BIT_SHIFT) & 1) << 8
                   | (st >> _ELEM_SHIFT) << 9)
    rec[12:16] = half[0::2] | half[1::2] << 16
    zz = np.asarray(z, np.float32)
    rec[16:16 + len(zz)] = (np.float32(1.0) / np.maximum(
        zz, np.float32(1e-12))).view(np.uint32)
    return rec.view(np.int32)


def tab_layout(max_feats: int, max_splits: int, max_leaves: int):
    """Word offsets of a tree blob: (features, split records, leaves, total),
    each part 16-byte aligned."""
    feat_off = TAB_HEADER
    node_off = feat_off + -(-max_feats // 4) * 4
    leaf_off = node_off + 2 * (-(-max_splits // 2) * 2)
    return feat_off, node_off, leaf_off, leaf_off + LEAF_WORDS * max_leaves


def _tree_blobs(tree_feats, n_feats, split_nodes, n_splits, n_leaves, steps,
                step_ord, elem_slot, elem_z, leaf_value, leaf_m) -> np.ndarray:
    """The kernel's blob of every tree [T, W] (:func:`tab_layout`)."""
    n_trees, n_l = leaf_m.shape
    feat_off, node_off, leaf_off, width = tab_layout(
        tree_feats.shape[1], split_nodes.shape[1], n_l)
    tab = np.zeros((n_trees, width), np.int32)
    tab[:, 0] = n_splits
    tab[:, 1] = n_leaves
    tab[:, 2] = n_feats
    tab[:, feat_off:feat_off + tree_feats.shape[1]] = tree_feats
    tab[:, node_off:node_off + 2 * split_nodes.shape[1]] = split_nodes.reshape(
        n_trees, -1)
    for t in range(n_trees):
        for l in range(int(n_leaves[t])):
            m = int(leaf_m[t, l])
            o = leaf_off + LEAF_WORDS * l
            tab[t, o:o + LEAF_WORDS] = _leaf_record(
                m, leaf_value[t, l], elem_z[t, l, :m], elem_slot[t, l],
                steps[t, l], step_ord[t, l])
    return tab


def saabas_layout(max_depth: int):
    """Word offsets of a tree's Saabas walk table: (entries, feature halves
    within an entry, entry pitch, total). The node records of levels
    0..D-1 come first (two words each, the heap order of
    ``ShapForest.nodes``), then an entry for each last-level position p at
    ``entries + p * pitch``: D credits, then ceil(D / 2) feature halves
    (pair 2h in the low half of word h, pair 2h + 1 in the high one,
    :data:`SAABAS_PAD` past the leaf's pairs). The pitch is odd, so lanes
    at entries that differ mod 32 read distinct banks, and an entry spans
    two 32-byte sectors where a walk reads it from device memory; the
    parts and the total are 16-byte aligned."""
    d = int(max_depth)
    rows = max(d, 1)
    pitch = (rows + -(-rows // 2)) | 1
    entries = -(-2 * ((1 << d) - 1) // 4) * 4
    return entries, rows, pitch, -(-(entries + (pitch << d)) // 4) * 4


def _saabas_tables(nodes: np.ndarray, base_weight: np.ndarray, d: int
                   ) -> np.ndarray:
    """Every tree's Saabas walk table [T, W] (:func:`saabas_layout`) from
    its packed node records [T, heap, 2] and base weights [T, heap].

    A D-step walk that goes on below a leaf ends at a last-level position
    under that leaf, so position p names the leaf that the bits of p reach
    from the root. Its entry holds the leaf's path features in order of
    first occurrence with their credits, each built as
    :func:`predict_contribs_plain` builds a row's credit vector for the
    tree: +0.0, then for every step at that feature ``+ (bw[child] -
    bw[node])`` in step order, f32 (one IEEE subtraction and add a step)."""
    n_trees = nodes.shape[0]
    entries, halves, pitch, width = saabas_layout(d)
    n_pos = 1 << d
    rows = max(d, 1)
    words = nodes[..., 1]
    tt = np.arange(n_trees)[:, None]
    pos = np.arange(n_pos)[None, :]
    idx = np.zeros((n_trees, n_pos), np.int64)
    feats = np.full((n_trees, n_pos, rows), -1, np.int64)
    vals = np.zeros((n_trees, n_pos, rows), np.float32)
    n_used = np.zeros((n_trees, n_pos), np.int64)
    for s in range(d):
        w = words[tt, idx]
        stepped = (w & LEAF) == 0
        f = (w & FEATURE_MASK).astype(np.int64)
        nxt = np.where(stepped, 2 * idx + 1 + ((pos >> (d - 1 - s)) & 1),
                       idx)
        delta = base_weight[tt, nxt] - base_weight[tt, idx]
        match = feats == f[..., None]
        has = match.any(-1)
        j = np.where(has, match.argmax(-1), n_used)
        ti, pi = np.nonzero(stepped)
        jj = j[ti, pi]
        vals[ti, pi, jj] = vals[ti, pi, jj] + delta[ti, pi]
        feats[ti, pi, jj] = f[ti, pi]
        n_used = n_used + (stepped & ~has)
        idx = nxt
    tab = np.zeros((n_trees, width), np.int32)
    top = n_pos - 1
    tab[:, :2 * top] = nodes[:, :top].reshape(n_trees, -1)
    half = np.full((n_trees, n_pos, 2 * -(-rows // 2)), SAABAS_PAD, np.int64)
    half[..., :rows] = np.where(feats >= 0, feats, SAABAS_PAD)
    entry = np.zeros((n_trees, n_pos, pitch), np.int32)
    entry[..., :rows] = vals.view(np.int32)
    entry[..., halves:halves + half.shape[2] // 2] = (
        half[..., 0::2] | half[..., 1::2] << 16).astype(np.uint32).view(
            np.int32)
    tab[:, entries:entries + n_pos * pitch] = entry.reshape(n_trees, -1)
    return tab


def tree_scales(sf: ShapForest, num_outputs: int = 1,
                num_parallel_tree: int = 1, ntree_limit: int = 0,
                tree_weights: Optional[np.ndarray] = None) -> TreeScales:
    """Each tree's scale ``tree_weights[t] / npt`` (0 at or past
    ``ntree_limit``: those trees are not read) and class, and the bias
    columns summed in tree order as the reference's scan sums them."""
    t = sf.n_trees
    k = int(num_outputs)
    npt = int(num_parallel_tree)
    scale = (np.ones(t, np.float32) if tree_weights is None
             else np.asarray(tree_weights, np.float32).copy())
    n_read = t
    if ntree_limit:
        scale = np.where(np.arange(t) < ntree_limit, scale, np.float32(0.0))
        n_read = min(t, int(ntree_limit))
    scale = (scale / np.float32(npt)).astype(np.float32)
    cls = ((np.arange(t) // npt) % k).astype(np.int32)
    sb = np.zeros(k, np.float32)
    eb = np.zeros(k, np.float32)
    for i in range(t):
        c = cls[i]
        sb[c] = np.float32(sb[c] + np.float32(sf.root_weight[i] * scale[i]))
        eb[c] = np.float32(eb[c] + np.float32(sf.expectation[i] * scale[i]))
    dev = sf.leaf_value.device
    return TreeScales(torch.from_numpy(scale).to(dev),
                      torch.from_numpy(cls).to(dev),
                      torch.from_numpy(np.stack([sb, eb])).to(dev), n_read, k)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _decode(sf: ShapForest):
    return sf.nodes[:, 0].contiguous().view(torch.float32), sf.nodes[:, 1]


def _route(sf: ShapForest, x: torch.Tensor, pos: torch.Tensor):
    """go-right [n, *pos.shape] of the rows of ``x`` at heap records
    ``pos`` (global positions)."""
    values, words = _decode(sf)
    v = values[pos]
    w = words[pos]
    xv = x[:, (w & FEATURE_MASK).long()]
    return _step_right(sf, v[None], w[None], xv)


def _group(sf: ShapForest, n: int, t_read: int, per_tree: int):
    """Rows per step and trees per group for the plain versions."""
    budget = _PLAIN_ELEMS["cuda" if sf.leaf_value.is_cuda else "cpu"]
    rows = max(1, min(n, budget // max(per_tree, 1)))
    trees = max(1, min(t_read, budget // max(rows * per_tree, 1)))
    return rows, trees


def _leaf_paths(sf: ShapForest, x: torch.Tensor, t0: int, t1: int, l: int):
    """Leaf position l of trees [t0, t1) for the rows of ``x``: the merged
    indicators ``o`` [n, G, D], and the elements' z, slots, validity
    [G, D], the leaf values and element counts [G] (0 where a tree has no
    leaf l)."""
    dev = x.device
    d = sf.steps.shape[2]
    st = sf.steps[t0:t1, l, :]  # [G, D]
    valid = st >= 0
    node = (st & _NODE_MASK).long()
    bit = (st >> _BIT_SHIFT) & 1
    elem = (st >> _ELEM_SHIFT).long()
    tcol = torch.arange(t0, t1, device=dev, dtype=torch.long)[:, None]
    pos = torch.where(valid, tcol * sf.heap + node, tcol * sf.heap)
    right = _route(sf, x, pos)  # [n, G, D]
    cond = (right.long() == bit[None]) | ~valid[None]
    ks = torch.arange(d, device=dev)
    o = torch.ones((x.shape[0], t1 - t0, d), dtype=torch.float32, device=dev)
    for s in range(d):
        hit = valid[:, s, None] & (elem[:, s, None] == ks[None, :])  # [G, D]
        o = o * torch.where(hit[None], cond[:, :, s, None].float(), 1.0)
    m = sf.leaf_m[t0:t1, l]
    ev = ks[None, :] < m[:, None]
    return (o, sf.elem_z[t0:t1, l, :], sf.elem_slot[t0:t1, l, :].long(), ev,
            sf.leaf_value[t0:t1, l], m)


def split_route_plain(sf: ShapForest, x: torch.Tensor, t0: int, t1: int
                      ) -> torch.Tensor:
    """The node bits of trees [t0, t1) for the rows of ``x``: go-right
    [n, G, S] at every split ordinal (False past a tree's splits), each
    split tested once, as the kernels route a tree."""
    rec = sf.split_nodes[t0:t1]  # [G, S, 2]
    v = rec[..., 0].contiguous().view(torch.float32)
    w = rec[..., 1]
    xv = x[:, (w & FEATURE_MASK).long()]
    s = torch.arange(rec.shape[1], device=x.device)
    live = s[None, :] < sf.n_splits[t0:t1, None]
    return _step_right(sf, v[None], w[None], xv) & live[None]


def leaf_indicators_plain(sf: ShapForest, x: torch.Tensor, t0: int, t1: int,
                          l: int) -> torch.Tensor:
    """The merged indicators ``o`` [n, G, D] of leaf position l of trees
    [t0, t1) from the node bits: an element's o is 1 where the row takes
    the branch of every step of it (``_leaf_paths``'s o, from each split
    tested once a tree)."""
    route = split_route_plain(sf, x, t0, t1).long()  # [n, G, S]
    st = sf.steps[t0:t1, l, :]
    ords = sf.step_ord[t0:t1, l, :]  # [G, D]
    valid = ords >= 0
    bit = (st >> _BIT_SHIFT) & 1
    elem = (st >> _ELEM_SHIFT).long()
    rb = torch.gather(route, 2, torch.clamp(ords, min=0).long()[None].expand(
        x.shape[0], -1, -1))  # [n, G, D]
    fail = (rb != bit[None]) & valid[None]
    d = st.shape[1]
    ks = torch.arange(d, device=x.device)
    o = torch.ones((x.shape[0], t1 - t0, d), dtype=torch.float32,
                   device=x.device)
    for s in range(d):
        hit = (elem[:, s, None] == ks[None, :])[None]  # [1, G, D]
        o = torch.where(hit & fail[:, :, s, None], 0.0, o)
    return o


def _extend(o, z, ev):
    """EXTEND over the elements: q [n, G, D + 1] of prod_e (z_e + o_e t)."""
    n, g, d = o.shape
    q = torch.zeros((n, g, d + 1), dtype=torch.float32, device=o.device)
    q[..., 0] = 1.0
    for e in range(d):
        shifted = torch.cat([torch.zeros_like(q[..., :1]), q[..., :-1]], -1)
        new = z[None, :, e, None] * q + o[..., e, None] * shifted
        q = torch.where(ev[None, :, e, None], new, q)
    return q


def _unwind(q, z, o):
    """UNWIND q [n, G, W] by (z + o t): z [G], o [n, G] -> [n, G, W - 1]."""
    w = q.shape[-1] - 1
    r1 = [None] * w
    acc = q[..., w]
    for k in range(w - 1, -1, -1):
        r1[k] = acc
        acc = q[..., k] - z[None, :] * acc
    r1 = torch.stack(r1, -1)
    zz = z[None, :, None]
    r0 = torch.where(zz > 0.0, q[..., :w] / torch.clamp(zz, min=1e-12), 0.0)
    return torch.where(o[..., None] > 0.5, r1, r0)


def _dot(r, w):
    """sum_k r[..., k] w[..., k] in order of k (r [n, G, W], w [G, W'])."""
    s = torch.zeros(r.shape[:-1], dtype=torch.float32, device=r.device)
    for k in range(min(r.shape[-1], w.shape[-1])):
        s = s + r[..., k] * w[None, :, k]
    return s


def _acc_trees(acc, phi, sf, sc: TreeScales, t0: int):
    """acc[:, k_t, feats_t] += phi[:, t - t0, :U_t] * scale_t, trees in order."""
    cls = sc.tree_class.tolist()
    scale = sc.scale
    nf = sf.n_feats.tolist()
    for j in range(phi.shape[1]):
        t = t0 + j
        u = nf[t]
        if not u:
            continue
        f = sf.tree_feats[t, :u].long()
        acc[:, cls[t], f] = acc[:, cls[t], f] + phi[:, j, :u] * scale[t]


def predict_contribs_plain(sf: ShapForest, x: torch.Tensor, sc: TreeScales,
                           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Saabas contributions [N, K, F + 1]: walking each row's path, every
    split's ``base_weight[child] - base_weight[node]`` to its feature; the
    bias column the roots' weights (``sc.bias[0]``)."""
    n, nf = x.shape
    k = sc.num_outputs
    dev = x.device
    if out is None:
        out = torch.empty((n, k, nf + 1), dtype=torch.float32, device=dev)
    heap = sf.heap
    rows, group = _group(sf, n, sc.n_trees, nf)
    values, words = _decode(sf)
    for lo in range(0, n, rows):
        hi = min(lo + rows, n)
        xc = x[lo:hi]
        acc = torch.zeros((hi - lo, k, nf), dtype=torch.float32, device=dev)
        for t0 in range(0, sc.n_trees, group):
            t1 = min(t0 + group, sc.n_trees)
            base = (torch.arange(t0, t1, device=dev) * heap)[None, :]
            idx = torch.zeros((hi - lo, t1 - t0), dtype=torch.long,
                              device=dev)
            contrib = torch.zeros((hi - lo, t1 - t0, nf),
                                  dtype=torch.float32, device=dev)
            for _ in range(sf.max_depth):
                w = words[base + idx]
                stepped = (w & LEAF) == 0
                f = (w & FEATURE_MASK).long()
                xv = torch.gather(xc, 1, f.reshape(hi - lo, -1)).reshape(
                    f.shape)
                right = _step_right(sf, values[base + idx], w, xv)
                nxt = torch.where(stepped, 2 * idx + 1 + right.long(), idx)
                delta = torch.where(
                    stepped, sf.base_weight[base + nxt]
                    - sf.base_weight[base + idx], 0.0)
                contrib.scatter_add_(2, f[..., None], delta[..., None])
                idx = nxt
            cls = sc.tree_class.tolist()
            for j in range(t1 - t0):
                t = t0 + j
                acc[:, cls[t]] = acc[:, cls[t]] + contrib[:, j] * sc.scale[t]
        out[lo:hi, :, :nf] = acc
    out[:, :, nf] = sc.bias[0][None, :]
    return out


def predict_contribs_exact_plain(sf: ShapForest, x: torch.Tensor,
                                 sc: TreeScales,
                                 out: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Exact TreeSHAP [N, K, F + 1]; the bias column the trees'
    expectations (``sc.bias[1]``)."""
    n, nf = x.shape
    k = sc.num_outputs
    dev = x.device
    if out is None:
        out = torch.empty((n, k, nf + 1), dtype=torch.float32, device=dev)
    d = sf.steps.shape[2]
    rows, group = _group(sf, n, sc.n_trees, 4 * (d + 1) + sf.max_feats)
    for lo in range(0, n, rows):
        hi = min(lo + rows, n)
        xc = x[lo:hi]
        acc = torch.zeros((hi - lo, k, nf), dtype=torch.float32, device=dev)
        for t0 in range(0, sc.n_trees, group):
            t1 = min(t0 + group, sc.n_trees)
            phi = torch.zeros((hi - lo, t1 - t0, sf.max_feats),
                              dtype=torch.float32, device=dev)
            for l in range(sf.max_leaves):
                o, z, slot, ev, v, m = _leaf_paths(sf, xc, t0, t1, l)
                q = _extend(o, z, ev)
                w = sf.weights[m.long()]  # [G, W]
                for e in range(d):
                    r = _unwind(q, z[:, e], o[..., e])
                    c = (v[None, :] * (o[..., e] - z[None, :, e])) * _dot(r, w)
                    c = torch.where(ev[None, :, e], c, 0.0)
                    phi.scatter_add_(
                        2, slot[None, :, e, None].expand(hi - lo, -1, 1),
                        c[..., None])
            _acc_trees(acc, phi, sf, sc, t0)
        out[lo:hi, :, :nf] = acc
    out[:, :, nf] = sc.bias[1][None, :]
    return out


def predict_interactions_plain(sf: ShapForest, x: torch.Tensor,
                               sc: TreeScales,
                               out: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """SHAP interaction values [N, K, F + 1, F + 1] (the reference's
    definition): per tree the pair terms ``Phi[i, j]`` from the path
    polynomial with i unwound, the feature-bias column ``Phi[i, F]``, the
    diagonal as each feature row's remainder, then into the tree's class;
    ``Phi[F, F]`` the expectation less the feature-bias column."""
    n, nf = x.shape
    k = sc.num_outputs
    dev = x.device
    if out is None:
        out = torch.empty((n, k, nf + 1, nf + 1), dtype=torch.float32,
                          device=dev)
    d = sf.steps.shape[2]
    u_max = sf.max_feats
    rows, group = _group(sf, n, sc.n_trees,
                         4 * (d + 1) + u_max * (u_max + 2))
    cls = sc.tree_class.tolist()
    n_feats = sf.n_feats.tolist()
    wt = sf.weights
    for lo in range(0, n, rows):
        hi = min(lo + rows, n)
        xc = x[lo:hi]
        nr = hi - lo
        mat = torch.zeros((nr, k, nf, nf), dtype=torch.float32, device=dev)
        fb = torch.zeros((nr, k, nf), dtype=torch.float32, device=dev)
        for t0 in range(0, sc.n_trees, group):
            t1 = min(t0 + group, sc.n_trees)
            g = t1 - t0
            pm = torch.zeros((nr, g, u_max * u_max), dtype=torch.float32,
                             device=dev)
            pb = torch.zeros((nr, g, u_max), dtype=torch.float32, device=dev)
            pp = torch.zeros((nr, g, u_max), dtype=torch.float32, device=dev)
            for l in range(sf.max_leaves):
                o, z, slot, ev, v, m = _leaf_paths(sf, xc, t0, t1, l)
                q = _extend(o, z, ev)
                w_m = wt[m.long()]
                w_m1 = wt[torch.clamp(m - 1, min=0).long()]
                for i in range(d):
                    vi = ev[:, i]
                    zi = z[:, i]
                    oi = o[..., i]
                    prod = v.clone()
                    for j in range(d):
                        if j != i:
                            prod = prod * torch.where(ev[:, j], z[:, j], 1.0)
                    b = (0.5 * (oi - zi[None, :])) * prod[None, :]
                    si = slot[None, :, i, None].expand(nr, -1, 1)
                    pb.scatter_add_(2, si, torch.where(vi[None], b, 0.0)[
                        ..., None])
                    qi = _unwind(q, zi, oi)  # [n, G, D]
                    c = (v[None, :] * (oi - zi[None, :])) * _dot(qi, w_m)
                    pp.scatter_add_(2, si, torch.where(vi[None], c, 0.0)[
                        ..., None])
                    qi = torch.cat([qi, torch.zeros_like(qi[..., :1])], -1)
                    for j in range(d):
                        if j == i:
                            continue
                        pv = vi & ev[:, j]
                        r = _unwind(qi, z[:, j], o[..., j])
                        base = (o[..., j] - z[None, :, j]) * _dot(r, w_m1)
                        delta = ((0.5 * v[None, :]) * base) * (oi - zi[None, :])
                        cell = (slot[:, i] * u_max + slot[:, j])[None, :, None]
                        pm.scatter_add_(2, cell.expand(nr, -1, 1),
                                        torch.where(pv[None], delta, 0.0)[
                                            ..., None])
            for jt in range(g):
                t = t0 + jt
                u = n_feats[t]
                if not u:
                    continue
                f = sf.tree_feats[t, :u].long()
                sq = pm[:, jt].reshape(nr, u_max, u_max)[:, :u, :u]
                ro = torch.zeros((nr, u), dtype=torch.float32, device=dev)
                for c2 in range(u):
                    ro = ro + sq[:, :, c2]
                diag = (pp[:, jt, :u] - ro) - pb[:, jt, :u]
                eye = torch.eye(u, dtype=torch.bool, device=dev)
                cellv = torch.where(eye[None], diag[:, :, None], sq)
                s = sc.scale[t]
                kk = cls[t]
                blk = mat[:, kk][:, f][:, :, f]
                mat[:, kk, f[:, None], f[None, :]] = blk + cellv * s
                fb[:, kk, f] = fb[:, kk, f] + pb[:, jt, :u] * s
        out[lo:hi, :, :nf, :nf] = mat
        out[lo:hi, :, :nf, nf] = fb
        out[lo:hi, :, nf, :nf] = fb
        tot = torch.zeros((nr, k), dtype=torch.float32, device=dev)
        for f in range(nf):
            tot = tot + fb[:, :, f]
        out[lo:hi, :, nf, nf] = sc.bias[1][None, :] - tot
    return out


# --------------------------------------------------------------------------
# B15: the kernel wrappers
# --------------------------------------------------------------------------


#: rows mapping: rows (threads) a CTA
ROWS_CTA = 128
#: lanes mapping: warps a CTA (one row; the warps take trees)
LANES_WARPS = 4
#: lanes mapping: staged f32 words a leaf (exact: its m contributions;
#: interactions: 8 x 8 pair cells with the plain terms on the diagonal, then
#: 8 feature-bias terms), odd pitches so the 32 lanes' rows hit distinct banks
STAGE_WORDS = {"exact": 9, "interactions": 73}
#: shared memory a CTA may take: the rows mapping keeps five CTAs an SM
#: (what its registers allow; on the H100 the exact kernel over 1M rows of
#: the 500-tree HIGGS forest took 871 ms with every buffer on chip, 57.6 KB
#: a CTA, and 825 ms at 43.3 KB: ``chip_smoke.py --b15-variants``)
_ROWS_SHARED_MAX = 44 << 10
_LANES_SHARED_MAX = 200 << 10
#: an x tile or a row of x larger than this stays in device memory
_X_SHARED_MAX = 48 << 10
#: below this many rows an SM the lanes mapping, above it the rows mapping.
#: On the H100 with the 500-tree HIGGS forest (``chip_smoke.py
#: --b15-variants``) the rows mapping takes 26 ms (exact) and 215-323 ms
#: (interactions) up to 16k rows, as a CTA walks the whole forest however
#: few its rows, while the lanes mapping takes 2.2 and 15 ms a thousand
#: rows: they meet near 12k and 21k rows; Saabas's rows mapping takes
#: 0.42-0.44 ms up to 32k rows, its lanes mapping 0.41 ms at 16,384 and
#: 0.55 ms at 24,576
LANES_ROWS_PER_SM = {"exact": 88, "interactions": 160, "saabas": 128}
#: Saabas rows mapping: rows (threads) a CTA, tried largest first, and
#: trees a staged tile (a thread walks two in lock step), tried largest
#: first, under the first shared-memory budget that holds the x tile, the
#: class accumulators and two tiles (the first budget keeps two CTAs an
#: SM). On the H100 over 1,048,576 HIGGS rows (``chip_smoke.py
#: --b15-variants``) 256 rows and 2 trees took 5.6-5.7 ms, 8 trees 6.6 ms
#: (two CTAs an SM instead of three), 128 rows 6.2-8.2 ms
SAABAS_ROWS = (256, 128, 64, 32)
SAABAS_TILE_TREES = (2, 1)
#: Saabas lanes mapping: rows a CTA (the 128 threads walk 128 / R trees a
#: group, so a warp's loads touch 32 / R trees), the largest that still
#: gives every SM this many CTAs (on the H100, 4,096 HIGGS rows took 0.25,
#: 0.18, 0.12 and 0.15 ms at 1, 2, 4 and 8 rows a CTA, 16,384 rows 0.84,
#: 0.63, 0.46 and 0.40 ms: ``chip_smoke.py --b15-variants``)
SAABAS_LANES_ROWS = (8, 4, 2, 1)
_SAABAS_LANES_CTAS_PER_SM = 4
_SAABAS_SHARED_MAX = (112 << 10, 227 << 10)


class ShapPlan(NamedTuple):
    """How one B15 launch maps its work: the mapping, the CTA size and
    grid, and where each buffer lives: a word offset into the CTA's dynamic
    shared memory, or -1 for the kernel's scratch in device memory
    (``scratch_words`` a row); the Saabas rows mapping also stages
    ``tile_trees`` trees a tile."""

    mapping: str
    threads: int
    grid: int
    shared_bytes: int
    off_tab: int
    off_route: int
    off_x: int
    off_sums: int
    off_stage: int
    off_acc: int
    acc_words: int  # class accumulators a row
    sums_words: int  # the tree's sums a row (a warp, lanes mapping)
    scratch_words: int
    tile_trees: int = 1
    cta_rows: int = 1  # the Saabas lanes mapping's rows a CTA


def _words(sf: ShapForest, num_features: int, num_outputs: int, mode: str):
    kf = num_outputs * num_features
    u = sf.max_feats
    if mode == "exact":
        return kf, u
    return kf * num_features + kf, u * u + 2 * u


def _layout(parts, budget):
    """Word offsets of the parts [(name, words, required)] packed 16-byte
    aligned in order; a part that is not required and does not fit the
    budget (bytes) gets -1. Returns ({name: offset}, bytes) or None when a
    required part does not fit."""
    off, at = {}, 0
    for name, words, required in parts:
        words = -(-words // 4) * 4
        if 4 * (at + words) <= budget:
            off[name] = at
            at += words
        elif required:
            return None
        else:
            off[name] = -1
    return off, 4 * at


def shap_plan(sf: ShapForest, mode: str, n: int, num_features: int,
              num_outputs: int, sm_count: int,
              mapping: Optional[str] = None) -> ShapPlan:
    """The launch plan of a B15 kernel for ``n`` rows, from the shapes and
    the card's SM count alone. Exact and interactions: forests deeper than
    TAB_MAX_DEPTH take "deep"; else "lanes" (a row a CTA, every sum on
    chip) below ``LANES_ROWS_PER_SM`` rows an SM where its buffers fit, and
    "rows" (a thread a row) above. Saabas: :func:`_saabas_plan`.
    ``mapping`` forces one; a mapping the shapes cannot take raises
    ValueError."""
    _check(mode in MODES, f"B15: no plan for {mode}")
    _check(mapping is None or mapping in MAPPINGS,
           f"B15: mapping {mapping!r} is not one of {MAPPINGS}")
    if mode == "saabas":
        return _saabas_plan(sf, n, num_features, num_outputs, sm_count,
                            mapping)
    acc_w, sums_w = _words(sf, num_features, num_outputs, mode)
    rw = max(1, -(-sf.max_splits // 32))
    x_w = num_features
    deep = sf.max_depth > TAB_MAX_DEPTH
    if mapping is None:
        lanes = _lanes_layout(sf, mode, x_w, rw, acc_w, sums_w)
        if deep:
            mapping = "deep"
        elif lanes is not None and n < LANES_ROWS_PER_SM[mode] * sm_count:
            mapping = "lanes"
        else:
            mapping = "rows"
    if mapping == "deep":
        return ShapPlan("deep", ROWS_CTA, max(1, -(-n // ROWS_CTA)), 0,
                        -1, -1, -1, -1, -1, -1, acc_w, sums_w,
                        acc_w + sums_w)
    _check(not deep, f"B15: the {mapping} mapping takes forests up to depth "
                     f"{TAB_MAX_DEPTH}, not {sf.max_depth}")
    if mapping == "lanes":
        lay = _lanes_layout(sf, mode, x_w, rw, acc_w, sums_w)
        _check(lay is not None,
               f"B15: the lanes mapping's per-warp sums ({sums_w} words) do "
               f"not fit a CTA's shared memory")
        off, nbytes = lay
        _check(n < 2 ** 31, "B15: the lanes mapping takes fewer than 2^31 "
                            "rows")
        return ShapPlan("lanes", 32 * LANES_WARPS, max(1, n), nbytes,
                        -1, off["route"], off["x"], off["sums"],
                        off["stage"], off["acc"], acc_w, sums_w,
                        0 if off["acc"] >= 0 else acc_w)
    r = ROWS_CTA
    tab_w = tab_layout(sf.max_feats, sf.max_splits, sf.max_leaves)[3]
    x_fits = 4 * x_w * r <= _X_SHARED_MAX
    off, nbytes = _layout([("tab", 2 * tab_w, True), ("route", rw * r, True),
                           ("x", x_w * r if x_fits else 1 << 40, False),
                           ("sums", sums_w * r, False),
                           ("acc", acc_w * r, False)], _ROWS_SHARED_MAX) or (
        None, 0)
    _check(off is not None, "B15: a tree's blob does not fit a CTA's shared "
                            "memory")
    scratch = ((0 if off["acc"] >= 0 else acc_w)
               + (0 if off["sums"] >= 0 else sums_w))
    return ShapPlan("rows", r, max(1, -(-n // r)), nbytes, off["tab"],
                    off["route"], off["x"], off["sums"], -1, off["acc"],
                    acc_w, sums_w, scratch)


def _lanes_layout(sf, mode, x_w, rw, acc_w, sums_w):
    if sf.max_depth > TAB_MAX_DEPTH:
        return None
    nw = LANES_WARPS
    return _layout([("route", nw * rw, True),
                    ("stage", nw * 32 * STAGE_WORDS[mode], True),
                    ("sums", nw * sums_w, True),
                    ("x", x_w if 4 * x_w <= _X_SHARED_MAX else 1 << 40,
                     False),
                    ("acc", acc_w, False)], _LANES_SHARED_MAX)


def _saabas_plan(sf, n, num_features, num_outputs, sm_count, mapping):
    """Saabas: forests with walk tables take "lanes" (1-8 rows a CTA:
    threads walk trees, the tree's credits staged densely, threads over the
    class accumulators fold them in tree order) below ``LANES_ROWS_PER_SM``
    rows an SM and "rows" (a thread a row; trees staged in tiles; the
    class accumulators on chip, ``[K * F][rows]``) above, where their
    buffers fit; else "deep" (the thread-a-row kernel, the
    accumulators in the scratch)."""
    kf = num_outputs * num_features
    rc, lanes = next(
        ((r, lay) for r in SAABAS_LANES_ROWS
         if (n >= r * _SAABAS_LANES_CTAS_PER_SM * sm_count or r == 1)
         and (lay := _saabas_lanes_layout(sf, num_features, kf, r))
         is not None), (1, None))
    rows = _saabas_rows_layout(sf, num_features, kf)
    if mapping is None:
        if lanes is not None and (n < LANES_ROWS_PER_SM["saabas"] * sm_count
                                  or rows is None):
            mapping = "lanes"
        else:
            mapping = "rows" if rows is not None else "deep"
    if mapping == "deep":
        return ShapPlan("deep", ROWS_CTA, max(1, -(-n // ROWS_CTA)), 0, -1,
                        -1, -1, -1, -1, -1, kf, 0, kf)
    _check(sf.saabas_tab is not None,
           f"B15: the Saabas {mapping} mapping takes forests up to depth "
           f"{SAABAS_MAX_DEPTH} with walk tables, not depth {sf.max_depth}")
    if mapping == "lanes":
        _check(lanes is not None, "B15: the Saabas lanes mapping's buffers "
                                  "do not fit a CTA's shared memory")
        _check(n < 2 ** 31, "B15: the lanes mapping takes fewer than 2^31 "
                            "rows")
        off, nbytes = lanes
        return ShapPlan("lanes", 32 * LANES_WARPS, max(1, -(-n // rc)),
                        nbytes, -1, -1, off["x"], -1, off["stage"],
                        off["acc"], kf, 0, 0, 1, rc)
    _check(rows is not None, "B15: the Saabas rows mapping's buffers do not "
                             "fit a CTA's shared memory")
    r, tt, (off, nbytes) = rows
    return ShapPlan("rows", r, max(1, -(-n // r)), nbytes, off["tab"], -1,
                    off["x"], -1, -1, off["acc"], kf, 0, 0, tt)


def _saabas_lanes_layout(sf, num_features, kf, rc):
    """The ``rc`` rows' x and class accumulators, and the dense credits of
    a tree a thread (an odd pitch of ``F | 1`` words) with the group's
    scales and classes."""
    if sf.saabas_tab is None:
        return None
    nt = 32 * LANES_WARPS
    return _layout([("x", rc * num_features, True), ("acc", rc * kf, True),
                    ("stage", nt * ((num_features | 1) + 2), True)],
                   _LANES_SHARED_MAX)


def _saabas_rows_layout(sf, num_features, kf):
    """(rows a CTA, trees a tile, layout) of the Saabas rows mapping."""
    if sf.saabas_tab is None:
        return None
    width = saabas_layout(sf.max_depth)[3]
    for budget in _SAABAS_SHARED_MAX:
        for r in SAABAS_ROWS:
            for tt in SAABAS_TILE_TREES:
                lay = _layout([("tab", 2 * tt * width, True),
                               ("x", num_features * r, True),
                               ("acc", kf * r, True)], budget)
                if lay is not None:
                    return r, tt, lay
    return None


def scratch_floats(sf: ShapForest, num_features: int, num_outputs: int,
                   mode: str, n: Optional[int] = None,
                   sm_count: int = 132) -> int:
    """f32 words a row of the kernel's scratch (``XrtShapArgs.scratch``)
    takes: the class accumulators and the current tree's sums that the
    launch plan of ``n`` rows keeps in device memory; with ``n`` None the
    most any plan takes. It does not fall as ``n`` grows, so the words of a
    call's n cover every chunk of it."""
    if n is None:
        if mode == "saabas":
            return num_outputs * num_features
        acc_w, sums_w = _words(sf, num_features, num_outputs, mode)
        return acc_w + sums_w
    return shap_plan(sf, mode, n, num_features, num_outputs,
                     sm_count).scratch_words


def out_shape(n: int, num_features: int, num_outputs: int, mode: str):
    f1 = num_features + 1
    if mode == "interactions":
        return (n, num_outputs, f1, f1)
    return (n, num_outputs, f1)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _args(sf: ShapForest, x, sc: TreeScales, out, scratch, mode: str,
          plan: ShapPlan):
    a = _build.ShapArgs()
    for name in ("nodes", "base_weight", "steps", "elem_slot", "elem_z",
                 "leaf_value", "leaf_m", "n_leaves", "tree_feats", "n_feats",
                 "weights"):
        setattr(a, name, getattr(sf, name).data_ptr())
    a.x = x.data_ptr()
    a.scale = sc.scale.data_ptr()
    a.tree_class = sc.tree_class.data_ptr()
    a.bias = sc.bias[0 if mode == "saabas" else 1].data_ptr()
    a.scratch = scratch.data_ptr()
    a.out = out.data_ptr()
    a.n_rows = x.shape[0]
    a.n_features = x.shape[1]
    a.n_trees = sc.n_trees
    a.max_depth = sf.max_depth
    a.max_leaves = sf.max_leaves
    a.max_feats = sf.max_feats
    a.num_outputs = sc.num_outputs
    a.has_cat = int(sf.has_cat)
    a.weights_width = int(sf.weights.shape[1])
    if sf.tree_tab is not None:
        a.tree_tab = sf.tree_tab.data_ptr()
        (a.feat_off, a.node_off, a.leaf_off,
         a.tab_words) = tab_layout(sf.max_feats, sf.max_splits,
                                   sf.max_leaves)
    if sf.saabas_tab is not None:
        a.saabas_tab = sf.saabas_tab.data_ptr()
        (a.sb_entry_off, a.sb_half_off, a.sb_pitch,
         a.sb_words) = saabas_layout(sf.max_depth)
    a.route_words = max(1, -(-sf.max_splits // 32))
    a.mapping = MAPPINGS.index(plan.mapping)
    for name in ("threads", "grid", "shared_bytes", "off_tab",
                 "off_route", "off_x", "off_sums", "off_stage",
                 "off_acc", "acc_words", "sums_words", "scratch_words",
                 "tile_trees", "cta_rows"):
        setattr(a, name, getattr(plan, name))
    return a


def _run(mode: str, sf: ShapForest, x: torch.Tensor, sc: TreeScales,
         out: Optional[torch.Tensor], scratch: Optional[torch.Tensor],
         stream, plain, mapping: Optional[str] = None):
    n = x.shape[0]
    _check(x.dtype == torch.float32 and x.dim() == 2 and x.is_contiguous()
           and x.shape[1] == sf.num_features,
           f"B15: x must be contiguous f32 [N, {sf.num_features}]")
    shape = out_shape(n, sf.num_features, sc.num_outputs, mode)
    _check(out is None or (out.dtype == torch.float32
                           and tuple(out.shape) == shape
                           and out.is_contiguous()
                           and out.device == x.device),
           f"B15: out must be contiguous f32 {list(shape)} on the device "
           f"of x")
    if not x.is_cuda:
        return plain(sf, x, sc, out)
    dev = x.device
    _check(sf.leaf_value.device == dev and sc.scale.device == dev,
           f"B15: the SHAP forest and the tree scales must be on {dev}")
    _check(sf.max_depth <= MAX_DEPTH,
           f"B15: max_depth={sf.max_depth} is deeper than the kernel's "
           f"{MAX_DEPTH}")
    _check(sc.num_outputs < 1 << 16 and sf.n_trees * sf.heap < 2 ** 31,
           "B15: forest or classes out of range")
    plan = shap_plan(sf, mode, n, sf.num_features, sc.num_outputs,
                     _sm_count(dev.index or 0), mapping)
    words = plan.scratch_words
    _check(n * words < 2 ** 62 and n * shape[-1] < 2 ** 62,
           "B15: launch too large")
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    if scratch is None:
        scratch = torch.empty((max(words * n, 1),), dtype=torch.float32,
                              device=dev)
    _check(scratch.dtype == torch.float32 and scratch.is_contiguous()
           and scratch.device == dev and scratch.numel() >= words * n,
           f"B15: scratch must be contiguous f32 of at least {words * n} "
           f"elements on {dev}")
    if n == 0:
        return out
    a = _args(sf, x, sc, out, scratch, mode, plan)
    s = (stream if stream is not None
         else torch.cuda.current_stream(dev)).cuda_stream
    with torch.cuda.device(dev):
        fn = getattr(_build.library("shap"), f"xrt_shap_{mode}")
        code = fn(ctypes.byref(a), s)
    _build.check(code, f"B15 shap {mode}")
    wrapper = _WRAPPERS[mode]
    wrapper.launches += 1
    LAUNCHES_BY_MODE[mode] += 1
    key = (mode, plan.mapping)
    LAUNCHES_BY_MAPPING[key] = LAUNCHES_BY_MAPPING.get(key, 0) + 1
    return out


def predict_contribs(sf: ShapForest, x: torch.Tensor, sc: TreeScales,
                     out: Optional[torch.Tensor] = None,
                     scratch: Optional[torch.Tensor] = None,
                     stream: Optional[torch.cuda.Stream] = None,
                     mapping: Optional[str] = None) -> torch.Tensor:
    """B15 Saabas wrapper: [N, K, F + 1] (see :func:`predict_contribs_plain`).
    ``scratch``: at least ``scratch_floats(..., N) * N`` f32 on the device
    (allocated when None); ``stream`` defaults to the current one;
    ``mapping`` as :func:`predict_contribs_exact`'s."""
    return _run("saabas", sf, x, sc, out, scratch, stream,
                predict_contribs_plain, mapping)


def predict_contribs_exact(sf: ShapForest, x: torch.Tensor, sc: TreeScales,
                           out: Optional[torch.Tensor] = None,
                           scratch: Optional[torch.Tensor] = None,
                           stream: Optional[torch.cuda.Stream] = None,
                           mapping: Optional[str] = None) -> torch.Tensor:
    """B15 exact TreeSHAP wrapper: [N, K, F + 1]. ``mapping`` forces one of
    :data:`MAPPINGS` (default: :func:`shap_plan`'s choice); a mapping the
    shapes cannot take raises ValueError."""
    return _run("exact", sf, x, sc, out, scratch, stream,
                predict_contribs_exact_plain, mapping)


def predict_interactions(sf: ShapForest, x: torch.Tensor, sc: TreeScales,
                         out: Optional[torch.Tensor] = None,
                         scratch: Optional[torch.Tensor] = None,
                         stream: Optional[torch.cuda.Stream] = None,
                         mapping: Optional[str] = None) -> torch.Tensor:
    """B15 interactions wrapper: [N, K, F + 1, F + 1]; ``mapping`` as
    :func:`predict_contribs_exact`'s."""
    return _run("interactions", sf, x, sc, out, scratch, stream,
                predict_interactions_plain, mapping)


#: B15 launches by entry point; each wrapper's ``launches`` counts its own,
#: and its ``launches_by_mode`` is this dict, shared by the three
LAUNCHES_BY_MODE = dict.fromkeys(MODES, 0)
#: B15 launches by (entry point, mapping)
LAUNCHES_BY_MAPPING = {}
_WRAPPERS = {"saabas": predict_contribs, "exact": predict_contribs_exact,
             "interactions": predict_interactions}
for _w in _WRAPPERS.values():
    _w.launches = 0
    _w.launches_by_mode = LAUNCHES_BY_MODE
    _w.launches_by_mapping = LAUNCHES_BY_MAPPING


def reset_launches() -> None:
    """Set every B15 launch counter to 0."""
    for mode, w in _WRAPPERS.items():
        w.launches = 0
        LAUNCHES_BY_MODE[mode] = 0
    LAUNCHES_BY_MAPPING.clear()


def leaf_ops(sf: ShapForest, mode: str, n_trees: Optional[int] = None
             ) -> int:
    """f32 operations one row needs over the first ``n_trees`` trees' actual
    leaves (what ``chip_smoke.py`` bounds B15 with). Per leaf of m merged
    elements and L steps: 2 a routing test (L); EXTEND 3 (e + 1) for e < m;
    ``exact``: per element an UNWIND (2 a coefficient), the weighted sum
    (2 a coefficient) and the contribution (4), then 2 a feature of the tree
    into its class; ``interactions``: per element i the product of the
    others' z (m), the bias term (3), the UNWIND and weighted sum (4 m + 4)
    and per other element j an UNWIND and weighted sum of the polynomial
    without i (4 (m - 1) + 6), then 3 a cell of the tree's block;
    ``saabas``: 8 a step of one walk and 2 a feature (the thread-a-row
    kernel's count, kept for comparison beside the tight one,
    :func:`saabas_ops`)."""
    t_read = sf.n_trees if n_trees is None else n_trees
    m = sf.leaf_m.cpu().numpy()[:t_read].astype(np.int64)
    steps = (sf.steps.cpu().numpy()[:t_read] >= 0).sum(-1)
    nl = sf.n_leaves.cpu().numpy()[:t_read]
    nf = sf.n_feats.cpu().numpy()[:t_read].astype(np.int64)
    if mode == "saabas":
        return int(t_read * (8 * sf.max_depth) + 2 * nf.sum())
    live = np.arange(m.shape[1])[None, :] < nl[:, None]
    mm = np.where(live, m, 0)
    ops = 2 * np.where(live, steps, 0) + 3 * mm * (mm + 1) // 2
    if mode == "exact":
        ops = ops + mm * (4 * mm + 4)
        return int(ops.sum() + 2 * nf.sum())
    ops = ops + mm * (mm + 3 + 4 * mm + 4
                      + np.maximum(mm - 1, 0) * (4 * np.maximum(mm - 1, 0)
                                                 + 6))
    return int(ops.sum() + 3 * (nf * nf).sum())


def saabas_walk(sf: ShapForest, x: torch.Tensor,
                n_trees: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's walk through the first ``n_trees`` trees' Saabas walk
    tables (``sf.saabas_tab``), as the rows mapping takes it: D levels of
    node records (on below a leaf) to a last-level position p [N, T], and
    the split tests [N, T] taken before the leaf."""
    _check(sf.saabas_tab is not None,
           f"B15: no Saabas walk tables above depth {SAABAS_MAX_DEPTH}")
    n = x.shape[0]
    d = sf.max_depth
    width = saabas_layout(d)[3]
    t_read = sf.n_trees if n_trees is None else n_trees
    flat = sf.saabas_tab[:t_read].reshape(-1)
    values = flat.view(torch.float32)
    base = (torch.arange(t_read, device=x.device) * width)[None, :]
    h = torch.zeros((n, t_read), dtype=torch.long, device=x.device)
    tests = torch.zeros((n, t_read), dtype=torch.int32, device=x.device)
    live = torch.ones((n, t_read), dtype=torch.bool, device=x.device)
    for _ in range(d):
        v = values[base + 2 * h]
        w = flat[base + 2 * h + 1]
        xv = torch.gather(x, 1, (w & FEATURE_MASK).long().reshape(n, -1)
                          ).reshape(w.shape)
        live = live & ((w & LEAF) == 0)
        tests += live
        h = 2 * h + 1 + _step_right(sf, v, w, xv).long()
    return h - ((1 << d) - 1), tests


def saabas_ops(sf: ShapForest, x: torch.Tensor,
               n_trees: Optional[int] = None, chunk: int = 1 << 16) -> int:
    """f32 operations Saabas needs over these rows with the leaves' credits
    built once per model (what ``chip_smoke.py`` bounds B15 Saabas with):
    per row and tree one compare a split test on the way to the leaf the
    row reaches (:func:`saabas_walk`), and a multiply and an add for each of
    that leaf's (feature, credit) pairs."""
    d = sf.max_depth
    entries, halves, pitch, width = saabas_layout(d)
    t_read = sf.n_trees if n_trees is None else n_trees
    tab = sf.saabas_tab[:t_read]
    at = (entries + torch.arange(1 << d, device=tab.device)[:, None] * pitch
          + halves + torch.arange(-(-halves // 2), device=tab.device))
    half = tab[:, at]  # [T, 2^D, ceil(D / 2)]
    pairs = (((half & SAABAS_PAD) != SAABAS_PAD).sum(-1)
             + (((half >> 16) & SAABAS_PAD) != SAABAS_PAD).sum(-1))
    tt = torch.arange(t_read, device=tab.device)[None, :]
    ops = 0
    for lo in range(0, x.shape[0], chunk):
        p, tests = saabas_walk(sf, x[lo:lo + chunk], t_read)
        ops += int(tests.sum(dtype=torch.int64)) + 2 * int(
            pairs[tt, p].sum(dtype=torch.int64))
    return ops
