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
entry point. The plain versions are vectorised over rows and groups of
trees and loop over leaf positions and path elements; the tests use them,
and ``chip_smoke.py`` holds the kernels against them on the card. Nothing
on the card's path calls them.
"""

import ctypes
from typing import NamedTuple, Optional

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
#: most f32 elements a plain step holds per tensor ([rows, trees, ...]):
#: 64 MB on the host, 1 GB on a card
_PLAIN_ELEMS = {"cpu": 1 << 24, "cuda": 1 << 28}


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
    ``weights`` [D + 1, max(D, 1)] f32 the Shapley weight table. Host
    arrays: ``expectation`` [T] f32 and ``root_weight`` [T] f32."""

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

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ShapForest(
        nodes=put(_pack_split_nodes(forest, num_features, cat_features)),
        base_weight=put(np.asarray(forest.base_weight, np.float32).reshape(-1)),
        steps=put(steps), elem_slot=put(elem_slot), elem_z=put(elem_z),
        leaf_value=put(leaf_value), leaf_m=put(leaf_m),
        n_leaves=put(n_leaves), tree_feats=put(tree_feats),
        n_feats=put(n_feats), weights=put(weight_table(d)),
        expectation=expectation,
        root_weight=np.asarray(forest.base_weight, np.float32)[:, 0].copy(),
        n_trees=int(n_trees), max_depth=d, num_features=int(num_features),
        has_cat=bool(len(cat_features)))


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


def scratch_floats(sf: ShapForest, num_features: int, num_outputs: int,
                   mode: str) -> int:
    """f32 words of a row's kernel scratch (``XrtShapArgs.scratch``): the
    class accumulators, then the current tree's per-feature sums."""
    kf = num_outputs * num_features
    u = sf.max_feats
    if mode == "saabas":
        return kf
    if mode == "exact":
        return kf + u
    return kf * num_features + kf + u * u + 2 * u


def out_shape(n: int, num_features: int, num_outputs: int, mode: str):
    f1 = num_features + 1
    if mode == "interactions":
        return (n, num_outputs, f1, f1)
    return (n, num_outputs, f1)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _args(sf: ShapForest, x, sc: TreeScales, out, scratch, mode: str):
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
    return a


def _run(mode: str, sf: ShapForest, x: torch.Tensor, sc: TreeScales,
         out: Optional[torch.Tensor], scratch: Optional[torch.Tensor],
         stream, plain):
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
    words = scratch_floats(sf, sf.num_features, sc.num_outputs, mode)
    _check(n * words < 2 ** 62 and n * shape[-1] < 2 ** 62,
           "B15: launch too large")
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    if scratch is None:
        scratch = torch.empty((max(words, 1) * max(n, 1),),
                              dtype=torch.float32, device=dev)
    _check(scratch.dtype == torch.float32 and scratch.is_contiguous()
           and scratch.device == dev and scratch.numel() >= words * n,
           f"B15: scratch must be contiguous f32 of at least {words * n} "
           f"elements on {dev}")
    if n == 0:
        return out
    a = _args(sf, x, sc, out, scratch, mode)
    s = (stream if stream is not None
         else torch.cuda.current_stream(dev)).cuda_stream
    with torch.cuda.device(dev):
        fn = getattr(_build.library("shap"), f"xrt_shap_{mode}")
        code = fn(ctypes.byref(a), s)
    _build.check(code, f"B15 shap {mode}")
    wrapper = _WRAPPERS[mode]
    wrapper.launches += 1
    LAUNCHES_BY_MODE[mode] += 1
    return out


def predict_contribs(sf: ShapForest, x: torch.Tensor, sc: TreeScales,
                     out: Optional[torch.Tensor] = None,
                     scratch: Optional[torch.Tensor] = None,
                     stream: Optional[torch.cuda.Stream] = None
                     ) -> torch.Tensor:
    """B15 Saabas wrapper: [N, K, F + 1] (see :func:`predict_contribs_plain`).
    ``scratch``: at least ``scratch_floats(...) * N`` f32 on the device
    (allocated when None); ``stream`` defaults to the current one."""
    return _run("saabas", sf, x, sc, out, scratch, stream,
                predict_contribs_plain)


def predict_contribs_exact(sf: ShapForest, x: torch.Tensor, sc: TreeScales,
                           out: Optional[torch.Tensor] = None,
                           scratch: Optional[torch.Tensor] = None,
                           stream: Optional[torch.cuda.Stream] = None
                           ) -> torch.Tensor:
    """B15 exact TreeSHAP wrapper: [N, K, F + 1]."""
    return _run("exact", sf, x, sc, out, scratch, stream,
                predict_contribs_exact_plain)


def predict_interactions(sf: ShapForest, x: torch.Tensor, sc: TreeScales,
                         out: Optional[torch.Tensor] = None,
                         scratch: Optional[torch.Tensor] = None,
                         stream: Optional[torch.cuda.Stream] = None
                         ) -> torch.Tensor:
    """B15 interactions wrapper: [N, K, F + 1, F + 1]."""
    return _run("interactions", sf, x, sc, out, scratch, stream,
                predict_interactions_plain)


#: B15 launches by entry point; each wrapper's ``launches`` counts its own,
#: and its ``launches_by_mode`` is this dict, shared by the three
LAUNCHES_BY_MODE = dict.fromkeys(MODES, 0)
_WRAPPERS = {"saabas": predict_contribs, "exact": predict_contribs_exact,
             "interactions": predict_interactions}
for _w in _WRAPPERS.values():
    _w.launches = 0
    _w.launches_by_mode = LAUNCHES_BY_MODE


def reset_launches() -> None:
    """Set every B15 launch counter to 0."""
    for mode, w in _WRAPPERS.items():
        w.launches = 0
        LAUNCHES_BY_MODE[mode] = 0


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
    ``saabas``: 8 a step of one walk and 2 a feature."""
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
