"""Leaf-wise (``grow_policy="lossguide"``) tree growth over node-sorted rows.

Port of ``xgboost_ray_tpu/ops/grow_lossguide.py`` ``build_tree_lossguide``
(``:51-301``): the frontier leaf with the highest gain is split, again and
again, until the leaf budget (``GrowConfig.max_leaves``) is spent. The
reference's static frontier table of ``2 * leaves - 1`` entries is kept as
it is (append-only: the root is entry 0, step t's children entries
``1 + 2t`` and ``2 + 2t``), and so is each step's rule: the first maximum of
the active entries' gains is split unless it is not finite (``do_split``),
a child may split further only while ``2 * slot + 2 < heap``, and leaf
values and covers come from ``leaf_weight`` of the children's totals, read
off their histograms.

The rows stay sorted by frontier leaf (K3's order, ``ops/histogram.py``),
each leaf a segment of it. One step is:

1. the frontier step (``frontier_step``; kernel ``csrc/lossguide.cu``, one
   CTA): takes in the last step's two children (their entries, records and
   segments), finds the first maximum of the entries' gains, writes the
   split leaf's records, retires its entry, and writes what the launches
   after it read: the leaf's segment as the middle node of a three-node
   level (the rows before it, the leaf, the rows after it) for K3, and the
   leaf's formed histogram;
2. K3 (``partition_level``) splits that segment into its two children,
   stably (the other two nodes do not split: their rows stay in place);
3. K1 builds the smaller child's histogram, int64 in fixed point on the
   card; the all-reduce merges it (``allreduce``) and ``dequantize`` makes
   it f32;
4. K2's level kernel without records (``ops/split.split_nodes``) forms the
   two children from the parent's histogram as the depthwise level step
   forms siblings (parent - smaller child in f32, the phantom missing
   bucket zeroed), keeps them in the grower's store of formed histograms
   (one a frontier entry) and finds their best splits.

After the last step the frontier step takes in the last children and
writes the leaves' segments in row order, and K3's leaf-value mode
(``partition_leaf_values``) gives every row its leaf's value. No launch
reads a device value on the host: a tree is ``max_leaves`` frontier steps
and ``max_leaves - 1`` launches each of K3, K1, the dequantise step and
K2, besides the root's K1, dequantise and K2, and the final K3 leaf-value
pass.

Quantized gradients and the quantized wire (``ops/grow_lossguide.py:63-146``
of the reference) as ``build_tree``: the step's histogram formed in the
integer domain and dequantized once (the store keeps integer-domain
histograms), the wire decided on the reference's step histogram (two
nodes; the root one). A step on the quantized wire sums both children
in one K1 launch and merges both, as the reference does (steps 3-4 then
take no sibling), and their totals from that launch come exact from one
more all-reduce.

On the CPU without fixed-point scales (the plain versions, f32 sums: the
JAX package's arithmetic) both children's histograms are summed from
their rows, as the reference builds both (``:218-221``); the reference's
histogram is its one-hot matrix product (``hist_onehot``), whose f32 sums
associate otherwise than the scatter order of the plain K1, so the plain
grower's statistics agree with it within the f32 summation bound.
"""

import ctypes
from typing import Callable, NamedTuple, Optional

import torch

from xgboost_ray_tpu_torch.ops import _build
from xgboost_ray_tpu_torch.ops.grow import GrowConfig, Tree, empty_tree
from xgboost_ray_tpu_torch.ops.histogram import (
    INACTIVE,
    LEAF,
    SPLIT,
    _check,
    build_histogram,
    dequantize,
    form_dequantize,
    partition_leaf_values,
    partition_level,
    quant_scales,
    quantized_hist_allreduce,
    wire_quantized,
)
from xgboost_ray_tpu_torch.ops.split import (
    LevelSplits,
    TreeRecords,
    leaf_weight,
    split_nodes,
)


class Frontier(NamedTuple):
    """The frontier of one lossguide tree on its device: the entry table
    ([n_ent] each: heap slot, active flag, gain, split feature, bin and
    default direction, the leaf's row segment [start, end) in K3's order),
    ``last`` int32 [2] (the last step's do_split and split slot), what K3
    reads a step (``seg`` [4], the three nodes' ``feature`` / ``split_bin``
    / ``default_left`` / ``state`` / ``value``), the formed histograms of
    every entry (``store`` [n_ent, F, nbt, 2] f32) and the split leaf's
    (``parent`` [1, F, nbt, 2]), and the leaves in row order for K3's
    leaf-value mode (``leaf_seg`` [n_ent + 1], ``leaf_state``,
    ``leaf_value`` [n_ent])."""

    slot: torch.Tensor
    active: torch.Tensor
    gain: torch.Tensor
    feat: torch.Tensor
    bin: torch.Tensor
    dl: torch.Tensor
    start: torch.Tensor
    end: torch.Tensor
    last: torch.Tensor
    seg: torch.Tensor
    feature: torch.Tensor
    split_bin: torch.Tensor
    default_left: torch.Tensor
    state: torch.Tensor
    value: torch.Tensor
    store: torch.Tensor
    parent: torch.Tensor
    leaf_seg: torch.Tensor
    leaf_state: torch.Tensor
    leaf_value: torch.Tensor


def new_frontier(leaves: int, n_rows: int, n_features: int, nbt: int,
                 device, store_dtype: torch.dtype = torch.float32
                 ) -> Frontier:
    """An empty frontier of ``2 * leaves - 1`` entries (the step's first
    launch fills entry 0 from the root); ``store_dtype`` the formed
    histograms' (int32: the sums of quantized gradients)."""
    n_ent = 2 * leaves - 1
    i32 = dict(dtype=torch.int32, device=device)
    # [0, 0, 0, N] made on the device: no copy from the host
    seg = torch.arange(4, **i32).floor_divide_(3).mul_(n_rows)
    f32 = dict(dtype=torch.float32, device=device)
    b8 = dict(dtype=torch.bool, device=device)
    u8 = dict(dtype=torch.uint8, device=device)
    return Frontier(
        slot=torch.full((n_ent,), -1, **i32),
        active=torch.zeros(n_ent, **b8),
        gain=torch.full((n_ent,), float("-inf"), **f32),
        feat=torch.zeros(n_ent, **i32), bin=torch.zeros(n_ent, **i32),
        dl=torch.zeros(n_ent, **b8), start=torch.zeros(n_ent, **i32),
        end=torch.zeros(n_ent, **i32), last=torch.zeros(2, **i32),
        seg=seg,
        feature=torch.zeros(3, **i32), split_bin=torch.zeros(3, **i32),
        default_left=torch.zeros(3, **b8), state=torch.zeros(3, **u8),
        value=torch.zeros(3, **f32),
        store=torch.empty((n_ent, n_features, nbt, 2), dtype=store_dtype,
                          device=device),
        parent=torch.zeros((1, n_features, nbt, 2), dtype=store_dtype,
                           device=device),
        leaf_seg=torch.zeros(n_ent + 1, **i32),
        leaf_state=torch.zeros(n_ent, **u8),
        leaf_value=torch.zeros(n_ent, **f32))


def frontier_step_plain(fr: Frontier, rec: TreeRecords, sp: LevelSplits,
                        new_seg: Optional[torch.Tensor], t: int,
                        select: bool, finish: bool) -> None:
    """The frontier step in PyTorch ops, in place on ``fr`` and
    ``rec.tree``. Takes in ``sp``: at ``t`` 0 the root's search (entry 0,
    rows [0, N)), else step t - 1's two children's (entries ``2t - 1``,
    ``2t``, their segments from K3's ``new_seg`` [7]), as the reference's
    scan body appends them (``:269-289``); then with ``select`` splits the
    first maximum of the active gains where it is finite (``:200-224``),
    and with ``finish`` writes the leaves in row order."""
    tree, p, dev = rec.tree, rec.p, fr.slot.device
    heap = tree.feature.shape[0]
    n_ent = fr.slot.shape[0]
    lr = p.learning_rate
    neg_inf = torch.tensor(float("-inf"), device=dev)
    gh = sp.node_gh
    value = lr * leaf_weight(gh[:, 0], gh[:, 1], p)
    if t == 0:
        ks = torch.tensor([0], device=dev)
        slots = torch.tensor([0], dtype=torch.int32, device=dev)
        split = torch.ones(1, dtype=torch.bool, device=dev)
        start = torch.zeros(1, dtype=torch.int32, device=dev)
        end = fr.seg[3:4].clone()
    else:
        k = 2 * t - 1
        ks = torch.tensor([k, k + 1], device=dev)
        parent = fr.last[1].long()
        slots = torch.stack([2 * parent + 1, 2 * parent + 2]).to(torch.int32)
        split = (fr.last[0] != 0).expand(2)
        start = new_seg[2:4].clone()
        end = new_seg[3:5].clone()
    can = split & sp.valid & (2 * slots.long() + 2 < heap)
    fr.slot[ks] = torch.where(split, slots, -1)
    fr.active[ks] = split
    fr.gain[ks] = torch.where(can, sp.gain, neg_inf)
    fr.feat[ks] = torch.where(split, sp.feature, 0)
    fr.bin[ks] = torch.where(split, sp.split_bin, 0)
    fr.dl[ks] = sp.default_left & split
    fr.start[ks] = torch.where(split, start, 0)
    fr.end[ks] = torch.where(split, end, 0)
    # the new leaves' records (none where the last step did not split)
    sl = slots.long()[split]
    tree.is_leaf[sl] = True
    tree.value[sl] = value[split]
    tree.cover[sl] = gh[:, 1][split]
    tree.base_weight[sl] = value[split]
    if select:
        scores = torch.where(fr.active, fr.gain, neg_inf)
        i = int(torch.argmax(scores))  # the first maximum
        do_split = bool(torch.isfinite(scores[i]))
        slot = int(fr.slot[i])
        n_features, nbt = fr.store.shape[1], fr.store.shape[2]
        feat = min(max(int(fr.feat[i]), 0), n_features - 1)
        sbin = int(fr.bin[i])
        fr.last[0] = int(do_split)
        fr.last[1] = max(slot, 0)
        fr.seg[1] = fr.start[i]
        fr.seg[2] = fr.end[i]
        fr.feature[1] = feat
        fr.split_bin[1] = sbin
        fr.default_left[1] = fr.dl[i]
        fr.state[1] = SPLIT if do_split else INACTIVE
        if do_split:
            tree.feature[slot] = feat
            tree.split_bin[slot] = sbin
            tree.threshold[slot] = rec.cuts[feat, min(max(sbin, 0), nbt - 3)]
            tree.default_left[slot] = fr.dl[i]
            tree.is_leaf[slot] = False
            tree.value[slot] = 0.0
            tree.gain[slot] = fr.gain[i]
            fr.active[i] = False
            fr.parent.copy_(fr.store[i:i + 1])
    if finish:
        act = fr.active
        idx = torch.arange(n_ent, device=dev)
        # row order: by start, an empty segment before the leaf that
        # starts where it sits (a rank may hold no row of a leaf)
        n_rows = int(fr.seg[3])
        key = torch.where(
            act, (fr.start.long() * (n_rows + 1) + fr.end.long()) * n_ent
            + idx, torch.iinfo(torch.int64).max)
        order = torch.argsort(key)
        m = int(act.sum())
        e = order[:m]
        fr.leaf_seg.fill_(int(fr.seg[3]))
        fr.leaf_seg[:m] = fr.start[e]
        fr.leaf_state.fill_(INACTIVE)
        fr.leaf_state[:m] = LEAF
        fr.leaf_value.zero_()
        fr.leaf_value[:m] = tree.value[fr.slot[e].long()]


def frontier_step(fr: Frontier, rec: TreeRecords, sp: LevelSplits,
                  new_seg: Optional[torch.Tensor], t: int, select: bool,
                  finish: bool) -> None:
    """The frontier-step wrapper (``frontier_step_plain``'s function): CPU
    tensors -> the plain version, CUDA tensors -> one launch of
    ``xrt_lossguide_step`` (``csrc/lossguide.cu``), or raise.
    ``frontier_step.launches`` counts the launches."""
    if not fr.slot.is_cuda:
        frontier_step_plain(fr, rec, sp, new_seg, t, select, finish)
        return
    tree, p = rec.tree, rec.p
    dev = fr.slot.device
    n_ent = fr.slot.shape[0]
    _check(t == 0 or (new_seg is not None and new_seg.shape == (7,)
                      and new_seg.dtype == torch.int32
                      and new_seg.device == dev),
           "frontier_step: new_seg must be K3's int32 [7] after a step")
    _check(sp.node_gh.shape == ((1 if t == 0 else 2), 2)
           and sp.node_gh.device == dev,
           "frontier_step: the root's search at t 0, two children's after")
    rec.c_args()  # checks the tree's arrays
    a = _build.LossguideArgs()
    for name in ("feature", "split_bin", "threshold", "default_left",
                 "is_leaf", "value", "gain", "cover", "base_weight"):
        setattr(a, name, getattr(tree, name).data_ptr())
    a.cuts = rec.cuts.data_ptr()
    for name in ("slot", "active", "gain", "feat", "bin", "dl", "start",
                 "end", "last"):
        setattr(a, "ent_" + name if name != "last" else "last",
                getattr(fr, name).data_ptr())
    a.sp_gain, a.sp_feat, a.sp_bin = (sp.gain.data_ptr(),
                                      sp.feature.data_ptr(),
                                      sp.split_bin.data_ptr())
    a.sp_dl, a.sp_valid, a.sp_gh = (sp.default_left.data_ptr(),
                                    sp.valid.data_ptr(),
                                    sp.node_gh.data_ptr())
    a.new_seg = _build.ptr(new_seg)
    a.seg3, a.feature3, a.split_bin3 = (fr.seg.data_ptr(),
                                        fr.feature.data_ptr(),
                                        fr.split_bin.data_ptr())
    a.dl3, a.state3 = fr.default_left.data_ptr(), fr.state.data_ptr()
    a.store, a.parent = fr.store.data_ptr(), fr.parent.data_ptr()
    a.leaf_seg, a.leaf_state, a.leaf_value = (fr.leaf_seg.data_ptr(),
                                              fr.leaf_state.data_ptr(),
                                              fr.leaf_value.data_ptr())
    a.hist_pairs = fr.store[0].numel() // 2
    a.n_ent, a.heap = n_ent, tree.feature.shape[0]
    a.n_features, a.nbt = fr.store.shape[1], fr.store.shape[2]
    a.t, a.select, a.finish = t, int(select), int(finish)
    a.reg_lambda, a.reg_alpha = p.reg_lambda, p.reg_alpha
    a.max_delta_step = max(p.max_delta_step, 0.0)
    a.learning_rate = p.learning_rate
    with torch.cuda.device(dev):
        code = _build.library("lossguide").xrt_lossguide_step(
            ctypes.byref(a), _build.stream_ptr(dev))
    _build.check(code, "frontier step")
    frontier_step.launches += 1


frontier_step.launches = 0


def build_tree_lossguide(
    bins: torch.Tensor,  # [N, F] int16/uint8 bins (max_bin == missing)
    gh: torch.Tensor,  # [N, 2] float32 (grad, hess), or int8/int16
    cuts: torch.Tensor,  # [F, max_bin - 1] raw cut values
    cfg: GrowConfig,
    feat_has_missing: Optional[torch.Tensor] = None,  # [F] bool
    allreduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    qscale: Optional[torch.Tensor] = None,  # [4] f32 fixed-point scales
    tree: Optional[Tree] = None,  # [heap] fields to write the tree into
    row_value: Optional[torch.Tensor] = None,  # [N] f32 to write into
    feature_mask: Optional[torch.Tensor] = None,  # [F] bool (bytree)
    cat: Optional[torch.Tensor] = None,  # [F] bool: categorical features
    gh_scale: Optional[torch.Tensor] = None,  # [2] f32: gh is int8/int16
    coll=None,  # the ranks' Collectives: the quantized wire's
):
    """Grow one leaf-wise tree of at most ``cfg.max_leaves`` leaves in the
    heap of depth ``cfg.max_depth``. Returns (Tree, row_value [N]), the
    contract of ``ops/grow.build_tree``, whose arguments these are
    (column sampling by tree only; no constraints: ``params`` refuses
    them with lossguide).

    On the card, and wherever ``qscale`` is given, K1 sums the smaller
    child (in fixed point, or int32 for integer gradients), and the
    sibling is formed from the parent's histogram as the depthwise grower
    forms it; on the CPU's plain versions both children are summed, as
    the reference builds both. Quantized gradients (``gh_scale``) and the
    quantized wire (``cfg.hist_quant``, over ``coll``) as ``build_tree``:
    the step's histogram is formed in the integer domain and dequantized
    once. Where the reference's step histogram (two nodes, the root one)
    reaches ``cfg.hist_quant_min_bytes`` its merge takes the wire: then
    every path sums both children, as the reference does (a sibling
    formed from a parent that came off the wire would carry its
    ancestors' rounding), and their totals from the same K1 launch come
    exact from one more all-reduce. The frontier keeps integer-domain
    histograms: int32, or f32 once a step's wire is quantized."""
    n, num_features = bins.shape
    dev = bins.device
    quant_gh = gh_scale is not None
    if qscale is None and bins.is_cuda and not quant_gh:
        qscale = quant_scales(gh, n)
    nbt = cfg.max_bin + 1
    leaves = max(1, int(cfg.max_leaves))
    per_node = num_features * nbt * 2
    # the reference's step histograms: the root's, then two children's
    q_root = wire_quantized(cfg.hist_quant, per_node,
                            cfg.hist_quant_min_bytes)
    q_step = wire_quantized(cfg.hist_quant, 2 * per_node,
                            cfg.hist_quant_min_bytes)
    store_int = quant_gh and not (q_root or (leaves > 1 and q_step))
    subtract = not q_step and (bins.is_cuda or qscale is not None)
    store_dtype = torch.int32 if store_int else torch.float32
    if tree is None:
        tree = empty_tree(cfg.heap_size, dev)
    if row_value is None:
        row_value = torch.empty(n, dtype=torch.float32, device=dev)
    rec = TreeRecords(tree, cuts, feat_has_missing, cfg.split, None, cat)
    fr = new_frontier(leaves, n, num_features, nbt, dev, store_dtype)
    if coll is None and cfg.hist_quant != "none":
        from xgboost_ray_tpu_torch.distributed import Collectives

        coll = Collectives()  # this process's world: one rank without one

    def merged(h, qwire):
        """The step histogram merged over the ranks: on the wire where it
        is quantized (the card's fixed-point sums dequantized first), else
        exactly (int32 for integer gradients)."""
        if qwire:
            if qscale is not None:
                h = dequantize(h, qscale)
            return quantized_hist_allreduce(h, cfg.hist_quant, coll, 0,
                                            cfg.hist_quant_block)
        if allreduce is not None:
            h = allreduce(h)
        return h if qscale is None else dequantize(h, qscale)

    def exact_totals(t):
        """Nodes' (G, H) summed exactly over the ranks, as f32."""
        if allreduce is not None:
            t = allreduce(t)
        if quant_gh:
            return form_dequantize(t.view(-1, 1, 1, 2), None, None, gh_scale,
                                   torch.int32, False)[1].view(-1, 2)
        return t if qscale is None else dequantize(t, qscale)

    def search(h, prev, sir, out, qwire, totals):
        """The nodes' search: with integer gradients their histogram
        formed, kept in ``out`` and dequantized once first."""
        if not quant_gh:
            return split_nodes(h, prev, sir, rec, out, feature_mask,
                               totals=totals)
        formed, values, tot = form_dequantize(h, prev, sir, gh_scale,
                                              store_dtype,
                                              with_totals=not qwire)
        out.copy_(formed)
        return split_nodes(values, None, None, rec, torch.empty_like(values),
                           feature_mask, totals=totals if qwire else tot)

    order = torch.arange(n, dtype=torch.int32, device=dev)
    root_seg = torch.arange(2, dtype=torch.int32, device=dev).mul_(n)
    hist, totals = build_histogram(bins, gh, order, root_seg, 1, nbt,
                                   qscale=qscale)
    sp = search(merged(hist, q_root), None, None, fr.store[0:1], q_root,
                exact_totals(totals) if q_root else None)
    frontier_step(fr, rec, sp, None, 0, leaves > 1, leaves == 1)
    for t in range(leaves - 1):
        part = partition_level(
            order, fr.seg, bins, fr.feature, fr.split_bin, fr.default_left,
            fr.state, fr.value, row_value, write_small=subtract,
            missing_bin=cfg.max_bin,
            merge_counts=allreduce if subtract else None, cat=cat)
        order = part.order
        kids = fr.store[1 + 2 * t:3 + 2 * t]
        if subtract:
            small, _ = build_histogram(bins, gh, part.small_rows,
                                       part.small_seg[1:3], 1, nbt,
                                       qscale=qscale)
            sp = search(merged(small, False), fr.parent,
                        part.small_is_right[1:2], kids, False, None)
        else:
            # both children: the middle node's two, in K3's order
            both, two = build_histogram(bins, gh, order, part.seg[2:5], 2,
                                        nbt, qscale=qscale)
            sp = search(merged(both, q_step), None, None, kids, q_step,
                        exact_totals(two) if q_step else None)
        frontier_step(fr, rec, sp, part.seg, t + 1, t + 2 < leaves,
                      t + 2 == leaves)
    partition_leaf_values(order, fr.leaf_seg, fr.leaf_state, fr.leaf_value,
                          row_value)
    return tree, row_value
