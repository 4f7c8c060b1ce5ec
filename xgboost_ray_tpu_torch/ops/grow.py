"""Level-wise (depth-wise) tree growth over node-sorted rows.

Port of ``xgboost_ray_tpu/ops/grow.py``: ``GrowConfig`` (``:164``), the
padded-heap ``Tree`` (``:239``), ``route_right_binned`` (``:65``), the
depthwise ``build_tree`` (``:269-785``) on its order-tracking path with
sibling subtraction (``:433-438``, ``:529-561``) — the accelerator path —
and B4, ``predict_tree_binned`` (``:786``): one tree, or a round's K trees
in one launch, walked over binned rows, what the engine adds to an eval
set's margins each round (kernel: ``csrc/walk.cu``;
``predict_tree_binned_plain`` beside it).

Per level d (``n_nodes = 2**d``):

1. K1 builds the histogram of every node (d = 0) or, with sibling
   subtraction, of each parent's smaller child from the compacted row list;
2. K2 (``split_level``, one launch) forms the sibling as parent - child,
   reads each node's (G, H) off the histogram, finds its best split and
   writes the level's tree records, the node states K3 reads and the next
   level's active nodes;
3. K3 routes the rows, re-partitions them by child, compacts the next
   level's smaller children and writes the leaf value of every row whose
   leaf is fixed on this level (``row_value``).

Node totals are read off the histogram (K2), as the JAX grower reads them;
below the last level K1 sums the final nodes' rows without a histogram,
K2's ``leaf_records`` writes the final records, and K3's leaf-value mode
hands every row its final leaf value (no row moves, so that pass routes,
scans and scatters nothing). Nothing here reads a device value on the
host: a tree is launches only.

Column sampling (``colsample_bytree`` / ``_bylevel`` / ``_bynode``,
``ops/grow.py:132-161``, ``:610-623``): the tree's mask, and each level's
draws ANDed into it (B12f, ``sample_feature_mask``; the keys fold in
``SALT_BYLEVEL`` / ``SALT_BYNODE`` and the level), go to K2's masked
instantiation. A row-sampled tree is grown over its compacted rows
(``ops/sampling.py``), which nothing here needs to know.

Constraints (``GrowConfig.monotone_constraints`` /
``interaction_constraints``, ``ops/grow.py:396-430``): K2's constrained
instantiation scores and values each node within its monotone bounds,
[1] at the root and doubling each level on the device (each level step
returns the next level's), and reads each node's interaction mask off its
ancestors in the tree it writes; the plain grower (CPU tensors) keeps the
reference's own interaction state instead (``InteractionState``).

Quantized gradients (``gh_scale``; ``ops/grow.py:340-360``, ``:577-601``):
K1's integer instantiation sums the int8 / int16 buffer exactly, the merge
is an exact int32 all-reduce, and the level's histogram is formed in the
integer domain and dequantized once (``form_dequantize``), which also
hands K2 the nodes' (G, H). The quantized wire (``cfg.hist_quant``): a
level whose built histogram reaches ``hist_quant_min_bytes`` (at the
reference's 4 bytes a value) merges on ``quantized_hist_allreduce``, and
its node totals come exact from K1's totals pass merged by one more
all-reduce (``:441-481``), into K2's totals input.

``allreduce`` is the merge across ranks (the ``allreduce`` argument of
``ops/grow.py:269``): None at world 1, else the engine's all-reduce SUM,
which counts its bytes. It merges every histogram and the final totals
and, as the reference does (``ops/grow.py:509-526``), the per-child row
counts inside K3 (``merge_counts``): the smaller child must be the same on
every rank, so above world 1 K3 chooses it from the merged counts. On
the card K1 sums in fixed point (``qscale``: the round's scales,
``ops/histogram.quant_scales``), so the merge takes the int64 histogram
and totals and ``dequantize`` gives K2 their f32 values after it; on the
CPU the sums are f32, as the JAX package's.
"""

import ctypes
import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import torch

from xgboost_ray_tpu_torch.ops import _build
from xgboost_ray_tpu_torch.ops.objectives import _fma
from xgboost_ray_tpu_torch.ops.random import Key, fold_in, gumbel, uniform
from xgboost_ray_tpu_torch.ops.histogram import (
    SPLIT,
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
    SplitParams,
    TreeConstraints,
    TreeRecords,
    leaf_records,
    split_level,
)


# Disjoint fold_in domains of the per-tree draws (``ops/grow.py:57-62``):
# row subsampling, GOSS and the three column-sampling masks never share a
# stream
SALT_SUBSAMPLE = 0x51D1
SALT_BYTREE = 0x51D2
SALT_BYLEVEL = 0x51D3
SALT_BYNODE = 0x51D4
SALT_GOSS = 0x51D5
SALT_SR = 0x51D6  # stochastic rounding of quantized gradients (gh_precision)


def route_right_binned(bin_vals, split_bin, default_left, missing_bin: int,
                       is_cat=None):
    """The binned routing rule: numeric bin > split_bin goes right, a
    categorical one (``is_cat``, broadcast like the others; None: no
    categorical feature) goes left only at bin == split_bin (one-vs-rest),
    the missing bucket follows the learned default."""
    present_right = bin_vals > split_bin
    if is_cat is not None:
        present_right = torch.where(is_cat, bin_vals != split_bin,
                                    present_right)
    return torch.where(bin_vals == missing_bin, ~default_left, present_right)


@dataclasses.dataclass(frozen=True)
class GrowConfig:
    max_depth: int = 6
    max_bin: int = 256
    split: SplitParams = dataclasses.field(default_factory=SplitParams)
    sibling_subtract: bool = True
    # per-feature monotone constraints (len == F, values -1/0/+1) or ();
    # tuple of feature-index groups of the interaction constraints or ()
    monotone_constraints: tuple = ()
    interaction_constraints: tuple = ()
    # indices of the categorical features (bins are category codes, splits
    # one-vs-rest, ``ops/grow.py:178-181``)
    cat_features: tuple = ()
    # the lossguide leaf budget (0: depthwise growth, ``engine.py:314-322``)
    max_leaves: int = 0
    # the histogram merge's wire (``ops/histogram.quantized_hist_allreduce``)
    hist_quant: str = "none"
    hist_quant_min_bytes: int = 32768
    hist_quant_block: int = 512

    @property
    def heap_size(self) -> int:
        return (1 << (self.max_depth + 1)) - 1


class Tree(NamedTuple):
    """One decision tree in padded-heap layout; all arrays [heap_size]."""

    feature: torch.Tensor  # int32, -1 if leaf/unused
    split_bin: torch.Tensor  # int32, rows with bin <= split_bin go left
    threshold: torch.Tensor  # float32 raw-value threshold (left iff x < thr)
    default_left: torch.Tensor  # bool, where missing goes
    is_leaf: torch.Tensor  # bool
    value: torch.Tensor  # float32 leaf value (scaled by learning_rate)
    gain: torch.Tensor  # float32 split gain at internal nodes
    cover: torch.Tensor  # float32 hessian sum reaching each node
    base_weight: torch.Tensor  # float32 lr-scaled leaf_weight of every node


def empty_tree(heap_size: int, device, n_trees: Optional[int] = None) -> Tree:
    """An unused heap of ``heap_size`` nodes, or with ``n_trees`` that many
    ([n_trees, heap_size] fields)."""
    shape = (heap_size,) if n_trees is None else (n_trees, heap_size)

    def z(dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Tree(
        feature=torch.full(shape, -1, dtype=torch.int32, device=device),
        split_bin=z(torch.int32), threshold=z(torch.float32),
        default_left=z(torch.bool), is_leaf=z(torch.bool),
        value=z(torch.float32), gain=z(torch.float32),
        cover=z(torch.float32), base_weight=z(torch.float32),
    )


def sample_feature_mask_plain(key: Key, n_features: int, rate: float,
                              log_fw: Optional[torch.Tensor] = None,
                              batch: Optional[int] = None,
                              base: Optional[torch.Tensor] = None,
                              device=None) -> torch.Tensor:
    """The reference's ``sample_feature_mask`` (``ops/grow.py:132``), bool
    [F] or [batch, F], ANDed with ``base`` [F] where given: without
    ``log_fw`` a Bernoulli(rate) draw and its first kept feature (feature 0
    where none is); with ``log_fw`` (log of ``feature_weights``, -inf at 0)
    the features whose Gumbel-perturbed score reaches the k-th largest, k =
    max(1, round(rate F)), at a finite weight, and the first maximum."""
    shape = (n_features,) if batch is None else (batch, n_features)
    if log_fw is None:
        drawn = uniform(key, shape, device=device) < torch.tensor(
            rate, dtype=torch.float32, device=device)
        first = drawn.to(torch.uint8).argmax(dim=-1, keepdim=True)
    else:
        k = max(1, int(round(rate * n_features)))
        scores = log_fw + gumbel(key, shape, device=device)
        kth = torch.sort(scores, dim=-1, descending=True).values[..., k - 1:k]
        drawn = (scores >= kth) & torch.isfinite(log_fw)
        first = scores.argmax(dim=-1, keepdim=True)
    guard = torch.arange(n_features, device=drawn.device) == first
    mask = drawn | guard
    return mask if base is None else mask & base


def sample_feature_mask(key: Key, n_features: int, rate: float,
                        log_fw: Optional[torch.Tensor] = None,
                        batch: Optional[int] = None,
                        base: Optional[torch.Tensor] = None,
                        device=None) -> torch.Tensor:
    """B12f wrapper: ``sample_feature_mask_plain``'s bool mask on
    ``device``. On the CPU the plain version; on a CUDA device one launch
    of ``xrt_feature_mask`` (``csrc/sampling.cu``), a CTA a row, or raise.
    ``log_fw`` and ``base`` lie on ``device``. ``sample_feature_mask
    .launches`` counts the launches."""
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return sample_feature_mask_plain(key, n_features, rate, log_fw, batch,
                                         base, device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    rows = 1 if batch is None else int(batch)
    for name, t, dtype in (("log_fw", log_fw, torch.float32),
                           ("base", base, torch.bool)):
        if t is not None and not (t.device == device and t.dtype == dtype
                                  and t.shape == (n_features,)
                                  and t.is_contiguous()):
            raise ValueError(f"sample_feature_mask: {name} must be a "
                             f"contiguous {dtype} [F] on {device}")
    out = torch.empty((rows, n_features), dtype=torch.bool, device=device)
    a = _build.MaskArgs()
    a.log_fw, a.base, a.out = (_build.ptr(log_fw), _build.ptr(base),
                               out.data_ptr())
    a.rows, a.n_features = rows, n_features
    a.k = max(1, int(round(rate * n_features)))
    a.rate = rate
    a.key0, a.key1 = key
    with torch.cuda.device(device):
        code = _build.library("sampling").xrt_feature_mask(
            ctypes.byref(a), _build.stream_ptr(device))
    _build.check(code, "B12f feature mask")
    sample_feature_mask.launches += 1
    return out[0] if batch is None else out


sample_feature_mask.launches = 0


def level_feature_mask(tree_mask: Optional[torch.Tensor], level_key: Key,
                       depth: int, n_nodes: int, n_features: int,
                       bylevel: float, bynode: float,
                       log_fw: Optional[torch.Tensor], device
                       ) -> Optional[torch.Tensor]:
    """A level's feature mask (``ops/grow.py:610-623``): the tree's
    (``colsample_bytree``), ANDed with the level's draw (``colsample_bylevel``,
    [F]), then with each node's (``colsample_bynode``, [n_nodes, F], node k
    row k over every heap slot of the level); None where nothing masks."""
    fmask = tree_mask
    if bylevel < 1.0:
        k = fold_in(fold_in(level_key, SALT_BYLEVEL), depth)
        fmask = sample_feature_mask(k, n_features, bylevel, log_fw,
                                    base=fmask, device=device)
    if bynode < 1.0:
        k = fold_in(fold_in(level_key, SALT_BYNODE), depth)
        fmask = sample_feature_mask(k, n_features, bynode, log_fw,
                                    batch=n_nodes, base=fmask, device=device)
    return fmask


def cat_flags(cat_features: tuple, n_features: int,
              device) -> Optional[torch.Tensor]:
    """[F] bool marking the categorical features (None where there are
    none): the reference's ``cat_mask_const`` (``ops/grow.py:78``)."""
    if not cat_features:
        return None
    out = torch.zeros(n_features, dtype=torch.bool)
    out[list(cat_features)] = True
    return out.to(device)


class InteractionState:
    """The reference's per-node interaction state of one level
    (``ops/grow.py:414-430``, ``:625-641``, ``:750-760``): ``active`` [n,
    S] the groups holding every feature split on above the node, ``used``
    [n, F] those features, ``has_used`` [n] whether any split is above it;
    the plain grower's, where K2 reads the same off the tree
    (``ops/split.interaction_mask``)."""

    def __init__(self, membership: torch.Tensor):
        n_sets, num_features = membership.shape
        dev = membership.device
        self.membership = membership
        self.active = torch.ones((1, n_sets), dtype=torch.bool, device=dev)
        self.used = torch.zeros((1, num_features), dtype=torch.bool,
                                device=dev)
        self.has_used = torch.zeros(1, dtype=torch.bool, device=dev)

    def allowed(self) -> torch.Tensor:
        """[n, F] bool: the union of the still-active groups and the path's
        features; a node below no split may use any feature."""
        union = (self.active[:, :, None] & self.membership[None]).any(dim=1)
        return torch.where(self.has_used[:, None], union | self.used, True)

    def split(self, valid_split: torch.Tensor, feature: torch.Tensor):
        """Advance to the next level after the level's splits."""
        num_features = self.membership.shape[1]
        fsafe = feature.clamp(0, num_features - 1).long()
        vs = valid_split[:, None]
        self.active = torch.where(vs, self.active & self.membership.T[fsafe],
                                  self.active)
        onehot = (torch.arange(num_features, device=fsafe.device)[None, :]
                  == fsafe[:, None])
        self.used = self.used | (vs & onehot)
        self.has_used = self.has_used | valid_split
        self.active, self.used, self.has_used = (
            torch.repeat_interleave(t, 2, dim=0)
            for t in (self.active, self.used, self.has_used))


def build_tree(
    bins: torch.Tensor,  # [N, F] int16/uint8 bins (max_bin == missing)
    gh: torch.Tensor,  # [N, 2] float32 (grad, hess)
    cuts: torch.Tensor,  # [F, max_bin - 1] raw cut values
    cfg: GrowConfig,
    feat_has_missing: Optional[torch.Tensor] = None,  # [F] bool
    allreduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    qscale: Optional[torch.Tensor] = None,  # [4] f32 fixed-point scales
    tree: Optional[Tree] = None,  # [heap] fields to write the tree into
    row_value: Optional[torch.Tensor] = None,  # [N] f32 to write into
    feature_mask: Optional[torch.Tensor] = None,  # [F] bool (bytree)
    level_key: Optional[Key] = None,  # the tree's key (bylevel / bynode)
    colsample_bylevel: float = 1.0,
    colsample_bynode: float = 1.0,
    feature_log_weights: Optional[torch.Tensor] = None,  # [F] log(fw)
    constraints: Optional[TreeConstraints] = None,  # cfg's, made once
    cat: Optional[torch.Tensor] = None,  # [F] bool of cfg.cat_features
    gh_scale: Optional[torch.Tensor] = None,  # [2] f32: gh is int8/int16
    coll=None,  # the ranks' Collectives: the quantized wire's
):
    """Grow one tree. Returns (Tree, row_value [N]): the learning-rate
    scaled leaf value each row lands in. ``tree`` and ``row_value``, where
    given, are written in place and returned (a round of K trees writes
    class k's into row k of its [K, heap] and [K, N] tensors).

    With ``qscale`` (always on the card; there this rank's own scales when
    the caller passes none) the histograms are summed in fixed point and
    dequantised after ``allreduce``; without it, on the CPU, they are f32.

    Column sampling: ``feature_mask`` (the tree's), and with ``level_key``
    each level's bylevel / bynode draws (B12f, ``level_feature_mask``),
    take K2's masked level step. ``cfg``'s constraints take its
    constrained level step (``constraints``: their device form, made here
    where the caller passes none). ``cat`` (``cat_flags`` of
    ``cfg.cat_features``, made here where the caller passes none) takes
    K2's categorical search and K3's categorical route.

    Quantized gradients (``gh_scale``: ``gh`` is the int8 / int16 buffer
    of ``ops/objectives.quantize_gh`` and its [2] scales): K1 sums exact
    int32 (no fixed point), the merge is exact in int32, and each level's
    histogram is formed in the integer domain and dequantized once
    (``form_dequantize``, the reference's ``ops/grow.py:577-601``), which
    also gives K2 the nodes' (G, H) as the dequantized exact sums.

    The quantized wire (``cfg.hist_quant``; ``coll`` the ranks'
    ``Collectives``, this process's where None): a level whose built
    histogram reaches ``cfg.hist_quant_min_bytes`` at 4 bytes a value
    merges its f32 values (the card's fixed-point sums dequantized first;
    the integer sums as f32) on the wire, and its node totals come exact
    from one more all-reduce of every node's sums (K1 without the
    histogram), as the reference's packed side-psum
    (``ops/grow.py:441-481``); after a quantized wire the integer-domain
    histogram is f32."""
    n = bins.shape[0]
    dev = bins.device
    quant_gh = gh_scale is not None
    if qscale is None and bins.is_cuda and not quant_gh:
        qscale = quant_scales(gh, n)

    def merged(h):
        if allreduce is not None:
            h = allreduce(h)
        return h if qscale is None else dequantize(h, qscale)

    def exact_totals(t):
        """Every node's (G, H) summed exactly over the ranks, as f32 (the
        integer sums of quantized gradients dequantized once)."""
        if not quant_gh:
            return merged(t)
        if allreduce is not None:
            t = allreduce(t)
        return form_dequantize(t.view(-1, 1, 1, 2), None, None, gh_scale,
                               torch.int32, False)[1].view(-1, 2)

    if coll is None and cfg.hist_quant != "none":
        from xgboost_ray_tpu_torch.distributed import Collectives

        coll = Collectives()  # this process's world: one rank without one

    def on_wire(h):
        """A quantized level's merge: the local f32 values on the wire."""
        if qscale is not None:
            h = dequantize(h, qscale)
        return quantized_hist_allreduce(h, cfg.hist_quant, coll, 0,
                                        cfg.hist_quant_block)

    nbt = cfg.max_bin + 1
    if tree is None:
        tree = empty_tree(cfg.heap_size, dev)
    if constraints is None and (cfg.monotone_constraints
                                or cfg.interaction_constraints):
        constraints = TreeConstraints(cfg.monotone_constraints,
                                      cfg.interaction_constraints,
                                      bins.shape[1], dev)
    if cat is None and cfg.cat_features:
        cat = cat_flags(cfg.cat_features, bins.shape[1], dev)
    rec = TreeRecords(tree, cuts, feat_has_missing, cfg.split, constraints,
                      cat)
    cons = rec.cons
    # monotone bounds: [1] at the root, the next level's from each step
    bounds = None
    if cons is not None and cons.monotone is not None:
        inf = torch.full((1,), float("inf"), device=dev)
        bounds = (-inf, inf)
    ic = (InteractionState(cons.membership)
          if cons is not None and cons.membership is not None
          and not bins.is_cuda else None)
    if row_value is None:
        row_value = torch.empty(n, dtype=torch.float32, device=dev)
    order = torch.arange(n, dtype=torch.int32, device=dev)
    seg = torch.tensor([0, n], dtype=torch.int32, device=dev)
    active = torch.ones(1, dtype=torch.bool, device=dev)
    prev_hist = part = None

    num_features = bins.shape[1]
    per_level = level_key is not None and (colsample_bylevel < 1.0
                                           or colsample_bynode < 1.0)
    for d in range(cfg.max_depth):
        n_nodes = 1 << d
        fmask = (level_feature_mask(feature_mask, level_key, d, n_nodes,
                                    num_features, colsample_bylevel,
                                    colsample_bynode, feature_log_weights,
                                    dev)
                 if per_level else feature_mask)
        allowed = None if ic is None else ic.allowed()
        # the formed histogram is the next level's parent, unless none comes
        keep = cfg.sibling_subtract and d < cfg.max_depth - 1
        sib = d > 0 and cfg.sibling_subtract
        n_built = n_nodes // 2 if sib else n_nodes
        qwire = wire_quantized(cfg.hist_quant,
                               n_built * num_features * nbt * 2,
                               cfg.hist_quant_min_bytes)
        if sib:
            # build each parent's smaller child; the sibling is parent - it
            hist, totals = build_histogram(
                bins, gh, part.small_rows, part.small_seg, n_nodes // 2, nbt,
                qscale=qscale)
        else:
            hist, totals = build_histogram(bins, gh, order, seg, n_nodes, nbt,
                                           qscale=qscale)
        node_gh = None
        if qwire:
            if sib:  # every node's sums, not only the smaller children's
                _, totals = build_histogram(bins, gh, order, seg, n_nodes,
                                            nbt, with_hist=False,
                                            qscale=qscale)
            node_gh = exact_totals(totals)
            hist = on_wire(hist)
        elif quant_gh:
            if allreduce is not None:
                hist = allreduce(hist)
        else:
            hist = merged(hist)
        sir = part.small_is_right if sib else None
        if quant_gh:
            # the integer domain: form, keep, dequantize once
            formed_int = hist.dtype == torch.int32 and (
                not sib or prev_hist.dtype == torch.int32)
            formed, values, tot = form_dequantize(
                hist, prev_hist if sib else None, sir, gh_scale,
                torch.int32 if formed_int else torch.float32,
                with_totals=not qwire)
            step = split_level(values, None, None, active, rec, False, fmask,
                               bounds, allowed,
                               totals=node_gh if qwire else tot)
            next_hist = formed if keep else None
        else:
            step = split_level(hist, prev_hist if sib else None, sir, active,
                               rec, keep, fmask, bounds, allowed,
                               totals=node_gh)
            next_hist = step.hist
        sp = step.splits
        bounds = step.bounds
        if ic is not None:
            ic.split(step.state == SPLIT, sp.feature)
        part = partition_level(
            order, seg, bins, sp.feature, sp.split_bin, sp.default_left,
            step.state, step.node_value, row_value,
            write_small=keep, missing_bin=cfg.max_bin,
            merge_counts=allreduce if keep else None, cat=cat,
        )
        order, seg = part.order, part.seg
        prev_hist, active = next_hist, step.active

    # final level: every still-active node is a leaf, valued from its rows'
    # (g, h) totals (K1 without the histogram), and its rows take the value
    n_nodes = 1 << cfg.max_depth
    _, totals = build_histogram(bins, gh, order, seg, n_nodes, nbt,
                                with_hist=False, qscale=qscale)
    node_value, state = leaf_records(exact_totals(totals), active, rec,
                                     bounds)
    partition_leaf_values(order, seg, state, node_value, row_value)
    return tree, row_value


# --------------------------------------------------------------------------
# B4: the binned tree walk
# --------------------------------------------------------------------------


def predict_tree_binned_plain(tree: Tree, bins: torch.Tensor, max_depth: int,
                              missing_bin: int,
                              cat: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Walk one tree over binned rows ``bins`` [N, F]; the leaf value of
    every row [N] f32 (the JAX ``predict_tree_binned``; ``cat`` [F] bool
    the categorical features): ``max_depth`` steps, a leaf keeping its
    index. A tree of [T, heap] fields is T trees, walked one after the
    other: [T, N]."""
    if tree.feature.dim() == 2:
        return torch.stack([
            predict_tree_binned_plain(Tree(*[f[t] for f in tree]), bins,
                                      max_depth, missing_bin, cat)
            for t in range(tree.feature.shape[0])])
    n, num_features = bins.shape
    idx = torch.zeros(n, dtype=torch.int64, device=bins.device)
    for _ in range(max_depth):
        f = tree.feature[idx].clamp(0, num_features - 1).long()
        bv = bins.gather(1, f[:, None])[:, 0].to(torch.int32)
        go_right = route_right_binned(bv, tree.split_bin[idx],
                                      tree.default_left[idx], missing_bin,
                                      None if cat is None else cat[f])
        nxt = 2 * idx + 1 + go_right.long()
        idx = torch.where(tree.is_leaf[idx], idx, nxt)
    return tree.value[idx]


_WALK_DTYPES = {"feature": torch.int32, "split_bin": torch.int32,
                "default_left": torch.bool, "is_leaf": torch.bool,
                "value": torch.float32}

#: B4's mappings (``csrc/walk.cu``): row tiles staged in shared memory, or
#: each visit's bin gathered from device memory
WALK_MAPPINGS = ("tiled", "gather")
#: dynamic shared memory a CTA may take after the opt-in attribute
WALK_SHARED_MAX = 227 * 1024
#: a tile buffer's bytes: the target, and the most for the 32-row tile of
#: wide rows (wider rows take the gather mapping)
_WALK_TILE_BYTES = 32 * 1024
_WALK_TILE_MAX = 100 * 1024
_WALK_MIN_ROWS, _WALK_MAX_ROWS = 32, 1024
_WALK_GATHER_ROWS = 512  # rows a tile of the gather mapping (no staging)
_WALK_STAGES = 2  # kStages of the kernel: tile buffers a CTA
_NODE_BYTES = 12  # a staged node: its 8-byte record and its f32 value
#: the records' 24-bit feature field
WALK_MAX_FEATURES = 1 << 24


class WalkPlan(NamedTuple):
    """How one B4 launch maps its work (``csrc/walk.cu``)."""

    mapping: str  # "tiled" | "gather"
    rows_per_tile: int  # R, a power of two
    trees_per_group: int  # G trees staged at once; 0: forest not staged
    n_groups: int
    shared_bytes: int  # dynamic shared memory a CTA: forest + tile buffers


def _round16(b: int) -> int:
    return -(-b // 16) * 16


@functools.lru_cache(maxsize=None)
def walk_plan(num_features: int, bin_bytes: int, n_trees: int,
              max_depth: int, mapping: Optional[str] = None) -> WalkPlan:
    """B4's launch plan. Tiled unless the 32-row tile of these rows exceeds
    100 KB: R rows a tile, the most (a power of two, 32-1024) whose tile
    holds at most 32 KB, ``_WALK_STAGES`` tile buffers; then the forest's
    nodes (12 bytes each) beside them: all T trees where they fit in a
    CTA's 227 KB, else groups of as many trees as fit, else (deeper trees)
    none, read from device memory. The kernel runs as many CTAs as an SM
    holds at the plan's shared memory. ``mapping`` forces one."""
    heap = (2 << max_depth) - 1
    row_bytes = num_features * bin_bytes
    if mapping is None:
        mapping = ("tiled" if _WALK_MIN_ROWS * row_bytes <= _WALK_TILE_MAX
                   else "gather")
    if mapping not in WALK_MAPPINGS:
        raise ValueError(f"B4: unknown mapping {mapping!r}")
    if mapping == "tiled":
        rows = _WALK_MAX_ROWS
        while rows > _WALK_MIN_ROWS and rows * row_bytes > _WALK_TILE_BYTES:
            rows //= 2
        tiles = _WALK_STAGES * _round16(rows * row_bytes)
        if tiles > WALK_SHARED_MAX:
            raise ValueError(f"B4: rows of {row_bytes} bytes do not tile")
    else:
        rows, tiles = _WALK_GATHER_ROWS, 0
    forest = _round16(_NODE_BYTES * n_trees * heap)
    if tiles + forest <= WALK_SHARED_MAX:
        return WalkPlan(mapping, rows, n_trees, 1, tiles + forest)
    per_group = (WALK_SHARED_MAX - tiles - 15) // (_NODE_BYTES * heap)
    if per_group < 1:
        return WalkPlan(mapping, rows, 0, 1, tiles)
    n_groups = -(-n_trees // per_group)
    group = -(-n_trees // n_groups)
    return WalkPlan(mapping, rows, group, n_groups,
                    tiles + _round16(_NODE_BYTES * group * heap))


@functools.lru_cache(maxsize=None)
def _walk_ctas(device_index: int, bin_bytes: int, plan: WalkPlan,
               categorical: bool = False) -> int:
    """The persistent grid's most on this device for ``plan`` (and the
    categorical instantiation where ``categorical``): the CTAs its SMs
    hold at the plan's shared memory. The C call also sets the kernel's
    attributes for every later launch, so it is made once a device, plan
    and instantiation."""
    a = _build.WalkArgs()
    a.bin_bytes = bin_bytes
    a.categorical = int(categorical)
    a.mapping = WALK_MAPPINGS.index(plan.mapping)
    a.trees_per_group = plan.trees_per_group
    a.shared_bytes = plan.shared_bytes
    ctas = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        code = _build.library("walk").xrt_walk_ctas(ctypes.byref(a),
                                                    ctypes.byref(ctas))
    _build.check(code, "B4's grid")
    if ctas.value < 1:
        raise RuntimeError(f"B4: no CTA fits {plan}")
    return ctas.value


def predict_tree_binned(tree: Tree, bins: torch.Tensor, max_depth: int,
                        missing_bin: int,
                        plan: Optional[WalkPlan] = None,
                        cat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B4 wrapper: row values [N] f32 of ``tree`` (a heap of
    ``2^(max_depth + 1) - 1`` nodes) over ``bins`` [N, F] (uint8 or int16);
    for a tree of [T, heap] fields (a round's T trees of equal depth) the
    row values [T, N] of all T in one launch. CPU tensors take
    ``predict_tree_binned_plain``; CUDA tensors launch the kernel of
    ``csrc/walk.cu`` with ``plan`` (default ``walk_plan``; bins that are not
    16-byte aligned take the gather mapping) or raise. ``cat`` [F] bool:
    the categorical features (one-vs-rest routing; None: none).
    ``predict_tree_binned.launches`` counts the launches,
    ``.launches_by_mapping`` them by mapping."""
    if not bins.is_cuda:
        return predict_tree_binned_plain(tree, bins, max_depth, missing_bin,
                                         cat)
    n, num_features = bins.shape
    dev = bins.device
    heap = (1 << (max_depth + 1)) - 1
    shape = tree.feature.shape[:-1] + (heap,)
    n_trees = shape[0] if len(shape) == 2 else 1
    if not (bins.dtype in (torch.uint8, torch.int16) and bins.is_contiguous()
            and 1 <= num_features <= WALK_MAX_FEATURES):
        raise ValueError("predict_tree_binned: bins must be contiguous uint8 "
                         "or int16 [N, F], 1 <= F <= 2^24")
    for name, dtype in _WALK_DTYPES.items():
        t = getattr(tree, name)
        if (t.device != dev or t.dtype != dtype or t.shape != shape
                or not t.is_contiguous() or n_trees < 1):
            raise ValueError(
                f"predict_tree_binned: tree.{name} must be a contiguous "
                f"{dtype} [{heap}] or [T, {heap}] on the bins' device "
                f"(max_depth {max_depth})")
    aligned = bins.data_ptr() % 16 == 0
    if plan is None:
        plan = walk_plan(num_features, bins.element_size(), n_trees,
                         max_depth, None if aligned else "gather")
    elif plan.mapping == "tiled" and not aligned:
        raise ValueError("predict_tree_binned: the tiled mapping needs "
                         "16-byte aligned bins")
    out = torch.empty(shape[:-1] + (n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    a = _build.WalkArgs()
    a.feature, a.split_bin, a.default_left, a.is_leaf, a.value = (
        getattr(tree, name).data_ptr() for name in _WALK_DTYPES)
    a.bins, a.out = bins.data_ptr(), out.data_ptr()
    a.n_rows, a.n_features, a.bin_bytes = n, num_features, bins.element_size()
    a.n_trees, a.max_depth, a.missing_bin = n_trees, max_depth, missing_bin
    a.mapping = WALK_MAPPINGS.index(plan.mapping)
    a.rows_per_tile = plan.rows_per_tile
    a.trees_per_group = plan.trees_per_group
    a.shared_bytes = plan.shared_bytes
    a.grid = _walk_ctas(dev.index or 0, a.bin_bytes, plan, cat is not None)
    if cat is not None:  # a bool's bytes are the kernel's uint8 flags
        if not (cat.dtype == torch.bool and cat.shape == (num_features,)
                and cat.device == dev and cat.is_contiguous()):
            raise ValueError("predict_tree_binned: cat must be contiguous "
                             "bool [F] on the bins' device")
        a.cat, a.categorical = cat.data_ptr(), 1
    with torch.cuda.device(dev):
        code = _build.library("walk").xrt_walk_binned(
            ctypes.byref(a), _build.stream_ptr(dev))
    _build.check(code, "B4 binned walk")
    predict_tree_binned.launches += 1
    predict_tree_binned.launches_by_mapping[plan.mapping] += 1
    if cat is not None:
        predict_tree_binned.launches_categorical += 1
    return out


predict_tree_binned.launches = 0
predict_tree_binned.launches_by_mapping = dict.fromkeys(WALK_MAPPINGS, 0)
predict_tree_binned.launches_categorical = 0


def predict_forest_weighted_plain(forest: Tree, n_trees: int,
                                  bins: torch.Tensor, base: torch.Tensor,
                                  weights: torch.Tensor, max_depth: int,
                                  missing_bin: int,
                                  cat: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Plain B4w: ``base`` [N, K] plus, for each output k, the weighted
    values of the first ``n_trees`` trees of ``forest`` ([t_cap, heap]
    fields; tree t adds to output t mod K) over ``bins`` [N, F]: summed in
    tree order from +0, each term fused into the sum (``fma(v, w_t,
    acc)``) with one output, rounded and added with more, then added to
    ``base`` (a forest of one slot and one output: ``fma(v, w_0, base)``).
    That is the JAX dart step's ``forest_margin`` (``engine.py:2880-2892``,
    an einsum over every slot) as XLA's CPU program sums it up to 48 slots
    with one output and 60 with more (beyond them XLA blocks the sum, and
    the two agree within the f32 summation bound); the empty slots beyond
    ``n_trees`` (weight 0, value 0) add nothing."""
    n, k_out = base.shape
    out = base.clone()
    if n_trees == 0:
        return out
    if k_out == 1 and forest.feature.shape[0] == 1:
        v = predict_tree_binned_plain(Tree(*[f[0] for f in forest]), bins,
                                      max_depth, missing_bin, cat)
        return _fma(v, weights[0], base[:, 0])[:, None]
    values = predict_tree_binned_plain(
        Tree(*[f[:n_trees] for f in forest]), bins, max_depth, missing_bin,
        cat)
    w = weights[:n_trees]
    for k in range(k_out):
        acc = torch.zeros(n, dtype=torch.float32, device=bins.device)
        for t in range(k, n_trees, k_out):
            acc = (_fma(values[t], w[t], acc) if k_out == 1
                   else acc + values[t] * w[t])
        out[:, k] = base[:, k] + acc
    return out


#: B4w stages the forest in shared memory up to this many bytes
_WEIGHTED_STAGE_BYTES = 48 * 1024


def predict_forest_weighted(forest: Tree, n_trees: int, bins: torch.Tensor,
                            base: torch.Tensor, weights: torch.Tensor,
                            max_depth: int, missing_bin: int,
                            cat: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """B4w wrapper, B4's weighted-forest mode: the [N, K] margins of
    ``predict_forest_weighted_plain``, without B4's [T, N] values. CPU
    tensors take the plain version; CUDA tensors launch
    ``xrt_walk_weighted`` of ``csrc/walk.cu`` once, or raise.
    ``predict_forest_weighted.launches`` counts the launches."""
    if not bins.is_cuda:
        return predict_forest_weighted_plain(forest, n_trees, bins, base,
                                             weights, max_depth, missing_bin,
                                             cat)
    n, num_features = bins.shape
    k_out = base.shape[1]
    dev = bins.device
    heap = (2 << max_depth) - 1
    if not (bins.dtype in (torch.uint8, torch.int16) and bins.is_contiguous()
            and 1 <= num_features <= WALK_MAX_FEATURES):
        raise ValueError("predict_forest_weighted: bins must be contiguous "
                         "uint8 or int16 [N, F], 1 <= F <= 2^24")
    t_cap = forest.feature.shape[0]
    for name, dtype in _WALK_DTYPES.items():
        t = getattr(forest, name)
        if (t.device != dev or t.dtype != dtype or t.shape != (t_cap, heap)
                or not t.is_contiguous()):
            raise ValueError(
                f"predict_forest_weighted: forest.{name} must be a "
                f"contiguous {dtype} [t_cap, {heap}] on the bins' device")
    if not (0 <= n_trees <= t_cap and weights.dtype == torch.float32
            and weights.device == dev and weights.is_contiguous()
            and weights.shape[0] >= n_trees
            and base.dtype == torch.float32 and base.device == dev
            and base.is_contiguous() and base.shape == (n, k_out)):
        raise ValueError("predict_forest_weighted: n_trees <= t_cap, "
                         "weights [>= n_trees] and base [N, K] contiguous "
                         "float32 on the bins' device")
    if cat is not None and not (cat.dtype == torch.bool and cat.device == dev
                                and cat.shape == (num_features,)
                                and cat.is_contiguous()):
        raise ValueError("predict_forest_weighted: cat must be contiguous "
                         "bool [F] on the bins' device")
    out = torch.empty_like(base)
    if n == 0:
        return out
    if n_trees == 0:
        return out.copy_(base)
    a = _build.WalkWeightedArgs()
    a.feature, a.split_bin, a.default_left, a.is_leaf, a.value = (
        getattr(forest, name).data_ptr() for name in _WALK_DTYPES)
    a.bins, a.weights = bins.data_ptr(), weights.data_ptr()
    a.base, a.out, a.cat = base.data_ptr(), out.data_ptr(), _build.ptr(cat)
    a.n_rows, a.n_features, a.bin_bytes = n, num_features, bins.element_size()
    a.n_trees, a.heap, a.max_depth = n_trees, heap, max_depth
    a.missing_bin, a.n_out = missing_bin, k_out
    a.fused = (0 if k_out > 1 else 2 if t_cap == 1 else 1)
    a.staged = int(_NODE_BYTES * n_trees * heap <= _WEIGHTED_STAGE_BYTES)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    a.grid = max(1, min(-(-n // 256), 8 * sms))
    with torch.cuda.device(dev):
        code = _build.library("walk").xrt_walk_weighted(
            ctypes.byref(a), _build.stream_ptr(dev))
    _build.check(code, "B4w weighted-forest walk")
    predict_forest_weighted.launches += 1
    return out


predict_forest_weighted.launches = 0
