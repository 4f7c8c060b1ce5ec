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
from xgboost_ray_tpu_torch.ops.histogram import (
    build_histogram,
    dequantize,
    partition_leaf_values,
    partition_level,
    quant_scales,
)
from xgboost_ray_tpu_torch.ops.split import (
    SplitParams,
    TreeRecords,
    leaf_records,
    split_level,
)


def route_right_binned(bin_vals, split_bin, default_left, missing_bin: int):
    """The binned routing rule: numeric bin > split_bin goes right, the
    missing bucket follows the learned default."""
    present_right = bin_vals > split_bin
    return torch.where(bin_vals == missing_bin, ~default_left, present_right)


@dataclasses.dataclass(frozen=True)
class GrowConfig:
    max_depth: int = 6
    max_bin: int = 256
    split: SplitParams = dataclasses.field(default_factory=SplitParams)
    sibling_subtract: bool = True

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
):
    """Grow one tree. Returns (Tree, row_value [N]): the learning-rate
    scaled leaf value each row lands in. ``tree`` and ``row_value``, where
    given, are written in place and returned (a round of K trees writes
    class k's into row k of its [K, heap] and [K, N] tensors).

    With ``qscale`` (always on the card; there this rank's own scales when
    the caller passes none) the histograms are summed in fixed point and
    dequantised after ``allreduce``; without it, on the CPU, they are f32."""
    n = bins.shape[0]
    dev = bins.device
    if qscale is None and bins.is_cuda:
        qscale = quant_scales(gh, n)

    def merged(h):
        if allreduce is not None:
            h = allreduce(h)
        return h if qscale is None else dequantize(h, qscale)

    nbt = cfg.max_bin + 1
    if tree is None:
        tree = empty_tree(cfg.heap_size, dev)
    rec = TreeRecords(tree, cuts, feat_has_missing, cfg.split)
    if row_value is None:
        row_value = torch.empty(n, dtype=torch.float32, device=dev)
    order = torch.arange(n, dtype=torch.int32, device=dev)
    seg = torch.tensor([0, n], dtype=torch.int32, device=dev)
    active = torch.ones(1, dtype=torch.bool, device=dev)
    prev_hist = part = None

    for d in range(cfg.max_depth):
        n_nodes = 1 << d
        # the formed histogram is the next level's parent, unless none comes
        keep = cfg.sibling_subtract and d < cfg.max_depth - 1
        if d > 0 and cfg.sibling_subtract:
            # build each parent's smaller child; K2 forms the sibling as
            # parent - it
            hist_small, _ = build_histogram(
                bins, gh, part.small_rows, part.small_seg, n_nodes // 2, nbt,
                qscale=qscale)
            step = split_level(merged(hist_small), prev_hist,
                               part.small_is_right, active, rec, keep)
        else:
            hist, _ = build_histogram(bins, gh, order, seg, n_nodes, nbt,
                                      qscale=qscale)
            step = split_level(merged(hist), None, None, active, rec, keep)
        sp = step.splits
        part = partition_level(
            order, seg, bins, sp.feature, sp.split_bin, sp.default_left,
            step.state, step.node_value, row_value,
            write_small=keep, missing_bin=cfg.max_bin,
            merge_counts=allreduce if keep else None,
        )
        order, seg = part.order, part.seg
        prev_hist, active = step.hist, step.active

    # final level: every still-active node is a leaf, valued from its rows'
    # (g, h) totals (K1 without the histogram), and its rows take the value
    n_nodes = 1 << cfg.max_depth
    _, totals = build_histogram(bins, gh, order, seg, n_nodes, nbt,
                                with_hist=False, qscale=qscale)
    node_value, state = leaf_records(merged(totals), active, rec)
    partition_leaf_values(order, seg, state, node_value, row_value)
    return tree, row_value


# --------------------------------------------------------------------------
# B4: the binned tree walk
# --------------------------------------------------------------------------


def predict_tree_binned_plain(tree: Tree, bins: torch.Tensor, max_depth: int,
                              missing_bin: int) -> torch.Tensor:
    """Walk one tree over binned rows ``bins`` [N, F]; the leaf value of
    every row [N] f32 (the JAX ``predict_tree_binned``, numeric features):
    ``max_depth`` steps, a leaf keeping its index. A tree of [T, heap]
    fields is T trees, walked one after the other: [T, N]."""
    if tree.feature.dim() == 2:
        return torch.stack([
            predict_tree_binned_plain(Tree(*[f[t] for f in tree]), bins,
                                      max_depth, missing_bin)
            for t in range(tree.feature.shape[0])])
    n, num_features = bins.shape
    idx = torch.zeros(n, dtype=torch.int64, device=bins.device)
    for _ in range(max_depth):
        f = tree.feature[idx].clamp(0, num_features - 1).long()
        bv = bins.gather(1, f[:, None])[:, 0].to(torch.int32)
        go_right = route_right_binned(bv, tree.split_bin[idx],
                                      tree.default_left[idx], missing_bin)
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
def _walk_ctas(device_index: int, bin_bytes: int, plan: WalkPlan) -> int:
    """The persistent grid's most on this device for ``plan``: the CTAs
    its SMs hold at the plan's shared memory. The C call also sets the
    kernel's attributes for every later launch, so it is made once a
    device and plan."""
    a = _build.WalkArgs()
    a.bin_bytes = bin_bytes
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
                        plan: Optional[WalkPlan] = None) -> torch.Tensor:
    """B4 wrapper: row values [N] f32 of ``tree`` (a heap of
    ``2^(max_depth + 1) - 1`` nodes) over ``bins`` [N, F] (uint8 or int16);
    for a tree of [T, heap] fields (a round's T trees of equal depth) the
    row values [T, N] of all T in one launch. CPU tensors take
    ``predict_tree_binned_plain``; CUDA tensors launch the kernel of
    ``csrc/walk.cu`` with ``plan`` (default ``walk_plan``; bins that are not
    16-byte aligned take the gather mapping) or raise.
    ``predict_tree_binned.launches`` counts the launches,
    ``.launches_by_mapping`` them by mapping."""
    if not bins.is_cuda:
        return predict_tree_binned_plain(tree, bins, max_depth, missing_bin)
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
    a.grid = _walk_ctas(dev.index or 0, a.bin_bytes, plan)
    with torch.cuda.device(dev):
        code = _build.library("walk").xrt_walk_binned(
            ctypes.byref(a), _build.stream_ptr(dev))
    _build.check(code, "B4 binned walk")
    predict_tree_binned.launches += 1
    predict_tree_binned.launches_by_mapping[plan.mapping] += 1
    return out


predict_tree_binned.launches = 0
predict_tree_binned.launches_by_mapping = dict.fromkeys(WALK_MAPPINGS, 0)
