"""Level-wise (depth-wise) tree growth over node-sorted rows.

Port of ``xgboost_ray_tpu/ops/grow.py``: ``GrowConfig`` (``:164``), the
padded-heap ``Tree`` (``:239``), ``route_right_binned`` (``:65``) and the
depthwise ``build_tree`` (``:269-785``) on its order-tracking path with
sibling subtraction (``:433-438``, ``:529-561``) — the accelerator path.

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

``allreduce`` is the histogram merge across ranks: the identity at world 1
(the ``allreduce`` argument of ``ops/grow.py:269``).
"""

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from xgboost_ray_tpu_torch.ops.histogram import (
    build_histogram,
    partition_leaf_values,
    partition_level,
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


def empty_tree(heap_size: int, device) -> Tree:
    def z(dtype):
        return torch.zeros(heap_size, dtype=dtype, device=device)

    return Tree(
        feature=torch.full((heap_size,), -1, dtype=torch.int32, device=device),
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
    allreduce: Callable[[torch.Tensor], torch.Tensor] = lambda x: x,
):
    """Grow one tree. Returns (Tree, row_value [N]): the learning-rate
    scaled leaf value each row lands in."""
    n = bins.shape[0]
    dev = bins.device
    nbt = cfg.max_bin + 1
    tree = empty_tree(cfg.heap_size, dev)
    rec = TreeRecords(tree, cuts, feat_has_missing, cfg.split)
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
                bins, gh, part.small_rows, part.small_seg, n_nodes // 2, nbt)
            step = split_level(allreduce(hist_small), prev_hist,
                               part.small_is_right, active, rec, keep)
        else:
            hist, _ = build_histogram(bins, gh, order, seg, n_nodes, nbt)
            step = split_level(allreduce(hist), None, None, active, rec, keep)
        sp = step.splits
        part = partition_level(
            order, seg, bins, sp.feature, sp.split_bin, sp.default_left,
            step.state, step.node_value, row_value,
            write_small=keep,
            missing_bin=cfg.max_bin,
        )
        order, seg = part.order, part.seg
        prev_hist, active = step.hist, step.active

    # final level: every still-active node is a leaf, valued from its rows'
    # (g, h) totals (K1 without the histogram), and its rows take the value
    n_nodes = 1 << cfg.max_depth
    _, totals = build_histogram(bins, gh, order, seg, n_nodes, nbt,
                                with_hist=False)
    node_value, state = leaf_records(allreduce(totals), active, rec)
    partition_leaf_values(order, seg, state, node_value, row_value)
    return tree, row_value
