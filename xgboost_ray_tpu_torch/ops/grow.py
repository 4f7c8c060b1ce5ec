"""Level-wise (depth-wise) tree growth over node-sorted rows.

Port of ``xgboost_ray_tpu/ops/grow.py``: ``GrowConfig`` (``:164``), the
padded-heap ``Tree`` (``:239``), ``route_right_binned`` (``:65``) and the
depthwise ``build_tree`` (``:269-785``) on its order-tracking path with
sibling subtraction (``:433-438``, ``:529-561``) — the accelerator path.

Per level d (``n_nodes = 2**d``):

1. K1 builds the histogram of every node (d = 0) or, with sibling
   subtraction, of each parent's smaller child from the compacted row list;
   the sibling is parent - child;
2. K2 reads each node's (G, H) off the histogram and finds its best split;
3. K3 routes the rows, re-partitions them by child, compacts the next
   level's smaller children and writes the leaf value of every row whose
   leaf is fixed on this level (``row_value``).

Node totals are read off the histogram (K2), as the JAX grower reads them;
below the last level K1 sums the final nodes' rows without a histogram and
one more K3 pass hands every row its final leaf value. Nothing here reads a
device value on the host: a tree is launches only.

``allreduce`` is the histogram merge across ranks: the identity at world 1
(the ``allreduce`` argument of ``ops/grow.py:269``).
"""

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from xgboost_ray_tpu_torch.ops.histogram import (
    INACTIVE,
    LEAF,
    SPLIT,
    build_histogram,
    partition_level,
    zero_phantom_missing,
)
from xgboost_ray_tpu_torch.ops.split import SplitParams, find_splits, leaf_weight


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


def _interleave(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """[n, ...] x 2 -> [2n, ...] as (left_0, right_0, left_1, ...)."""
    return torch.stack([left, right], dim=1).reshape(
        (2 * left.shape[0],) + left.shape[1:])


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
    n, num_features = bins.shape
    dev = bins.device
    nbt = cfg.max_bin + 1
    lr = cfg.split.learning_rate
    tree = empty_tree(cfg.heap_size, dev)
    row_value = torch.empty(n, dtype=torch.float32, device=dev)
    order = torch.arange(n, dtype=torch.int32, device=dev)
    seg = torch.tensor([0, n], dtype=torch.int32, device=dev)
    active = torch.ones(1, dtype=torch.bool, device=dev)
    prev_hist = part = None
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    for d in range(cfg.max_depth):
        n_nodes = 1 << d
        base = n_nodes - 1
        if d > 0 and cfg.sibling_subtract:
            # build each parent's smaller child; the sibling is parent - it
            hist_small, _ = build_histogram(
                bins, gh, part.small_rows, part.small_seg, n_nodes // 2, nbt)
            hist_small = allreduce(hist_small)
            hist_big = prev_hist - hist_small
            sir = part.small_is_right[:, None, None, None]
            hist = _interleave(torch.where(sir, hist_big, hist_small),
                               torch.where(sir, hist_small, hist_big))
        else:
            hist, _ = build_histogram(bins, gh, order, seg, n_nodes, nbt)
            hist = allreduce(hist)
        hist = zero_phantom_missing(hist, feat_has_missing)
        prev_hist = hist

        sp = find_splits(hist, cfg.split)
        node_gh = sp.node_gh
        valid_split = sp.valid & active
        node_value = lr * leaf_weight(node_gh[:, 0], node_gh[:, 1], cfg.split)
        is_new_leaf = active & ~valid_split
        fsafe = sp.feature.clamp(0, num_features - 1).long()
        thr = cuts[fsafe, sp.split_bin.clamp(0, cfg.max_bin - 2).long()]
        sl = slice(base, base + n_nodes)
        tree.feature[sl] = torch.where(valid_split, sp.feature, -1)
        tree.split_bin[sl] = torch.where(valid_split, sp.split_bin, 0)
        tree.threshold[sl] = torch.where(valid_split, thr, zero)
        tree.default_left[sl] = sp.default_left & valid_split
        tree.is_leaf[sl] = is_new_leaf
        tree.value[sl] = torch.where(is_new_leaf, node_value, zero)
        tree.gain[sl] = torch.where(valid_split, sp.gain, zero)
        tree.cover[sl] = torch.where(active, node_gh[:, 1], zero)
        tree.base_weight[sl] = torch.where(active, node_value, zero)

        state = torch.where(
            valid_split, SPLIT, torch.where(is_new_leaf, LEAF, INACTIVE)
        ).to(torch.uint8)
        part = partition_level(
            order, seg, bins, sp.feature, sp.split_bin, sp.default_left,
            state, node_value, row_value,
            write_small=cfg.sibling_subtract and d < cfg.max_depth - 1,
            missing_bin=cfg.max_bin,
        )
        order, seg = part.order, part.seg
        active = torch.repeat_interleave(valid_split, 2)

    # final level: every still-active node is a leaf, valued from its rows'
    # (g, h) totals (K1 without the histogram), and its rows take the value
    n_nodes = 1 << cfg.max_depth
    _, totals = build_histogram(bins, gh, order, seg, n_nodes, nbt,
                                with_hist=False)
    node_gh = allreduce(totals)
    node_value = torch.where(
        active, lr * leaf_weight(node_gh[:, 0], node_gh[:, 1], cfg.split), zero)
    sl = slice(n_nodes - 1, 2 * n_nodes - 1)
    tree.is_leaf[sl] = active
    tree.value[sl] = node_value
    tree.cover[sl] = torch.where(active, node_gh[:, 1], zero)
    tree.base_weight[sl] = node_value
    no_split = torch.zeros(n_nodes, dtype=torch.int32, device=dev)
    partition_level(
        order, seg, bins, no_split, no_split, active,
        torch.where(active, LEAF, INACTIVE).to(torch.uint8), node_value,
        row_value, write_small=False, missing_bin=cfg.max_bin,
    )
    return tree, row_value
