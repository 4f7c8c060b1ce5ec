"""Gradient histograms (K1) and the per-level row partition (K3).

K1, ``build_histogram``: sums (g, h) into ``[n_nodes, F, n_bins + 1, 2]``
buckets keyed by (row's node, feature, bin) over node-sorted rows, and the
per-node (g, h) totals in the same pass. It stands in for every histogram
provider of the JAX package (``xgboost_ray_tpu/ops/histogram.py:430``
``hist_scatter``, ``:452`` ``hist_onehot``, ``:696``/``:719`` presorted
blocks, ``:809`` ``node_sums``; ``ops/provider.py:95-165``): every
``hist_impl`` value resolves to it. Kernel: ``csrc/histogram.cu``.

K3, ``partition_level``: routes every row of a level by its node's split,
keeps the rows sorted by node with a stable segmented split, packs the rows
of each parent's smaller child for the next level's build, and writes the
leaf value of rows whose leaf is fixed on this level. It replaces
``route_right_binned`` and the ``pos`` update of ``ops/grow.py`` with
``update_partition_order`` (``:558``) and ``select_small_child_rows``
(``:603``). Kernel: ``csrc/partition.cu``.

Each wrapper sends CPU tensors to its plain PyTorch version and CUDA
tensors to its kernel (or raises): there is no fallback. ``launches``
counts kernel launches. The plain versions are device-agnostic, so
``chip_smoke.py`` can hold each kernel against them on the card.

Row layout: ``rows[seg[k]:seg[k + 1]]`` are node k's rows in increasing
row id; ``seg`` is int32 ``[n_nodes + 1]`` (``seg[n_nodes]`` = rows used).
"""

from typing import NamedTuple, Tuple

import torch

from xgboost_ray_tpu_torch.ops import _build

#: node states for K3 (``csrc/partition.cu``)
INACTIVE, SPLIT, LEAF = 0, 1, 2


# --------------------------------------------------------------------------
# K1: histogram build
# --------------------------------------------------------------------------


def _node_of_slot(seg: torch.Tensor, n_nodes: int) -> torch.Tensor:
    counts = (seg[1:] - seg[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(n_nodes, device=seg.device), counts,
        output_size=int(seg[-1]))


def flat_bucket_ids(bins: torch.Tensor, rows: torch.Tensor, seg: torch.Tensor,
                    n_nodes: int, n_bins_total: int) -> torch.Tensor:
    """[M * F] int64 flat bucket id (node, feature, bin) of every selected
    row and feature, in slot order: the index of one ``index_add_``."""
    num_features = bins.shape[1]
    m = int(seg[-1])
    node = _node_of_slot(seg, n_nodes)
    flat = ((node[:, None] * num_features
             + torch.arange(num_features, device=bins.device)[None, :])
            * n_bins_total + bins[rows[:m].long()].long())
    return flat.reshape(-1)


def build_histogram_plain(bins: torch.Tensor, gh: torch.Tensor,
                          rows: torch.Tensor, seg: torch.Tensor, n_nodes: int,
                          n_bins_total: int, with_hist: bool = True):
    """One flat scatter-add over the node-sorted rows (the JAX
    ``hist_scatter`` formulation; on the CPU ``index_add_`` adds in row
    order, so each bucket and each node total sums its rows in the order the
    JAX scatter does). Returns (hist [n_nodes, F, n_bins_total, 2] f32 or
    None without ``with_hist``, totals [n_nodes, 2])."""
    num_features = bins.shape[1]
    m = int(seg[-1])
    ghr = gh[rows[:m].long()]
    totals = torch.zeros((n_nodes, 2), dtype=torch.float32, device=bins.device)
    totals.index_add_(0, _node_of_slot(seg, n_nodes), ghr)
    if not with_hist:
        return None, totals
    hist = torch.zeros((n_nodes * num_features * n_bins_total, 2),
                       dtype=torch.float32, device=bins.device)
    hist.index_add_(0, flat_bucket_ids(bins, rows, seg, n_nodes, n_bins_total),
                    ghr[:, None, :].expand(m, num_features, 2).reshape(-1, 2))
    return hist.reshape(n_nodes, num_features, n_bins_total, 2), totals


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _hist_launch_shape(device, num_features: int, n_bins_total: int,
                       capacity: int) -> Tuple[int, int, int]:
    """(ftile, grid_x, min_rows) for K1: the widest feature tile whose
    shared histogram fits in 200 KB, about two CTAs per SM, and at least
    1024 rows per CTA so the flush stays small next to the accumulation."""
    ftile = max(1, min(num_features, 48, (200 * 1024) // (8 * n_bins_total)))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    min_rows = 1024
    grid_x = max(1, min(2 * sms, -(-capacity // min_rows)))
    return ftile, grid_x, min_rows


def build_histogram(bins: torch.Tensor, gh: torch.Tensor, rows: torch.Tensor,
                    seg: torch.Tensor, n_nodes: int, n_bins_total: int,
                    with_hist: bool = True):
    """K1 wrapper: (hist [n_nodes, F, n_bins_total, 2], totals [n_nodes, 2])
    over ``rows[seg[k]:seg[k+1]]`` for each node k; ``with_hist=False``
    computes the totals only (hist is None)."""
    if not bins.is_cuda:
        return build_histogram_plain(bins, gh, rows, seg, n_nodes,
                                     n_bins_total, with_hist)
    n, num_features = bins.shape
    dev = bins.device
    for t in (gh, rows, seg):
        _check(t.device == dev, "build_histogram: tensors on different devices")
    _check(bins.dtype in (torch.int16, torch.uint8) and bins.is_contiguous(),
           "build_histogram: bins must be contiguous int16 or uint8 [N, F]")
    _check(gh.dtype == torch.float32 and gh.shape == (n, 2)
           and gh.is_contiguous(), "build_histogram: gh must be f32 [N, 2]")
    _check(rows.dtype == torch.int32 and rows.dim() == 1
           and rows.is_contiguous(), "build_histogram: rows must be int32 [M]")
    _check(seg.dtype == torch.int32 and seg.shape == (n_nodes + 1,)
           and seg.is_contiguous(),
           "build_histogram: seg must be int32 [n_nodes + 1]")
    _check(n_bins_total <= 1025, "build_histogram: max_bin <= 1024")
    hist = (torch.zeros((n_nodes, num_features, n_bins_total, 2),
                        dtype=torch.float32, device=dev) if with_hist else None)
    totals = torch.zeros((n_nodes, 2), dtype=torch.float32, device=dev)
    ftile, grid_x, min_rows = _hist_launch_shape(
        dev, num_features, n_bins_total, rows.shape[0])
    with torch.cuda.device(dev):
        code = _build.library("histogram").xrt_hist_build(
            bins.data_ptr(), bins.element_size(), gh.data_ptr(),
            rows.data_ptr(), seg.data_ptr(), n_nodes, num_features,
            n_bins_total, ftile, grid_x, min_rows, int(with_hist),
            _build.ptr(hist), totals.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "K1 histogram")
    build_histogram.launches += 1
    return hist, totals


build_histogram.launches = 0


def node_sums(gh: torch.Tensor, pos: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Per-node (g, h) totals by node index [N] (the JAX ``node_sums``)."""
    out = torch.zeros((n_nodes, 2), dtype=gh.dtype, device=gh.device)
    return out.index_add_(0, pos.long(), gh)


def zero_phantom_missing(h: torch.Tensor, feat_has_missing) -> torch.Tensor:
    """Zero the missing bucket of features that have no missing value."""
    if feat_has_missing is None:
        return h
    keep = feat_has_missing[None, :, None].to(h.dtype)
    h[:, :, -1, :] *= keep
    return h


# --------------------------------------------------------------------------
# K3: routing + stable partition + smaller-child compaction
# --------------------------------------------------------------------------


class LevelPartition(NamedTuple):
    order: torch.Tensor  # [N] int32, node-sorted for the 2 n_nodes children
    seg: torch.Tensor  # [2 n_nodes + 1] int32
    small_rows: torch.Tensor  # [>= N // 2] int32, first small_seg[-1] valid
    small_seg: torch.Tensor  # [n_nodes + 1] int32 (by parent)
    small_is_right: torch.Tensor  # [n_nodes] bool


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                      torch.cumsum(x, 0)[:-1]])


def update_partition_order(order: torch.Tensor, counts: torch.Tensor,
                           go_right: torch.Tensor):
    """Stable segment split of the node-sorted order (the JAX
    ``update_partition_order``); ``go_right`` is indexed by row id. Returns
    (new_order, new_counts [2 n_nodes])."""
    n = order.shape[0]
    dev = order.device
    counts = counts.long()
    csum = torch.cumsum(counts, 0)
    seg_start = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                           csum[:-1]])
    seg_of_slot = torch.searchsorted(csum, torch.arange(n, device=dev),
                                     right=True)
    gr_s = go_right[order.long()].long()
    left_s = 1 - gr_s
    cum_left = torch.cumsum(left_s, 0) - left_s
    cum_right = torch.cumsum(gr_s, 0) - gr_s
    # out-of-range gathers clamp, as XLA's do (they only feed empty nodes)
    left_before = cum_left[seg_start.clamp(max=n - 1)]
    right_before = cum_right[seg_start.clamp(max=n - 1)]
    rank_left = cum_left - left_before[seg_of_slot]
    rank_right = cum_right - right_before[seg_of_slot]
    seg_end = (csum - 1).clamp(min=0, max=n - 1)
    left_count = torch.where(
        counts > 0, cum_left[seg_end] + left_s[seg_end] - left_before,
        torch.zeros_like(counts))
    right_count = counts - left_count
    new_counts = torch.stack([left_count, right_count], dim=1).reshape(-1)
    new_start = _excl_cumsum(new_counts)
    child = 2 * seg_of_slot + gr_s
    rank = torch.where(gr_s.bool(), rank_right, rank_left)
    dest = new_start[child] + rank
    new_order = torch.zeros_like(order)
    new_order[dest] = order
    return new_order, new_counts.to(torch.int32)


def select_small_child_rows(order: torch.Tensor, counts: torch.Tensor,
                            small_is_right: torch.Tensor):
    """Pack every parent's smaller child into [N // 2] slots (the JAX
    ``select_small_child_rows``). Returns (rows with sentinel N, parent of
    slot, valid mask, counts_sel [n_par])."""
    n = order.shape[0]
    dev = order.device
    n_par = small_is_right.shape[0]
    n_half = max(n // 2, 1)
    counts = counts.long()
    c_small = (2 * torch.arange(n_par, device=dev)
               + small_is_right.long())
    counts_sel = counts[c_small]
    seg_start = _excl_cumsum(counts)
    cum_sel = torch.cumsum(counts_sel, 0)
    start_sel = _excl_cumsum(counts_sel)
    i = torch.arange(n_half, device=dev)
    p = torch.searchsorted(cum_sel, i, right=True)
    pc = p.clamp(0, n_par - 1)
    src = seg_start[c_small[pc]] + (i - start_sel[pc])
    valid = i < cum_sel[-1]
    rows = torch.where(valid, order[src.clamp(0, n - 1)].long(),
                       torch.full_like(src, n)).to(torch.int32)
    return rows, pc.to(torch.int32), valid, counts_sel.to(torch.int32)


def partition_level_plain(order, seg, bins, feature, split_bin, default_left,
                          state, node_value, row_value, write_small: bool,
                          missing_bin: int) -> LevelPartition:
    """Plain PyTorch K3, composed from the JAX package's functions."""
    from xgboost_ray_tpu_torch.ops.grow import route_right_binned

    n = order.shape[0]
    n_nodes = feature.shape[0]
    dev = order.device
    counts = (seg[1:] - seg[:-1]).long()
    node = _node_of_slot(seg, n_nodes)
    rows = order.long()
    st = state[node].long()
    b = bins[rows, feature.long()[node]].long()
    right = route_right_binned(b, split_bin[node], default_left[node],
                               missing_bin) & (st == SPLIT)
    go_right = torch.zeros(n, dtype=torch.bool, device=dev)
    go_right[rows] = right
    new_order, new_counts = update_partition_order(order, counts, go_right)
    lc, rc = new_counts[0::2], new_counts[1::2]
    split = state == SPLIT
    small_is_right = torch.where(split, rc <= lc,
                                 torch.ones_like(split))
    if write_small:
        small_rows, _, _, counts_sel = select_small_child_rows(
            new_order, new_counts, small_is_right)
    else:
        small_rows = torch.empty(1, dtype=torch.int32, device=dev)
        counts_sel = torch.where(small_is_right, rc, lc)
    leaf = st == LEAF
    row_value[rows[leaf]] = node_value[node[leaf]]
    new_seg = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         torch.cumsum(new_counts, 0).to(torch.int32)])
    small_seg = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                           torch.cumsum(counts_sel, 0).to(torch.int32)])
    return LevelPartition(new_order, new_seg, small_rows, small_seg,
                          small_is_right)


def partition_level(order: torch.Tensor, seg: torch.Tensor, bins: torch.Tensor,
                    feature: torch.Tensor, split_bin: torch.Tensor,
                    default_left: torch.Tensor, state: torch.Tensor,
                    node_value: torch.Tensor, row_value: torch.Tensor,
                    write_small: bool, missing_bin: int) -> LevelPartition:
    """K3 wrapper. ``state`` [n_nodes] uint8 (INACTIVE / SPLIT / LEAF);
    ``row_value`` [N] f32 is written in place for the rows of LEAF nodes
    (``node_value``)."""
    if not order.is_cuda:
        return partition_level_plain(order, seg, bins, feature, split_bin,
                                     default_left, state, node_value,
                                     row_value, write_small, missing_bin)
    n, num_features = bins.shape
    n_nodes = feature.shape[0]
    dev = order.device
    lib = _build.library("partition")
    node_tensors = [(feature, torch.int32), (split_bin, torch.int32),
                    (default_left, torch.bool), (state, torch.uint8),
                    (node_value, torch.float32)]
    for t, dt in node_tensors:
        _check(t.device == dev and t.dtype == dt and t.shape == (n_nodes,)
               and t.is_contiguous(), f"partition_level: node array must be "
               f"contiguous {dt} [n_nodes] on {dev}")
    _check(order.dtype == torch.int32 and order.shape == (n,)
           and order.is_contiguous(), "partition_level: order int32 [N]")
    _check(seg.dtype == torch.int32 and seg.shape == (n_nodes + 1,)
           and seg.device == dev, "partition_level: seg int32 [n_nodes + 1]")
    _check(bins.device == dev and bins.is_contiguous()
           and bins.dtype in (torch.int16, torch.uint8),
           "partition_level: bins contiguous int16/uint8 [N, F]")
    _check(row_value.device == dev and row_value.dtype == torch.float32
           and row_value.shape == (n,) and row_value.is_contiguous(),
           "partition_level: row_value f32 [N]")
    n_tiles = max(1, -(-n // lib.xrt_partition_tile()))
    i32 = dict(dtype=torch.int32, device=dev)
    tile_left = torch.empty(n_tiles, **i32)
    bnd_left = torch.empty(n_nodes + 1, **i32)
    node_left0 = torch.empty(n_nodes + 1, **i32)
    new_order = torch.empty(n, **i32)
    new_seg = torch.empty(2 * n_nodes + 1, **i32)
    small_rows = torch.empty(max(n // 2, 1) if write_small else 1, **i32)
    small_seg = torch.empty(n_nodes + 1, **i32)
    small_is_right = torch.empty(n_nodes, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        code = lib.xrt_partition(
            order.data_ptr(), seg.data_ptr(), n_nodes, n, bins.data_ptr(),
            bins.element_size(), num_features, feature.data_ptr(),
            split_bin.data_ptr(), default_left.data_ptr(), state.data_ptr(),
            missing_bin, node_value.data_ptr(), int(write_small),
            tile_left.data_ptr(), bnd_left.data_ptr(), node_left0.data_ptr(),
            new_order.data_ptr(), new_seg.data_ptr(), small_rows.data_ptr(),
            small_seg.data_ptr(), small_is_right.data_ptr(),
            row_value.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "K3 partition")
    partition_level.launches += 1
    return LevelPartition(new_order, new_seg, small_rows, small_seg,
                          small_is_right)


partition_level.launches = 0
