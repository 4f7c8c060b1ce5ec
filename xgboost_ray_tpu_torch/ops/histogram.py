"""Gradient histograms (K1) and the per-level row partition (K3).

K1, ``build_histogram``: sums (g, h) into ``[n_nodes, F, n_bins + 1, 2]``
buckets keyed by (row's node, feature, bin) over node-sorted rows, and the
per-node (g, h) totals in the same pass. It stands in for every histogram
provider of the JAX package (``xgboost_ray_tpu/ops/histogram.py:430``
``hist_scatter``, ``:452`` ``hist_onehot``, ``:696``/``:719`` presorted
blocks, ``:809`` ``node_sums``; ``ops/provider.py:95-165``): every
``hist_impl`` value resolves to it. Kernel: ``csrc/histogram.cu``.

The kernel sums in fixed point: each row's (g, h) is quantised to int64 with
the round's power-of-two scales (``quant_scales``) and the sums are int64,
so they are the same bits in any order of the atomics, over any shard
layout and after an integer all-reduce; ``dequantize`` turns the merged sums
into the f32 histogram K2 reads. Its plain version is
``build_histogram_fixed_plain`` (the card's checks). On the CPU the grower
keeps the f32 ``build_histogram_plain``, which sums in the JAX package's
order and is bitwise equal to it.

K3, ``partition_level``: routes every row of a level by its node's split,
keeps the rows sorted by node with a stable segmented split, packs the rows
of each parent's smaller child for the next level's build, and writes the
leaf value of rows whose leaf is fixed on this level. It replaces
``route_right_binned`` and the ``pos`` update of ``ops/grow.py`` with
``update_partition_order`` (``:558``) and ``select_small_child_rows``
(``:603``). Above one rank the smaller child is chosen from the children's
counts summed over the ranks (``merge_counts``), as the JAX grower's
``psum`` of them (``ops/grow.py:509-526``), so every rank builds the same
children. Kernel: ``csrc/partition.cu``. Its leaf-value mode,
``partition_leaf_values``, serves the grower's last call, where no row
moves: it only writes each leaf row's value (the JAX grower's final
``row_value``, ``ops/grow.py:782``).

Each wrapper sends CPU tensors to its plain PyTorch version and CUDA
tensors to its kernel (or raises): there is no fallback. ``launches``
counts kernel launches. The plain versions are device-agnostic, so
``chip_smoke.py`` can hold each kernel against them on the card.

Row layout: ``rows[seg[k]:seg[k + 1]]`` are node k's rows in increasing
row id; ``seg`` is int32 ``[n_nodes + 1]`` (``seg[n_nodes]`` = rows used).
"""

from typing import Callable, NamedTuple, Optional, Tuple

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


#: exponent range of the fixed-point scales: 2^e and 2^-e stay normal f32
_E_MIN, _E_MAX = -126, 126
#: the bound every sum stays under: n_global * (max|v| * 2^e + 1) < 2^62
_Q_LIMIT = 2.0 ** 62


def _pow2(e: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """2^e, exactly, from integer-valued ``e`` (built from the exponent
    bits: no rounding of exp2/pow)."""
    if dtype == torch.float64:
        return ((e.long() + 1023) << 52).view(torch.float64)
    return ((e.int() + 127) << 23).view(torch.float32)


def scales_for(absmax: torch.Tensor, n_global: int) -> torch.Tensor:
    """The fixed-point scales for (max|g|, max|h|) ``absmax`` (f32 [2]) over
    ``n_global`` rows: f32 [4] = (2^eg, 2^eh, 2^-eg, 2^-eh) on ``absmax``'s
    device, each e the largest with n_global * (max|v| * 2^e + 1) < 2^62
    (clamped to [-126, 126]; 126 where the max is 0). A few launches and
    no host read: ``floor(log2(...))`` may be one off, so the first of
    e0 + 1, e0, e0 - 1 that fits is taken."""
    n = max(1, int(n_global))
    md = absmax.double()
    e0 = torch.floor(torch.log2((_Q_LIMIT / n - 1.0) / md))  # inf at max 0
    cand = (e0 + torch.arange(1, -2, -1, dtype=torch.float64,
                              device=md.device)[:, None]).clamp(_E_MIN, _E_MAX)
    fits = n * (md * _pow2(cand, torch.float64) + 1.0) < _Q_LIMIT
    e = torch.where(fits[0], cand[0], torch.where(fits[1], cand[1], cand[2]))
    return _pow2(torch.cat([e, -e]), torch.float32)


def quant_scales(gh: torch.Tensor, n_global: int,
                 reduce_max: Optional[
                     Callable[[torch.Tensor], torch.Tensor]] = None
                 ) -> torch.Tensor:
    """A round's fixed-point scales (``scales_for``) from its gradients
    ``gh`` [N, 2]: the per-column max of |gh|, merged across ranks by
    ``reduce_max`` (an all-reduce MAX), stays on ``gh``'s device."""
    absmax = (torch.linalg.vector_norm(gh, float("inf"), dim=0)
              if gh.shape[0]
              else torch.zeros(2, dtype=torch.float32, device=gh.device))
    if reduce_max is not None:
        absmax = reduce_max(absmax)
    return scales_for(absmax, n_global)


def quantize_gh(gh: torch.Tensor, qscale: torch.Tensor) -> torch.Tensor:
    """[N, 2] int64 ``llrint(v * 2^e)`` per column (an exact product, round
    half to even): what K1 adds for each row."""
    return torch.round(gh * qscale[:2]).to(torch.int64)


def build_histogram_fixed_plain(bins: torch.Tensor, gh: torch.Tensor,
                                rows: torch.Tensor, seg: torch.Tensor,
                                n_nodes: int, n_bins_total: int,
                                qscale: torch.Tensor, with_hist: bool = True):
    """What K1 computes: int64 ``index_add_`` of the quantised (g, h) over
    the node-sorted rows. Returns (hist [n_nodes, F, n_bins_total, 2] int64
    or None without ``with_hist``, totals [n_nodes, 2] int64); integer sums,
    so any order gives the same bits."""
    num_features = bins.shape[1]
    m = int(seg[-1])
    qr = quantize_gh(gh[rows[:m].long()], qscale)
    totals = torch.zeros((n_nodes, 2), dtype=torch.int64, device=bins.device)
    totals.index_add_(0, _node_of_slot(seg, n_nodes), qr)
    if not with_hist:
        return None, totals
    hist = torch.zeros((n_nodes * num_features * n_bins_total, 2),
                       dtype=torch.int64, device=bins.device)
    hist.index_add_(0, flat_bucket_ids(bins, rows, seg, n_nodes, n_bins_total),
                    qr[:, None, :].expand(m, num_features, 2).reshape(-1, 2))
    return hist.reshape(n_nodes, num_features, n_bins_total, 2), totals


def dequantize_plain(h: torch.Tensor, qscale: torch.Tensor) -> torch.Tensor:
    """int64 sums [..., 2] -> f32: float(sum) rounded to nearest, times
    2^-e (exact)."""
    return h.to(torch.float32) * qscale[2:]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def dequantize(h: torch.Tensor, qscale: torch.Tensor) -> torch.Tensor:
    """The f32 histogram or totals K2 reads from merged int64 sums [..., 2]
    (``dequantize_plain``'s function; a small kernel in
    ``csrc/histogram.cu`` on the card, ``launches`` counts it)."""
    if not h.is_cuda:
        return dequantize_plain(h, qscale)
    dev = h.device
    _check(h.dtype == torch.int64 and h.shape[-1] == 2 and h.is_contiguous()
           and h.data_ptr() % 16 == 0,
           "dequantize: sums must be 16-byte aligned contiguous int64 [..., 2]")
    _check(qscale.device == dev and qscale.dtype == torch.float32
           and qscale.shape == (4,) and qscale.is_contiguous(),
           "dequantize: qscale must be f32 [4] on the sums' device")
    out = torch.empty(h.shape, dtype=torch.float32, device=dev)
    n_pairs = h.numel() // 2
    grid = max(1, min(-(-n_pairs // 256), 4096))  # grid-stride above
    with torch.cuda.device(dev):
        code = _build.library("histogram").xrt_hist_dequant(
            h.data_ptr(), out.data_ptr(), n_pairs, qscale.data_ptr(), grid,
            _build.stream_ptr(dev))
    _build.check(code, "K1 dequantise")
    dequantize.launches += 1
    return out


dequantize.launches = 0


#: shared memory one K1 CTA may use: two CTAs share an SM's 228 KB
_K1_SMEM_BUDGET = 113 * 1024
#: fewest node-sorted rows a K1 CTA takes, so the flush stays small next to
#: the accumulation
_K1_MIN_ROWS = 2048


def _hist_launch_shape(device, num_features: int, n_bins_total: int,
                       capacity: int) -> Tuple[int, int, int]:
    """(ftile, grid_x, min_rows) for K1: features split into the fewest
    even tiles whose four 32-bit word planes (16 x nbt bytes a feature, at
    most 32 features) fit ``_K1_SMEM_BUDGET``; a persistent grid of two
    CTAs per SM (fewer when ``capacity`` rows give each CTA less than
    ``_K1_MIN_ROWS``)."""
    lib = _build.library("histogram")
    fmax = max(1, min(32, _K1_SMEM_BUDGET // (16 * n_bins_total)))
    n_tiles = -(-num_features // fmax)
    ftile = -(-num_features // n_tiles)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid_x = max(1, min(lib.xrt_hist_ctas_per_sm() * sms,
                        -(-capacity // _K1_MIN_ROWS)))
    return ftile, grid_x, _K1_MIN_ROWS


def build_histogram(bins: torch.Tensor, gh: torch.Tensor, rows: torch.Tensor,
                    seg: torch.Tensor, n_nodes: int, n_bins_total: int,
                    with_hist: bool = True,
                    qscale: Optional[torch.Tensor] = None):
    """K1 wrapper: (hist [n_nodes, F, n_bins_total, 2], totals [n_nodes, 2])
    over ``rows[seg[k]:seg[k+1]]`` for each node k; ``with_hist=False``
    computes the totals only (hist is None).

    CUDA tensors need the round's ``qscale`` (``quant_scales``): K1 sums
    int64 fixed point (``dequantize`` makes them f32). CPU tensors take the
    f32 ``build_histogram_plain``, the JAX package's sums, and no
    ``qscale``."""
    if not bins.is_cuda:
        _check(qscale is None, "build_histogram: the CPU sums f32 and takes "
               "no qscale (K1's fixed point is the card's)")
        return build_histogram_plain(bins, gh, rows, seg, n_nodes,
                                     n_bins_total, with_hist)
    n, num_features = bins.shape
    dev = bins.device
    for t in (gh, rows, seg):
        _check(t.device == dev, "build_histogram: tensors on different devices")
    _check(qscale is not None and qscale.device == dev
           and qscale.dtype == torch.float32 and qscale.shape == (4,)
           and qscale.is_contiguous(),
           "build_histogram: K1 sums in fixed point and needs the round's "
           "qscale (f32 [4] on the device, ops/histogram.quant_scales)")
    _check(bins.dtype in (torch.int16, torch.uint8) and bins.is_contiguous(),
           "build_histogram: bins must be contiguous int16 or uint8 [N, F]")
    _check(gh.dtype == torch.float32 and gh.shape == (n, 2)
           and gh.is_contiguous() and gh.data_ptr() % 8 == 0,
           "build_histogram: gh must be 8-byte aligned contiguous f32 [N, 2]")
    _check(rows.dtype == torch.int32 and rows.dim() == 1
           and rows.is_contiguous(), "build_histogram: rows must be int32 [M]")
    _check(seg.dtype == torch.int32 and seg.shape == (n_nodes + 1,)
           and seg.is_contiguous(),
           "build_histogram: seg must be int32 [n_nodes + 1]")
    _check(n_bins_total <= 1025, "build_histogram: max_bin <= 1024")
    hist = (torch.zeros((n_nodes, num_features, n_bins_total, 2),
                        dtype=torch.int64, device=dev) if with_hist else None)
    totals = torch.zeros((n_nodes, 2), dtype=torch.int64, device=dev)
    ftile, grid_x, min_rows = _hist_launch_shape(
        dev, num_features, n_bins_total, rows.shape[0])
    with torch.cuda.device(dev):
        code = _build.library("histogram").xrt_hist_build(
            bins.data_ptr(), bins.element_size(), gh.data_ptr(),
            rows.data_ptr(), seg.data_ptr(), n_nodes, num_features,
            n_bins_total, ftile, grid_x, min_rows,
            int(with_hist), qscale.data_ptr(),
            _build.ptr(hist), totals.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "K1 histogram")
    build_histogram.launches += 1
    return hist, totals


build_histogram.launches = 0


class AllreduceBytes:
    """Per-rank wire bytes of the collectives, under the ring model of the
    reference's ``AllreduceBytes`` (``xgboost_ray_tpu/ops/histogram.py:96``):
    an all-reduce moves ``2 (n - 1) / n x bytes(operand)``; 0 at world 1."""

    def __init__(self, n_actors: int):
        self.n = max(1, int(n_actors))
        self.total = 0

    def add_allreduce(self, t: torch.Tensor) -> None:
        self.total += int(2 * (self.n - 1) * t.numel() * t.element_size()
                          / self.n)


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
    small_rows: torch.Tensor  # [N // 2 or N] int32, first small_seg[-1] valid
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
                            small_is_right: torch.Tensor,
                            n_slots: Optional[int] = None):
    """Pack every parent's chosen child into ``n_slots`` slots (default
    N // 2, the JAX ``select_small_child_rows``; N when the choice was made
    from all ranks' counts, so a child smaller over the world may be the
    larger one here). Returns (rows with sentinel N, parent of slot, valid
    mask, counts_sel [n_par])."""
    n = order.shape[0]
    dev = order.device
    n_par = small_is_right.shape[0]
    n_half = max(n // 2, 1) if n_slots is None else n_slots
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
                          missing_bin: int,
                          merge_counts=None) -> LevelPartition:
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
    world = (new_counts.long() if merge_counts is None
             else merge_counts(new_counts.long()))
    small_is_right = torch.where(split, world[1::2] <= world[0::2],
                                 torch.ones_like(split))
    if write_small:
        small_rows, _, _, counts_sel = select_small_child_rows(
            new_order, new_counts, small_is_right,
            None if merge_counts is None else n)
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
                    write_small: bool, missing_bin: int,
                    merge_counts: Optional[
                        Callable[[torch.Tensor], torch.Tensor]] = None
                    ) -> LevelPartition:
    """K3 wrapper. ``state`` [n_nodes] uint8 (INACTIVE / SPLIT / LEAF);
    ``row_value`` [N] f32 is written in place for the rows of LEAF nodes
    (``node_value``). ``merge_counts`` (above one rank: the all-reduce SUM)
    takes the children's row counts, int64 [2 n_nodes], and returns them
    summed over the ranks; the smaller child of each parent is then chosen
    from those, the same on every rank, and ``small_rows`` has N slots."""
    if not order.is_cuda:
        return partition_level_plain(order, seg, bins, feature, split_bin,
                                     default_left, state, node_value,
                                     row_value, write_small, missing_bin,
                                     merge_counts)
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
           and order.is_contiguous() and order.data_ptr() % 16 == 0,
           "partition_level: order 16-byte aligned int32 [N]")
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
    mask = torch.empty(-(-n // 8), dtype=torch.uint8, device=dev)  # go-right bits
    tile_left = torch.empty(n_tiles, **i32)
    bnd_left = torch.empty(n_nodes + 1, **i32)
    node_left0 = torch.empty(n_nodes + 1, **i32)
    new_order = torch.empty(n, **i32)
    new_seg = torch.empty(2 * n_nodes + 1, **i32)
    slots = max(n // 2, 1) if merge_counts is None else max(n, 1)
    small_rows = torch.empty(slots if write_small else 1, **i32)
    small_seg = torch.empty(n_nodes + 1, **i32)
    small_is_right = torch.empty(n_nodes, dtype=torch.bool, device=dev)
    stream = _build.stream_ptr(dev)
    with torch.cuda.device(dev):
        code = lib.xrt_partition_route(
            order.data_ptr(), seg.data_ptr(), n_nodes, n, bins.data_ptr(),
            bins.element_size(), num_features, feature.data_ptr(),
            split_bin.data_ptr(), default_left.data_ptr(), state.data_ptr(),
            missing_bin, mask.data_ptr(), tile_left.data_ptr(),
            bnd_left.data_ptr(), node_left0.data_ptr(), new_seg.data_ptr(),
            int(merge_counts is None), small_seg.data_ptr(),
            small_is_right.data_ptr(), stream)
    _build.check(code, "K3 partition (route)")
    world = None
    if merge_counts is not None:
        world = merge_counts((new_seg[1:] - new_seg[:-1]).long())
        _check(world.device == dev and world.dtype == torch.int64
               and world.shape == (2 * n_nodes,) and world.is_contiguous(),
               "partition_level: merge_counts must give int64 [2 n_nodes] "
               "on the device")
    with torch.cuda.device(dev):
        code = lib.xrt_partition_scatter(
            order.data_ptr(), seg.data_ptr(), n_nodes, n, state.data_ptr(),
            node_value.data_ptr(), int(write_small), mask.data_ptr(),
            tile_left.data_ptr(), node_left0.data_ptr(), new_seg.data_ptr(),
            _build.ptr(world), small_seg.data_ptr(),
            small_is_right.data_ptr(), new_order.data_ptr(),
            small_rows.data_ptr(), row_value.data_ptr(), stream)
    _build.check(code, "K3 partition (scatter)")
    partition_level.launches += 1
    return LevelPartition(new_order, new_seg, small_rows, small_seg,
                          small_is_right)


partition_level.launches = 0


def partition_leaf_values_plain(order, seg, state, node_value,
                                row_value) -> None:
    """Plain PyTorch K3 leaf-value mode: ``row_value[order[p]] =
    node_value[k]`` for every position p of a LEAF node k; the row-value
    write of ``partition_level_plain`` alone."""
    node = _node_of_slot(seg, state.shape[0])
    leaf = state[node] == LEAF
    row_value[order.long()[leaf]] = node_value[node[leaf]]


def partition_leaf_values(order: torch.Tensor, seg: torch.Tensor,
                          state: torch.Tensor, node_value: torch.Tensor,
                          row_value: torch.Tensor) -> None:
    """K3's leaf-value mode, for the grower's last call: every node is a
    LEAF or INACTIVE, so no row moves and only ``row_value`` (f32 [N],
    written in place) is produced. No routing, scan or new order."""
    if not order.is_cuda:
        partition_leaf_values_plain(order, seg, state, node_value, row_value)
        return
    n = order.shape[0]
    n_nodes = state.shape[0]
    dev = order.device
    for t, dt in ((state, torch.uint8), (node_value, torch.float32)):
        _check(t.device == dev and t.dtype == dt and t.shape == (n_nodes,)
               and t.is_contiguous(), f"partition_leaf_values: node array "
               f"must be contiguous {dt} [n_nodes] on {dev}")
    _check(order.dtype == torch.int32 and order.dim() == 1
           and order.is_contiguous() and order.data_ptr() % 16 == 0,
           "partition_leaf_values: order 16-byte aligned int32 [N]")
    _check(seg.dtype == torch.int32 and seg.shape == (n_nodes + 1,)
           and seg.device == dev and seg.is_contiguous(),
           "partition_leaf_values: seg int32 [n_nodes + 1]")
    _check(row_value.device == dev and row_value.dtype == torch.float32
           and row_value.shape == (n,) and row_value.is_contiguous(),
           "partition_leaf_values: row_value f32 [N]")
    with torch.cuda.device(dev):
        code = _build.library("partition").xrt_leaf_values(
            order.data_ptr(), seg.data_ptr(), n_nodes, n, state.data_ptr(),
            node_value.data_ptr(), row_value.data_ptr(),
            _build.stream_ptr(dev))
    _build.check(code, "K3 leaf values")
    partition_leaf_values.launches += 1


partition_leaf_values.launches = 0
