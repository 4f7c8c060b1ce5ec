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

Quantized gradients (``gh_precision``): K1's integer instantiation sums
int8 / int16 (g, h) into exact int32 histograms and totals (native 32-bit
shared atomics, no carry words), and ``form_dequantize`` forms each
level's siblings in the integer domain and dequantizes the level once
(``csrc/histogram.cu``). The quantized histogram wire (``hist_quant``,
B11: ``quantized_hist_allreduce``, kernels in ``csrc/quant.cu``) merges a
level's f32 histogram over the ranks in int8 / int16, with row or block
scales, as the reference's wire does step for step.

Each wrapper sends CPU tensors to its plain PyTorch version and CUDA
tensors to its kernel (or raises): there is no fallback. ``launches``
counts kernel launches. The plain versions are device-agnostic, so
``chip_smoke.py`` can hold each kernel against them on the card.

Row layout: ``rows[seg[k]:seg[k + 1]]`` are node k's rows in increasing
row id; ``seg`` is int32 ``[n_nodes + 1]`` (``seg[n_nodes]`` = rows used).
"""

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
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


def _from_first(rows: torch.Tensor, seg: torch.Tensor):
    """``rows`` and ``seg`` rebased where the first node starts past 0 (the
    lossguide grower's two children, the middle of its three-node level)."""
    s0 = int(seg[0])
    return (rows[s0:], seg - s0) if s0 else (rows, seg)


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
    None without ``with_hist``, totals [n_nodes, 2]). Integer ``gh``
    (``gh_precision``: int8 / int16) sums exact int32, as the reference's
    integer histogram does."""
    rows, seg = _from_first(rows, seg)
    num_features = bins.shape[1]
    m = int(seg[-1])
    acc = torch.float32 if gh.is_floating_point() else torch.int32
    ghr = gh[rows[:m].long()].to(acc)
    totals = torch.zeros((n_nodes, 2), dtype=acc, device=bins.device)
    totals.index_add_(0, _node_of_slot(seg, n_nodes), ghr)
    if not with_hist:
        return None, totals
    hist = torch.zeros((n_nodes * num_features * n_bins_total, 2),
                       dtype=acc, device=bins.device)
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
    device (for any f32 [..., k] of maxima, along the last axis the k scales
    then their inverses: the sketch's weights take k = 1, K classes' (g, h)
    maxima [K, 2] give [K, 4]), each e the largest with n_global * (max|v| *
    2^e + 1) < 2^62 (clamped to [-126, 126]; 126 where the max is 0). A few
    launches and no host read: ``floor(log2(...))`` may be one off, so the
    first of e0 + 1, e0, e0 - 1 that fits is taken."""
    n = max(1, int(n_global))
    md = absmax.double()
    e0 = torch.floor(torch.log2((_Q_LIMIT / n - 1.0) / md))  # inf at max 0
    step = torch.arange(1, -2, -1, dtype=torch.float64, device=md.device)
    cand = (e0 + step.view(3, *([1] * md.dim()))).clamp(_E_MIN, _E_MAX)
    fits = n * (md * _pow2(cand, torch.float64) + 1.0) < _Q_LIMIT
    e = torch.where(fits[0], cand[0], torch.where(fits[1], cand[1], cand[2]))
    return _pow2(torch.cat([e, -e], dim=-1), torch.float32)


def quant_scales(gh: torch.Tensor, n_global: int,
                 reduce_max: Optional[
                     Callable[[torch.Tensor], torch.Tensor]] = None
                 ) -> torch.Tensor:
    """A round's fixed-point scales (``scales_for``) from its gradients
    ``gh`` [N, 2], or [K, N, 2] for K classes: the per-column max of |gh|
    ([2], or each class's [K, 2] in one pass), merged across ranks by
    ``reduce_max`` (one all-reduce MAX), stays on ``gh``'s device: [4], or
    [K, 4] (class k's scales in row k, so a rare class's small (g, h) keep
    their resolution)."""
    absmax = gh_absmax(gh)
    if reduce_max is not None:
        absmax = reduce_max(absmax)
    return scales_for(absmax, n_global)


def gh_absmax(gh: torch.Tensor) -> torch.Tensor:
    """The per-column max of |gh| over the rows: [2] of [N, 2], [K, 2] of
    [K, N, 2] (zeros without rows)."""
    if gh.shape[-2]:
        return torch.linalg.vector_norm(gh, float("inf"), dim=-2)
    return torch.zeros(gh.shape[:-2] + (2,), dtype=torch.float32,
                       device=gh.device)


def fixed_point_gh(gh: torch.Tensor, qscale: torch.Tensor) -> torch.Tensor:
    """[N, 2] int64 ``llrint(v * 2^e)`` per column (an exact product, round
    half to even): what K1 adds for each row in fixed point (not the
    reference's ``quantize_gh``, which is ``ops/objectives.quantize_gh``)."""
    return torch.round(gh * qscale[:2]).to(torch.int64)


def build_histogram_fixed_plain(bins: torch.Tensor, gh: torch.Tensor,
                                rows: torch.Tensor, seg: torch.Tensor,
                                n_nodes: int, n_bins_total: int,
                                qscale: torch.Tensor, with_hist: bool = True):
    """What K1 computes: int64 ``index_add_`` of the quantised (g, h) over
    the node-sorted rows. Returns (hist [n_nodes, F, n_bins_total, 2] int64
    or None without ``with_hist``, totals [n_nodes, 2] int64); integer sums,
    so any order gives the same bits."""
    rows, seg = _from_first(rows, seg)
    num_features = bins.shape[1]
    m = int(seg[-1])
    qr = fixed_point_gh(gh[rows[:m].long()], qscale)
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
                       capacity: int, planes: int = 4
                       ) -> Tuple[int, int, int]:
    """(ftile, grid_x, min_rows) for K1: features split into the fewest
    even tiles whose ``planes`` 32-bit word planes (4 x planes x nbt bytes
    a feature: four for the int64 fixed point, two for the integer
    gradients' int32; at most 32 features) fit ``_K1_SMEM_BUDGET``; a
    persistent grid of two CTAs per SM (fewer when ``capacity`` rows give
    each CTA less than ``_K1_MIN_ROWS``)."""
    lib = _build.library("histogram")
    fmax = max(1, min(32, _K1_SMEM_BUDGET // (4 * planes * n_bins_total)))
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
    over ``rows[seg[k]:seg[k+1]]`` for each node k (``seg[0]`` may be past
    0: the rows before it are read by no node); ``with_hist=False``
    computes the totals only (hist is None).

    CUDA tensors need the round's ``qscale`` (``quant_scales``): K1 sums
    int64 fixed point (``dequantize`` makes them f32). CPU tensors take the
    f32 ``build_histogram_plain``, the JAX package's sums, and no
    ``qscale``. Integer ``gh`` (int8 / int16 [N, 2], ``gh_precision``)
    takes K1's integer instantiation on the card, exact int32 sums with
    native 32-bit shared atomics and no ``qscale`` (``launches_int``
    counts it apart), and the plain version's int32 sums on the CPU."""
    if not bins.is_cuda:
        _check(qscale is None, "build_histogram: the CPU sums f32 and takes "
               "no qscale (K1's fixed point is the card's)")
        return build_histogram_plain(bins, gh, rows, seg, n_nodes,
                                     n_bins_total, with_hist)
    n, num_features = bins.shape
    dev = bins.device
    for t in (gh, rows, seg):
        _check(t.device == dev, "build_histogram: tensors on different devices")
    if not gh.is_floating_point():
        return _build_histogram_int(bins, gh, rows, seg, n_nodes,
                                    n_bins_total, with_hist, qscale)
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
build_histogram.launches_int = 0


def _build_histogram_int(bins, gh, rows, seg, n_nodes: int,
                         n_bins_total: int, with_hist: bool, qscale):
    """K1's integer instantiation (``build_histogram`` with int8 / int16
    gh on the card): int32 hist and totals."""
    n, num_features = bins.shape
    dev = bins.device
    _check(qscale is None, "build_histogram: integer gradients sum exactly "
           "and take no qscale")
    _check(bins.dtype in (torch.int16, torch.uint8) and bins.is_contiguous(),
           "build_histogram: bins must be contiguous int16 or uint8 [N, F]")
    # the kernels read one element at a time: no alignment beyond the type's
    _check(gh.dtype in (torch.int8, torch.int16) and gh.is_contiguous(),
           "build_histogram: integer gh must be contiguous int8 or int16")
    _check(gh.shape == (n, 2), f"build_histogram: integer gh must be "
           f"[N, 2] = [{n}, 2] as bins, not {list(gh.shape)}")
    _check(rows.dtype == torch.int32 and rows.dim() == 1
           and rows.is_contiguous(), "build_histogram: rows must be int32 [M]")
    _check(seg.dtype == torch.int32 and seg.shape == (n_nodes + 1,)
           and seg.is_contiguous(),
           "build_histogram: seg must be int32 [n_nodes + 1]")
    _check(n_bins_total <= 1025, "build_histogram: max_bin <= 1024")
    hist = (torch.zeros((n_nodes, num_features, n_bins_total, 2),
                        dtype=torch.int32, device=dev) if with_hist else None)
    totals = torch.zeros((n_nodes, 2), dtype=torch.int32, device=dev)
    ftile, grid_x, min_rows = _hist_launch_shape(
        dev, num_features, n_bins_total, rows.shape[0], planes=2)
    with torch.cuda.device(dev):
        code = _build.library("histogram").xrt_hist_build_int(
            bins.data_ptr(), bins.element_size(), gh.data_ptr(),
            gh.element_size(), rows.data_ptr(), seg.data_ptr(), n_nodes,
            num_features, n_bins_total, ftile, grid_x, min_rows,
            int(with_hist), _build.ptr(hist), totals.data_ptr(),
            _build.stream_ptr(dev))
    _build.check(code, "K1 histogram (integer gh)")
    build_histogram.launches_int += 1
    return hist, totals


# --------------------------------------------------------------------------
# integer gradients: the sibling formed and the sums dequantised once
# --------------------------------------------------------------------------


def form_dequantize_plain(small: torch.Tensor, prev: Optional[torch.Tensor],
                          small_is_right: Optional[torch.Tensor],
                          scale: torch.Tensor, formed_dtype: torch.dtype,
                          with_totals: bool):
    """A level's histogram in the quantized-gradient domain and its f32
    values (the reference's ``ops/grow.py:577-601``): with ``prev`` (the
    parents' formed sums) each parent's smaller child ``small`` as given
    and its sibling as parent - smaller child (int32 where both are int32,
    else f32 of each), interleaved by ``small_is_right``; without it
    ``small`` itself. The formed sums as ``formed_dtype`` (what the next
    level keeps), then dequantized once: f32(formed) x ``scale`` [2]; with
    ``with_totals`` (int32 inputs) each node's (G, H) too, the exact int32
    sum of feature 0's buckets dequantized. Returns (formed, values,
    totals or None)."""
    if prev is None:
        exact = small
    else:
        if small.dtype == torch.int32 and prev.dtype == torch.int32:
            big = prev - small
        else:
            big = prev.to(torch.float32) - small.to(torch.float32)
        sir = small_is_right[:, None, None, None]
        sm = small.to(big.dtype)
        exact = torch.stack([torch.where(sir, big, sm),
                             torch.where(sir, sm, big)], dim=1).reshape(
            (2 * small.shape[0],) + small.shape[1:])
    formed = exact.to(formed_dtype)
    values = exact.to(torch.float32) * scale
    totals = None
    if with_totals:
        totals = exact[:, 0].sum(dim=1, dtype=torch.int32).to(
            torch.float32) * scale
    return formed, values, totals


def form_dequantize(small: torch.Tensor, prev: Optional[torch.Tensor],
                    small_is_right: Optional[torch.Tensor],
                    scale: torch.Tensor, formed_dtype: torch.dtype,
                    with_totals: bool):
    """``form_dequantize_plain``'s function: CPU tensors -> the plain
    version, CUDA tensors -> one launch of ``xrt_hist_form_dequant``
    (``csrc/histogram.cu``), or raise. ``small`` [n, F, nbt, 2] (int32 or
    f32), ``prev`` the same shape (int32 or f32) or None, ``small_is_right``
    [n] bool with ``prev``, ``scale`` [2] f32; ``formed_dtype`` int32 (only
    from int32 inputs) or f32; totals only from int32 inputs.
    ``form_dequantize.launches`` counts the launches."""
    _check(formed_dtype in (torch.int32, torch.float32)
           and (formed_dtype == torch.float32 or (
               small.dtype == torch.int32
               and (prev is None or prev.dtype == torch.int32))),
           "form_dequantize: int32 formed sums need int32 inputs")
    _check(not with_totals or (small.dtype == torch.int32 and (
        prev is None or prev.dtype == torch.int32)),
        "form_dequantize: totals come from int32 sums only")
    if not small.is_cuda:
        return form_dequantize_plain(small, prev, small_is_right, scale,
                                     formed_dtype, with_totals)
    dev = small.device
    _check(small.dim() == 4 and small.shape[3] == 2
           and small.dtype in (torch.int32, torch.float32)
           and small.is_contiguous(),
           "form_dequantize: small must be contiguous int32 or f32 "
           "[n, F, nbt, 2]")
    n_small, num_features, nbt, _ = small.shape
    n_nodes = n_small if prev is None else 2 * n_small
    if prev is not None:
        _check(prev.shape == small.shape and prev.device == dev
               and prev.dtype in (torch.int32, torch.float32)
               and prev.is_contiguous(),
               "form_dequantize: prev must have small's shape")
        _check(small_is_right is not None
               and small_is_right.shape == (n_small,)
               and small_is_right.dtype == torch.bool
               and small_is_right.device == dev,
               "form_dequantize: small_is_right must be bool [n]")
    scale = scale.contiguous()
    _check(scale.shape == (2,) and scale.dtype == torch.float32
           and scale.device == dev, "form_dequantize: scale f32 [2]")
    shape = (n_nodes, num_features, nbt, 2)
    formed = torch.empty(shape, dtype=formed_dtype, device=dev)
    values = torch.empty(shape, dtype=torch.float32, device=dev)
    totals = (torch.empty((n_nodes, 2), dtype=torch.float32, device=dev)
              if with_totals else None)
    pairs = n_nodes * num_features * nbt
    grid = max(1, min(-(-pairs // 256), 4096))
    with torch.cuda.device(dev):
        code = _build.library("histogram").xrt_hist_form_dequant(
            small.data_ptr(), int(small.dtype == torch.int32),
            _build.ptr(prev),
            int(prev is not None and prev.dtype == torch.int32),
            _build.ptr(small_is_right), n_nodes, num_features, nbt,
            scale.data_ptr(), formed.data_ptr(),
            int(formed_dtype == torch.int32), values.data_ptr(),
            _build.ptr(totals), grid, _build.stream_ptr(dev))
    _build.check(code, "K1 form and dequantise")
    form_dequantize.launches += 1
    return formed, values, totals


form_dequantize.launches = 0


class AllreduceBytes:
    """Per-rank wire bytes of the collectives, under the ring model of the
    reference's ``AllreduceBytes`` (``xgboost_ray_tpu/ops/histogram.py:96``):
    an all-reduce moves ``2 (n - 1) / n x bytes(operand)``, an all-to-all
    ``(n - 1) / n x bytes(operand)``, an all-gather ``(n - 1) / n x
    bytes(output)`` (``(n - 1) x bytes(chunk)``), a ring hop the operand
    itself; 0 at world 1 (a ring hop moves nothing there either: the port
    makes none). ``repeated(n)`` scales what is recorded inside it."""

    def __init__(self, n_actors: int):
        self.n = max(1, int(n_actors))
        self.total = 0
        self._mult = 1

    @staticmethod
    def _nbytes(t: torch.Tensor) -> int:
        return t.numel() * t.element_size()

    def add_allreduce(self, t: torch.Tensor) -> None:
        self.total += int(2 * (self.n - 1) * self._nbytes(t)
                          / self.n) * self._mult

    def add_all_to_all(self, t: torch.Tensor) -> None:
        self.total += int((self.n - 1) * self._nbytes(t)
                          / self.n) * self._mult

    def add_allgather(self, out: torch.Tensor) -> None:
        self.total += int((self.n - 1) * self._nbytes(out)
                          / self.n) * self._mult

    def add_ppermute(self, t: torch.Tensor, hops: int = 1) -> None:
        self.total += self._nbytes(t) * int(hops) * self._mult

    def repeated(self, n: int):
        """Context manager: collectives recorded inside count ``n`` times."""
        import contextlib

        counter = self

        @contextlib.contextmanager
        def scope():
            counter._mult *= n
            try:
                yield
            finally:
                counter._mult //= n

        return scope()


# --------------------------------------------------------------------------
# B11: the quantized histogram wire (``hist_quant``)
# --------------------------------------------------------------------------
#
# The reference's ``quantized_hist_allreduce`` and
# ``_block_scaled_allreduce`` (``ops/histogram.py:188-385``), step for step
# over ``distributed.Collectives``. Row modes ("int8" / "int16"): one scale
# per (node, feature) row from the world's absmax (an all-reduce MAX),
# round-half-even onto the grid, a reduce-scatter as an all-to-all of the
# narrow rows summed in int32, each rank's merged rows requantized against
# their own absmax and all-gathered with the scales in-band. Block modes
# ("int8_block" / "int16_block"): the flat histogram in ``world`` chunks,
# scales per ``hist_quant_block`` elements from what a rank holds when it
# sends, a ring of n - 1 one-hop exchanges that dequantize and add at each
# hop, then each rank's chunk requantized and all-gathered. At world 1 both
# round twice, the same contract as above it. The kernels (``csrc/
# quant.cu``): B11q quantizes (a group's absmax, its scale, the rounding,
# the scale words), B11acc dequantizes and adds (the rows' int32 sum times
# their scale; a hop's q x scale + x), B11deq dequantizes a payload. As the
# reference's jitted program computes them: ``amax / qmax`` is ``amax *
# f32(1 / qmax)``, ``x / scale`` a true division, a hop's ``q x scale + x``
# one fused multiply-add.

HIST_QUANT_MODES = ("none", "int16", "int8", "int16_block", "int8_block")
_QMAX = {"int16": 32767, "int8": 127}
_QDTYPE = {"int16": torch.int16, "int8": torch.int8}
#: block-scaled wire modes -> the narrow dtype their payloads use
HIST_QUANT_BLOCK_MODES = {"int16_block": "int16", "int8_block": "int8"}
#: default elements per in-band scale block (``hist_quant_block``)
HIST_QUANT_DEFAULT_BLOCK = 512
#: payloads below this many bytes (4 a value) take the exact merge
HIST_QUANT_MIN_BYTES = 32768

_F32_TINY = 2.0 ** -126


def _ftz(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < _F32_TINY, x * 0.0, x)


def wire_quantized(mode: str, n_values: int, min_bytes: int) -> bool:
    """Whether a merge of ``n_values`` histogram values takes the quantized
    wire: a mode other than "none" and at least ``min_bytes`` at the
    reference's 4 bytes a value (``ops/histogram.py:220``; the card's
    int64 sums are decided on the same 4 bytes)."""
    return mode != "none" and n_values * 4 >= min_bytes


def _scale_words(dtype: torch.dtype) -> int:
    return 4 // torch.empty(0, dtype=dtype).element_size()


def _groups(length: int, group: int) -> int:
    return -(-length // group)


def wire_quantize_plain(x: torch.Tensor, group: int, qmax: int,
                        dtype: torch.dtype,
                        amax: Optional[torch.Tensor] = None,
                        inband: bool = False, absmax_only: bool = False):
    """B11q's function over ``x`` [S, L] f32: each segment's groups of
    ``group`` values (the last ragged, padded with zeros), scale ``amax x
    f32(1 / qmax)`` (1 where 0) of each group's absmax (``amax`` [S x g]
    given, else computed), values ``clip(round(x / scale))``. Returns
    ``amax`` with ``absmax_only``; the payload [S, L + g x w] (``dtype``,
    each segment's values then its g scales' w words) with ``inband``;
    else (q [S, L], scale [S x g] f32)."""
    n_seg, length = x.shape
    g = _groups(length, group)
    xb = torch.nn.functional.pad(x, (0, g * group - length)).view(
        n_seg, g, group)
    if amax is None:
        amax = xb.abs().amax(dim=2).reshape(-1)
    if absmax_only:
        return amax
    r = float(np.float32(1.0) / np.float32(qmax))
    scale = torch.where(amax > 0, _ftz(amax * r),
                        torch.ones((), dtype=torch.float32, device=x.device))
    q = torch.round(_ftz(xb / scale.view(n_seg, g, 1))).clamp(-qmax, qmax)
    q = q.to(dtype).view(n_seg, g * group)[:, :length].contiguous()
    if not inband:
        return q, scale
    return torch.cat([q, scale.view(torch.float32).view(n_seg, g).view(
        dtype).view(n_seg, -1)], dim=1)


def _unpack(payload: torch.Tensor, length: int, group: int):
    """(q [S, L], scale [S x g] f32) of an in-band payload [S, L + g w]."""
    n_seg = payload.shape[0]
    q = payload[:, :length]
    scale = payload[:, length:].reshape(-1).clone().view(torch.float32)
    return q, scale


def wire_dequantize_plain(q: torch.Tensor, length: int, group: int,
                          scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """B11deq's function: f32 [S, L] = f32(q) x its group's scale, from an
    in-band payload [S, L + g w] (``scale`` None) or from q [S, L] and
    ``scale`` [S x g]."""
    if scale is None:
        q, scale = _unpack(q, length, group)
    n_seg = q.shape[0]
    g = _groups(length, group)
    qb = torch.nn.functional.pad(q.to(torch.int32).to(torch.float32),
                                 (0, g * group - length)).view(n_seg, g, group)
    return _ftz(qb * scale.view(n_seg, g, 1)).view(n_seg, g * group)[
        :, :length].contiguous()


def wire_accumulate_plain(q: torch.Tensor, scale_or_x: torch.Tensor,
                          group: int = 0) -> torch.Tensor:
    """B11acc's function. Row mode (``q`` [n, C, L] narrow, the n ranks'
    pieces of this rank's C rows; ``scale_or_x`` their scales [C]): f32
    [C, L] = f32(int32 sum over the n) x scale. Block mode (``q`` an
    in-band payload [L + g w], ``scale_or_x`` the local f32 [L], ``group``
    the block): f32 [L] = fma(f32(q), scale, x)."""
    if q.dim() == 3:
        acc = q.to(torch.int32).sum(dim=0, dtype=torch.int32)
        return _ftz(acc.to(torch.float32) * scale_or_x[:, None])
    from xgboost_ray_tpu_torch.ops.objectives import _fma

    length = scale_or_x.shape[0]
    qv, scale = _unpack(q.view(1, -1), length, group)
    g = _groups(length, group)
    qb = torch.nn.functional.pad(qv.to(torch.int32).to(torch.float32),
                                 (0, g * group - length)).view(g, group)
    per = scale.view(g, 1).expand(g, group).reshape(-1)[:length]
    return _ftz(_fma(qb.reshape(-1)[:length], per, _ftz(scale_or_x)))


def _wire_geometry(q: torch.Tensor, dtype_ok: bool, what: str) -> None:
    _check(dtype_ok and q.is_contiguous(), f"{what}: contiguous int8 / "
           f"int16 payload expected")


def wire_quantize(x: torch.Tensor, group: int, qmax: int, dtype: torch.dtype,
                  amax: Optional[torch.Tensor] = None, inband: bool = False,
                  absmax_only: bool = False):
    """B11q wrapper (``wire_quantize_plain``'s function): CPU tensors ->
    the plain version, CUDA tensors -> one launch of ``xrt_wire_quant``
    (``csrc/quant.cu``), or raise. ``wire_quantize.launches`` counts."""
    if not x.is_cuda:
        return wire_quantize_plain(x, group, qmax, dtype, amax, inband,
                                   absmax_only)
    dev = x.device
    _check(x.dtype == torch.float32 and x.dim() == 2 and x.is_contiguous(),
           "wire_quantize: x must be contiguous f32 [S, L]")
    n_seg, length = x.shape
    g = _groups(length, group)
    if amax is not None:
        amax = amax.contiguous()
        _check(amax.dtype == torch.float32 and amax.shape == (n_seg * g,)
               and amax.device == dev, "wire_quantize: amax f32 [S x g]")
    sw = _scale_words(dtype)
    f32 = dict(dtype=torch.float32, device=dev)
    amax_out = q = scale = None
    if absmax_only:
        amax_out = torch.empty(n_seg * g, **f32)
    elif inband:
        q = torch.empty((n_seg, length + g * sw), dtype=dtype, device=dev)
    else:
        q = torch.empty((n_seg, length), dtype=dtype, device=dev)
        scale = torch.empty(n_seg * g, **f32)
    if n_seg * g:
        with torch.cuda.device(dev):
            code = _build.library("quant").xrt_wire_quant(
                x.data_ptr(), n_seg, length, group, _build.ptr(amax),
                _build.ptr(amax_out), _build.ptr(q),
                0 if q is None else q.element_size(),
                0 if q is None else q.shape[1], _build.ptr(scale), qmax,
                float(np.float32(1.0) / np.float32(qmax)),
                _build.stream_ptr(dev))
        _build.check(code, "B11 quantize")
        wire_quantize.launches += 1
    if absmax_only:
        return amax_out
    return q if inband else (q, scale)


wire_quantize.launches = 0


def wire_dequantize(q: torch.Tensor, length: int, group: int,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B11deq wrapper (``wire_dequantize_plain``'s function): CPU tensors
    -> the plain version, CUDA tensors -> one launch of ``xrt_wire_deq``,
    or raise. ``wire_dequantize.launches`` counts."""
    if not q.is_cuda:
        return wire_dequantize_plain(q, length, group, scale)
    dev = q.device
    _wire_geometry(q, q.dtype in (torch.int8, torch.int16) and q.dim() == 2,
                   "wire_dequantize")
    n_seg = q.shape[0]
    g = _groups(length, group)
    if scale is not None:
        scale = scale.contiguous()
        _check(scale.dtype == torch.float32 and scale.shape == (n_seg * g,)
               and scale.device == dev and q.shape[1] == length,
               "wire_dequantize: q [S, L] and scale f32 [S x g]")
    else:
        _check(q.shape[1] == length + g * _scale_words(q.dtype),
               "wire_dequantize: an in-band payload is [S, L + g w]")
    out = torch.empty((n_seg, length), dtype=torch.float32, device=dev)
    if out.numel():
        with torch.cuda.device(dev):
            code = _build.library("quant").xrt_wire_deq(
                q.data_ptr(), q.element_size(), q.shape[1], n_seg, length,
                group, _build.ptr(scale), out.data_ptr(),
                _build.stream_ptr(dev))
        _build.check(code, "B11 dequantize")
        wire_dequantize.launches += 1
    return out


wire_dequantize.launches = 0


def wire_accumulate(q: torch.Tensor, scale_or_x: torch.Tensor,
                    group: int = 0) -> torch.Tensor:
    """B11acc wrapper (``wire_accumulate_plain``'s function, row or block
    mode): CPU tensors -> the plain version, CUDA tensors -> one launch of
    ``xrt_wire_acc``, or raise. ``wire_accumulate.launches`` counts."""
    if not q.is_cuda:
        return wire_accumulate_plain(q, scale_or_x, group)
    dev = q.device
    _wire_geometry(q, q.dtype in (torch.int8, torch.int16), "wire_accumulate")
    v = scale_or_x.contiguous()
    _check(v.dtype == torch.float32 and v.device == dev and v.dim() == 1,
           "wire_accumulate: f32 [C] scales or [L] values")
    if q.dim() == 3:
        n_src, rows, length = q.shape
        _check(v.shape == (rows,), "wire_accumulate: scales [C]")
        out = torch.empty((rows, length), dtype=torch.float32, device=dev)
    else:
        n_src, rows, length = 0, 1, v.shape[0]
        _check(q.dim() == 1 and q.shape[0] == length + _groups(
            length, group) * _scale_words(q.dtype),
            "wire_accumulate: an in-band payload [L + g w]")
        out = torch.empty(length, dtype=torch.float32, device=dev)
    if out.numel():
        with torch.cuda.device(dev):
            code = _build.library("quant").xrt_wire_acc(
                q.data_ptr(), q.element_size(), n_src, rows, length, group,
                v.data_ptr(), out.data_ptr(), _build.stream_ptr(dev))
        _build.check(code, "B11 accumulate")
        wire_accumulate.launches += 1
    return out


wire_accumulate.launches = 0


def quantized_hist_allreduce(h: torch.Tensor, mode: str, coll,
                             min_bytes: int = HIST_QUANT_MIN_BYTES,
                             block: int = HIST_QUANT_DEFAULT_BLOCK
                             ) -> torch.Tensor:
    """Merge a local histogram ``h`` [n_nodes, F, nbt, 2] (f32, or the
    int32 sums of integer gradients) over ``coll``'s ranks
    (``distributed.Collectives``) on the ``mode`` wire, each collective's
    bytes recorded in ``coll.bytes``. "none", and payloads under
    ``min_bytes`` (4 bytes a value), take the exact merge (an all-reduce
    SUM of ``h`` as it is); the others return the f32 merged histogram,
    the same bits on every rank. Integer sums ride the quantized wire as
    their f32 values."""
    if not wire_quantized(mode, h.numel(), min_bytes):
        return coll.sum(h.contiguous())
    if mode in HIST_QUANT_BLOCK_MODES:
        return _block_scaled_allreduce(h, HIST_QUANT_BLOCK_MODES[mode], coll,
                                       int(block))
    if mode not in _QMAX:
        raise ValueError(f"unknown hist_quant mode {mode!r}")
    qmax, qdt = _QMAX[mode], _QDTYPE[mode]
    nn, num_features, nbt, two = h.shape
    rows, cols = nn * num_features, nbt * two
    hr = h.reshape(rows, cols).to(torch.float32).contiguous()
    n = coll.world
    # stage 1: shared per-(node, feature) scales from the world's absmax
    amax = coll.max(wire_quantize(hr, cols, qmax, qdt, absmax_only=True))
    q, scale = wire_quantize(hr, cols, qmax, qdt, amax=amax)
    if n == 1:
        # no wire: the same two roundings as above one rank
        merged = wire_dequantize(q, cols, cols, scale)
        q2, scale2 = wire_quantize(merged, cols, qmax, qdt)
        return wire_dequantize(q2, cols, cols, scale2).view(h.shape)
    # stage 2: the narrow rows' reduce-scatter, summed in int32
    pad = (-rows) % n
    if pad:
        q = torch.cat([q, q.new_zeros((pad, cols))])
        scale = torch.cat([scale, scale.new_ones(pad)])
    chunk = (rows + pad) // n
    recv = coll.all_to_all(q.view(n, chunk, cols))
    own = scale[coll.rank * chunk:(coll.rank + 1) * chunk]
    merged_rows = wire_accumulate(recv, own)
    # stage 3: this rank's merged rows requantized and gathered, scales
    # in-band
    payload = wire_quantize(merged_rows, cols, qmax, qdt, inband=True)
    full = coll.all_gather(payload)
    return wire_dequantize(full, cols, cols)[:rows].reshape(h.shape)


def _block_scaled_allreduce(h: torch.Tensor, base: str, coll,
                            block: int) -> torch.Tensor:
    """The block-scaled ring (``ops/histogram.py:286-385``)."""
    qmax, qdt = _QMAX[base], _QDTYPE[base]
    size = h.numel()
    flat = h.reshape(-1).to(torch.float32)
    n = coll.world
    pad = (-size) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    chunk = (size + pad) // n
    if n == 1:
        p1 = wire_quantize(flat.view(1, chunk), block, qmax, qdt, inband=True)
        p2 = wire_quantize(wire_dequantize(p1, chunk, block), block, qmax,
                           qdt, inband=True)
        return wire_dequantize(p2, chunk, block).view(-1)[:size].reshape(
            h.shape)
    chunks = flat.view(n, chunk)
    p = coll.rank
    # ring reduce-scatter: at step s rank p sends the running sum of chunk
    # (p - 1 - s) % n to p + 1, which adds its own copy in f32
    cur = chunks[(p - 1) % n].contiguous()
    for s in range(n - 1):
        payload = wire_quantize(cur.view(1, chunk), block, qmax, qdt,
                                inband=True)
        recv = coll.ring_exchange(payload.view(-1))
        cur = wire_accumulate(recv, chunks[(p - 2 - s) % n].contiguous(),
                              block)
    payload = wire_quantize(cur.view(1, chunk), block, qmax, qdt,
                            inband=True)
    full = coll.all_gather(payload)
    merged = wire_dequantize(full, chunk, block).view(-1)
    return merged[:size].reshape(h.shape)


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
                          missing_bin: int, merge_counts=None,
                          cat=None) -> LevelPartition:
    """Plain PyTorch K3, composed from the JAX package's functions."""
    from xgboost_ray_tpu_torch.ops.grow import route_right_binned

    n = order.shape[0]
    n_nodes = feature.shape[0]
    dev = order.device
    counts = (seg[1:] - seg[:-1]).long()
    node = _node_of_slot(seg, n_nodes)
    rows = order.long()
    st = state[node].long()
    f_row = feature.long()[node]
    b = bins[rows, f_row].long()
    right = route_right_binned(b, split_bin[node], default_left[node],
                               missing_bin,
                               None if cat is None else cat[f_row]
                               ) & (st == SPLIT)
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
                        Callable[[torch.Tensor], torch.Tensor]] = None,
                    cat: Optional[torch.Tensor] = None
                    ) -> LevelPartition:
    """K3 wrapper. ``state`` [n_nodes] uint8 (INACTIVE / SPLIT / LEAF);
    ``cat`` [F] bool: the categorical features, routed one-vs-rest;
    ``row_value`` [N] f32 is written in place for the rows of LEAF nodes
    (``node_value``). ``merge_counts`` (above one rank: the all-reduce SUM)
    takes the children's row counts, int64 [2 n_nodes], and returns them
    summed over the ranks; the smaller child of each parent is then chosen
    from those, the same on every rank, and ``small_rows`` has N slots."""
    if not order.is_cuda:
        return partition_level_plain(order, seg, bins, feature, split_bin,
                                     default_left, state, node_value,
                                     row_value, write_small, missing_bin,
                                     merge_counts, cat)
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
    if cat is not None:  # a bool's bytes are the kernel's uint8 flags
        _check(cat.dtype == torch.bool and cat.shape == (num_features,)
               and cat.device == dev and cat.is_contiguous(),
               "partition_level: cat contiguous bool [F]")
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
            missing_bin, _build.ptr(cat), mask.data_ptr(),
            tile_left.data_ptr(),
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
    if cat is not None:
        partition_level.launches_categorical += 1
    return LevelPartition(new_order, new_seg, small_rows, small_seg,
                          small_is_right)


partition_level.launches = 0
partition_level.launches_categorical = 0


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
