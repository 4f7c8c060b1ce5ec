"""Quantile sketch and feature binning, in PyTorch on the training device.

Port of the device half of ``xgboost_ray_tpu/ops/binning.py`` (``:264``
``feature_min_max``, ``:273`` ``sketch_histogram``, ``:324``
``cuts_from_sketch``, ``:346`` ``bin_matrix``), driven as
``engine.TpuEngine._sketch_and_bin`` drives them (``engine.py:876``):

1. per-feature min/max over non-NaN values;
2. a fine weighted histogram of ``SKETCH_BINS`` buckets per feature;
3. cut points read off its CDF at the equi-weight quantiles;
4. ``bin = #cuts <= x`` (``searchsorted`` right), NaN -> ``max_bin``.

Across ranks (``coll``, the engine's collectives) the min/max go through
an all-reduce MIN/MAX, the fine histogram and the per-feature missing-value
counts through an all-reduce SUM: the ``pmin``/``pmax``/``psum`` of
``engine.py:876-903``.

The arithmetic is the JAX package's, op for op in float32 (with the cut
read-off fused as its compiled program fuses it), so cuts and bins are
bitwise equal to it. This runs once per ``train``; a hand kernel for it
is queued (ROADMAP). Rows are processed in blocks to bound the transient
index buffers at large N.
"""

from typing import Optional, Tuple

import numpy as np
import torch

# Number of fine histogram buckets used by the sketch (>= max_bin).
SKETCH_BINS = 2048

#: rows per block of the sketch/bin passes (bounds int64 index transients)
_BLOCK_ROWS = 1 << 20


def bin_dtype(max_bin: int):
    """Smallest integer dtype that can hold bins 0..max_bin (missing ==
    max_bin), as numpy dtype — the JAX package's choice."""
    return np.uint8 if max_bin + 1 <= 256 else np.int16


def torch_bin_dtype(max_bin: int) -> torch.dtype:
    return torch.uint8 if max_bin + 1 <= 256 else torch.int16


def feature_min_max(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-feature (min, max) over non-NaN entries. x: [N, F] f32."""
    big = torch.tensor(np.finfo(np.float32).max, dtype=torch.float32,
                       device=x.device)
    mn = torch.full((x.shape[1],), np.finfo(np.float32).max,
                    dtype=torch.float32, device=x.device)
    mx = -mn
    for lo in range(0, x.shape[0], _BLOCK_ROWS):
        xb = x[lo:lo + _BLOCK_ROWS]
        mask = ~torch.isnan(xb)
        mn = torch.minimum(mn, torch.where(mask, xb, big).amin(0))
        mx = torch.maximum(mx, torch.where(mask, xb, -big).amax(0))
    return mn, mx


def sketch_histogram(x: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor,
                     weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fine weighted histogram per feature over [mn, mx]: [F, SKETCH_BINS]."""
    n, num_features = x.shape
    one = torch.ones((), dtype=torch.float32, device=x.device)
    scale = torch.where(mx > mn, mx - mn, one)
    offs = torch.arange(num_features, device=x.device) * SKETCH_BINS
    hist = torch.zeros(num_features * SKETCH_BINS, dtype=torch.float32,
                       device=x.device)
    for lo in range(0, n, _BLOCK_ROWS):
        xb = x[lo:lo + _BLOCK_ROWS]
        t = (xb - mn[None, :]) / scale[None, :]
        idx = torch.clamp((t * SKETCH_BINS).to(torch.int32), 0,
                          SKETCH_BINS - 1)
        w = (torch.ones(xb.shape[0], dtype=torch.float32, device=x.device)
             if weight is None else weight[lo:lo + _BLOCK_ROWS].float())
        wv = torch.where(torch.isnan(xb), torch.zeros((), device=x.device),
                         w[:, None])
        hist.index_add_(0, (idx.long() + offs[None, :]).reshape(-1),
                        wv.reshape(-1))
    return hist.reshape(num_features, SKETCH_BINS)


def cuts_from_sketch(mn: torch.Tensor, mx: torch.Tensor, hist: torch.Tensor,
                     max_bin: int) -> torch.Tensor:
    """Merged fine histogram -> cut points [F, max_bin - 1] (the upper edge
    of the bucket where each equi-weight quantile falls)."""
    num_features = hist.shape[0]
    cdf = torch.cumsum(hist, dim=1)
    total = torch.clamp(cdf[:, -1:], min=1e-12)
    cdf = cdf / total
    qs = torch.arange(1, max_bin, dtype=torch.float32,
                      device=hist.device) / max_bin
    idx = torch.searchsorted(
        cdf.contiguous(), qs.expand(num_features, -1).contiguous(),
        right=False,
    )
    idx = torch.clamp(idx, 0, SKETCH_BINS - 1)
    one = torch.ones((), dtype=torch.float32, device=hist.device)
    scale = torch.where(mx > mn, mx - mn, one)
    edges = (idx.to(torch.float32) + 1.0) / SKETCH_BINS
    # mn + edges * scale as one fused multiply-add, as the compiled JAX
    # program evaluates it: the product of a 12-bit edge and a float32
    # scale is exact in float64, so the sum rounds once to float64 and
    # then to float32 (equal to the FMA but for double-rounding ties)
    return (mn[:, None].double()
            + edges.double() * scale[:, None].double()).to(torch.float32)


def bin_matrix(x: torch.Tensor, cuts: torch.Tensor, max_bin: int) -> torch.Tensor:
    """[N, F] f32 -> [N, F] bins (``bin_dtype``): #cuts <= x, NaN ->
    max_bin."""
    n, num_features = x.shape
    out = torch.empty((n, num_features), dtype=torch_bin_dtype(max_bin),
                      device=x.device)
    cuts = cuts.contiguous()
    for lo in range(0, n, _BLOCK_ROWS):
        xb = x[lo:lo + _BLOCK_ROWS]
        b = torch.searchsorted(cuts, xb.t().contiguous(), right=True).t()
        b = torch.where(torch.isnan(xb), max_bin, b)
        out[lo:lo + _BLOCK_ROWS] = b.to(out.dtype)
    return out


def sketch_and_bin(x: torch.Tensor, weight: Optional[torch.Tensor],
                   max_bin: int, coll=None):
    """The sketch -> cuts -> bins pipeline over this rank's rows ``x``, its
    merges through ``coll`` (the engine's ``distributed.Collectives``; None
    at world 1). Returns (bins [N, F], cuts [F, max_bin - 1] f32,
    feat_has_missing [F] bool), cuts and the mask the same on every rank."""
    mn, mx = feature_min_max(x)
    if coll is not None:
        mn, mx = coll.min(mn), coll.max(mx)
    hist = sketch_histogram(x, mn, mx, weight)
    if coll is not None:
        hist = coll.sum(hist)
    cuts = cuts_from_sketch(mn, mx, hist, max_bin)
    bins = bin_matrix(x, cuts, max_bin)
    missing = torch.zeros(x.shape[1], dtype=torch.int64, device=x.device)
    for lo in range(0, x.shape[0], _BLOCK_ROWS):
        missing += (bins[lo:lo + _BLOCK_ROWS] == max_bin).sum(0)
    if coll is not None:
        missing = coll.sum(missing)
    return bins, cuts, missing > 0
