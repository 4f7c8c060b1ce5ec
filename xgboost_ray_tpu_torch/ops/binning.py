"""Quantile sketch and feature binning, in PyTorch on the training device.

Port of the device half of ``xgboost_ray_tpu/ops/binning.py`` (``:264``
``feature_min_max``, ``:273`` ``sketch_histogram``, ``:324``
``cuts_from_sketch``, ``:346`` ``bin_matrix``), driven as
``engine.TpuEngine._sketch_and_bin`` drives them (``engine.py:876``):

1. per-feature min/max over non-NaN values;
2. a fine weighted histogram of ``SKETCH_BINS`` buckets per feature;
3. cut points read off its CDF at the equi-weight quantiles;
4. ``bin = #cuts <= x`` (``searchsorted`` right), NaN -> ``max_bin``.

A categorical feature's cuts are the codes' midpoints ``k + 0.5``
(``engine.py:885-894``), so bin c is category c and NaN the missing bin;
``validate_categorical_codes`` (``ops/binning.py:164``) first checks that
its column holds integer codes in [0, max_bin - 2].

Across ranks (``coll``, the engine's collectives) the min/max go through
an all-reduce MIN/MAX, the fine histogram and the per-feature missing-value
counts through an all-reduce SUM: the ``pmin``/``pmax``/``psum`` of
``engine.py:876-903``.

On the CPU the arithmetic is the JAX package's, op for op in float32 (with
the cut read-off fused as its compiled program fuses it), so cuts and bins
are bitwise equal to it. On the card the fine histogram sums the weights
in int64 fixed point with K1's scheme (``ops/histogram.scales_for``: one
power-of-two scale from the all-reduced max|w| and the global row count),
so the sums, merged by an integer all-reduce and then made f32, are the
same bits in any order of CUDA's atomics and over any shard layout; with
unit weights every bucket is an integer count below 2^24 and the f32 sums
are the same bits either way. This runs once per ``train``; a hand kernel
for it is queued (ROADMAP). Rows are processed in blocks to bound the
transient index buffers at large N.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from xgboost_ray_tpu_torch.ops.histogram import scales_for

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
                     weight: Optional[torch.Tensor] = None,
                     qscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fine weighted histogram per feature over [mn, mx]: [F, SKETCH_BINS],
    f32 sums, or with ``qscale`` (``sketch_scale``) int64 fixed-point sums
    of ``llrint(w * 2^e)`` (exact in any order; ``dequantize_sketch`` makes
    them f32)."""
    n, num_features = x.shape
    dev = x.device
    one = torch.ones((), dtype=torch.float32, device=dev)
    scale = torch.where(mx > mn, mx - mn, one)
    offs = torch.arange(num_features, device=dev) * SKETCH_BINS
    hist = torch.zeros(num_features * SKETCH_BINS,
                       dtype=torch.float32 if qscale is None else torch.int64,
                       device=dev)
    for lo in range(0, n, _BLOCK_ROWS):
        xb = x[lo:lo + _BLOCK_ROWS]
        t = (xb - mn[None, :]) / scale[None, :]
        idx = torch.clamp((t * SKETCH_BINS).to(torch.int32), 0,
                          SKETCH_BINS - 1)
        w = (torch.ones(xb.shape[0], dtype=torch.float32, device=dev)
             if weight is None else weight[lo:lo + _BLOCK_ROWS].float())
        if qscale is not None:
            w = torch.round(w * qscale[0])  # an exact product, half to even
        wv = torch.where(torch.isnan(xb), torch.zeros((), device=dev),
                         w[:, None])
        hist.index_add_(0, (idx.long() + offs[None, :]).reshape(-1),
                        wv.reshape(-1).to(hist.dtype))
    return hist.reshape(num_features, SKETCH_BINS)


def sketch_scale(weight: Optional[torch.Tensor], n_global: int,
                 reduce_max=None, device=None) -> torch.Tensor:
    """The sketch's fixed-point scale, f32 [2] = (2^e, 2^-e): e the largest
    with n_global * (max|w| * 2^e + 1) < 2^62 (K1's ``scales_for``), max|w|
    merged across ranks by ``reduce_max`` (1 without weights)."""
    if weight is None:
        absmax = torch.ones(1, dtype=torch.float32, device=device)
    elif weight.numel():
        absmax = weight.float().abs().amax().reshape(1)
    else:
        absmax = torch.zeros(1, dtype=torch.float32, device=weight.device)
    if reduce_max is not None:
        absmax = reduce_max(absmax)
    return scales_for(absmax, n_global)


def dequantize_sketch(hist: torch.Tensor, qscale: torch.Tensor) -> torch.Tensor:
    """Merged int64 sketch sums -> f32: float(sum) rounded to nearest, times
    2^-e (exact)."""
    return hist.to(torch.float32) * qscale[1]


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


def validate_feature_types_count(cat_features, n_features: int) -> None:
    """Every categorical feature index must name a real column."""
    if any(i >= n_features for i in cat_features):
        raise ValueError("feature_types has more entries than features.")


def validate_categorical_codes(x: np.ndarray, cat_features,
                               max_bin: int) -> None:
    """Categorical columns must hold integer codes in [0, max_bin-2]
    (NaN = missing is fine)."""
    validate_feature_types_count(cat_features, x.shape[1])
    for fi in cat_features:
        col = x[:, fi]
        vals = col[~np.isnan(col)]
        if vals.size and (
            (vals < 0).any()
            or (vals != np.round(vals)).any()
            or vals.max() > max_bin - 2
        ):
            raise ValueError(
                f"categorical feature {fi} must hold integer codes in "
                f"[0, {max_bin - 2}] (max_bin={max_bin}); raise max_bin or "
                f"re-encode the column."
            )


def code_cuts(cuts: torch.Tensor, cat_features, max_bin: int) -> torch.Tensor:
    """``cuts`` with each categorical feature's row the codes' midpoints
    ``arange(max_bin - 1) + 0.5``: bin c is category c."""
    if not cat_features:
        return cuts
    cuts = cuts.clone()
    cuts[list(cat_features)] = (
        torch.arange(max_bin - 1, dtype=torch.float32, device=cuts.device)
        + 0.5)
    return cuts


def sketch_and_bin(x: torch.Tensor, weight: Optional[torch.Tensor],
                   max_bin: int, coll=None, n_global: Optional[int] = None,
                   cat_features: tuple = ()):
    """The sketch -> cuts -> bins pipeline over this rank's rows ``x``, its
    merges through ``coll`` (the engine's ``distributed.Collectives``; None
    at world 1). On the card the fine histogram is summed in fixed point
    for ``n_global`` rows in the world (default: this rank's). The
    ``cat_features`` take the code cuts (``code_cuts``). Returns
    (bins [N, F], cuts [F, max_bin - 1] f32, feat_has_missing [F] bool),
    cuts and the mask the same on every rank."""
    mn, mx = feature_min_max(x)
    if coll is not None:
        mn, mx = coll.min(mn), coll.max(mx)
    qscale = None
    if x.is_cuda:
        qscale = sketch_scale(weight, x.shape[0] if n_global is None
                              else n_global,
                              None if coll is None else coll.max, x.device)
    hist = sketch_histogram(x, mn, mx, weight, qscale)
    if coll is not None:
        hist = coll.sum(hist)
    if qscale is not None:
        hist = dequantize_sketch(hist, qscale)
    cuts = code_cuts(cuts_from_sketch(mn, mx, hist, max_bin), cat_features,
                     max_bin)
    bins = bin_matrix(x, cuts, max_bin)
    missing = torch.zeros(x.shape[1], dtype=torch.int64, device=x.device)
    for lo in range(0, x.shape[0], _BLOCK_ROWS):
        missing += (bins[lo:lo + _BLOCK_ROWS] == max_bin).sum(0)
    if coll is not None:
        missing = coll.sum(missing)
    return bins, cuts, missing > 0
