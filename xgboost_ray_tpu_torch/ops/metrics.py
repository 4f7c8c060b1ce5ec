"""Evaluation metrics of the port.

Port of ``xgboost_ray_tpu/ops/metrics.py``: the elementwise metrics
``logloss`` (``:36``), ``error`` and ``error@t`` (``:43``), ``rmse``
(``:27``), ``mae``, ``rmsle``, ``mphe``, ``mape``, ``poisson-nloglik``,
``quantile`` (``:32-105``), ``mlogloss`` / ``merror`` (``:49-55``), the
survival metric ``aft-nloglik`` (``ops/survival.py:101-140``), the binned
``auc`` / ``aucpr`` (``:144-181``: a [2, 4096] (positive, negative) weight
histogram over sigmoid-score bins, merged over the ranks, the areas from
the merged bins) and the host metric ``auc_exact`` (``_auc_np``,
``:326``), the per-group ``ndcg`` / ``map`` (``rank_metric_contrib``,
``:183``: B9r in ``csrc/ranking.cu``; ``_ndcg_np`` / ``_map_np``, ``:376``,
``:392``, on the host for a set without groups; ``cox-nloglik`` is B14's,
``ops/cox.py``), with the direction early stopping takes
(``parse_metric_name``, ``is_maximize_metric``). Each elementwise metric
reduces to a (numerator, denominator) pair of weighted sums; the engine
divides on the host, as ``engine.TpuEngine.step`` does. On the card the
sums come out of K4 (``ops/objectives.round_update``: the kernel adds its
CTAs' partials) or, for K outputs, the softmax pass
(``ops/objectives.softmax_update``), and the AUC histogram out of B9a
(``auc_histogram``, ``csrc/auc.cu``).

B9a sums weights in int64 fixed point: each row's weight times a power of
two (``auc_scale``: the set's largest |weight| times its global row count
stays below 2^52), rounded to an integer, so a bin's sum does not depend
on the order its rows are added in (CTAs, ranks) and, below 2^53, is
exact in float64: the histogram joins the round's one metric all-reduce as
float64 and the merged sums are the same bits at every world size and on
every rerun. The bins are the JAX package's bit for bit
(``ops/objectives.sigmoid`` is its sigmoid); its float32 sums differ from
the exact ones by their own rounding.
"""

import ctypes
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from xgboost_ray_tpu_torch.ops import _build
from xgboost_ray_tpu_torch.ops.objectives import (
    PARTIALS,
    ObjConsts,
    first_argmax,
    label_class,
    log1p_f32,
    objective_consts,
    sigmoid,
    softmax_parts,
)


def softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def logloss_terms(margin, label):
    return torch.where(label > 0.5, softplus(-margin), softplus(margin))


def error_terms(margin, label, threshold: float = 0.5):
    p = sigmoid(margin)
    return torch.where((p > threshold) != (label > 0.5), 1.0, 0.0)


def pinball_terms(margins: torch.Tensor, label: torch.Tensor,
                  alphas: Sequence[float]) -> torch.Tensor:
    """[N] mean over the K outputs of the pinball loss ``max(a d, (a - 1)
    d)``, d = y - m (``_quantile_pinball``)."""
    if margins.dim() == 1:
        margins = margins[:, None]
    if len(alphas) != margins.shape[1]:
        if len(alphas) != 1:
            raise ValueError(
                f"quantile metric got {margins.shape[1]} margin columns but "
                f"{len(alphas)} quantile_alpha values; they must align.")
        alphas = tuple(alphas) * margins.shape[1]
    total = torch.zeros_like(label)
    for k, a in enumerate(alphas):
        a = float(np.float32(a))
        d = label - margins[:, k]
        total = total + torch.maximum(a * d, (a - 1.0) * d)
    return total / margins.shape[1]


def metric_partials(margin: torch.Tensor, label: torch.Tensor,
                    weight: torch.Tensor, metrics: Sequence[str] = (),
                    consts: Optional[ObjConsts] = None,
                    lower: Optional[torch.Tensor] = None,
                    upper: Optional[torch.Tensor] = None,
                    alphas: Sequence[float] = (),
                    margins: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[15] float64 in ``PARTIALS`` order over [N] f32 margins (float32
    sums, as the JAX metrics take them): sum(w * logloss), sum(w * wrong),
    sum(w * d^2), sum(w) always; the sums of the other terms only where
    ``metrics`` names a metric that reads them (zero elsewhere, as K4
    leaves them). ``consts``: the objective's (huber slope, AFT sigma and
    distribution, error@t's thresholds in ``error_thresholds(metrics)``'s
    order, the quantile alpha of one output);
    ``lower`` / ``upper``: the label bounds; ``margins`` [N, K] and
    ``alphas``: the quantile metric over K outputs."""
    c = consts if consts is not None else objective_consts()
    m, y, w = margin, label, weight
    d = m - y
    sums = [torch.sum(w * logloss_terms(m, y)),
             torch.sum(w * error_terms(m, y)), torch.sum(w * d * d),
             torch.sum(w)]
    zero = torch.zeros((), dtype=torch.float32, device=m.device)
    sums += [zero] * (len(PARTIALS) - 4)
    slots = {k4_slot(name, metrics) for name in metrics} - {None}
    if 4 in slots:
        sums[4] = torch.sum(w * d.abs())
    if 5 in slots:
        ls = (log1p_f32(torch.clamp(m, min=float(np.float32(-1.0 + 1e-6))))
              - log1p_f32(y))
        sums[5] = torch.sum(w * ls * ls)
    if 6 in slots:
        s = c.huber_slope
        sums[6] = torch.sum(w * (s * s * (torch.sqrt(1.0 + (d / s) ** 2)
                                          - 1.0)))
    if 7 in slots:
        sums[7] = torch.sum(w * (d / torch.clamp(y.abs(), min=1e-10)).abs())
    if 8 in slots:
        mc = torch.clamp(m, -30.0, 30.0)
        sums[8] = torch.sum(w * (torch.exp(mc) - y * mc
                                 + torch.lgamma(y + 1.0)))
    thresholds = (c.threshold, c.threshold2, c.threshold3, c.threshold4)
    for slot, t in zip(ERROR_T_SLOTS, thresholds):
        if slot in slots:
            sums[slot] = torch.sum(w * error_terms(m, y, t))
    if 10 in slots:
        from xgboost_ray_tpu_torch.ops.survival import aft_nloglik_terms

        if lower is None or upper is None:
            raise ValueError("aft-nloglik needs label_lower_bound / "
                             "label_upper_bound")
        sums[10] = torch.sum(w * aft_nloglik_terms(m, lower, upper, c))
    if 11 in slots:
        sums[11] = torch.sum(w * pinball_terms(
            m if margins is None else margins, y, alphas or (c.alpha0,)))
    return torch.stack(sums).to(torch.float64)


def mlogloss_terms(margin: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """[N] ``-log_softmax(margin)[y]`` of [N, K] margins: the label cast as
    the reference casts it, a negative class in [-K, 0) wrapping and one
    outside [-K, K) NaN, as ``take_along_axis`` gives."""
    k = margin.shape[1]
    _, d, _, s = softmax_parts(margin)
    logp = d - torch.log(s)[:, None]
    c = label_class(label)
    c = torch.where(c < 0, c + k, c)
    ok = (c >= 0) & (c < k)
    ll = -logp.gather(1, c.clamp(0, k - 1)[:, None])[:, 0]
    return torch.where(ok, ll, torch.full_like(ll, float("nan")))


def merror_terms(margin: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """[N] 1.0 where the first argmax of the margins is not the label's
    class, else 0.0."""
    return torch.where(first_argmax(margin) != label_class(label), 1.0, 0.0)


def softmax_partials(margin: torch.Tensor, label: torch.Tensor,
                     weight: torch.Tensor, logloss0: bool = False
                     ) -> torch.Tensor:
    """[3] float64: sum(w * mlogloss), sum(w * wrong), sum(w) over [N, K]
    f32 margins (float32 sums, as the JAX metrics take them); with
    ``logloss0`` [4], sum(w * logloss) of column 0 last (the reference's
    ``logloss`` under a softmax objective, ``ops/metrics.py:36``)."""
    sums = [torch.sum(weight * mlogloss_terms(margin, label)),
            torch.sum(weight * merror_terms(margin, label)),
            torch.sum(weight)]
    if logloss0:
        sums.append(torch.sum(weight * logloss_terms(margin[:, 0], label)))
    return torch.stack(sums).to(torch.float64)


def parse_metric_name(name: str) -> Tuple[str, Optional[float]]:
    """Split 'ndcg@10' / 'error@0.7' style names into (base, arg)."""
    if "@" in name:
        base, arg = name.split("@", 1)
        # xgboost's "ndcg@10-" means "minus" convention; strip trailing '-'
        return base, float(arg.rstrip("-"))
    return name, None


def is_maximize_metric(name: str) -> bool:
    """Whether a larger value of the metric is better (early stopping)."""
    base, _ = parse_metric_name(name)
    return base in ("auc", "ndcg", "map", "aucpr", "auc_exact")


#: the partial sum each K4 metric divides by the weight sum
_K4_NUMERATOR = {"logloss": "logloss", "error": "error", "rmse": "sqerr",
                 "mae": "abserr", "rmsle": "sqlogerr", "mphe": "phe",
                 "mape": "ape", "poisson-nloglik": "poisson",
                 "aft-nloglik": "aft", "quantile": "pinball"}
_SOFTMAX_NUMERATOR = {"mlogloss": "mlogloss", "merror": "merror",
                      "logloss": "logloss"}
#: the metrics read from the AUC histogram (``auc_from_hist`` and
#: ``aucpr_from_hist``) and the host metrics (computed from margins on the
#: host, combined over the ranks)
HIST_METRICS = ("auc", "aucpr")
HOST_METRICS = ("auc_exact",)
#: the per-group ranking metrics (B9r over a set's groups, ``ndcg_np`` /
#: ``map_np`` on the host for a set without them) and Cox's metric (B14)
RANK_METRICS = ("ndcg", "map")
COX_METRIC = "cox-nloglik"


#: K4's sums of ``error@t`` (t != 0.5), one a threshold, in the order the
#: run's ``eval_metric`` names the thresholds (``error_thresholds``)
ERROR_T_SLOTS = tuple(PARTIALS.index(n) for n in (
    "error_t", "error_t2", "error_t3", "error_t4"))


def error_thresholds(names: Sequence[str]) -> Tuple[float, ...]:
    """The distinct float32 thresholds t != 0.5 of the ``error@t`` metrics
    of a run, in the order ``names`` gives them (at most four: K4 has a sum
    for each)."""
    ts = []
    for name in names:
        base, arg = parse_metric_name(name)
        if base == "error" and arg is not None:
            t = float(np.float32(arg))
            if t != 0.5 and t not in ts:
                ts.append(t)
    if len(ts) > len(ERROR_T_SLOTS):
        raise NotImplementedError(
            f"eval_metric: error@t at {len(ts)} thresholds; the port sums "
            f"at most {len(ERROR_T_SLOTS)} thresholds besides 0.5 a run.")
    return tuple(ts)


def threshold_consts(names: Sequence[str]) -> Dict[str, float]:
    """``ObjConsts``' threshold fields for a run's metrics (0.5 where a slot
    is unused)."""
    ts = error_thresholds(names) + (0.5,) * len(ERROR_T_SLOTS)
    return dict(zip(("threshold", "threshold2", "threshold3", "threshold4"),
                    ts))


def k4_slot(name: str, names: Optional[Sequence[str]] = None
            ) -> Optional[int]:
    """The index in ``PARTIALS`` of the numerator of a K4 metric, None for
    a metric K4 does not sum. ``error`` at a threshold other than 0.5 has
    its own sum, its slot by the threshold's place among the run's
    (``names``: the run's metrics; ``name`` alone by default)."""
    base, arg = parse_metric_name(name)
    if base == "error" and arg is not None and float(
            np.float32(arg)) != 0.5:
        ts = error_thresholds(names if names is not None else [name])
        return ERROR_T_SLOTS[ts.index(float(np.float32(arg)))]
    num = _K4_NUMERATOR.get(base)
    return None if num is None else PARTIALS.index(num)


def check_metric(name: str, softmax: bool) -> None:
    """Raise for a metric the port does not compute for this kind of
    objective (the softmax metrics go with the softmax objectives, every
    other with the one-output and quantile ones)."""
    base, arg = parse_metric_name(name)
    if softmax:
        # the softmax pass's sums, and as the reference reads a softmax
        # model's margins: logloss on column 0, the AUCs on column 1
        ok = (base in _SOFTMAX_NUMERATOR or base in HIST_METRICS
              or base in HOST_METRICS)
    else:
        ok = (base in _K4_NUMERATOR or base in HIST_METRICS
              or base in HOST_METRICS or base in RANK_METRICS
              or name == COX_METRIC)
    if not ok or (arg is not None and base not in ("error",)
                  + RANK_METRICS):
        raise NotImplementedError(
            f"eval_metric={name!r} is not supported by xgboost_ray_tpu_torch "
            f"with {'a softmax' if softmax else 'a one-output'} objective.")


def error_threshold(names: Sequence[str]) -> float:
    """The first threshold of the ``error@t`` metrics (t != 0.5) of a run
    (K4's first ``error_t`` sum); 0.5 without one."""
    ts = error_thresholds(names)
    return ts[0] if ts else 0.5


def metric_values(sums: torch.Tensor, names: Sequence[str],
                  partials: Sequence[str] = PARTIALS,
                  hist: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Host values of the named metrics from partial sums named by
    ``partials`` (``metric_partials``' order, or the softmax pass's
    ``SOFTMAX_PARTIALS``; one device -> host read) and, for ``auc`` /
    ``aucpr``, the merged [2, 4096] AUC histogram ``hist``."""
    s = dict(zip(partials, torch.as_tensor(sums).cpu().tolist()))
    den = max(s["weight"], 1e-12)
    out = {}
    for name in names:
        base, _ = parse_metric_name(name)
        if base in HIST_METRICS:
            if hist is None:
                raise ValueError(f"metric_values: {name} needs the AUC "
                                 f"histogram")
            out[name] = (auc_from_hist(hist) if base == "auc"
                         else aucpr_from_hist(hist))
            continue
        slot = k4_slot(name, names) if partials == PARTIALS else None
        num = (PARTIALS[slot] if slot is not None
               else _SOFTMAX_NUMERATOR.get(base))
        if num not in s:
            raise NotImplementedError(f"eval_metric={name!r}")
        out[name] = s[num] / den
        if base in ("rmse", "rmsle"):
            out[name] = float(out[name]) ** 0.5
    return out


# --------------------------------------------------------------------------
# auc / aucpr: B9a's histogram and the areas from it
# --------------------------------------------------------------------------

#: sigmoid-score bins of the AUC histogram (``AUC_BINS``, ``:142``)
AUC_BINS = 4096


def auc_score(margins: torch.Tensor) -> torch.Tensor:
    """The score column AUC ranks: the margin of one output, else output
    1's (``auc_hist``)."""
    return margins[:, 0] if margins.shape[1] == 1 else margins[:, 1]


def auc_scale(max_abs_weight: float, n_global: int) -> float:
    """The power of two B9a multiplies weights by: the largest |weight|
    times the set's global row count times it stays at or below 2^52, so
    every bin's integer sum (each row rounded by at most 1/2) is exact in
    float64 after the merge."""
    total = float(max_abs_weight) * max(int(n_global), 1)
    if not total > 0 or not math.isfinite(total):
        return 1.0
    return 2.0 ** (52 - math.ceil(math.log2(total)))


def auc_bins(score: torch.Tensor) -> torch.Tensor:
    """[N] int64 bin of each score: ``clip(int(sigmoid(s) * 4096), 0,
    4095)``, the float32 -> int32 cast as XLA's (truncated, NaN to 0)."""
    p = torch.nan_to_num(sigmoid(score) * float(AUC_BINS), nan=0.0)
    return p.long().clamp(0, AUC_BINS - 1)


def auc_histogram_plain(score: torch.Tensor, label: torch.Tensor,
                        weight: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain B9a: [2, 4096] int64 (positive, negative) sums of
    ``rint(w * scale)`` over the rows' bins (a label above 0.5 positive,
    one at or below it negative, NaN neither)."""
    q = torch.round(weight.double() * scale).long()
    b = auc_bins(score)
    h = torch.zeros((2, AUC_BINS), dtype=torch.int64, device=score.device)
    h[0].index_add_(0, b, torch.where(label > 0.5, q, 0))
    h[1].index_add_(0, b, torch.where(label <= 0.5, q, 0))
    return h


#: CTAs an SM of B9a (``kCtasPerSm`` of ``csrc/auc.cu``)
AUC_CTAS_PER_SM = 2


@functools.lru_cache(maxsize=None)
def _auc_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def auc_histogram(score: torch.Tensor, label: torch.Tensor,
                  weight: torch.Tensor, scale: float) -> torch.Tensor:
    """B9a wrapper: [2, 4096] int64 (positive, negative) weight histogram
    of ``score`` [N] (a view with any row stride, e.g. a column of [N, K]
    margins) over the sigmoid bins, weights in fixed point (``scale``:
    ``auc_scale``). CPU tensors take ``auc_histogram_plain``; CUDA tensors
    launch the kernel of ``csrc/auc.cu`` once (``auc_histogram.launches``)."""
    if not score.is_cuda:
        return auc_histogram_plain(score, label, weight, scale)
    n = score.shape[0]
    dev = score.device
    if score.dtype != torch.float32 or score.dim() != 1 or (
            n > 1 and score.stride(0) < 1):
        raise ValueError("auc_histogram: score must be float32 [N]")
    for t in (label, weight):
        if (t.device != dev or t.dtype != torch.float32 or t.shape != (n,)
                or not t.is_contiguous()):
            raise ValueError("auc_histogram: label and weight must be "
                             "contiguous float32 [N] on the score's device")
    hist = torch.zeros((2, AUC_BINS), dtype=torch.int64, device=dev)
    a = _build.AucArgs()
    a.score, a.label, a.weight, a.hist = (
        _build.ptr(t) for t in (score, label, weight, hist))
    a.n, a.scale = n, float(scale)
    a.stride = score.stride(0) if n > 1 else 1
    a.grid = max(1, min(-(-n // 1024),
                        _auc_sms(dev.index) * AUC_CTAS_PER_SM))
    with torch.cuda.device(dev):
        code = _build.library("auc").xrt_auc_hist(ctypes.byref(a),
                                                  _build.stream_ptr(dev))
    _build.check(code, "B9a (auc_histogram)")
    auc_histogram.launches += 1
    return hist


auc_histogram.launches = 0


def auc_from_hist(h: np.ndarray) -> float:
    """ROC AUC from a merged [2, B] histogram (midrank ties within bins),
    ``auc_from_hist`` (``:160``) in float64 on the host."""
    pos, neg = np.asarray(h[0], np.float64), np.asarray(h[1], np.float64)
    cneg_before = np.cumsum(neg) - neg
    num = np.sum(pos * (cneg_before + 0.5 * neg))
    denom = pos.sum() * neg.sum()
    return float(num / max(denom, 1e-12)) if denom > 0 else 0.5


def aucpr_from_hist(h: np.ndarray) -> float:
    """PR AUC from a merged [2, B] histogram (step integration, high to
    low), ``aucpr_from_hist`` (``:171``) in float64 on the host."""
    pos = np.asarray(h[0], np.float64)[::-1]
    neg = np.asarray(h[1], np.float64)[::-1]
    tp, fp = np.cumsum(pos), np.cumsum(neg)
    if not h[0].sum() > 0:
        return 0.0
    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / max(tp[-1], 1e-12)
    d_recall = np.diff(recall, prepend=0.0)
    return float(np.sum(precision * d_recall))


def auc_exact_np(score: np.ndarray, label: np.ndarray,
                 weight: Optional[np.ndarray]) -> float:
    """``auc_exact``: the weighted ROC AUC as a rank statistic, ties by
    weighted midranks (``_auc_np``, ``:326``), on the host in float64."""
    score = np.asarray(score, np.float64)
    label = np.asarray(label, np.float32)
    weight = (np.ones(score.shape[0]) if weight is None or np.size(weight) == 0
              else np.asarray(weight, np.float32).astype(np.float64))
    order = np.argsort(score, kind="stable")
    s, y, w = score[order], label[order], weight[order]
    cw = np.cumsum(w)
    ranks = cw - w / 2.0
    _, inv, counts = np.unique(s, return_inverse=True, return_counts=True)
    grp_sum = np.zeros(counts.shape[0])
    grp_w = np.zeros(counts.shape[0])
    np.add.at(grp_sum, inv, ranks * w)
    np.add.at(grp_w, inv, w)
    ranks = (grp_sum / np.maximum(grp_w, 1e-12))[inv]
    pos_w = np.sum(w * (y > 0.5))
    neg_w = np.sum(w * (y <= 0.5))
    if pos_w <= 0 or neg_w <= 0:
        return 0.5
    return float((np.sum(ranks * w * (y > 0.5)) - pos_w * pos_w / 2.0)
                 / (pos_w * neg_w))


# --------------------------------------------------------------------------
# ndcg / map: B9r over a set's groups, and the host versions
# --------------------------------------------------------------------------

#: threads of a B9r CTA (``kRankThreads`` of ``csrc/ranking.cu``): the last
#: CTA sums the groups' values in that many contiguous runs
RANK_SUM_THREADS = 128


def rank_metric_cut(k: Optional[float], width: int) -> int:
    """The positions a metric reads: G without ``@k``, else ``max(1,
    min(k, G))`` over the padded G (``kk``, ``:192``)."""
    return width if k is None else max(1, min(int(k), width))


def rank_metric_groups_plain(kind: str, margin: torch.Tensor,
                             label: torch.Tensor, layout,
                             k: Optional[float] = None) -> torch.Tensor:
    """[NG] f32 ndcg@k or map@k of each group (the per-group ``val`` of the
    JAX ``rank_metric_contrib``, ``:183-246``): the group ordered by
    descending score, stable, its padding last; ndcg's DCG over the first
    ``kk`` positions with the discount 1 / log2(2 + i), 1 where the ideal
    DCG is 0; map's AP 0 where no document is relevant. Sums over the
    padded axis take ``ops/split.tree_sum``'s order."""
    from xgboost_ray_tpu_torch.ops.ranking import _log2_recip, gain_of
    from xgboost_ray_tpu_torch.ops.split import tree_sum

    n = label.shape[0]
    gsz = layout.width
    kk = rank_metric_cut(k, gsz)
    dev = label.device
    pos = torch.arange(gsz, dtype=torch.float32, device=dev)
    disc = torch.where(pos < kk, _log2_recip(2.0 + pos), 0.0)
    topk = (pos < kk).to(torch.float32)
    s_ext = torch.cat([margin.reshape(-1), margin.new_zeros(1)])
    y_ext = torch.cat([label, label.new_zeros(1)])
    rows_all = layout.padded_rows(n)
    chunk = int(np.clip(4_000_000 // max(gsz, 1), 1, 4096))
    vals = []
    for lo in range(0, layout.n_groups, chunk):
        r = rows_all[lo:lo + chunk]
        v = r < n
        s = torch.where(v, s_ext[r], float("-inf"))
        y = torch.where(v, y_ext[r], 0.0)
        order = torch.argsort(s, dim=1, descending=True, stable=True)
        ys = torch.gather(y, 1, order)
        if kind == "ndcg":
            dcg = tree_sum(gain_of(ys) * disc[None, :])
            y_ideal = torch.sort(y, dim=1, descending=True).values
            idcg = tree_sum(gain_of(y_ideal) * disc[None, :])
            val = torch.where(idcg > 0, dcg / torch.clamp(idcg, min=1e-12),
                              1.0)
        else:
            rel = (ys > 0).to(torch.float32) * topk[None, :]
            prec = torch.cumsum(rel, dim=1) / (pos + 1.0)[None, :]
            ap_num = tree_sum(prec * rel)
            ap_den = tree_sum(rel)
            val = torch.where(ap_den > 0,
                              ap_num / torch.clamp(ap_den, min=1e-12), 0.0)
        vals.append(val)
    if not vals:
        return label.new_zeros(0)
    return torch.cat(vals)


def rank_metric_sum_plain(vals: torch.Tensor) -> torch.Tensor:
    """[2] f64 (sum of the groups' values, groups) in B9r's fixed order:
    ``RANK_SUM_THREADS`` contiguous runs of ceil(NG / threads) groups, each
    summed in order in f64, then the runs' sums in order."""
    ng = vals.shape[0]
    v = vals.double().cpu().tolist()
    per = -(-ng // RANK_SUM_THREADS) if ng else 0
    total = 0.0
    for t in range(RANK_SUM_THREADS):
        part = 0.0
        for x in v[t * per:(t + 1) * per]:
            part += x
        total += part
    return torch.tensor([total, float(ng)], dtype=torch.float64)


def rank_metric_plain(kind: str, margin: torch.Tensor, label: torch.Tensor,
                      layout, k: Optional[float] = None) -> torch.Tensor:
    """Plain B9r: [2] f64 (sum of the groups' ndcg@k / map@k, groups)."""
    return rank_metric_sum_plain(
        rank_metric_groups_plain(kind, margin, label, layout, k))


def rank_metric_contrib(kind: str, margin: torch.Tensor, label: torch.Tensor,
                        layout, k: Optional[float] = None) -> torch.Tensor:
    """B9r wrapper: [2] f64 (sum over the set's groups of ndcg@k or map@k,
    groups) for margins [N] (or [N, 1]) and labels [N], on their device.
    CPU tensors take ``rank_metric_plain``; CUDA tensors launch the kernel
    of ``csrc/ranking.cu`` once (``rank_metric_contrib.launches``)."""
    from xgboost_ray_tpu_torch.ops.ranking import (
        check_group_inputs,
        rank_args,
        rank_scratch,
    )

    if kind not in RANK_METRICS:
        raise ValueError(f"rank_metric_contrib: not a ranking metric {kind!r}")
    margin = margin.reshape(-1)
    if not label.is_cuda:
        return rank_metric_plain(kind, margin, label, layout, k)
    check_group_inputs("rank_metric_contrib", margin, label, layout)
    dev = label.device
    out = torch.zeros(2, dtype=torch.float64, device=dev)
    ng = layout.n_groups
    if ng == 0:
        return out
    vals = torch.empty(ng, dtype=torch.float32, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    scratch = rank_scratch(layout, label.shape[0], dev)
    a = rank_args(margin, label, layout, RANK_METRICS.index(kind),
                  rank_metric_cut(k, layout.width))
    a.scratch, a.vals, a.ticket, a.out = (_build.ptr(t) for t in (
        scratch, vals, ticket, out))
    a.threads = RANK_SUM_THREADS
    with torch.cuda.device(dev):
        code = _build.library("ranking").xrt_rank_metric(
            ctypes.byref(a), _build.stream_ptr(dev))
    _build.check(code, "B9r (rank_metric_contrib)")
    rank_metric_contrib.launches += 1
    return out


rank_metric_contrib.launches = 0


def _dcg_at(labels: np.ndarray, k: int) -> float:
    labels = labels[:k]
    gains = (2.0 ** labels - 1.0) / np.log2(np.arange(2, labels.size + 2))
    return float(np.sum(gains))


def ndcg_np(score: np.ndarray, label: np.ndarray, group_ptr: np.ndarray,
            k: int) -> float:
    """Mean NDCG@k over query groups on the host in float64 (``_ndcg_np``,
    ``:376``). group_ptr: [n_groups+1] row offsets."""
    total, n_groups = 0.0, 0
    for g in range(group_ptr.size - 1):
        lo, hi = group_ptr[g], group_ptr[g + 1]
        if hi <= lo:
            continue
        ls, ss = label[lo:hi], score[lo:hi]
        order = np.argsort(-ss, kind="stable")
        dcg = _dcg_at(ls[order], k)
        ideal = _dcg_at(np.sort(ls)[::-1], k)
        total += (dcg / ideal) if ideal > 0 else 1.0
        n_groups += 1
    return total / max(n_groups, 1)


def map_np(score: np.ndarray, label: np.ndarray, group_ptr: np.ndarray,
           k: int) -> float:
    """Mean average precision@k over groups (binary relevance: label > 0)
    on the host in float64 (``_map_np``, ``:392``)."""
    total, n_groups = 0.0, 0
    for g in range(group_ptr.size - 1):
        lo, hi = group_ptr[g], group_ptr[g + 1]
        if hi <= lo:
            continue
        ls = (label[lo:hi] > 0).astype(np.float64)
        order = np.argsort(-score[lo:hi], kind="stable")
        rel = ls[order][:k]
        if rel.sum() == 0:
            total += 0.0
        else:
            prec = np.cumsum(rel) / np.arange(1, rel.size + 1)
            total += float(np.sum(prec * rel) / rel.sum())
        n_groups += 1
    return total / max(n_groups, 1)


def rank_metric_np(name: str, margin: np.ndarray, label: np.ndarray,
                   group_ptr: Optional[np.ndarray]) -> float:
    """A ranking metric of a set on the host (``compute_metric``,
    ``:521-526``): its groups, or the whole set as one group without."""
    base, arg = parse_metric_name(name)
    label = np.asarray(label, np.float32)
    if group_ptr is None:
        group_ptr = np.array([0, label.shape[0]], dtype=np.int64)
    k = int(arg) if arg is not None else (2 ** 31 - 1)
    fn = ndcg_np if base == "ndcg" else map_np
    margin = np.asarray(margin, np.float32)
    score = margin[:, 0] if margin.ndim == 2 else margin
    return fn(score.astype(np.float64), label.astype(np.float64), group_ptr,
              k)
