"""``survival:cox``: the Breslow partial likelihood and B14.

Port of ``xgboost_ray_tpu/ops/objectives.py``: ``cox_risk_terms``
(``:399-444``), ``_make_cox`` (``:447-483``: g = r S1 - ev, h = max(r S1 -
r^2 S2, 1e-16), the hazard ratio exp(margin) as the prediction, base score
s to the margin log(max(s, 1e-16))) and ``ops/metrics.py``'s
``cox_nloglik_global`` (``:263-280``). A label is a time to the event; a
negative one is right-censored at its magnitude (xgboost's convention).

The risk set of every event spans all rows of the world, so at world > 1
each rank gathers the margins every round (and the labels and weights once,
at set-up: ``distributed.Collectives.all_gather``), computes the global
terms and keeps its own rows' (g, h), as the JAX package gathers them with
``lax.all_gather`` (``:384-397``). ``cox-nloglik`` is then the same on
every rank and is not summed over the ranks again (``metrics.py:301-306``).

The sort by time and the two ``searchsorted`` depend on the labels alone:
``cox_setup`` makes them once per set (``order``, and the counts of rows
with a time at or above, and above, each row's), bit for bit the JAX
package's per-round ones. A round (``cox_round``) is then B14 (CUDA C++,
``csrc/cox.cu``): M = the largest margin of a weighted row (0 where there
is none), r = w exp(m - M) in time order, its inclusive scan, D, the
scans of ev / D and ev / D^2, S1 and S2, and the rows' (g, h); with the
metric, ev (log D + M - m) summed. Every scan is XLA's CPU ``cumsum``
order (``ops/split.blocked_cumsum``: in order within blocks of 16, the
block totals scanned the same way, each block adding the scan of the
blocks before it), so the plain version (``cox_round_plain``) is the JAX
package's bit for bit, and the kernel the plain version's.
"""

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from xgboost_ray_tpu_torch.ops import _build
from xgboost_ray_tpu_torch.ops.objectives import _fma, _ftz, exp_f32, log_f32
from xgboost_ray_tpu_torch.ops.split import blocked_cumsum

#: CTAs x threads of B14's metric sum (``kSumCtas`` / ``kThreads`` of
#: ``csrc/cox.cu``): thread t of that grid sums the rows t, t + T, ... in
#: f64, then the last CTA's thread j the j-th run of T / threads partials,
#: then its thread 0 the runs in order
COX_SUM_CTAS = 256
COX_THREADS = 256
#: the scan block (XLA's CPU cumsum order)
SCAN_BLOCK = 16


@dataclasses.dataclass
class CoxSetup:
    """What a set's labels alone fix (``cox_setup``): ``order`` [N] the
    rows by descending time, stable; ``cnt_ge`` / ``cnt_gt`` [N] the rows
    with a time at or above / above each row's; all int64 on the set's
    device, over the world's rows."""

    order: torch.Tensor
    cnt_ge: torch.Tensor
    cnt_gt: torch.Tensor


def cox_setup(label: torch.Tensor) -> CoxSetup:
    """The sort by time and the two searchsorted of ``cox_risk_terms``
    (``jnp.argsort`` is stable; ``searchsorted`` right and left), once per
    set: ``torch.sort(stable=True)`` as the JAX package sorts with XLA's
    argsort outside any kernel."""
    neg_t = -label.abs()
    neg_ts, order = torch.sort(neg_t, stable=True)
    cnt_ge = torch.searchsorted(neg_ts, neg_t, right=True)
    cnt_gt = torch.searchsorted(neg_ts, neg_t, right=False)
    return CoxSetup(order, cnt_ge, cnt_gt)


def _max_margin(m: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """M: the largest margin of a row with w > 0 (NaN-propagating), 0 where
    that is not finite (no such row)."""
    mw = torch.where(w > 0, m, torch.full_like(m, float("-inf")))
    mm = mw.max() if m.numel() else m.new_tensor(float("-inf"))
    return torch.where(torch.isfinite(mm), mm, torch.zeros_like(mm))


def risk_denominator(cum: torch.Tensor) -> torch.Tensor:
    """D = ``jnp.maximum(D, 1e-38)`` as the reference's CPU program computes
    it: the constant 1e-38 is a subnormal float32, which XLA flushes to
    zero, so the clamp is at 0 (a risk set of zero weight gives D = 0 and
    its events' terms 0 / 0, NaN, there as here)."""
    return torch.clamp(_ftz(cum), min=0.0)


def cox_risk_terms(m: torch.Tensor, label: torch.Tensor, w: torch.Tensor,
                   setup: Optional[CoxSetup] = None):
    """The JAX ``cox_risk_terms`` over the world's rows: (r, ev, S1, S2,
    logD), each [N] f32, as the reference's CPU program computes them."""
    setup = cox_setup(label) if setup is None else setup
    mm = _max_margin(m, w)
    r = _ftz(w * _ftz(exp_f32(_ftz(m - mm))))
    ev = w * (label > 0).to(torch.float32)
    order = setup.order
    cum_r = blocked_cumsum(r[order])
    d = risk_denominator(cum_r[torch.clamp(setup.cnt_ge - 1, min=0)])
    log_d = log_f32(d) + mm
    d_sorted = d[order]
    evs = ev[order]
    zero = m.new_zeros(1)
    pref1 = torch.cat([zero, blocked_cumsum(evs / d_sorted)])
    pref2 = torch.cat([zero, blocked_cumsum(evs / (d_sorted * d_sorted))])
    s1 = pref1[-1] - pref1[setup.cnt_gt]
    s2 = pref2[-1] - pref2[setup.cnt_gt]
    return r, ev, s1, s2, log_d


def cox_gh_terms(r: torch.Tensor, ev: torch.Tensor, s1: torch.Tensor,
                 s2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g = r S1 - ev and h = max(r S1 - r^2 S2, 1e-16), each multiply-add
    fused as XLA's CPU program fuses it."""
    g = _fma(r, s1, -ev)
    h = torch.clamp(_fma(r, s1, -((r * r) * s2)), min=1e-16)
    return g, h


def cox_metric_sum_plain(terms: torch.Tensor, ev: torch.Tensor
                         ) -> torch.Tensor:
    """[2] f64 (sum of ev (log D + M - m), sum of ev) in B14's order: thread
    t of T = ``COX_SUM_CTAS`` x ``COX_THREADS`` adds rows t, t + T, ... in
    f64 from 0.0, then ``COX_THREADS`` contiguous runs of the T partials
    each in order, then the runs in order."""
    t_all = COX_SUM_CTAS * COX_THREADS
    out = []
    for x in (terms, ev):
        n = x.shape[0]
        k = -(-n // t_all)
        pad = torch.zeros(k * t_all, dtype=torch.float64)
        pad[:n] = x.detach().cpu().double()
        acc = torch.zeros(t_all, dtype=torch.float64)
        for block in pad.view(k, t_all):
            acc += block
        per = t_all // COX_THREADS
        total = 0.0
        for run in acc.view(COX_THREADS, per).tolist():
            part = 0.0
            for v in run:
                part += v
            total += part
        out.append(total)
    return torch.tensor(out, dtype=torch.float64)


def cox_round_plain(m: torch.Tensor, label: torch.Tensor, w: torch.Tensor,
                    setup: CoxSetup, offset: int = 0,
                    n_local: Optional[int] = None, with_metric: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain B14: (gh [n_local, 2] f32 of this rank's rows ``offset`` ..
    ``offset + n_local`` of the world's, the ``cox-nloglik`` sums [2] f64
    or None) from the world's margins [N], labels and weights."""
    m = m.reshape(-1)
    n_local = m.shape[0] - offset if n_local is None else n_local
    r, ev, s1, s2, log_d = cox_risk_terms(m, label, w, setup)
    g, h = cox_gh_terms(r, ev, s1, s2)
    sl = slice(offset, offset + n_local)
    gh = torch.stack([g[sl], h[sl]], dim=1)
    if not with_metric:
        return gh, None
    return gh, cox_metric_sum_plain(ev * (log_d - m), ev)


class CoxArgs(ctypes.Structure):
    """``XrtCoxArgs`` of ``csrc/cox.cu``: one B14 call, passed by pointer
    (edit both together)."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "margin", "label", "weight", "order", "cnt_ge", "cnt_gt", "gh",
        "cum", "t1", "t2", "stat", "part", "ticket", "out")]
        + [(name, ctypes.c_longlong) for name in ("n", "offset", "n_local")]
        + [("with_metric", ctypes.c_int)])


def scan_levels(n: int) -> int:
    """Floats of a blocked scan's workspace over n values: the values and
    the block totals of every level above (n / 16 + n / 256 + ...)."""
    total, length = 0, n
    while True:
        total += length
        if length <= SCAN_BLOCK:
            return total
        length = -(-length // SCAN_BLOCK)


def cox_round(m: torch.Tensor, label: torch.Tensor, w: torch.Tensor,
              setup: CoxSetup, offset: int = 0,
              n_local: Optional[int] = None, with_metric: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """B14 wrapper: (gh [n_local, 2] f32 of this rank's rows, the metric
    sums [2] f64 or None) from the world's margins [N] (or [N, 1]), labels,
    weights and ``setup``. CPU tensors take ``cox_round_plain``; CUDA
    tensors run the kernels of ``csrc/cox.cu`` (one call a round:
    ``cox_round.launches``)."""
    m = m.reshape(-1)
    n = label.shape[0]
    n_local = n - offset if n_local is None else n_local
    if not label.is_cuda:
        return cox_round_plain(m, label, w, setup, offset, n_local,
                               with_metric)
    dev = label.device
    for t in (m, label, w):
        if (t.device != dev or t.dtype != torch.float32 or t.numel() != n
                or not t.is_contiguous()):
            raise ValueError("cox_round: margin, label and weight must be "
                             "contiguous float32 [N] on one device")
    for t in (setup.order, setup.cnt_ge, setup.cnt_gt):
        if t.device != dev or t.dtype != torch.int64 or t.shape != (n,):
            raise ValueError("cox_round: the set-up must be int64 [N] on "
                             "the rows' device")
    if offset < 0 or n_local < 0 or offset + n_local > n:
        raise ValueError("cox_round: this rank's rows lie outside [0, N)")
    gh = torch.empty((n_local, 2), dtype=torch.float32, device=dev)
    out = torch.zeros(2, dtype=torch.float64, device=dev)
    if n == 0:
        return gh, (out if with_metric else None)
    words = scan_levels(n)
    cum = torch.empty(words, dtype=torch.float32, device=dev)
    t12 = torch.empty((2, words), dtype=torch.float32, device=dev)
    stat = torch.empty(2, dtype=torch.float32, device=dev)
    part = torch.empty((COX_SUM_CTAS * COX_THREADS, 2), dtype=torch.float64,
                       device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    a = CoxArgs()
    (a.margin, a.label, a.weight, a.order, a.cnt_ge, a.cnt_gt, a.gh, a.cum,
     a.t1, a.t2, a.stat, a.part, a.ticket, a.out) = (
        _build.ptr(t) for t in (
            m, label, w, setup.order, setup.cnt_ge, setup.cnt_gt, gh, cum,
            t12[0], t12[1], stat, part, ticket, out))
    a.n, a.offset, a.n_local = n, offset, n_local
    a.with_metric = int(with_metric)
    with torch.cuda.device(dev):
        code = _build.library("cox").xrt_cox_round(ctypes.byref(a),
                                                   _build.stream_ptr(dev))
    _build.check(code, "B14 (cox_round)")
    cox_round.launches += 1
    return gh, (out if with_metric else None)


cox_round.launches = 0


def cox_round_bytes(n: int, n_local: int, with_metric: bool) -> int:
    """The bytes B14 must move a round, for its bound: the margin, label
    and weight of every row read once, the three int64 set-up arrays read
    once, the (g, h) pairs of this rank's rows written once (each scan's
    intermediates stay a kernel's own)."""
    return n * (3 * 4 + 3 * 8) + n_local * 8 + (16 if with_metric else 0)
