"""Objectives of this slice and K4, the fused per-round elementwise pass.

Port of ``xgboost_ray_tpu/ops/objectives.py`` for ``binary:logistic``
(``_make_logistic``, ``:88``) and ``reg:squarederror``
(``_make_squarederror``, ``:57``), with the base_score -> margin maps,
the prediction transforms (``:99``, ``:66``) and ``get_objective``
(``:485``). The transform of ``binary:logistic`` is ``jax.nn.sigmoid`` in
the reference; ``sigmoid`` below is bitwise equal to it on the CPU.

K4 (CUDA C++, ``csrc/objective.cu``) fuses the end of boosting round i
with the start of round i+1 in one pass over the rows: ``margin +=
row_value`` (the new tree's leaf value per row), the metric partial sums on
the new margin (logloss, error, squared error, weight: ``ops/metrics.py``
``_logloss``/``_error``/``_rmse``), and the next round's (g, h). Round 0
runs it with ``row_value = 0``. Its eval mode (``with_gh=False``) serves a
held-out eval set: the same margin add and partials over that set's rows
(its ``row_value`` from B4, ``ops/grow.predict_tree_binned``), no (g, h)
written; the partials replace the eval metrics of the reference's round
(``engine.py:1427-1462``). What bounds it: bytes — four f32 reads and the
margin's write per row, plus the (g, h) pair; ``k4_plan`` sizes its
persistent grid from the row count and the SMs, and one launch gives the
[4] f64 sums (the last CTA adds the CTAs' f32 quadruples). The port has no
Triton kernel. ``max(p (1 - p), 1e-16)`` and the softplus form of the
logloss are kept as the JAX functions write them. The plain version
evaluates the sigmoid with the reference's own float32 exp (``exp_f32``)
and reads and flushes subnormals as the reference's CPU program does
(``grad_hess``), so on the CPU the gradients equal the JAX package's bit
for bit, and the kernel's equal the plain version's.

``multi:softprob`` / ``multi:softmax`` with K = ``num_class`` outputs
(``_make_softmax``, ``:107-128``): ``p = softmax(m)``, ``g = (p -
onehot(y)) w``, ``h = max(2 p (1 - p), 1e-16) w``, a zero base margin, the
probabilities or the first argmax as the prediction. Their pass over the
rows is the softmax pass (CUDA C++, ``csrc/softmax.cu``; ``softmax_plan``
picks its path), K4's counterpart for K outputs,
in three modes: training (``softmax_update``: the K trees' row values
added to the [N, K] margins, the ``mlogloss``/``merror``/weight partials,
the next round's gradients as [K, N, 2] planes, class k's [N, 2]
contiguous for K1-K3), eval (the same without gradients) and transform
(``softmax_transform``: probabilities or classes from margins, for predict
and serve). The plain versions follow the reference's compiled CPU
program bit for bit: the max over classes in class order, the sum as XLA's
CPU reduce takes it (in class order up to 32 classes, a window-32 tree
above: ``ops/split.tree_sum``), the Cephes exp (``exp_f32``), a subnormal
result flushed to zero as XLA's CPU flushes it, labels cast to int32 as
XLA casts them (truncated, saturated, NaN to 0).
"""

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from xgboost_ray_tpu_torch.ops import _build
from xgboost_ray_tpu_torch.ops.split import tree_sum

LOGISTIC = "binary:logistic"
SQUARED = "reg:squarederror"
SOFTPROB = "multi:softprob"
SOFTMAX = "multi:softmax"

#: metric partial sums written by K4, in this order
PARTIALS = ("logloss", "error", "sqerr", "weight")
#: metric partial sums written by the softmax pass, in this order
SOFTMAX_PARTIALS = ("mlogloss", "merror", "weight")


@dataclasses.dataclass(frozen=True)
class Objective:
    name: str
    default_metric: str
    default_base_score: float = 0.5
    #: outputs per row: 1, or num_class for the softmax objectives
    num_outputs: int = 1

    @property
    def logistic(self) -> bool:
        return self.name == LOGISTIC

    @property
    def softmax(self) -> bool:
        return self.name in _ZERO_BASE

    @property
    def partials(self) -> Tuple[str, ...]:
        """The names of the metric partial sums its round pass writes."""
        return SOFTMAX_PARTIALS if self.softmax else PARTIALS

    def base_score_to_margin(self, s: float) -> float:
        if self.softmax:
            return 0.0
        if not self.logistic:
            return float(s)
        if not 0 < s < 1:
            return 0.0
        # float32 log of the python ratio, as the JAX package computes it
        return float(torch.log(torch.tensor(s / (1.0 - s), dtype=torch.float32)))

    def transform(self, margin: torch.Tensor) -> torch.Tensor:
        """[N, K] margins -> predictions on the margins' device: [N]
        probabilities for ``binary:logistic``, the margin itself for
        ``reg:squarederror``, [N, K] probabilities for ``multi:softprob``,
        [N] classes (f32) for ``multi:softmax``."""
        if self.softmax:
            return softmax_transform_plain(margin, self.name == SOFTPROB)
        return sigmoid(margin[:, 0]) if self.logistic else margin[:, 0]


def get_objective(name: str, num_class: int = 0) -> Objective:
    """The objective ``name``; the softmax objectives take ``num_class``
    (>= 2) outputs."""
    if name == LOGISTIC:
        return Objective(name, default_metric="logloss")
    if name == SQUARED:
        return Objective(name, default_metric="rmse")
    if name in _ZERO_BASE:
        if num_class < 2:
            raise ValueError("multi:* objectives require num_class >= 2")
        return Objective(name, default_metric=(
            "mlogloss" if name == SOFTPROB else "merror"),
            num_outputs=int(num_class))
    raise NotImplementedError(
        f"objective={name!r} is not supported by xgboost_ray_tpu_torch yet "
        f"({LOGISTIC} | {SQUARED} | {SOFTPROB} | {SOFTMAX}; the others are "
        f"ROADMAP queue A10)."
    )


#: objectives whose base_score maps to a zero margin (``:125``)
_ZERO_BASE = (SOFTPROB, SOFTMAX)


def base_score_margin(name: str, base_score: float) -> float:
    """The margin a model starts from (``Objective.base_score_to_margin``),
    also for a model of an objective the port predicts margins of but does
    not train."""
    if name in _ZERO_BASE:
        return 0.0
    return get_objective(name).base_score_to_margin(base_score)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add: the product of two float32 values is exact
    in float64, so a*b + c rounds once there and once to float32."""
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a.double() * b + c).to(torch.float32)


_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
          1.6666665459e-1, 5.0000001201e-1)


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def exp_f32(v: torch.Tensor) -> torch.Tensor:
    """float32 exp as the JAX package's compiled CPU program evaluates it:
    Cephes' range reduction and degree-5 polynomial, every multiply-add
    fused. Bitwise equal to it for |v| <= 87 (beyond, the reference flushes
    subnormal results and clamps later; ``sigmoid`` is equal either way), so
    the plain path's gradients are the reference's."""
    xc = torch.clamp(v, _f32(-88.3762626647949), _f32(88.3762626647950))
    fx = torch.floor(_fma(xc, _f32(1.44269504088896341), 0.5))
    x = _fma(fx, -_f32(0.693359375), xc)
    x = _fma(fx, _f32(2.12194440e-4), x)
    z = x * x
    y = _fma(x, _f32(_EXP_P[0]), _f32(_EXP_P[1]))
    for c in _EXP_P[2:]:
        y = _fma(y, x, _f32(c))
    y = 1.0 + _fma(y, z, x)
    scale = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.maximum(y * scale, v)


_F32_TINY = 2.0 ** -126  # smallest normal float32


def sigmoid(m: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid's compiled form: 1 / (1 + exp(-m)), with a subnormal
    result flushed to zero as the reference's CPU program flushes it."""
    p = 1.0 / (1.0 + exp_f32(-m))
    return torch.where(p < _F32_TINY, torch.zeros((), dtype=p.dtype,
                                                  device=p.device), p)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """A subnormal float32 flushed to a zero of its sign, as the
    reference's CPU program flushes every result and reads every operand."""
    return torch.where(x.abs() < _F32_TINY, x * 0.0, x)


def grad_hess(margin: torch.Tensor, label: torch.Tensor, weight: torch.Tensor,
              logistic: bool, scale_pos_weight: float = 1.0):
    """(g, h), each [N] f32 — the JAX closures' formulas as the reference's
    CPU program evaluates them: subnormal margins, labels and weights read
    as zero and every subnormal difference or product flushed (``_ftz``);
    the squared error's h is the weight itself, as there."""
    m, y, w = _ftz(margin), _ftz(label), _ftz(weight)
    if logistic:
        p = sigmoid(m)
        w = _ftz(w * torch.where(y > 0.5, scale_pos_weight, 1.0))
        g = _ftz(_ftz(p - y) * w)
        h = _ftz(torch.clamp(p * (1.0 - p), min=1e-16) * w)
        return g, h
    return _ftz(_ftz(m - y) * w), weight


def round_update_plain(margin: torch.Tensor, row_value: torch.Tensor,
                       label: torch.Tensor, weight: torch.Tensor,
                       logistic: bool, scale_pos_weight: float = 1.0,
                       with_gh: bool = True
                       ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain PyTorch K4: updates ``margin`` in place; returns (gh [N, 2], or
    None without ``with_gh``, partial sums [4] f64 in ``PARTIALS`` order)."""
    from xgboost_ray_tpu_torch.ops.metrics import metric_partials

    margin.add_(row_value)
    sums = metric_partials(margin, label, weight)
    if not with_gh:
        return None, sums
    g, h = grad_hess(margin, label, weight, logistic, scale_pos_weight)
    return torch.stack([g, h], dim=1), sums


#: rows a tile of K4 (``kTileRows`` of ``csrc/objective.cu``: 512 threads
#: of 4 rows) and the most CTAs an SM its persistent grid takes
K4_TILE_ROWS = 2048
K4_CTAS_PER_SM = 2
_K4_MODES = {"eval": 0, "logistic": 1, "squared": 2}


class K4Plan(NamedTuple):
    """How one K4 launch maps N rows: ``tiles`` tiles of ``K4_TILE_ROWS``
    rows, CTA c taking tiles c, c + grid, c + 2 grid, ... in order."""

    tiles: int
    grid: int


@functools.lru_cache(maxsize=None)
def k4_plan(n: int, sm_count: int) -> K4Plan:
    """K4's persistent grid for N rows on a card of ``sm_count`` SMs: a CTA
    a tile up to ``K4_CTAS_PER_SM`` CTAs an SM (at least one CTA, which
    writes zero sums for N = 0). It depends on N and the card only, never
    on the mode, so the eval mode sums the same rows in the same CTAs as
    the gh mode: their partials are bitwise equal."""
    tiles = -(-n // K4_TILE_ROWS)
    return K4Plan(tiles, max(1, min(tiles, sm_count * K4_CTAS_PER_SM)))


@functools.lru_cache(maxsize=None)
def _k4_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _k4_workspace(device_index: int, stream: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ticket [1] int32, zero between launches; partials [grid, 4] f32 for
    the largest grid) of the launches on one stream of one card: launches
    on one stream run in order, so they share them."""
    dev = torch.device("cuda", device_index)
    rows = _k4_sms(device_index) * K4_CTAS_PER_SM
    return (torch.zeros(1, dtype=torch.int32, device=dev),
            torch.empty((rows, 4), dtype=torch.float32, device=dev))


def _k4_args(plan: K4Plan, margin: torch.Tensor, row_value: torch.Tensor,
             label: torch.Tensor, weight: torch.Tensor,
             gh: Optional[torch.Tensor], part: torch.Tensor,
             ticket: torch.Tensor, out: torch.Tensor, logistic: bool,
             scale_pos_weight: float) -> "_build.K4Args":
    """One launch's ``XrtK4Args``: the eval mode where ``gh`` is None."""
    a = _build.K4Args()
    a.margin, a.row_value, a.label, a.weight, a.gh, a.part, a.ticket, a.out = (
        _build.ptr(t) for t in (margin, row_value, label, weight, gh, part,
                                ticket, out))
    a.n, a.grid = margin.shape[0], plan.grid
    a.mode = _K4_MODES["eval" if gh is None else
                       "logistic" if logistic else "squared"]
    a.scale_pos_weight = scale_pos_weight
    return a


def round_update(margin: torch.Tensor, row_value: torch.Tensor,
                 label: torch.Tensor, weight: torch.Tensor, logistic: bool,
                 scale_pos_weight: float = 1.0, with_gh: bool = True
                 ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """K4 wrapper: updates ``margin`` in place; returns (gh [N, 2], or None
    without ``with_gh``, partial sums [4] f64 in ``PARTIALS`` order). CPU
    tensors take the plain version; CUDA tensors launch the kernel of
    ``csrc/objective.cu`` once (``round_update.launches`` counts every
    launch, ``round_update.eval_launches`` those of the eval mode)."""
    if not margin.is_cuda:
        return round_update_plain(margin, row_value, label, weight, logistic,
                                  scale_pos_weight, with_gh)
    n = margin.shape[0]
    for t in (margin, row_value, label, weight):
        if (t.device != margin.device or t.dtype != torch.float32
                or t.shape != (n,) or not t.is_contiguous()):
            raise ValueError(
                "round_update: margin, row_value, label and weight must be "
                "contiguous float32 [N] tensors on one CUDA device"
            )
    dev = margin.device
    stream = _build.stream_ptr(dev)
    ticket, part = _k4_workspace(dev.index, stream)
    gh = (torch.empty((n, 2), dtype=torch.float32, device=dev)
          if with_gh else None)
    out = torch.empty(4, dtype=torch.float64, device=dev)
    a = _k4_args(k4_plan(n, _k4_sms(dev.index)), margin, row_value, label,
                 weight, gh, part, ticket, out, logistic, scale_pos_weight)
    with torch.cuda.device(dev):
        code = _build.library("objective").xrt_k4(ctypes.byref(a), stream)
    _build.check(code, "K4 (round_update)")
    round_update.launches += 1
    if not with_gh:
        round_update.eval_launches += 1
    return gh, out


round_update.launches = 0
round_update.eval_launches = 0


# --------------------------------------------------------------------------
# multi:softprob / multi:softmax and the softmax pass
# --------------------------------------------------------------------------


def label_class(label: torch.Tensor) -> torch.Tensor:
    """[N] int64 class index of f32 labels, cast as XLA casts float32 to
    int32 (``label.astype(jnp.int32)``): truncated toward zero, saturated,
    NaN to 0. No range check, as in the reference: a label outside [0, K)
    has no one-hot entry and its ``mlogloss`` term is NaN (below -K) or
    wraps (in [-K, 0))."""
    v = torch.nan_to_num(label.double(), nan=0.0)
    return v.clamp(-2.0 ** 31, 2.0 ** 31 - 1).trunc().long()


def first_argmax(v: torch.Tensor) -> torch.Tensor:
    """[N] int64 index of each row's first maximum of ``v`` [N, K]
    (``jnp.argmax``: a NaN counts as the maximum, the first one wins)."""
    best = v[:, 0]
    arg = torch.zeros(v.shape[0], dtype=torch.int64, device=v.device)
    for k in range(1, v.shape[1]):
        vk = v[:, k]
        better = (vk > best) | (torch.isnan(vk) & ~torch.isnan(best))
        best = torch.where(better, vk, best)
        arg = torch.where(better, k, arg)
    return arg


def softmax_parts(m: torch.Tensor):
    """The reference's softmax of [N, K] margins: (row max [N], shifted
    ``m - max`` [N, K], ``exp(shifted)`` [N, K], their sum [N]), each step
    flushed as the reference's CPU program flushes it. The sum is XLA's
    CPU reduce over the class axis (``ops/split.tree_sum``): in class order
    up to 32 classes, above that windows of 32 over the zero-padded axis
    (half the padding in front), each window and then the window sums added
    in order."""
    mx = m[:, 0]
    for k in range(1, m.shape[1]):
        mx = torch.maximum(mx, m[:, k])
    d = _ftz(m - mx[:, None])
    e = _ftz(exp_f32(d))
    return mx, d, e, tree_sum(e)


def softmax_probs(m: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(m, axis=-1)`` of [N, K] f32 margins, bitwise its
    compiled CPU form."""
    _, _, e, s = softmax_parts(m)
    return _ftz(e / s[:, None])


def softmax_grad_hess(margin: torch.Tensor, label: torch.Tensor,
                      weight: torch.Tensor):
    """(g, h), each [N, K] f32: ``_make_softmax``'s closure."""
    k = margin.shape[1]
    p = softmax_probs(margin)
    y = (label_class(label)[:, None]
         == torch.arange(k, device=margin.device)[None, :]).to(p.dtype)
    w = weight[:, None]
    g = _ftz((p - y) * w)
    h = _ftz(torch.clamp(2.0 * p * (1.0 - p), min=1e-16) * w)
    return g, h


def softmax_transform_plain(margin: torch.Tensor, prob: bool) -> torch.Tensor:
    """Plain softmax pass, transform mode: [N, K] probabilities
    (``multi:softprob``) or [N] f32 first-argmax classes of the
    probabilities (``multi:softmax``) from [N, K] margins."""
    p = softmax_probs(margin)
    return p if prob else first_argmax(p).to(torch.float32)


def softmax_update_plain(margin: torch.Tensor, row_value: torch.Tensor,
                         label: torch.Tensor, weight: torch.Tensor,
                         with_gh: bool = True
                         ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain softmax pass, training and eval modes: adds ``row_value``
    [K, N] to ``margin`` [N, K] in place; returns (gh [K, N, 2], or None
    without ``with_gh``, partial sums [3] f64 in ``SOFTMAX_PARTIALS``
    order)."""
    from xgboost_ray_tpu_torch.ops.metrics import softmax_partials

    margin.add_(row_value.T)
    sums = softmax_partials(margin, label, weight)
    if not with_gh:
        return None, sums
    g, h = softmax_grad_hess(margin, label, weight)
    return torch.stack([g.T, h.T], dim=2).contiguous(), sums


#: rows a CTA of the softmax pass takes, one a thread (kThreads of
#: ``csrc/softmax.cu``)
SMX_ROWS_PER_CTA = 256
#: the register path's compile-time bounds on K (KMAX of the kernel)
SMX_KMAX = (4, 8, 16, 32)
_SMX_LEVELS = 6  # kLevels of the kernel: the wide path takes K <= 32^6
_SMX_MODES = {"train": 0, "eval": 1, "prob": 2, "class": 3}


class SoftmaxPlan(NamedTuple):
    """How one launch of the softmax pass maps its work
    (``csrc/softmax.cu``): ``kmax`` 4-32 is the register path (persistent
    CTAs, their rows staged at ``pitch`` floats a row in two stage buffers,
    ``shared_bytes`` of shared memory, which the launch takes), 0 the wide
    path (K > 32: the class sum's window tree ``front0``, ``top``,
    ``front``)."""

    kmax: int
    pitch: int
    shared_bytes: int
    front0: int
    top: int
    front: Tuple[int, ...]


@functools.lru_cache(maxsize=None)
def softmax_plan(k: int, mode: str = "train") -> SoftmaxPlan:
    """The softmax pass's path for K classes in ``mode`` (``train``,
    ``eval``, ``prob``, ``class``): up to 32 the register path of the
    least bound of ``SMX_KMAX`` at or above K, its rows staged at a pitch
    of K floats (K odd) or K + 1 (K even: thread r's reads of its row fall
    in distinct banks), two stage buffers of 256 rows (in training and eval
    mode with their K row values, labels and weights: ``shared_bytes``);
    above 32 the wide path with the window tree of ``ops/split.tree_sum``
    over K classes."""
    if k < 2:
        raise ValueError(f"softmax pass: K = {k} < 2 classes")
    if k <= SMX_KMAX[-1]:
        kmax = next(b for b in SMX_KMAX if b >= k)
        pitch = k + 1 - k % 2
        labels = k + 2 if _SMX_MODES[mode] <= _SMX_MODES["eval"] else 0
        return SoftmaxPlan(kmax, pitch,
                           2 * 4 * SMX_ROWS_PER_CTA * (pitch + labels), 0, 0,
                           (0,) * _SMX_LEVELS)
    from xgboost_ray_tpu_torch.ops.predict import tree_windows

    front0, _, top, _, front = tree_windows(k)
    if top >= _SMX_LEVELS:
        raise ValueError(f"softmax pass: K = {k} classes exceed the kernel's "
                         f"{_SMX_LEVELS - 1} window levels")
    return SoftmaxPlan(0, 0, 0, front0, top,
                       tuple(front[:_SMX_LEVELS])
                       + (0,) * (_SMX_LEVELS - len(front)))


def _smx_args(mode: str, margin: torch.Tensor, row_value=None, label=None,
              weight=None, gh=None, part=None, out=None):
    n, k = margin.shape
    plan = softmax_plan(k, mode)
    a = _build.SoftmaxArgs()
    a.margin = margin.data_ptr()
    a.row_value, a.label, a.weight, a.gh, a.part, a.out = (
        _build.ptr(t) for t in (row_value, label, weight, gh, part, out))
    a.n, a.k, a.mode = n, k, _SMX_MODES[mode]
    a.kmax, a.pitch, a.shared_bytes = plan.kmax, plan.pitch, plan.shared_bytes
    a.kmagic = -(-(1 << 32) // k) & 0xFFFFFFFF
    a.front0, a.top = plan.front0, plan.top
    for i, f in enumerate(plan.front):
        a.front[i] = f
    return a


@functools.lru_cache(maxsize=None)
def _smx_ctas(device_index: int, k: int, mode: str) -> int:
    """The register path's persistent grid on this device: the CTAs its
    SMs hold at the shared memory K and the mode take. The C call also
    sets the kernel's attributes for every later launch, so it is made
    once a device, K and mode."""
    a = _smx_args(mode, torch.empty((0, k)))
    ctas = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        code = _build.library("softmax").xrt_softmax_ctas(
            ctypes.byref(a), ctypes.byref(ctas))
    _build.check(code, f"softmax pass's grid ({mode}, K = {k})")
    if ctas.value < 1:
        raise RuntimeError(f"softmax pass: no CTA fits ({mode}, K = {k})")
    return ctas.value


def _smx_grid(margin: torch.Tensor, mode: str) -> int:
    """CTAs of one launch (the partials' rows): the register path's
    persistent grid, at most a CTA a tile of 256 rows; the wide path a CTA
    a tile."""
    n, k = margin.shape
    tiles = -(-n // SMX_ROWS_PER_CTA)
    if k > SMX_KMAX[-1]:
        return tiles
    return min(tiles, _smx_ctas(margin.device.index or 0, k, mode))


def _smx_launch(mode: str, margin: torch.Tensor, grid: int, **tensors) -> None:
    a = _smx_args(mode, margin, **tensors)
    a.grid = grid
    dev = margin.device
    with torch.cuda.device(dev):
        code = _build.library("softmax").xrt_softmax(
            ctypes.byref(a), _build.stream_ptr(dev))
    _build.check(code, f"softmax pass ({mode})")


def _check_margin(margin: torch.Tensor, what: str) -> None:
    if not (margin.dtype == torch.float32 and margin.dim() == 2
            and margin.shape[1] >= 2 and margin.is_contiguous()):
        raise ValueError(f"{what}: margin must be contiguous float32 [N, K] "
                         f"with K >= 2")


def softmax_update(margin: torch.Tensor, row_value: torch.Tensor,
                   label: torch.Tensor, weight: torch.Tensor,
                   with_gh: bool = True
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Softmax pass wrapper, training mode (eval mode with
    ``with_gh=False``): ``margin`` [N, K] += ``row_value`` [K, N].T in
    place; returns (gh [K, N, 2] or None, partial sums [3] f64 in
    ``SOFTMAX_PARTIALS`` order). CPU tensors take
    ``softmax_update_plain``; CUDA tensors launch the kernel of
    ``csrc/softmax.cu`` (``softmax_update.launches`` counts every launch,
    ``softmax_update.eval_launches`` those of the eval mode)."""
    if not margin.is_cuda:
        return softmax_update_plain(margin, row_value, label, weight, with_gh)
    _check_margin(margin, "softmax_update")
    n, k = margin.shape
    for t, shape in ((row_value, (k, n)), (label, (n,)), (weight, (n,))):
        if (t.device != margin.device or t.dtype != torch.float32
                or t.shape != shape or not t.is_contiguous()):
            raise ValueError(
                "softmax_update: row_value [K, N], label [N] and weight [N] "
                "must be contiguous float32 on the margins' CUDA device")
    gh = (torch.empty((k, n, 2), dtype=torch.float32, device=margin.device)
          if with_gh else None)
    if n == 0:
        return gh, torch.zeros(3, dtype=torch.float64, device=margin.device)
    mode = "train" if with_gh else "eval"
    grid = _smx_grid(margin, mode)
    part = torch.empty((grid, 3), dtype=torch.float32, device=margin.device)
    _smx_launch(mode, margin, grid, row_value=row_value, label=label,
                weight=weight, gh=gh, part=part)
    softmax_update.launches += 1
    if not with_gh:
        softmax_update.eval_launches += 1
    return gh, part.sum(0, dtype=torch.float64)


softmax_update.launches = 0
softmax_update.eval_launches = 0


def softmax_transform(margin: torch.Tensor, prob: bool,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax pass wrapper, transform mode: [N, K] probabilities (``prob``)
    or [N] f32 classes from [N, K] margins, into ``out`` if given. CPU
    tensors take ``softmax_transform_plain``; CUDA tensors launch the
    kernel of ``csrc/softmax.cu`` (``softmax_transform.launches``)."""
    if not margin.is_cuda:
        res = softmax_transform_plain(margin, prob)
        return res if out is None else out.copy_(res)
    _check_margin(margin, "softmax_transform")
    shape = tuple(margin.shape) if prob else (margin.shape[0],)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=margin.device)
    if (out.device != margin.device or out.dtype != torch.float32
            or tuple(out.shape) != shape or not out.is_contiguous()):
        raise ValueError(f"softmax_transform: out must be contiguous float32 "
                         f"{list(shape)} on the margins' device")
    if margin.shape[0]:
        mode = "prob" if prob else "class"
        _smx_launch(mode, margin, _smx_grid(margin, mode), out=out)
        softmax_transform.launches += 1
    return out


softmax_transform.launches = 0
