"""Row sampling for one tree: uniform ``subsample`` and GOSS, compacted to a
fixed row budget (B12r).

Port of ``xgboost_ray_tpu/ops/sampling.py``: ``SamplingSpec`` (``:46``),
``spec_from_params`` (``:69``), ``goss_counts`` / ``row_budget``
(``:83-103``) and ``sample_rows`` (``:105-227``) for f32 gradients.

A draw covers one block of ``n_slots`` row slots: the rows a device of the
JAX package holds, its real rows first and padding after them (a padding
slot has zero gradients and all-missing bins). Every slot competes, padding
included, exactly as in the reference:

- uniform: the M = ceil(rate n) slots of the largest uniform keys
  (``random.uniform(key, (n,))``), ties to the lower index (``lax.top_k``);
  a selected padding slot keeps zero gradients;
- GOSS (``gradient_based``): the ``top_n`` slots of the largest ``|g|
  sqrt(max(h, 0))`` (padding -inf), then ``rand_n`` of the remaining real
  rows by uniform keys (the others keyed -1, so where the pool is smaller
  than ``rand_n`` the lowest-index others fill the budget with zero
  gradients), amplified by ``pool / min(pool, rand_n)``.

``sample_rows_plain`` is the reference step for step and keeps
``top_k``'s order (keys descending), which the f32 histograms of the CPU
path follow. B12r (``csrc/sampling.cu``) selects exactly the same set and
writes it in row order: on the card K1 sums in int64 fixed point, where the
order of the rows changes no sum.
"""

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from xgboost_ray_tpu_torch.ops import _build
from xgboost_ray_tpu_torch.ops.objectives import _ftz, sqrt_rn
from xgboost_ray_tpu_torch.ops.random import Key, uniform


@dataclasses.dataclass(frozen=True)
class SamplingSpec:
    """A run's row-sampling policy: "uniform" (rate = ``subsample``) or
    "gradient_based" (GOSS: ``top_rate`` kept, ``other_rate`` sampled with
    amplification)."""

    policy: str
    rate: float = 1.0
    top_rate: float = 0.2
    other_rate: float = 0.1


def spec_from_params(params) -> Optional[SamplingSpec]:
    """The run's spec, or None where no row is sampled."""
    if params.sampling_method == "gradient_based":
        return SamplingSpec("gradient_based", top_rate=float(params.top_rate),
                            other_rate=float(params.other_rate))
    if params.subsample < 1.0:
        return SamplingSpec("uniform", rate=float(params.subsample))
    return None


def _ceil_frac(rate: float, n: int) -> int:
    # ceil(rate * n) without float-dust surprises at exact multiples
    return int(math.ceil(round(rate * n, 9)))


def goss_counts(n: int, spec: SamplingSpec) -> Tuple[int, int]:
    """(top_n, rand_n) of a gradient_based spec over ``n`` slots."""
    top_n = min(n, _ceil_frac(spec.top_rate, n))
    rand_n = min(n - top_n, _ceil_frac(spec.other_rate, n))
    if top_n + rand_n == 0:
        rand_n = 1
    return top_n, rand_n


def row_budget(n: int, spec: SamplingSpec) -> int:
    """The compacted buffer's rows M for a block of ``n`` slots."""
    if spec.policy == "uniform":
        return max(1, min(n, _ceil_frac(spec.rate, n)))
    top_n, rand_n = goss_counts(n, spec)
    return top_n + rand_n


def _pad_gh(gh: torch.Tensor, n_slots: int) -> torch.Tensor:
    """The block's [n_slots, 2] gradients: its rows, then zeros."""
    pad = n_slots - gh.shape[0]
    if pad <= 0:
        return gh
    return torch.cat([gh, gh.new_zeros((pad, 2))])


def _top_k(values: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, descending, ties by the lower index."""
    vals, idx = torch.sort(values, descending=True, stable=True)
    return vals[:k], idx[:k]


def goss_score(gh: torch.Tensor) -> torch.Tensor:
    """|g| sqrt(max(h, 0)) of f32 rows (XLA's CPU program: operands and
    result flushed, a correctly rounded sqrt)."""
    g, h = _ftz(gh[:, 0]), _ftz(gh[:, 1])
    return _ftz(g.abs() * sqrt_rn(torch.clamp(h, min=0.0)))


def sample_rows_plain(gh: torch.Tensor, n_slots: int, key: Key,
                      spec: SamplingSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``sample_rows`` over a block: ``gh`` [n, 2] f32 of
    its real rows (n <= n_slots; the slots past n are padding). Returns
    (rows [M] int32 slot indices, gh_sel [M, 2] f32) in ``top_k``'s
    order (GOSS: the top rows, then the sampled ones)."""
    n_valid = gh.shape[0]
    dev = gh.device
    ghp = _pad_gh(gh, n_slots)
    valid = torch.arange(n_slots, device=dev) < n_valid
    if spec.policy == "uniform":
        m = row_budget(n_slots, spec)
        _, rows = _top_k(uniform(key, (n_slots,), device=dev), m)
        ok = valid[rows][:, None].to(torch.float32)
        return rows.to(torch.int32), ghp[rows] * ok
    if spec.policy != "gradient_based":
        raise ValueError(f"unknown sampling policy {spec.policy!r}")
    top_n, rand_n = goss_counts(n_slots, spec)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    score = torch.where(valid, goss_score(ghp), neg_inf)
    rows_parts, gh_parts = [], []
    eligible = valid
    if top_n:
        tvals, rows_top = _top_k(score, top_n)
        ok_top = torch.isfinite(tvals)[:, None].to(torch.float32)
        rows_parts.append(rows_top)
        gh_parts.append(ghp[rows_top] * ok_top)
        taken = torch.zeros(n_slots, dtype=torch.bool, device=dev)
        taken[rows_top] = True
        eligible = eligible & ~taken
    if rand_n:
        u = uniform(key, (n_slots,), device=dev)
        rscore = torch.where(eligible, u, torch.tensor(-1.0, device=dev))
        rvals, rows_rand = _top_k(rscore, rand_n)
        pool = eligible.to(torch.float32).sum()
        amp = torch.where(pool > 0, pool / torch.clamp(pool, max=float(rand_n)),
                          torch.zeros((), device=dev))
        ok = (rvals >= 0.0)[:, None].to(torch.float32)
        rows_parts.append(rows_rand)
        gh_parts.append(ghp[rows_rand] * amp * ok)
    return (torch.cat(rows_parts).to(torch.int32),
            torch.cat(gh_parts, dim=0))


# --------------------------------------------------------------------------
# B12r on the card
# --------------------------------------------------------------------------

#: B12r's modes (``csrc/sampling.cu``): a uniform draw, GOSS's top stage
#: and its sampled stage
SAMPLE_MODES = {"uniform": 0, "top": 1, "rand": 2}
#: the workspace's 32-bit words (``kWorkWords`` of ``csrc/sampling.cu``):
#: three 4,096-bin histograms, the barrier, the pool, then the CTAs' counts
_WORK_FIXED = 3 * 4096 + 8


@functools.lru_cache(maxsize=None)
def _sample_grid(device_index: int) -> int:
    """The cooperative grid of B12r on this card: every CTA resident."""
    grid = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        code = _build.library("sampling").xrt_sample_ctas(ctypes.byref(grid))
    _build.check(code, "B12r's grid")
    if grid.value < 1:
        raise RuntimeError("B12r: no CTA fits")
    return grid.value


@functools.lru_cache(maxsize=None)
def _sample_workspace(device_index: int, stream: int) -> torch.Tensor:
    """B12r's int32 workspace on one stream of one card (zero at first;
    each launch zeroes what it uses before using it, and leaves its grid
    barrier's counter at zero)."""
    words = _WORK_FIXED + 2 * _sample_grid(device_index)
    return torch.zeros(words, dtype=torch.int32,
                       device=torch.device("cuda", device_index))


def _b12r_launch(mode: str, gh: torch.Tensor, n_slots: int, k: int,
                 key: Key, rows: torch.Tensor, gh_sel: torch.Tensor,
                 row_offset: int, taken: Optional[torch.Tensor]) -> None:
    dev = gh.device
    stream = _build.stream_ptr(dev)
    a = _build.SampleArgs()
    a.gh = gh.data_ptr() if gh.shape[0] else None
    a.taken = _build.ptr(taken)
    a.rows, a.gh_sel = rows.data_ptr(), gh_sel.data_ptr()
    a.work = _sample_workspace(dev.index, stream).data_ptr()
    a.n_slots, a.n_valid, a.k, a.row_offset = n_slots, gh.shape[0], k, row_offset
    a.key0, a.key1 = key
    a.mode = SAMPLE_MODES[mode]
    a.grid = _sample_grid(dev.index)
    with torch.cuda.device(dev):
        code = _build.library("sampling").xrt_sample_rows(ctypes.byref(a),
                                                          stream)
    _build.check(code, f"B12r ({mode})")
    sample_rows.launches += 1


def sample_rows(gh: torch.Tensor, n_slots: int, key: Key, spec: SamplingSpec,
                row_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block's draw: (rows [M] int32, gh_sel [M, 2] f32), rows being
    ``row_offset`` + the slot (a slot past ``gh``'s rows is padding). CPU
    tensors take ``sample_rows_plain`` (``top_k``'s order); CUDA tensors
    launch B12r, once for a uniform draw and twice for GOSS (its top stage,
    then its sampled stage), each stage's rows in slot order, or raise.
    ``sample_rows.launches`` counts the launches."""
    if not gh.is_cuda:
        rows, gh_sel = sample_rows_plain(gh, n_slots, key, spec)
        return (rows + row_offset if row_offset else rows), gh_sel
    if not (gh.dtype == torch.float32 and gh.dim() == 2 and gh.shape[1] == 2
            and gh.is_contiguous() and gh.data_ptr() % 8 == 0
            and 0 <= gh.shape[0] <= n_slots < 2 ** 31):
        raise ValueError("sample_rows: gh must be 8-byte aligned contiguous "
                         "f32 [n, 2] with n <= n_slots < 2^31")
    dev = gh.device
    m = row_budget(n_slots, spec)
    rows = torch.empty(m, dtype=torch.int32, device=dev)
    gh_sel = torch.empty((m, 2), dtype=torch.float32, device=dev)
    if spec.policy == "uniform":
        _b12r_launch("uniform", gh, n_slots, m, key, rows, gh_sel, row_offset,
                     None)
        return rows, gh_sel
    if spec.policy != "gradient_based":
        raise ValueError(f"unknown sampling policy {spec.policy!r}")
    top_n, rand_n = goss_counts(n_slots, spec)
    taken = torch.empty(n_slots, dtype=torch.uint8, device=dev)
    if top_n:
        _b12r_launch("top", gh, n_slots, top_n, key, rows[:top_n],
                     gh_sel[:top_n], row_offset, taken)
    else:
        taken.zero_()
    if rand_n:
        _b12r_launch("rand", gh, n_slots, rand_n, key, rows[top_n:],
                     gh_sel[top_n:], row_offset, taken)
    return rows, gh_sel


sample_rows.launches = 0
