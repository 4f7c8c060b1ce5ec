"""Learning to rank: query groups, the LambdaMART gradients and B13.

Port of ``xgboost_ray_tpu/ops/ranking.py``: ``build_group_rows`` (``:26``,
copied), the pairwise lambdas ``_pairwise_lambdas`` (``:46``) over the
padded ``[chunk, G, G]`` layout, their per-row gradients
``make_rank_grad_hess`` (``:81-118``). ``rank:pairwise`` weights a pair
by 1, ``rank:ndcg`` and ``rank:map`` by |delta NDCG| of swapping the two
(``:82``).

A group is a run of rows of one shard with the same ``qid`` (the loader
sorts rows by ``qid``); each shard's groups are built on its own rows, so a
query split between two shards is two groups, as the JAX package builds
groups per device block. ``G``, the padded width, is the largest group of
any shard of the world (``GroupLayout``). The objectives' envelope
(``RankingObjective``, ``:126-145``: the margin as the prediction, a zero
base margin, ``ndcg`` or ``map`` by default) is their entry in
``ops/objectives._TABLE``.

B13 (CUDA C++, ``csrc/ranking.cu``) computes a round's (g, h) for every
row: a CTA a group, the group's scores, labels, gains and discounts staged
in shared memory (or, for a group larger than the staging, in a global
scratch), a thread a document i looping over the group's j. Each document
lies in one group, so g_i is its winner sum and loser sum computed in the
thread, with no scatter. The plain version (``rank_grad_hess_plain``)
follows the reference's compiled CPU program: the pair sums over the padded
axis are ``ops/split.tree_sum``'s window-32 tree (XLA's order for G > 32,
bitwise; for G <= 32 LLVM vectorises the fused sums with reassociation, an
order the port does not follow, within the f32 summation bound of the
terms), exp2 is ``exp(ln2 y)``, log2 is ``log(x) * (1 / ln2)``, both XLA's
polynomials, the ranks are ``jnp.argsort``'s stable order (counted: the
valid j with a larger score, or an equal one earlier in the group).
"""

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from xgboost_ray_tpu_torch.ops import _build
from xgboost_ray_tpu_torch.ops.objectives import (
    _ftz,
    exp_f32,
    log_f32,
    sigmoid,
)
from xgboost_ray_tpu_torch.ops.split import tree_sum

RANKING_OBJECTIVES = ("rank:pairwise", "rank:ndcg", "rank:map")

#: float32 ln 2 (exp2(y) is exp(ln2 y)) and the f32 reciprocal of the
#: float32 ln 2 (log2(x) is log(x) times it: XLA folds x / c to x * (1 / c))
LN2 = float(np.float32(np.log(2.0)))
INV_LN2 = float(np.float32(1.0) / np.float32(np.log(np.float32(2.0))))

#: documents of a group B13 / B9r stage in shared memory; a larger group
#: stages in a global scratch (``kStageDocs`` of ``csrc/ranking.cu``)
STAGE_DOCS = 2048


def build_group_rows(qid: np.ndarray, max_group: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: qid [N] (sorted by qid) -> (group_rows [n_groups, G],
    group_ptr). group_rows holds row indices padded with N (sentinel);
    group_ptr is the [n_groups+1] offset array the ranking metrics use."""
    qid = np.asarray(qid)
    n = qid.shape[0]
    change = np.nonzero(np.diff(qid))[0] + 1
    ptr = np.concatenate([[0], change, [n]]).astype(np.int64)
    sizes = np.diff(ptr)
    g = int(sizes.max()) if sizes.size else 1
    if max_group:
        g = max(g, max_group)
    rows = np.full((ptr.size - 1, g), n, dtype=np.int32)
    for i in range(ptr.size - 1):
        rows[i, : sizes[i]] = np.arange(ptr[i], ptr[i + 1], dtype=np.int32)
    return rows, ptr


def shard_group_offsets(qids: Sequence[np.ndarray]) -> np.ndarray:
    """[NG + 1] int64 row offsets of the groups of shards concatenated in
    order: each shard's groups built on its own rows (a query split between
    two shards is two groups)."""
    parts, base = [np.zeros(1, np.int64)], 0
    for q in qids:
        q = np.asarray(q)
        if q.shape[0]:
            parts.append(build_group_rows(q)[1][1:] + base)
        base += q.shape[0]
    return np.concatenate(parts)


@dataclasses.dataclass
class GroupLayout:
    """One set's groups on this rank: ``offsets`` [NG + 1] int64 (rows of
    group k are ``offsets[k]:offsets[k + 1]``, on the set's device) and
    ``width``, the padded G (the world's largest group)."""

    offsets: torch.Tensor
    width: int

    @property
    def n_groups(self) -> int:
        return self.offsets.shape[0] - 1

    def padded_rows(self, n: int) -> torch.Tensor:
        """The JAX layout: [NG, G] int64 row of each slot, ``n`` padding."""
        off = self.offsets.cpu()
        slot = torch.arange(self.width, dtype=torch.int64)
        rows = off[:-1, None] + slot[None, :]
        return torch.where(rows < off[1:, None], rows,
                           torch.full_like(rows, n)).to(self.offsets.device)


def _log2_recip(x: torch.Tensor) -> torch.Tensor:
    """1 / log2(x) as the reference evaluates it: 1 / (log(x) * (1/ln2))."""
    return 1.0 / (log_f32(x) * INV_LN2)


def gain_of(label: torch.Tensor) -> torch.Tensor:
    """2^y - 1 as the reference evaluates it (exp(ln2 y), flushed, - 1)."""
    return _ftz(exp_f32(label * LN2)) - 1.0


def pairwise_lambdas_plain(s: torch.Tensor, y: torch.Tensor,
                           valid: torch.Tensor, use_ndcg_delta: bool):
    """One padded group chunk (the JAX ``_pairwise_lambdas``). s, y, valid:
    [C, G]. Returns g, h: [C, G]."""
    c, gsz = s.shape
    yi, yj = y[:, :, None], y[:, None, :]
    vi, vj = valid[:, :, None], valid[:, None, :]
    beats = (yi > yj) & vi & vj
    rho = sigmoid(-(s[:, :, None] - s[:, None, :]))
    if use_ndcg_delta:
        neg = torch.where(valid, -s, torch.full_like(s, float("inf")))
        order = torch.argsort(neg, dim=1, stable=True)
        ranks = torch.argsort(order, dim=1, stable=True)
        inv_log = _log2_recip(2.0 + ranks.to(torch.float32))
        gain = gain_of(torch.where(valid, y, torch.zeros_like(y)))
        sorted_gain = torch.sort(torch.where(valid, gain, torch.zeros_like(
            gain)), dim=1).values.flip(1)
        pos_disc = _log2_recip(2.0 + torch.arange(gsz, dtype=torch.float32,
                                                  device=s.device))
        idcg = torch.clamp(tree_sum(sorted_gain * pos_disc[None, :]),
                           min=1e-12)
        dgain = (gain[:, :, None] - gain[:, None, :]).abs()
        ddisc = (inv_log[:, :, None] - inv_log[:, None, :]).abs()
        delta = dgain * ddisc / idcg[:, None, None]
        lam = torch.where(beats, rho * delta, 0.0)
        hess = torch.where(beats, torch.clamp(rho * (1.0 - rho), min=1e-16)
                           * delta, 0.0)
    else:
        lam = torch.where(beats, rho, 0.0)
        hess = torch.where(beats, torch.clamp(rho * (1.0 - rho), min=1e-16),
                           0.0)
    # winner i: g_i -= lam_ij summed over j; loser j: g_j += lam_ij over i
    g = -tree_sum(lam.transpose(1, 2)) + tree_sum(lam)
    h = tree_sum(hess.transpose(1, 2)) + tree_sum(hess)
    return g, h


def pair_chunk(width: int) -> int:
    """Groups a chunk of the plain version (the JAX ``chunk``: the [chunk,
    G, G] pair tensors bounded to ~64M elements)."""
    return int(np.clip(64_000_000 // max(width * width, 1), 1, 256))


def rank_grad_hess_plain(margin: torch.Tensor, label: torch.Tensor,
                         weight: torch.Tensor, layout: GroupLayout,
                         name: str) -> torch.Tensor:
    """Plain B13: gh [N, 2] f32 of ``make_rank_grad_hess(name)`` for
    margins [N], labels [N], weights [N] and this set's groups."""
    n = label.shape[0]
    use_ndcg = name in ("rank:ndcg", "rank:map")
    rows_all = layout.padded_rows(n)
    s_ext = torch.cat([margin.reshape(-1), margin.new_zeros(1)])
    y_ext = torch.cat([label, label.new_zeros(1)])
    g_acc = margin.new_zeros(n + 1)
    h_acc = margin.new_zeros(n + 1)
    chunk = pair_chunk(layout.width)
    for lo in range(0, layout.n_groups, chunk):
        r = rows_all[lo:lo + chunk]
        v = r < n
        g, h = pairwise_lambdas_plain(
            s_ext[r], torch.where(v, y_ext[r], 0.0), v, use_ndcg)
        g_acc.index_put_((r.reshape(-1),), torch.where(v, g, 0.0).reshape(-1),
                         accumulate=True)
        h_acc.index_put_((r.reshape(-1),), torch.where(v, h, 0.0).reshape(-1),
                         accumulate=True)
    g = g_acc[:n] * weight
    h = torch.clamp(h_acc[:n], min=1e-16) * weight
    return torch.stack([g, h], dim=1)


class RankArgs(ctypes.Structure):
    """``XrtRankArgs`` of ``csrc/ranking.cu``: one B13 or B9r launch,
    passed by pointer (edit both together)."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "margin", "label", "weight", "offsets", "gh", "scratch", "vals",
        "ticket", "out")]
        + [("n", ctypes.c_longlong)]
        + [(name, ctypes.c_int) for name in (
            "n_groups", "width", "mode", "k", "stage", "threads")])


#: B13's modes (``XRT_RANK_*`` of ``csrc/ranking.cu``)
RANK_MODES = {"rank:pairwise": 0, "rank:ndcg": 1, "rank:map": 1}


def rank_args(margin: torch.Tensor, label: torch.Tensor,
              layout: GroupLayout, mode: int, k: int = 0) -> RankArgs:
    """The args every B13 / B9r launch shares (tensors added by the
    caller): the staging is ``min(width, STAGE_DOCS)`` documents."""
    a = RankArgs()
    a.margin, a.label, a.offsets = (_build.ptr(t) for t in (
        margin, label, layout.offsets))
    a.n = label.shape[0]
    a.n_groups, a.width, a.mode, a.k = layout.n_groups, layout.width, mode, k
    a.stage = min(layout.width, STAGE_DOCS)
    return a


def check_group_inputs(what: str, margin: torch.Tensor, label: torch.Tensor,
                       layout: GroupLayout, *more: torch.Tensor) -> None:
    n = label.shape[0]
    dev = label.device
    for t in (margin, label, *more):
        if (t.device != dev or t.dtype != torch.float32 or t.numel() != n
                or not t.is_contiguous()):
            raise ValueError(f"{what}: margin, label and weight must be "
                             f"contiguous float32 [N] on one device")
    off = layout.offsets
    if off.device != dev or off.dtype != torch.int64 or off.dim() != 1:
        raise ValueError(f"{what}: offsets must be int64 [NG + 1] on the "
                         f"rows' device")
    if layout.width < 1 or layout.n_groups >= 2 ** 31:
        raise ValueError(f"{what}: bad group layout")


def rank_scratch(layout: GroupLayout, n: int, dev) -> Optional[torch.Tensor]:
    """[5, N] f32 staging for the groups larger than ``STAGE_DOCS`` (None
    where none is)."""
    if layout.width <= STAGE_DOCS:
        return None
    return torch.empty((5, max(n, 1)), dtype=torch.float32, device=dev)


def rank_grad_hess(margin: torch.Tensor, label: torch.Tensor,
                   weight: torch.Tensor, layout: GroupLayout,
                   name: str) -> torch.Tensor:
    """B13 wrapper: gh [N, 2] f32 of objective ``name`` (``rank:*``) for
    margins [N] (or [N, 1]), labels and weights [N] and the set's groups.
    CPU tensors take ``rank_grad_hess_plain``; CUDA tensors launch the
    kernel of ``csrc/ranking.cu`` once (``rank_grad_hess.launches``)."""
    if name not in RANK_MODES:
        raise ValueError(f"rank_grad_hess: not a ranking objective: {name!r}")
    margin = margin.reshape(-1)
    if not label.is_cuda:
        return rank_grad_hess_plain(margin, label, weight, layout, name)
    check_group_inputs("rank_grad_hess", margin, label, layout, weight)
    n, dev = label.shape[0], label.device
    gh = torch.empty((n, 2), dtype=torch.float32, device=dev)
    if layout.n_groups == 0:
        return gh
    scratch = rank_scratch(layout, n, dev)
    a = rank_args(margin, label, layout, RANK_MODES[name])
    a.weight, a.gh, a.scratch = (_build.ptr(t) for t in (weight, gh, scratch))
    with torch.cuda.device(dev):
        code = _build.library("ranking").xrt_rank_gh(ctypes.byref(a),
                                                     _build.stream_ptr(dev))
    _build.check(code, "B13 (rank_grad_hess)")
    rank_grad_hess.launches += 1
    return gh


rank_grad_hess.launches = 0


def _sizes(layout: GroupLayout) -> torch.Tensor:
    """[NG] f64 documents of each group."""
    return (layout.offsets[1:] - layout.offsets[:-1]).double()


def _sort_comparisons(sizes: torch.Tensor) -> float:
    """Comparisons of a sort of every group: g ceil(log2 g) for g docs."""
    return float((sizes * torch.ceil(torch.log2(sizes.clamp(min=1)))).sum())


def pair_operations(layout: GroupLayout, label: torch.Tensor,
                    use_ndcg: bool = True) -> int:
    """B13's arithmetic for its bound: what the function needs on these
    labels, not what the kernel does. Only a pair of one group with
    different labels has a lambda, and one evaluation serves both of its
    documents: per such unordered pair a score difference, a sigmoid (an
    exp of a dozen operations, an add, a division), rho (1 - rho) and its
    clamp, and the adds into g_i, g_j, h_i, h_j (22); |delta NDCG| adds
    its two differences, their product over the ideal DCG and the products
    by rho and by the hessian (8). Per document the weight's product and
    h's clamp (2); with |delta NDCG| also its gain (an exp2) and the
    discount of its rank (a log2, a division), about 30, and the group's two
    sorts that give the ranks and the ideal order."""
    sizes = _sizes(layout)
    lo, hi = int(layout.offsets[0]), int(layout.offsets[-1])
    codes = torch.unique(label[lo:hi], return_inverse=True)[1]
    gid = torch.repeat_interleave(
        torch.arange(layout.n_groups, device=sizes.device),
        (layout.offsets[1:] - layout.offsets[:-1]))
    same = torch.bincount(gid * (int(codes.max()) + 1 if hi > lo else 1)
                          + codes).double()
    pairs = float(((sizes * sizes).sum() - (same * same).sum()) / 2)
    docs = float(hi - lo)
    if not use_ndcg:
        return int(pairs * 22 + docs * 2)
    return int(pairs * 30 + docs * 32 + 2 * _sort_comparisons(sizes))


def rank_metric_operations(layout: GroupLayout, kind: str,
                           k: Optional[float] = None) -> int:
    """B9r's arithmetic for its bound: per group of g documents a stable
    sort by score (and for ndcg one of the labels, for the ideal DCG), then
    over its first min(kk, g) positions ndcg's two gains (an exp2 and a
    subtraction), their products by the discount and their adds (34 a
    position), or map's precision, its product and sums (5 a position)."""
    from xgboost_ray_tpu_torch.ops.metrics import rank_metric_cut

    sizes = _sizes(layout)
    cut = float(sizes.clamp(max=rank_metric_cut(k, layout.width)).sum())
    if kind == "ndcg":
        return int(2 * _sort_comparisons(sizes) + 34 * cut)
    return int(_sort_comparisons(sizes) + 5 * cut)
