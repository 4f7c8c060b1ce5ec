"""Split search (K2) over a level's gradient histograms.

Port of ``xgboost_ray_tpu/ops/split.py``: ``SplitParams`` (``:27``),
``score`` (``:50``), ``leaf_weight`` (``:56``) and the unconstrained numeric
``find_splits`` (``:79``). Per (node, feature) a prefix scan over the
present bins gives every candidate's left child; the gain is scored with the
missing bucket sent left and sent right under the ``min_child_weight`` gate;
the first maximum over the flattened (feature, bin) axis wins (``:158``);
``gamma`` decides validity. It also reads each node's (G, H) off feature
0's buckets, as ``build_tree`` does (``ops/grow.py:594``). The sums are
associated as the compiled JAX program associates them (``tree_sum``,
``blocked_cumsum``), so the kernel, the plain version and the JAX package
agree bitwise on one histogram. Kernel: ``csrc/split.cu``; the wrapper
sends CPU tensors to the plain version below.

Scores use the xgboost leaf objective with L1/L2 regularization:
  w*(G,H)  = -T(G) / (H + lambda),    T(G) = soft-threshold by alpha
  score    = T(G)^2 / (H + lambda)
  gain     = score_L + score_R - score_parent    (accepted iff > gamma)
"""

import dataclasses
from typing import NamedTuple

import torch

from xgboost_ray_tpu_torch.ops import _build


@dataclasses.dataclass(frozen=True)
class SplitParams:
    reg_lambda: float = 1.0
    reg_alpha: float = 0.0
    gamma: float = 0.0
    min_child_weight: float = 1.0
    learning_rate: float = 0.3
    max_delta_step: float = 0.0


class LevelSplits(NamedTuple):
    """Best split per node at one tree level (all arrays [n_nodes])."""

    gain: torch.Tensor  # float32; -inf when no valid split
    feature: torch.Tensor  # int32
    split_bin: torch.Tensor  # int32; rows with bin <= split_bin go left
    default_left: torch.Tensor  # bool; where missing values go
    valid: torch.Tensor  # bool; finite gain > gamma
    node_gh: torch.Tensor  # [n_nodes, 2] f32 node totals (histogram readout)


def _soft_threshold(g, alpha):
    return torch.sign(g) * torch.clamp(torch.abs(g) - alpha, min=0.0)


def score(g, h, p: SplitParams):
    t = _soft_threshold(g, p.reg_alpha)
    den = h + p.reg_lambda
    return torch.where(den > 0, t * t / torch.clamp(den, min=1e-38),
                       torch.zeros((), dtype=g.dtype, device=g.device))


def leaf_weight(g, h, p: SplitParams):
    den = h + p.reg_lambda
    w = torch.where(den > 0,
                    -_soft_threshold(g, p.reg_alpha) / torch.clamp(den, min=1e-38),
                    torch.zeros((), dtype=g.dtype, device=g.device))
    if p.max_delta_step > 0:
        w = torch.clamp(w, -p.max_delta_step, p.max_delta_step)
    return w


def _seq_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` strictly in order, from 0."""
    x = x.movedim(dim, 0)
    acc = torch.zeros_like(x[0])
    for i in range(x.shape[0]):
        acc = acc + x[i]
    return acc


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 of [n, m, ...] in the compiled JAX program's order: for
    m > 32, windows of 32 over the zero-padded axis (half the padding in
    front), each window and then the window sums added in order."""
    m = x.shape[1]
    while m > 32:
        nw = -(-m // 32)
        front = (nw * 32 - m) // 2
        pad = [0, 0] * (x.dim() - 2) + [front, nw * 32 - m - front]
        x = torch.nn.functional.pad(x, pad)
        x = _seq_sum(x.reshape((x.shape[0], nw, 32) + x.shape[2:]), 2)
        m = nw
    return _seq_sum(x, 1)


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in the compiled JAX program's
    order: in order within blocks of 16, then each block adds the
    (recursively blocked) scan of the earlier blocks' totals."""
    n = x.shape[-1]
    if n <= 16:
        return _seq_cumsum(x)
    nb = -(-n // 16)
    xp = torch.nn.functional.pad(x, [0, nb * 16 - n])
    blocks = xp.reshape(x.shape[:-1] + (nb, 16))
    within = _seq_cumsum(blocks)
    pre = blocked_cumsum(within[..., -1])  # [.., nb]
    out = torch.cat([within[..., :1, :],
                     within[..., 1:, :] + pre[..., :-1, None]], dim=-2)
    return out.reshape(x.shape[:-1] + (nb * 16,))[..., :n]


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """In-order inclusive prefix over the last axis (any device)."""
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., i])
    return torch.stack(cols, dim=-1)


def find_splits_plain(hist: torch.Tensor, p: SplitParams) -> LevelSplits:
    """The JAX ``find_splits`` (numeric, unconstrained) in PyTorch, with the
    node totals read off feature 0's buckets as ``build_tree`` does."""
    n_nodes, num_features, nbt, _ = hist.shape
    n_bins = nbt - 1
    node_gh = tree_sum(hist[:, 0])
    g = hist[..., 0]
    h = hist[..., 1]
    gm, hm = g[..., n_bins], h[..., n_bins]
    gl = blocked_cumsum(g[..., :n_bins])[..., : n_bins - 1]
    hl = blocked_cumsum(h[..., :n_bins])[..., : n_bins - 1]
    gp = node_gh[:, 0][:, None, None]
    hp = node_gh[:, 1][:, None, None]
    parent = score(node_gh[:, 0], node_gh[:, 1], p)[:, None, None]
    neg_inf = torch.tensor(float("-inf"), device=hist.device)

    def gain_for(gl_, hl_):
        gr_, hr_ = gp - gl_, hp - hl_
        ok = (hl_ >= p.min_child_weight) & (hr_ >= p.min_child_weight)
        gain = score(gl_, hl_, p) + score(gr_, hr_, p) - parent
        return torch.where(ok, gain, neg_inf)

    gain_missing_left = gain_for(gl + gm[..., None], hl + hm[..., None])
    gain_missing_right = gain_for(gl, hl)
    default_left = gain_missing_left >= gain_missing_right
    gain = torch.maximum(gain_missing_left, gain_missing_right)

    flat = gain.reshape(n_nodes, -1)
    best = torch.argmax(flat, dim=-1)  # first max: deterministic ties
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    dl = torch.gather(default_left.reshape(n_nodes, -1), 1, best[:, None])[:, 0]
    valid = torch.isfinite(best_gain) & (best_gain > p.gamma)
    return LevelSplits(
        gain=best_gain,
        feature=(best // (n_bins - 1)).to(torch.int32),
        split_bin=(best % (n_bins - 1)).to(torch.int32),
        default_left=dl,
        valid=valid,
        node_gh=node_gh,
    )


def find_splits(hist: torch.Tensor, p: SplitParams) -> LevelSplits:
    """K2 wrapper: CPU tensors -> plain version, CUDA tensors -> kernel."""
    if not hist.is_cuda:
        return find_splits_plain(hist, p)
    n_nodes, num_features, nbt, two = hist.shape
    dev = hist.device
    if not (hist.dtype == torch.float32 and two == 2 and hist.is_contiguous()):
        raise ValueError("find_splits: hist must be contiguous f32 "
                         "[n_nodes, F, nbt, 2]")
    if not 2 < nbt <= 1025:
        raise ValueError("find_splits: max_bin must be in (1, 1024]")
    nf = n_nodes * num_features
    f32 = dict(dtype=torch.float32, device=dev)
    f_gain = torch.empty(nf, **f32)
    f_bin = torch.empty(nf, dtype=torch.int32, device=dev)
    f_dl = torch.empty(nf, dtype=torch.uint8, device=dev)
    node_gh = torch.empty((n_nodes, 2), **f32)
    gain = torch.empty(n_nodes, **f32)
    feature = torch.empty(n_nodes, dtype=torch.int32, device=dev)
    split_bin = torch.empty(n_nodes, dtype=torch.int32, device=dev)
    default_left = torch.empty(n_nodes, dtype=torch.bool, device=dev)
    valid = torch.empty(n_nodes, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        code = _build.library("split").xrt_find_splits(
            hist.data_ptr(), n_nodes, num_features, nbt, float(p.reg_lambda),
            float(p.reg_alpha), float(p.gamma), float(p.min_child_weight),
            f_gain.data_ptr(), f_bin.data_ptr(), f_dl.data_ptr(),
            node_gh.data_ptr(), gain.data_ptr(), feature.data_ptr(),
            split_bin.data_ptr(), default_left.data_ptr(), valid.data_ptr(),
            _build.stream_ptr(dev))
    _build.check(code, "K2 split search")
    find_splits.launches += 1
    return LevelSplits(gain, feature, split_bin, default_left, valid, node_gh)


find_splits.launches = 0
