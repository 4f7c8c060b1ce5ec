"""Split search (K2): one tree level's per-node work.

Port of ``xgboost_ray_tpu/ops/split.py``: ``SplitParams`` (``:27``),
``score`` (``:50``), ``leaf_weight`` (``:56``) and the unconstrained numeric
``find_splits`` (``:79``); and of the per-node part of a level of the JAX
``build_tree`` around it (``ops/grow.py:565-690``: the sibling histogram,
the readout, the records), which ``split_level`` does in one launch per
level, and of its final level (``:765-780``, ``leaf_records``).

Per (node, feature) a prefix scan over the present bins gives every
candidate's left child; the gain is scored with the missing bucket sent
left and sent right under the ``min_child_weight`` gate; the first maximum
over the flattened (feature, bin) axis wins (``:158``); ``gamma`` decides
validity. It also reads each node's (G, H) off feature
0's buckets, as ``build_tree`` does (``ops/grow.py:594``). The sums are
associated as the compiled JAX program associates them (``tree_sum``,
``blocked_cumsum``), so the kernel, the plain version and the JAX package
agree bitwise on one histogram. Kernel: ``csrc/split.cu``; each wrapper
(``split_level``, ``leaf_records``, and ``find_splits``: the search alone)
sends CPU tensors to its plain version and CUDA tensors to the kernel (or
raises), and counts its launches.

Scores use the xgboost leaf objective with L1/L2 regularization:
  w*(G,H)  = -T(G) / (H + lambda),    T(G) = soft-threshold by alpha
  score    = T(G)^2 / (H + lambda)
  gain     = score_L + score_R - score_parent    (accepted iff > gamma)
"""

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import torch

from xgboost_ray_tpu_torch.ops import _build
from xgboost_ray_tpu_torch.ops.histogram import (
    INACTIVE,
    LEAF,
    SPLIT,
    _check,
    zero_phantom_missing,
)


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


def _sign(g):
    """``jnp.sign``: -0.0 and NaN map to themselves (``torch.sign`` gives
    +0.0 for both), so a leaf weight at G = -0.0 is +0.0, as in JAX."""
    return torch.where(g > 0, 1.0, torch.where(g < 0, -1.0, g))


def _soft_threshold(g, alpha):
    return _sign(g) * torch.clamp(torch.abs(g) - alpha, min=0.0)


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


def _check_node_array(t, n: int, dtype, dev, what: str) -> None:
    _check(t.dtype == dtype and t.shape == (n,) and t.device == dev
           and t.is_contiguous(), f"{what} must be contiguous {dtype} [{n}] "
           f"on {dev}")


def _check_hist(hist: torch.Tensor, what: str) -> None:
    _check(hist.dtype == torch.float32 and hist.dim() == 4
           and hist.shape[3] == 2 and hist.is_contiguous()
           and hist.data_ptr() % 8 == 0,
           f"{what}: hist must be 8-byte aligned contiguous f32 "
           "[n_nodes, F, nbt, 2]")
    _check(2 < hist.shape[2] <= 1025, f"{what}: max_bin must be in (1, 1024]")


def find_splits(hist: torch.Tensor, p: SplitParams) -> LevelSplits:
    """K2 alone (no sibling formation, no records): CPU tensors -> plain
    version, CUDA tensors -> one launch of the level kernel."""
    if not hist.is_cuda:
        return find_splits_plain(hist, p)
    _check_hist(hist, "find_splits")
    n_nodes, num_features, nbt, _ = hist.shape
    dev = hist.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    node_gh = torch.empty((n_nodes, 2), **f32)
    gain = torch.empty(n_nodes, **f32)
    feature = torch.empty(n_nodes, **i32)
    split_bin = torch.empty(n_nodes, **i32)
    default_left = torch.empty(n_nodes, dtype=torch.bool, device=dev)
    valid = torch.empty(n_nodes, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        code = _build.library("split").xrt_find_splits(
            hist.data_ptr(), n_nodes, num_features, nbt, float(p.reg_lambda),
            float(p.reg_alpha), float(p.gamma), float(p.min_child_weight),
            node_gh.data_ptr(), gain.data_ptr(), feature.data_ptr(),
            split_bin.data_ptr(), default_left.data_ptr(), valid.data_ptr(),
            _build.stream_ptr(dev))
    _build.check(code, "K2 split search")
    find_splits.launches += 1
    return LevelSplits(gain, feature, split_bin, default_left, valid, node_gh)


find_splits.launches = 0


# --------------------------------------------------------------------------
# one tree level: sibling formation + split search + records (K2)
# --------------------------------------------------------------------------

_TREE_DTYPES = (("feature", torch.int32), ("split_bin", torch.int32),
                ("threshold", torch.float32), ("default_left", torch.bool),
                ("is_leaf", torch.bool), ("value", torch.float32),
                ("gain", torch.float32), ("cover", torch.float32),
                ("base_weight", torch.float32))


class TreeRecords:
    """The tree a grower writes, level by level, and what its levels share:
    ``tree`` (the padded-heap ``Tree`` of ``ops/grow.py``, written in
    place), ``cuts`` [F, max_bin - 1] f32, ``feat_has_missing`` [F] bool or
    None, and the split parameters. On a CUDA device the C struct of their
    pointers is checked and filled once per tree (:meth:`c_args`)."""

    def __init__(self, tree, cuts: torch.Tensor, feat_has_missing,
                 p: SplitParams):
        self.tree = tree
        self.cuts = cuts
        self.feat_has_missing = feat_has_missing
        self.p = p
        self._c = None

    def c_args(self) -> int:
        """Address of the filled ``XrtTreeArgs`` (kept alive by self)."""
        if self._c is None:
            t, cuts, fhm = self.tree, self.cuts, self.feat_has_missing
            dev = cuts.device
            heap = t.feature.shape[0]
            for name, dt in _TREE_DTYPES:
                _check_node_array(getattr(t, name), heap, dt, dev,
                                  f"tree.{name}")
            _check(cuts.dtype == torch.float32 and cuts.dim() == 2
                   and cuts.is_contiguous(),
                   "cuts must be contiguous f32 [F, max_bin - 1]")
            if fhm is not None:
                _check_node_array(fhm, cuts.shape[0], torch.bool, dev,
                                  "feat_has_missing")
            p = self.p
            self._c = _build.TreeArgs(
                *(getattr(t, name).data_ptr() for name, _ in _TREE_DTYPES),
                cuts.data_ptr(), _build.ptr(fhm), cuts.shape[0],
                cuts.shape[1] + 2, p.reg_lambda, p.reg_alpha, p.gamma,
                p.min_child_weight, max(p.max_delta_step, 0.0),
                p.learning_rate)
        return ctypes.addressof(self._c)


class LevelStep(NamedTuple):
    """What one level's step hands to K3 and to the next level."""

    splits: LevelSplits  # best split per node, unmasked
    node_value: torch.Tensor  # [n_nodes] f32: lr * leaf_weight(G, H)
    state: torch.Tensor  # [n_nodes] uint8 SPLIT / LEAF / INACTIVE for K3
    active: torch.Tensor  # [2 n_nodes] bool: the next level's active nodes
    hist: Optional[torch.Tensor]  # the formed histogram: the next prev_hist


def _interleave(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """[n, ...] x 2 -> [2n, ...] as (left_0, right_0, left_1, ...)."""
    return torch.stack([left, right], dim=1).reshape(
        (2 * left.shape[0],) + left.shape[1:])


def split_level_plain(hist, prev_hist, small_is_right, active,
                      rec: TreeRecords, keep_hist: bool = True) -> LevelStep:
    """The level step in PyTorch ops, as the JAX grower composes it: the
    sibling as parent - smaller child (``prev_hist`` given), the phantom
    missing bucket zeroed, the readout and split search, and the records
    of ``ops/grow.py:661-684`` written into ``rec.tree``."""
    tree, cuts, p = rec.tree, rec.cuts, rec.p
    if prev_hist is not None:
        hist_small = hist
        hist_big = prev_hist - hist_small
        sir = small_is_right[:, None, None, None]
        hist = _interleave(torch.where(sir, hist_big, hist_small),
                           torch.where(sir, hist_small, hist_big))
    hist = zero_phantom_missing(hist, rec.feat_has_missing)
    n_nodes, num_features, nbt, _ = hist.shape
    max_bin = nbt - 1
    base = n_nodes - 1
    lr = p.learning_rate
    zero = torch.zeros((), dtype=torch.float32, device=hist.device)

    sp = find_splits_plain(hist, p)
    node_gh = sp.node_gh
    valid_split = sp.valid & active
    node_value = lr * leaf_weight(node_gh[:, 0], node_gh[:, 1], p)
    is_new_leaf = active & ~valid_split
    fsafe = sp.feature.clamp(0, num_features - 1).long()
    thr = cuts[fsafe, sp.split_bin.clamp(0, max_bin - 2).long()]
    sl = slice(base, base + n_nodes)
    tree.feature[sl] = torch.where(valid_split, sp.feature, -1)
    tree.split_bin[sl] = torch.where(valid_split, sp.split_bin, 0)
    tree.threshold[sl] = torch.where(valid_split, thr, zero)
    tree.default_left[sl] = sp.default_left & valid_split
    tree.is_leaf[sl] = is_new_leaf
    tree.value[sl] = torch.where(is_new_leaf, node_value, zero)
    tree.gain[sl] = torch.where(valid_split, sp.gain, zero)
    tree.cover[sl] = torch.where(active, node_gh[:, 1], zero)
    tree.base_weight[sl] = torch.where(active, node_value, zero)

    state = torch.where(
        valid_split, SPLIT, torch.where(is_new_leaf, LEAF, INACTIVE)
    ).to(torch.uint8)
    return LevelStep(sp, node_value, state,
                     torch.repeat_interleave(valid_split, 2),
                     hist if keep_hist else None)


def split_level(hist: torch.Tensor, prev_hist: Optional[torch.Tensor],
                small_is_right: Optional[torch.Tensor], active: torch.Tensor,
                rec: TreeRecords, keep_hist: bool = True) -> LevelStep:
    """K2 for one tree level, one launch: ``hist`` is K1's (all-reduced)
    histogram of the level's ``n_nodes`` nodes, or with ``prev_hist`` and
    ``small_is_right`` that of each parent's smaller child. ``active``
    [n_nodes] bool. Writes the level's slice of ``rec.tree``; the formed
    histogram comes back as ``hist`` when ``keep_hist`` (the next level's
    ``prev_hist``). CPU tensors -> plain version, CUDA tensors -> kernel."""
    if not hist.is_cuda:
        return split_level_plain(hist, prev_hist, small_is_right, active,
                                 rec, keep_hist)
    n_nodes = active.shape[0]
    dev = hist.device
    _check_hist(hist, "split_level")
    _, num_features, nbt, _ = hist.shape
    _check(hist.shape[0] == (n_nodes if prev_hist is None else n_nodes // 2),
           "split_level: hist must hold n_nodes nodes, or n_nodes / 2 with "
           "prev_hist")
    if prev_hist is not None:
        _check(prev_hist.shape == hist.shape and prev_hist.device == dev,
               "split_level: prev_hist must have the shape of hist")
        _check_hist(prev_hist, "split_level")
        _check_node_array(small_is_right, n_nodes // 2, torch.bool, dev,
                          "split_level: small_is_right")
    _check_node_array(active, n_nodes, torch.bool, dev, "split_level: active")
    _check(rec.cuts.device == dev and rec.cuts.shape == (num_features, nbt - 2)
           and rec.tree.feature.shape[0] >= 2 * n_nodes - 1,
           "split_level: cuts [F, max_bin - 1] and the tree must match hist")
    args = rec.c_args()
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    u8 = dict(dtype=torch.uint8, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    gain = torch.empty(n_nodes, **f32)
    feature = torch.empty(n_nodes, **i32)
    split_bin = torch.empty(n_nodes, **i32)
    default_left = torch.empty(n_nodes, **b8)
    valid = torch.empty(n_nodes, **b8)
    node_gh = torch.empty((n_nodes, 2), **f32)
    node_value = torch.empty(n_nodes, **f32)
    state = torch.empty(n_nodes, **u8)
    active_next = torch.empty(2 * n_nodes, **b8)
    hist_out = (torch.empty((n_nodes, num_features, nbt, 2), **f32)
                if keep_hist else None)
    with torch.cuda.device(dev):
        code = _build.library("split").xrt_split_level(
            args, hist.data_ptr(), _build.ptr(prev_hist),
            _build.ptr(small_is_right), active.data_ptr(), n_nodes,
            gain.data_ptr(), feature.data_ptr(), split_bin.data_ptr(),
            default_left.data_ptr(), valid.data_ptr(), node_gh.data_ptr(),
            node_value.data_ptr(), state.data_ptr(), active_next.data_ptr(),
            _build.ptr(hist_out), _build.stream_ptr(dev))
    _build.check(code, "K2 split level")
    split_level.launches += 1
    return LevelStep(
        LevelSplits(gain, feature, split_bin, default_left, valid, node_gh),
        node_value, state, active_next, hist_out)


split_level.launches = 0


def leaf_records_plain(node_gh: torch.Tensor, active: torch.Tensor,
                       rec: TreeRecords):
    """The final level in PyTorch ops (``ops/grow.py:765-780``): every
    active node is a leaf valued from its (G, H). Writes the level's
    records into ``rec.tree``; returns (node_value [n_nodes] f32, state
    [n_nodes] uint8 LEAF / INACTIVE for K3's leaf-value mode)."""
    tree, p = rec.tree, rec.p
    n_nodes = active.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=node_gh.device)
    node_value = torch.where(
        active, p.learning_rate * leaf_weight(node_gh[:, 0], node_gh[:, 1], p),
        zero)
    sl = slice(n_nodes - 1, 2 * n_nodes - 1)
    tree.is_leaf[sl] = active
    tree.value[sl] = node_value
    tree.cover[sl] = torch.where(active, node_gh[:, 1], zero)
    tree.base_weight[sl] = node_value
    return node_value, torch.where(active, LEAF, INACTIVE).to(torch.uint8)


def leaf_records(node_gh: torch.Tensor, active: torch.Tensor,
                 rec: TreeRecords):
    """K2's final-level form, one launch per tree: ``node_gh`` [n_nodes, 2]
    (K1's all-reduced totals), ``active`` [n_nodes] bool. CPU tensors ->
    plain version, CUDA tensors -> kernel."""
    if not node_gh.is_cuda:
        return leaf_records_plain(node_gh, active, rec)
    n_nodes = active.shape[0]
    dev = node_gh.device
    _check(node_gh.dtype == torch.float32 and node_gh.shape == (n_nodes, 2)
           and node_gh.is_contiguous(),
           "leaf_records: node_gh must be contiguous f32 [n_nodes, 2]")
    _check_node_array(active, n_nodes, torch.bool, dev, "leaf_records: active")
    _check(rec.cuts.device == dev
           and rec.tree.feature.shape[0] >= 2 * n_nodes - 1,
           "leaf_records: the tree must hold the level")
    args = rec.c_args()
    node_value = torch.empty(n_nodes, dtype=torch.float32, device=dev)
    state = torch.empty(n_nodes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        code = _build.library("split").xrt_leaf_records(
            args, node_gh.data_ptr(), active.data_ptr(), n_nodes,
            node_value.data_ptr(), state.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "K2 leaf records")
    leaf_records.launches += 1
    return node_value, state


leaf_records.launches = 0
