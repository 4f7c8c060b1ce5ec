"""Split search (K2): one tree level's per-node work.

Port of ``xgboost_ray_tpu/ops/split.py``: ``SplitParams`` (``:27``),
``score`` (``:50``), ``leaf_weight`` (``:56``), ``bounded_weight``
(``:64``), ``score_given_weight`` (``:69``) and the numeric
``find_splits`` (``:79``, with its monotone branch); and of the per-node
part of a level of the JAX ``build_tree`` around it
(``ops/grow.py:565-771``: the sibling histogram, the readout, the
interaction mask, the records, the children's monotone bounds), which
``split_level`` does in one launch per level, and of its final level
(``:765-780``, ``leaf_records``).

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

Constraints (``TreeConstraints``, made once a run): with a monotone
constraint on any feature every candidate of every feature is scored from
child weights clamped to the node's [lower, upper] interval
(``score_given_weight``), a candidate whose clamped weights break its
feature's sign scores -inf, node values are clamped too, and each split
narrows its children's intervals at the midpoint of the winner's two
weights (``ops/grow.py:710-748``). Interaction constraints mask the
features a node may split on: those of the groups that hold every feature
split on above it, and those features themselves (``:625-641``,
``:750-760``); K2 reads them off the node's ancestors in the tree it
writes (``interaction_mask``).

Categorical features (``TreeRecords.cat``, the reference's ``cat_mask``,
``ops/split.py:84-110``): bins are category codes and candidate s is the
one-vs-rest split "category s goes left", so its left child is the single
slot (g[s], h[s]) and not the prefix sum; everything else (both missing
directions, the gate, the constraints, the first-max rule) is unchanged,
and under monotone constraints the winner's carried child weights are the
single slot's. ``split_nodes`` is the level kernel without records, for
the lossguide grower's two children a step.
"""

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Tuple

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


def bounded_weight(g, h, p: SplitParams, lower, upper):
    """Leaf weight clamped to a node's feasible interval (monotone bounds):
    ``jnp.clip``, ``minimum(upper, maximum(lower, w))``."""
    return torch.minimum(upper, torch.maximum(lower, leaf_weight(g, h, p)))


def score_given_weight(g, h, p: SplitParams, w, child: bool = False):
    """Objective reduction of a (possibly bound-clamped) weight w:
    -(2 T(g) w + (h + lambda) w^2) (equal to ``score`` in exact arithmetic
    only), rounded as the reference's compiled CPU program rounds it
    (``find_splits`` compiled alone): -fma(2 T(g), w, ((h + lambda) w) w);
    a ``child``'s term, where ``reg_alpha`` is 0 and ``max_delta_step`` is
    on, -fma(w, (h + lambda) w, w 2 T(g)) (XLA's simplified soft threshold
    and clip leave its operands in the other order, and LLVM fuses the
    first product)."""
    from xgboost_ray_tpu_torch.ops.objectives import _fma

    t = _soft_threshold(g, p.reg_alpha)
    if child and _child_hw_first(p):
        return -_fma(w, (h + p.reg_lambda) * w, w * (2.0 * t))
    return -_fma(2.0 * t, w, (h + p.reg_lambda) * w * w)


def _child_hw_first(p: SplitParams) -> bool:
    """Whether the children's ``score_given_weight`` fuses its other
    product (``reg_alpha`` 0, ``max_delta_step`` on)."""
    return p.reg_alpha == 0.0 and p.max_delta_step > 0.0


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


def find_splits_plain(hist: torch.Tensor, p: SplitParams,
                      feature_mask: Optional[torch.Tensor] = None,
                      monotone: Optional[torch.Tensor] = None,
                      lower: Optional[torch.Tensor] = None,
                      upper: Optional[torch.Tensor] = None,
                      cat: Optional[torch.Tensor] = None) -> LevelSplits:
    """The JAX ``find_splits`` in PyTorch, with the node totals read off
    feature 0's buckets as ``build_tree`` does.
    ``feature_mask`` [F] or [n_nodes, F] bool: a masked feature's
    candidates score -inf (``:148-155``), then the first maximum wins.
    ``monotone`` [F] (-1 / 0 / +1) with ``lower`` / ``upper`` [n_nodes]
    (default -inf / +inf): the constrained branch (``:116-134``).
    ``cat`` [F] bool: the categorical features' one-vs-rest candidates
    (``:108-110``)."""
    return _search_plain(hist, p, feature_mask, monotone, lower, upper,
                         cat)[0]


def _search_plain(hist, p: SplitParams, feature_mask, monotone, lower, upper,
                  cat=None, totals=None):
    """``find_splits_plain`` and, with ``monotone``, the winner's clamped
    (w_left, w_right) [n_nodes] in the direction it chose (None without).
    ``totals`` [n_nodes, 2]: the node totals given (the reference's exact
    totals), else read off feature 0's buckets."""
    n_nodes, num_features, nbt, _ = hist.shape
    n_bins = nbt - 1
    node_gh = tree_sum(hist[:, 0]) if totals is None else totals
    g = hist[..., 0]
    h = hist[..., 1]
    gm, hm = g[..., n_bins], h[..., n_bins]
    gl = blocked_cumsum(g[..., :n_bins])[..., : n_bins - 1]
    hl = blocked_cumsum(h[..., :n_bins])[..., : n_bins - 1]
    if cat is not None:
        cm = cat[None, :, None]
        gl = torch.where(cm, g[..., : n_bins - 1], gl)
        hl = torch.where(cm, h[..., : n_bins - 1], hl)
    gp = node_gh[:, 0][:, None, None]
    hp = node_gh[:, 1][:, None, None]
    neg_inf = torch.tensor(float("-inf"), device=hist.device)

    if monotone is not None:
        inf = torch.full((n_nodes,), float("inf"), device=hist.device)
        lo = (-inf if lower is None else lower)[:, None, None]
        hi = (inf if upper is None else upper)[:, None, None]
        mono = monotone.to(torch.float32)[None, :, None]
        parent = score_given_weight(gp, hp, p,
                                    bounded_weight(gp, hp, p, lo, hi))

        def gain_for(gl_, hl_):
            gr_, hr_ = gp - gl_, hp - hl_
            ok = (hl_ >= p.min_child_weight) & (hr_ >= p.min_child_weight)
            wl = bounded_weight(gl_, hl_, p, lo, hi)
            wr = bounded_weight(gr_, hr_, p, lo, hi)
            viol = ((mono > 0) & (wl > wr)) | ((mono < 0) & (wl < wr))
            gain = (score_given_weight(gl_, hl_, p, wl, child=True)
                    + score_given_weight(gr_, hr_, p, wr, child=True)
                    - parent)
            return torch.where(ok & ~viol, gain, neg_inf), (wl, wr)
    else:
        parent = score(node_gh[:, 0], node_gh[:, 1], p)[:, None, None]

        def gain_for(gl_, hl_):
            gr_, hr_ = gp - gl_, hp - hl_
            ok = (hl_ >= p.min_child_weight) & (hr_ >= p.min_child_weight)
            gain = score(gl_, hl_, p) + score(gr_, hr_, p) - parent
            return torch.where(ok, gain, neg_inf), None

    gain_missing_left, w_ml = gain_for(gl + gm[..., None], hl + hm[..., None])
    gain_missing_right, w_mr = gain_for(gl, hl)
    default_left = gain_missing_left >= gain_missing_right
    gain = torch.maximum(gain_missing_left, gain_missing_right)
    if feature_mask is not None:
        mask = (feature_mask[None, :, None] if feature_mask.dim() == 1
                else feature_mask[:, :, None])
        gain = torch.where(mask, gain, neg_inf)

    flat = gain.reshape(n_nodes, -1)
    best = torch.argmax(flat, dim=-1)  # first max: deterministic ties
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    dl_all = default_left.reshape(n_nodes, -1)
    dl = torch.gather(dl_all, 1, best[:, None])[:, 0]
    valid = torch.isfinite(best_gain) & (best_gain > p.gamma)
    child_w = None
    if w_ml is not None:
        child_w = tuple(
            torch.gather(torch.where(default_left, a, b).reshape(n_nodes, -1),
                         1, best[:, None])[:, 0]
            for a, b in zip(w_ml, w_mr))
    return LevelSplits(
        gain=best_gain,
        feature=(best // (n_bins - 1)).to(torch.int32),
        split_bin=(best % (n_bins - 1)).to(torch.int32),
        default_left=dl,
        valid=valid,
        node_gh=node_gh,
    ), child_w


def _check_node_array(t, n: int, dtype, dev, what: str) -> None:
    _check(t.dtype == dtype and t.shape == (n,) and t.device == dev
           and t.is_contiguous(), f"{what} must be contiguous {dtype} [{n}] "
           f"on {dev}")


def _cat_row(cat: Optional[torch.Tensor], n_features: int, dev,
             what: str) -> Optional[torch.Tensor]:
    """The [F] categorical flags as the kernels read them (a bool tensor's
    bytes are 0 / 1: its storage is the kernels' uint8 row), checked; None
    where no feature is categorical."""
    if cat is None:
        return None
    _check(cat.dtype == torch.bool and cat.shape == (n_features,)
           and cat.device == dev and cat.is_contiguous(),
           f"{what}: cat must be contiguous bool [F] on {dev}")
    return cat


def _check_totals(totals: Optional[torch.Tensor], n_nodes: int, dev,
                  what: str) -> None:
    _check(totals is None or (
        totals.dtype == torch.float32 and totals.shape == (n_nodes, 2)
        and totals.device == dev and totals.is_contiguous()),
        f"{what}: totals must be contiguous f32 [n_nodes, 2] on {dev}")


def _check_hist(hist: torch.Tensor, what: str) -> None:
    _check(hist.dtype == torch.float32 and hist.dim() == 4
           and hist.shape[3] == 2 and hist.is_contiguous()
           and hist.data_ptr() % 8 == 0,
           f"{what}: hist must be 8-byte aligned contiguous f32 "
           "[n_nodes, F, nbt, 2]")
    _check(2 < hist.shape[2] <= 1025, f"{what}: max_bin must be in (1, 1024]")


def find_splits(hist: torch.Tensor, p: SplitParams,
                cat: Optional[torch.Tensor] = None) -> LevelSplits:
    """K2 alone (no sibling formation, no records), ``cat`` [F] bool the
    categorical features: CPU tensors -> plain version, CUDA tensors ->
    one launch of the level kernel."""
    if not hist.is_cuda:
        return find_splits_plain(hist, p, cat=cat)
    _check_hist(hist, "find_splits")
    n_nodes, num_features, nbt, _ = hist.shape
    dev = hist.device
    cat_row = _cat_row(cat, num_features, dev, "find_splits")
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
            _build.ptr(cat_row), _build.stream_ptr(dev))
    _build.check(code, "K2 split search")
    find_splits.launches += 1
    return LevelSplits(gain, feature, split_bin, default_left, valid, node_gh)


find_splits.launches = 0


# --------------------------------------------------------------------------
# one tree level: sibling formation + split search + records (K2)
# --------------------------------------------------------------------------

class TreeConstraints:
    """What K2 reads of ``monotone_constraints`` and
    ``interaction_constraints`` (the engine's validated, zero-padded tuples
    of ``GrowConfig``), made once a run on ``device``: ``monotone`` int8
    [F] (None where every entry is 0: the reference's ``mono_on``),
    ``membership`` bool [S, F] (group s holds feature f) and ``ic_bits``
    int32 [F, ceil(S / 32)] (bit s % 32 of word s // 32 set where group s
    holds feature f), both None without interaction constraints."""

    def __init__(self, monotone: tuple, interaction: tuple, n_features: int,
                 device):
        self.monotone = (torch.tensor(monotone, dtype=torch.int8,
                                      device=device)
                         if any(int(c) != 0 for c in monotone) else None)
        self.membership = self.ic_bits = None
        if interaction:
            n_sets = len(interaction)
            mem = torch.zeros((n_sets, n_features), dtype=torch.bool)
            for s, grp in enumerate(interaction):
                for fi in grp:
                    if fi < n_features:
                        mem[s, fi] = True
            words = torch.zeros((n_features, -(-n_sets // 32)),
                                dtype=torch.int64)
            for s in range(n_sets):
                words[:, s // 32] |= mem[s].to(torch.int64) << (s % 32)
            # the words' bit patterns as int32 (two's complement)
            words = torch.where(words >= 1 << 31, words - (1 << 32), words)
            self.membership = mem.to(device)
            self.ic_bits = words.to(torch.int32).to(device)

    @property
    def on(self) -> bool:
        return self.monotone is not None or self.membership is not None


def interaction_mask(tree_feature: torch.Tensor, n_nodes: int,
                     membership: torch.Tensor) -> torch.Tensor:
    """The features each node of the level of ``n_nodes`` nodes may split
    on, bool [n_nodes, F], from its ancestors in the tree being written
    (``tree_feature`` [heap] int32, -1 where a node did not split): K2's
    derivation. The ancestors' features are the reference's ``ic_used``,
    the groups holding every one of them its ``ic_active``, and a node
    with a split ancestor its ``ic_has_used`` (``ops/grow.py:625-641``,
    ``:750-760``): such a node may use the features of those groups and
    the ancestors' own; the root, and a node below no split, any."""
    n_sets, num_features = membership.shape
    dev = membership.device
    node = torch.arange(n_nodes, device=dev)
    depth = n_nodes.bit_length() - 1
    used = torch.zeros((n_nodes, num_features), dtype=torch.bool, device=dev)
    has_used = torch.zeros(n_nodes, dtype=torch.bool, device=dev)
    active = torch.ones((n_nodes, n_sets), dtype=torch.bool, device=dev)
    for j in range(1, depth + 1):
        fa = tree_feature[(1 << (depth - j)) - 1 + (node >> j)].long()
        split = fa >= 0
        f0 = fa.clamp(min=0)
        used[split, f0[split]] = True
        has_used |= split
        active &= torch.where(split[:, None], membership.T[f0], True)
    union = (active[:, :, None] & membership[None]).any(dim=1)
    return torch.where(has_used[:, None], union | used, True)


_TREE_DTYPES = (("feature", torch.int32), ("split_bin", torch.int32),
                ("threshold", torch.float32), ("default_left", torch.bool),
                ("is_leaf", torch.bool), ("value", torch.float32),
                ("gain", torch.float32), ("cover", torch.float32),
                ("base_weight", torch.float32))


class TreeRecords:
    """The tree a grower writes, level by level, and what its levels share:
    ``tree`` (the padded-heap ``Tree`` of ``ops/grow.py``, written in
    place), ``cuts`` [F, max_bin - 1] f32, ``feat_has_missing`` [F] bool or
    None, the split parameters, the constraints (``TreeConstraints`` or
    None) and ``cat``, the categorical features' flags (bool [F], or None:
    none). On a CUDA device the C struct of their pointers is checked and
    filled once per tree (:meth:`c_args`)."""

    def __init__(self, tree, cuts: torch.Tensor, feat_has_missing,
                 p: SplitParams, cons: Optional[TreeConstraints] = None,
                 cat: Optional[torch.Tensor] = None):
        self.tree = tree
        self.cuts = cuts
        self.feat_has_missing = feat_has_missing
        self.p = p
        self.cons = cons if cons is not None and cons.on else None
        self.cat = cat
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
            mono = bits = None
            if self.cons is not None:
                mono, bits = self.cons.monotone, self.cons.ic_bits
                if mono is not None:
                    _check_node_array(mono, cuts.shape[0], torch.int8, dev,
                                      "monotone")
                _check(bits is None or (
                    bits.dtype == torch.int32 and bits.is_contiguous()
                    and bits.device == dev and bits.dim() == 2
                    and bits.shape[0] == cuts.shape[0]),
                    "ic_bits must be contiguous int32 [F, words]")
            cat = _cat_row(self.cat, cuts.shape[0], dev, "TreeRecords")
            p = self.p
            self._c = _build.TreeArgs(
                *(getattr(t, name).data_ptr() for name, _ in _TREE_DTYPES),
                cuts.data_ptr(), _build.ptr(fhm), cuts.shape[0],
                cuts.shape[1] + 2, p.reg_lambda, p.reg_alpha, p.gamma,
                p.min_child_weight, max(p.max_delta_step, 0.0),
                p.learning_rate, _build.ptr(mono), _build.ptr(bits),
                0 if bits is None else bits.shape[1],
                _build.ptr(cat))
        return ctypes.addressof(self._c)


class LevelStep(NamedTuple):
    """What one level's step hands to K3 and to the next level."""

    splits: LevelSplits  # best split per node, unmasked
    node_value: torch.Tensor  # [n_nodes] f32: lr * leaf_weight(G, H)
    state: torch.Tensor  # [n_nodes] uint8 SPLIT / LEAF / INACTIVE for K3
    active: torch.Tensor  # [2 n_nodes] bool: the next level's active nodes
    hist: Optional[torch.Tensor]  # the formed histogram: the next prev_hist
    # monotone constraints: the next level's (lower, upper) [2 n_nodes] f32
    bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def _interleave(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """[n, ...] x 2 -> [2n, ...] as (left_0, right_0, left_1, ...)."""
    return torch.stack([left, right], dim=1).reshape(
        (2 * left.shape[0],) + left.shape[1:])


def _level_constraints(rec: TreeRecords, n_nodes: int, feature_mask,
                       bounds, ic_allowed, what: str):
    """(monotone or None, lower, upper, the search's feature mask) of one
    level: the column-sampling mask ANDed with the interaction mask
    (``ic_allowed`` where the caller holds it, else derived from the
    tree's ancestors: ``interaction_mask``) as ``ops/grow.py:634-637``
    combines them."""
    cons = rec.cons
    mono = lower = upper = None
    if cons is None:
        _check(bounds is None and ic_allowed is None,
               f"{what}: bounds and ic_allowed need the tree's constraints")
        return mono, lower, upper, feature_mask
    if cons.monotone is not None:
        _check(bounds is not None, f"{what}: monotone constraints need the "
                                   f"level's (lower, upper) bounds")
        mono, (lower, upper) = cons.monotone, bounds
    fmask = feature_mask
    if cons.membership is not None:
        allowed = (ic_allowed if ic_allowed is not None else
                   interaction_mask(rec.tree.feature, n_nodes,
                                    cons.membership))
        fmask = allowed if fmask is None else (
            (fmask[None, :] if fmask.dim() == 1 else fmask) & allowed)
    return mono, lower, upper, fmask


def child_bounds(mono, feature, valid_split, lower, upper, wl, wr):
    """The children's (lower, upper) [2 n_nodes] (``ops/grow.py:736-748``):
    a split on a feature of sign c narrows one side of each child's
    interval to the midpoint of its winner's clamped child weights."""
    mid = 0.5 * (wl + wr)
    c = torch.where(valid_split, mono.long()[feature.long()], 0)
    lower_l = torch.where(c < 0, torch.maximum(lower, mid), lower)
    upper_l = torch.where(c > 0, torch.minimum(upper, mid), upper)
    lower_r = torch.where(c > 0, torch.maximum(lower, mid), lower)
    upper_r = torch.where(c < 0, torch.minimum(upper, mid), upper)
    return _interleave(lower_l, lower_r), _interleave(upper_l, upper_r)


def _formed(hist, prev_hist, small_is_right, feat_has_missing):
    """The level's histogram as K2's prologue forms it: with ``prev_hist``
    each parent's children, the smaller one as given and its sibling as
    parent - smaller child; the phantom missing bucket zeroed."""
    if prev_hist is not None:
        big = prev_hist - hist
        sir = small_is_right[:, None, None, None]
        hist = _interleave(torch.where(sir, big, hist),
                           torch.where(sir, hist, big))
    return zero_phantom_missing(hist, feat_has_missing)


def split_level_plain(hist, prev_hist, small_is_right, active,
                      rec: TreeRecords, keep_hist: bool = True,
                      feature_mask: Optional[torch.Tensor] = None,
                      bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      ic_allowed: Optional[torch.Tensor] = None,
                      totals: Optional[torch.Tensor] = None
                      ) -> LevelStep:
    """The level step in PyTorch ops, as the JAX grower composes it: the
    sibling as parent - smaller child (``prev_hist`` given), the phantom
    missing bucket zeroed, the readout and split search (under
    ``feature_mask``, [F] or [n_nodes, F] bool, where given, and the
    constraints of ``rec.cons``: ``bounds`` the level's (lower, upper)
    [n_nodes], ``ic_allowed`` [n_nodes, F] an interaction mask the caller
    keeps, else ``interaction_mask``), the records of
    ``ops/grow.py:661-684`` written into ``rec.tree``, and with monotone
    constraints the next level's bounds."""
    tree, cuts, p = rec.tree, rec.cuts, rec.p
    hist = _formed(hist, prev_hist, small_is_right, rec.feat_has_missing)
    n_nodes, num_features, nbt, _ = hist.shape
    max_bin = nbt - 1
    base = n_nodes - 1
    lr = p.learning_rate
    zero = torch.zeros((), dtype=torch.float32, device=hist.device)
    mono, lower, upper, fmask = _level_constraints(
        rec, n_nodes, feature_mask, bounds, ic_allowed, "split_level")

    sp, child_w = _search_plain(hist, p, fmask, mono, lower, upper, rec.cat,
                                totals)
    node_gh = sp.node_gh
    valid_split = sp.valid & active
    node_value = lr * (leaf_weight(node_gh[:, 0], node_gh[:, 1], p)
                       if mono is None else
                       bounded_weight(node_gh[:, 0], node_gh[:, 1], p, lower,
                                      upper))
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
    nxt = (None if mono is None else
           child_bounds(mono, fsafe, valid_split, lower, upper, *child_w))
    return LevelStep(sp, node_value, state,
                     torch.repeat_interleave(valid_split, 2),
                     hist if keep_hist else None, nxt)


def split_level(hist: torch.Tensor, prev_hist: Optional[torch.Tensor],
                small_is_right: Optional[torch.Tensor], active: torch.Tensor,
                rec: TreeRecords, keep_hist: bool = True,
                feature_mask: Optional[torch.Tensor] = None,
                bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                ic_allowed: Optional[torch.Tensor] = None,
                totals: Optional[torch.Tensor] = None) -> LevelStep:
    """K2 for one tree level, one launch: ``hist`` is K1's (all-reduced)
    histogram of the level's ``n_nodes`` nodes, or with ``prev_hist`` and
    ``small_is_right`` that of each parent's smaller child. ``active``
    [n_nodes] bool. Writes the level's slice of ``rec.tree``; the formed
    histogram comes back as ``hist`` when ``keep_hist`` (the next level's
    ``prev_hist``). ``feature_mask`` ([F] or [n_nodes, F] bool, column
    sampling) takes K2's masked instantiation: a masked feature's
    candidates score -inf. The tree's constraints (``rec.cons``) take its
    constrained instantiation: ``bounds`` is the level's (lower, upper)
    [n_nodes] f32 under monotone constraints, the next level's come back
    in ``LevelStep.bounds``; the kernel reads each node's interaction mask
    off its ancestors in ``rec.tree`` (``ic_allowed``, a mask the caller
    keeps, is for the plain version only). ``totals`` [n_nodes, 2] f32:
    the nodes' (G, H) given (the exact totals of a quantized wire, or the
    dequantized integer sums of quantized gradients), else read off the
    histogram (the main path). CPU tensors -> plain version, CUDA tensors
    -> kernel (``launches_masked`` counts the masked launches,
    ``launches_constrained`` the constrained ones, ``launches_categorical``
    those with categorical features)."""
    if not hist.is_cuda:
        return split_level_plain(hist, prev_hist, small_is_right, active,
                                 rec, keep_hist, feature_mask, bounds,
                                 ic_allowed, totals)
    _check(ic_allowed is None, "split_level: ic_allowed is the plain "
                               "version's; the kernel derives the mask")
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
    mask_rows = 0
    if feature_mask is not None:
        mask_rows = 1 if feature_mask.dim() == 1 else n_nodes
        _check(feature_mask.dtype == torch.bool and feature_mask.device == dev
               and feature_mask.is_contiguous()
               and feature_mask.shape[-1] == num_features
               and feature_mask.numel() == mask_rows * num_features,
               "split_level: feature_mask must be contiguous bool [F] or "
               "[n_nodes, F] on the histogram's device")
    mono = rec.cons is not None and rec.cons.monotone is not None
    _check(mono == (bounds is not None),
           "split_level: bounds go with monotone constraints, and only")
    _check_totals(totals, n_nodes, dev, "split_level")
    if mono:
        for b in bounds:
            _check_node_array(b, n_nodes, torch.float32, dev,
                              "split_level: bounds")
    args = rec.c_args()
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    u8 = dict(dtype=torch.uint8, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    nxt = ((torch.empty(2 * n_nodes, **f32), torch.empty(2 * n_nodes, **f32))
           if mono else None)
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
            _build.ptr(hist_out), _build.ptr(feature_mask), mask_rows,
            *(_build.ptr(b) for b in (bounds or (None, None))),
            *(_build.ptr(b) for b in (nxt or (None, None))),
            _build.ptr(totals), _build.stream_ptr(dev))
    _build.check(code, "K2 split level")
    split_level.launches += 1
    if mask_rows:
        split_level.launches_masked += 1
    if rec.cons is not None:
        split_level.launches_constrained += 1
    if rec.cat is not None:
        split_level.launches_categorical += 1
    return LevelStep(
        LevelSplits(gain, feature, split_bin, default_left, valid, node_gh),
        node_value, state, active_next, hist_out, nxt)


split_level.launches = 0
split_level.launches_masked = 0
split_level.launches_constrained = 0
split_level.launches_categorical = 0


def split_nodes_plain(hist, prev_hist, small_is_right, rec: TreeRecords,
                      hist_out: torch.Tensor,
                      feature_mask: Optional[torch.Tensor] = None,
                      totals: Optional[torch.Tensor] = None
                      ) -> LevelSplits:
    """``split_nodes`` in PyTorch ops: the nodes' histogram formed as
    ``split_level_plain`` forms it (the sibling as parent - smaller child
    where ``prev_hist`` is given, the phantom missing bucket zeroed) and
    written to ``hist_out``, then the search under ``feature_mask`` and
    ``rec.cat``."""
    hist = _formed(hist if prev_hist is not None else hist.clone(),
                   prev_hist, small_is_right, rec.feat_has_missing)
    hist_out.copy_(hist)
    return _search_plain(hist, rec.p, feature_mask, None, None, None,
                         rec.cat, totals)[0]


def split_nodes(hist: torch.Tensor, prev_hist: Optional[torch.Tensor],
                small_is_right: Optional[torch.Tensor], rec: TreeRecords,
                hist_out: torch.Tensor,
                feature_mask: Optional[torch.Tensor] = None,
                totals: Optional[torch.Tensor] = None) -> LevelSplits:
    """K2's level kernel without records (the lossguide grower's search of
    a step's two children, or of the root): ``hist`` [n, F, nbt, 2] the
    nodes' histogram, or with ``prev_hist`` [1, F, nbt, 2] (the parent's
    formed histogram) and ``small_is_right`` [1] bool the smaller child's
    [1, F, nbt, 2], from which the two children are formed as the level
    step forms siblings. The formed histogram goes to ``hist_out`` [n or 2,
    F, nbt, 2] (a slice of the grower's store). ``feature_mask`` [F]
    bool takes the masked instantiation; ``rec.cat`` the categorical
    candidates; ``totals`` [n, 2] the nodes' (G, H) given (else read off
    the histogram, as ``split_level``). No tree record is written. CPU
    tensors -> plain version, CUDA tensors -> kernel."""
    if not hist.is_cuda:
        return split_nodes_plain(hist, prev_hist, small_is_right, rec,
                                 hist_out, feature_mask, totals)
    _check(rec.cons is None, "split_nodes: the lossguide grower takes no "
                             "constraints")
    _check_hist(hist, "split_nodes")
    dev = hist.device
    _, num_features, nbt, _ = hist.shape
    n_nodes = hist.shape[0] if prev_hist is None else 2
    if prev_hist is not None:
        _check(hist.shape[0] == 1 and prev_hist.shape == hist.shape
               and prev_hist.device == dev,
               "split_nodes: prev_hist and hist must be [1, F, nbt, 2]")
        _check_hist(prev_hist, "split_nodes")
        _check_node_array(small_is_right, 1, torch.bool, dev,
                          "split_nodes: small_is_right")
    _check_hist(hist_out, "split_nodes")
    _check(hist_out.shape == (n_nodes, num_features, nbt, 2)
           and hist_out.device == dev,
           "split_nodes: hist_out must be [n_nodes, F, nbt, 2]")
    _check(rec.cuts.device == dev and rec.cuts.shape == (num_features,
                                                         nbt - 2),
           "split_nodes: cuts [F, max_bin - 1] must match hist")
    _check_totals(totals, n_nodes, dev, "split_nodes")
    if feature_mask is not None:
        _check(feature_mask.dtype == torch.bool and feature_mask.device == dev
               and feature_mask.shape == (num_features,)
               and feature_mask.is_contiguous(),
               "split_nodes: feature_mask must be contiguous bool [F]")
    args = rec.c_args()
    f32 = dict(dtype=torch.float32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    gain = torch.empty(n_nodes, **f32)
    feature = torch.empty(n_nodes, dtype=torch.int32, device=dev)
    split_bin = torch.empty(n_nodes, dtype=torch.int32, device=dev)
    default_left = torch.empty(n_nodes, **b8)
    valid = torch.empty(n_nodes, **b8)
    node_gh = torch.empty((n_nodes, 2), **f32)
    with torch.cuda.device(dev):
        code = _build.library("split").xrt_split_level(
            args, hist.data_ptr(), _build.ptr(prev_hist),
            _build.ptr(small_is_right), None, n_nodes, gain.data_ptr(),
            feature.data_ptr(), split_bin.data_ptr(),
            default_left.data_ptr(), valid.data_ptr(), node_gh.data_ptr(),
            None, None, None, hist_out.data_ptr(),
            _build.ptr(feature_mask), 0 if feature_mask is None else 1,
            None, None, None, None, _build.ptr(totals),
            _build.stream_ptr(dev))
    _build.check(code, "K2 split nodes")
    split_nodes.launches += 1
    if rec.cat is not None:
        split_nodes.launches_categorical += 1
    return LevelSplits(gain, feature, split_bin, default_left, valid, node_gh)


split_nodes.launches = 0
split_nodes.launches_categorical = 0


def leaf_records_plain(node_gh: torch.Tensor, active: torch.Tensor,
                       rec: TreeRecords,
                       bounds: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None):
    """The final level in PyTorch ops (``ops/grow.py:765-780``): every
    active node is a leaf valued from its (G, H), clamped to ``bounds``
    (lower, upper) [n_nodes] under monotone constraints. Writes the
    level's records into ``rec.tree``; returns (node_value [n_nodes] f32,
    state [n_nodes] uint8 LEAF / INACTIVE for K3's leaf-value mode)."""
    tree, p = rec.tree, rec.p
    n_nodes = active.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=node_gh.device)
    w = (leaf_weight(node_gh[:, 0], node_gh[:, 1], p) if bounds is None
         else bounded_weight(node_gh[:, 0], node_gh[:, 1], p, *bounds))
    node_value = torch.where(active, p.learning_rate * w, zero)
    sl = slice(n_nodes - 1, 2 * n_nodes - 1)
    tree.is_leaf[sl] = active
    tree.value[sl] = node_value
    tree.cover[sl] = torch.where(active, node_gh[:, 1], zero)
    tree.base_weight[sl] = node_value
    return node_value, torch.where(active, LEAF, INACTIVE).to(torch.uint8)


def leaf_records(node_gh: torch.Tensor, active: torch.Tensor,
                 rec: TreeRecords,
                 bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """K2's final-level form, one launch per tree: ``node_gh`` [n_nodes, 2]
    (K1's all-reduced totals), ``active`` [n_nodes] bool, ``bounds`` the
    level's (lower, upper) [n_nodes] f32 under monotone constraints. CPU
    tensors -> plain version, CUDA tensors -> kernel."""
    if not node_gh.is_cuda:
        return leaf_records_plain(node_gh, active, rec, bounds)
    n_nodes = active.shape[0]
    dev = node_gh.device
    _check(node_gh.dtype == torch.float32 and node_gh.shape == (n_nodes, 2)
           and node_gh.is_contiguous(),
           "leaf_records: node_gh must be contiguous f32 [n_nodes, 2]")
    _check_node_array(active, n_nodes, torch.bool, dev, "leaf_records: active")
    for b in bounds or ():
        _check_node_array(b, n_nodes, torch.float32, dev,
                          "leaf_records: bounds")
    _check(rec.cuts.device == dev
           and rec.tree.feature.shape[0] >= 2 * n_nodes - 1,
           "leaf_records: the tree must hold the level")
    args = rec.c_args()
    node_value = torch.empty(n_nodes, dtype=torch.float32, device=dev)
    state = torch.empty(n_nodes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        code = _build.library("split").xrt_leaf_records(
            args, node_gh.data_ptr(), active.data_ptr(), n_nodes,
            *(_build.ptr(b) for b in (bounds or (None, None))),
            node_value.data_ptr(), state.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "K2 leaf records")
    leaf_records.launches += 1
    return node_value, state


leaf_records.launches = 0
