"""Forest prediction on raw feature values, and B8, the forest-walk kernel.

Port of ``xgboost_ray_tpu/ops/predict.py``: ``_step_right`` (``:23``),
``_walk_one_tree`` (``:36``), ``predict_margin`` (``:52``) and
``predict_leaf_index`` (``:512``), with the node-array twins of
``ops/node_array.py`` (``_walk_levels`` ``:105``, ``predict_margin_na``
``:141``, ``predict_leaf_index_na`` ``:171``).

The forest goes to the device once per model as a :class:`PredictForest`:
one packed 8-byte record per node (``pack_nodes``), in the padded-heap or
the node-array order. Above the last level a record holds a float (the
threshold of a numeric split, the category code of a categorical one, the
value of a leaf) and a word: the feature index, clamped to ``[0, F - 1]``,
in 24 bits and the flags ``LEAF``, ``DEFAULT_LEFT`` and ``CATEGORICAL``
above them (the categorical flag from the model's ``cat_features``). Every
node below a leaf holds a copy of the leaf's record, and a last-level
record holds the value a row ends with and the heap index of its leaf, so
a walk is ``max_depth`` steps of one record read, with no leaf test, and
reads the value and leaf index where it ends. That is the reference's
walk: a row freezes at its first leaf, and a row that meets none reads the
level-``max_depth`` node it reaches. One index formula per layout
(``_node_pos``) is all that differs between the two walks, in the plain
version and in the kernel alike:

- heap: ``t * heap + 2**k - 1 + p``;
- node array: ``T * (2**k - 1) + t * 2**k + p``

for slot p of level k of tree t. Routing: NaN follows ``default_left``; a
categorical feature goes right when its rounded code (half to even)
differs from the split's code; otherwise ``x >= threshold`` goes right.

Margins. Each tree's leaf value is multiplied by its ``tree_weights`` entry,
a tree at or past ``ntree_limit`` adds 0.0, and the per-class sums are
divided by ``num_parallel_tree`` before the base margin is added. The sums
over trees are a window-32 tree (windows of 32 trees over the zero-padded
axis, half the padding in front, each window and then the window sums
added in order: ``ops/split.tree_sum``): the order of the JAX package's
compiled CPU reduce over more than 32 trees, and an in-order sum up to 32.
With fewer trees the reference's order depends on what XLA fuses around
the reduce (weighted leaves are summed with FMAs, a sum of four gathered
leaves is vectorised), and for K > 1 it sums with a one-hot matrix product
whose order the CPU GEMM picks; there the two agree within float32
summation error. ``tests/test_torch_predict.py`` pins where they are
bitwise. Values: with ``transform`` (an objective's name) the margins go
through the objective's prediction transform (``Objective.transform``:
the sigmoid of ``binary:logistic``, the exp of the log-link objectives and
``survival:aft`` with the reference's own exp, hinge's 0/1; ``VALUE_FNS``),
which the kernel fuses into its epilogue (replacing
``xgboost_ray_tpu/models/booster.py:733-742``); an identity transform,
``reg:quantileerror``'s K outputs included, launches plain margins. The
softmax of ``multi:softprob`` / ``multi:softmax`` cannot be
fused: the kernel lays classes out as ``blockIdx.y``, so no thread holds a
row's K sums; their values are B8's margins, then the softmax pass in its
transform mode (``ops/objectives.softmax_transform``), two launches.

Each wrapper sends CPU tensors to its plain PyTorch version and CUDA
tensors to the kernel (or raises): there is no fallback. ``launches``
counts kernel launches (``launches_by_layout`` splits them by forest
layout, ``launches_by_plan`` by layout and mapping, ``launches_by_mode``
margins from values, ``launches_by_value_fn`` the values by transform). Kernel: ``csrc/predict.cu``; ``launch_plan`` picks
its mapping.
"""

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from xgboost_ray_tpu_torch.ops import _build
from xgboost_ray_tpu_torch.ops.node_array import level_major
from xgboost_ray_tpu_torch.ops.objectives import (
    SOFTPROB,
    VALUE_FNS,
    softmax_transform,
    softmax_transform_plain,
    transform_kind,
    value_transform,
)
from xgboost_ray_tpu_torch.ops.split import tree_sum

#: forest layouts the walk reads: the padded heap and the breadth-first
#: node array (``ops/node_array.py``)
LAYOUTS = ("heap", "node_array")

#: kernel mappings: a row per thread over staged tiles (large batches) and a
#: tree slot per thread with the window sums in shared memory (small ones)
MAPPINGS = ("rows", "windows")
#: the launch counters' keys: (layout, mapping), one per kernel the
#: wrappers launch
PLANS = tuple((lay, m) for lay in LAYOUTS for m in MAPPINGS)

#: a record's word above the last level: feature index, then the flags
FEATURE_MASK = (1 << 24) - 1
LEAF = 1 << 24
DEFAULT_LEFT = 1 << 25
CATEGORICAL = 1 << 26
MAX_FEATURES = 1 << 24

_WINDOW = 32  # the reference's reduce window over trees
_MAX_TREES = 1 << 20  # four window levels; node indices fit int32 below
_KERNEL_LEVELS = 4  # XRT_LEVELS of csrc/predict.cu
_MODES = {"margin": 0, "leaf": 1, "value": 2}  # XRT_MARGIN, ... of the kernel
_ROW_TILE = 512  # XRT_ROW_TILE: rows per CTA of the rows mapping
#: shared memory a CTA may take for 3, 2 or 1 CTAs an SM (228 KB, 1 KB
#: reserved a CTA; above 48 KB after the opt-in attribute)
_SHARED_BUDGETS = (75 * 1024, 113 * 1024, 227 * 1024)
_SHARED_MAX = _SHARED_BUDGETS[-1]
#: rows per plain walk step are (this / trees): the [T, rows] temporaries
_PLAIN_CHUNK_ELEMS = 1 << 22


class PredictForest(NamedTuple):
    """The packed forest on one device: ``nodes`` int32 ``[T * heap, 2]``
    (the record's float bits, its word) in ``layout`` order."""

    nodes: torch.Tensor
    n_trees: int
    max_depth: int
    layout: str
    num_features: int
    has_cat: bool


def pack_nodes(forest, max_depth: int, num_features: int,
               cat_features: Sequence[int] = ()) -> np.ndarray:
    """A stacked padded-heap forest (numpy fields ``[T, heap]``) -> packed
    records ``[T, heap, 2]`` int32 in heap order (see the module note)."""
    feature = np.asarray(forest.feature)
    n_trees, heap = feature.shape
    if heap != (2 << max_depth) - 1:
        raise ValueError(f"heap width {heap} does not match max_depth "
                         f"{max_depth}")
    if not 1 <= num_features < MAX_FEATURES:
        raise ValueError(f"B8 packs a feature index in 24 bits: "
                         f"num_features={num_features} must be in "
                         f"[1, {MAX_FEATURES})")
    is_leaf = np.asarray(forest.is_leaf, bool)
    value = np.asarray(forest.value, np.float32)
    # owner: the first leaf above or at a node (-1: none), by level
    owner = np.full((n_trees, heap), -1, np.int64)
    for k in range(max_depth + 1):
        idx = np.arange((1 << k) - 1, (2 << k) - 1)
        up = owner[:, (idx - 1) // 2] if k else np.full((n_trees, 1), -1)
        own = np.where(is_leaf[:, idx] & (k < max_depth), idx[None, :], -1)
        owner[:, idx] = np.where(up >= 0, up, own)
    fc = np.clip(feature, 0, num_features - 1).astype(np.int64)
    cat = np.isin(fc, np.asarray(list(cat_features), np.int64))
    code = np.asarray(forest.split_bin).astype(np.float32)
    split_value = np.where(cat, code, np.asarray(forest.threshold, np.float32))
    word = (fc | np.where(np.asarray(forest.default_left, bool),
                          DEFAULT_LEFT, 0) | np.where(cat, CATEGORICAL, 0))
    src = np.where(owner >= 0, owner, np.arange(heap)[None, :])
    ends = np.take_along_axis(value, src, axis=1)
    rec_value = np.where(owner >= 0, ends, split_value).astype(np.float32)
    word = np.where(owner >= 0, LEAF, word)
    last = slice((1 << max_depth) - 1, heap)
    rec_value[:, last] = ends[:, last]
    word[:, last] = src[:, last]
    out = np.empty((n_trees, heap, 2), np.int32)
    out[..., 0] = rec_value.view(np.int32)
    out[..., 1] = word
    return out


def device_forest(forest, max_depth: int, layout: str = "heap",
                  device="cpu", *, num_features: int,
                  cat_features: Sequence[int] = ()) -> PredictForest:
    """A stacked padded-heap forest (numpy fields ``[T, heap]``, e.g. a
    booster's ``forest``) -> :class:`PredictForest` on ``device``, packed
    for rows of ``num_features`` features, ``cat_features`` categorical."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown forest layout {layout!r}; one of {LAYOUTS}")
    packed = pack_nodes(forest, max_depth, num_features, cat_features)
    packed = (level_major(packed, max_depth) if layout == "node_array"
              else packed.reshape(-1, 2))
    nodes = torch.from_numpy(np.ascontiguousarray(packed)).to(device)
    return PredictForest(nodes, n_trees=int(packed.shape[0]) // (
        (2 << max_depth) - 1), max_depth=int(max_depth), layout=layout,
        num_features=int(num_features), has_cat=bool(len(cat_features)))


def decode_nodes(fo: PredictForest):
    """``(value [T * heap] f32, word [T * heap] int32)`` of the records."""
    return fo.nodes[:, 0].contiguous().view(torch.float32), fo.nodes[:, 1]


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _node_pos(layout: str, k: int, t_col: torch.Tensor, p: torch.Tensor,
              n_trees: int, heap: int) -> torch.Tensor:
    if layout == "heap":
        return t_col * heap + ((1 << k) - 1) + p
    return n_trees * ((1 << k) - 1) + (t_col << k) + p


def _step_right(fo: PredictForest, v, w, xv):
    """The reference's routing rule (``predict.py:23``) on gathered records.
    The categorical test compares the rounded code as a float: for the
    small integer codes a tree holds it decides as the reference's int32
    compare does, also where that cast saturates."""
    present_right = xv >= v
    if fo.has_cat:
        code_differs = torch.round(xv) != v
        present_right = torch.where((w & CATEGORICAL) != 0, code_differs,
                                    present_right)
    return torch.where(torch.isnan(xv), (w & DEFAULT_LEFT) == 0,
                       present_right)


def walk_plain(fo: PredictForest, x: torch.Tensor):
    """Level-synchronous walk of every tree for the rows of ``x`` [n, F]
    (the reference's ``_walk_levels`` on either layout). Returns
    ``(leaf_value [T, n] f32, leaf_heap_index [T, n] int32)``."""
    n, num_features = x.shape
    dev = x.device
    t = fo.n_trees
    heap = (2 << fo.max_depth) - 1
    values, words = decode_nodes(fo)
    t_col = torch.arange(t, dtype=torch.long, device=dev)[:, None]
    row_base = (torch.arange(n, dtype=torch.long, device=dev)
                * num_features)[None, :]
    xf = x.reshape(-1)
    p = torch.zeros((t, n), dtype=torch.long, device=dev)
    for k in range(fo.max_depth):
        pos = _node_pos(fo.layout, k, t_col, p, t, heap)
        w = words[pos]
        xv = xf[row_base + (w & FEATURE_MASK).long()]
        p = 2 * p + _step_right(fo, values[pos], w, xv).long()
    pos = _node_pos(fo.layout, fo.max_depth, t_col, p, t, heap)
    return values[pos], words[pos]


def _plain_rows(n_trees: int) -> int:
    return max(1, _PLAIN_CHUNK_ELEMS // max(n_trees, 1))


def predict_margin_plain(
    fo: PredictForest,
    x: torch.Tensor,  # [N, F] f32 raw (NaN = missing)
    base: Optional[torch.Tensor] = None,  # [N, K] f32, or None for base0
    base0: float = 0.0,
    num_outputs: int = 1,
    num_parallel_tree: int = 1,
    ntree_limit: int = 0,
    tree_weights: Optional[torch.Tensor] = None,  # [T] f32
    out: Optional[torch.Tensor] = None,  # [N, K] f32
    transform: Optional[str] = None,  # an objective's name: values
) -> torch.Tensor:
    """[N, K] margins: base + (window-tree sum of each class's weighted
    leaf values) / num_parallel_tree; with ``transform``, the objective's
    predictions of them ([N, 1], or [N, K] probabilities for
    ``multi:softprob``)."""
    n = x.shape[0]
    k = num_outputs
    dev = x.device
    if out is None:
        out = torch.empty((n, k), dtype=torch.float32, device=dev)
    t_idx = torch.arange(fo.n_trees, device=dev)
    in_class = (((t_idx // num_parallel_tree) % k)[:, None]
                == torch.arange(k, device=dev)[None, :])  # [T, K]
    step = _plain_rows(fo.n_trees * k)
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        leaf, _ = walk_plain(fo, x[lo:hi])  # [T, m]
        if tree_weights is not None:
            leaf = leaf * tree_weights[:, None]
        if ntree_limit:
            leaf = torch.where((t_idx < ntree_limit)[:, None], leaf, 0.0)
        c = leaf.T  # [m, T]
        if k == 1:
            s = tree_sum(c)[:, None]
        else:
            s = tree_sum(torch.where(in_class[None], c[:, :, None], 0.0))
        b = base[lo:hi] if base is not None else base0
        out[lo:hi] = b + s / num_parallel_tree
    if transform is not None:
        kind = transform_kind(transform)
        if kind == "softmax":
            return softmax_transform_plain(out, transform == SOFTPROB
                                           ).reshape(n, -1)
        if k == 1:
            out[:, 0] = value_transform(out[:, 0], kind)
    return out


def predict_leaf_index_plain(fo: PredictForest, x: torch.Tensor,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """[N, T] int32: the heap index of the leaf each row reaches per tree."""
    n = x.shape[0]
    if out is None:
        out = torch.empty((n, fo.n_trees), dtype=torch.int32, device=x.device)
    step = _plain_rows(fo.n_trees)
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        out[lo:hi] = walk_plain(fo, x[lo:hi])[1].T
    return out


# --------------------------------------------------------------------------
# B8: the kernel wrappers
# --------------------------------------------------------------------------


def tree_windows(n_trees: int):
    """The window tree of the sums over trees, as the kernel walks it:
    ``(front0, padded, top, m, front)``. Trees sit at padded positions
    ``front0 + t`` of ``padded`` (32 per first-level window); the
    first-level window sums are the level-1 items, ``m[i]`` items at level
    i, windowed again (``front[i]`` zeros in front) while more than 32; the
    sum is complete at level ``top``."""
    m = [n_trees, -(-n_trees // _WINDOW)]
    front = [(m[1] * _WINDOW - n_trees) // 2 if n_trees > _WINDOW else 0, 0]
    top = 1
    while m[top] > _WINDOW:
        nxt = -(-m[top] // _WINDOW)
        front[top] = (nxt * _WINDOW - m[top]) // 2
        m.append(nxt)
        front.append(0)
        top += 1
    return front[0], m[1] * _WINDOW, top, m, front


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class LaunchPlan(NamedTuple):
    """How one B8 launch maps its work (``csrc/predict.cu``)."""

    mapping: str  # "rows" | "windows"
    rows_per_block: int  # windows: rows per CTA
    trees_per_tile: int  # rows: trees per staged forest tile
    staged: bool  # rows: forest and x tiles in shared memory
    shared_bytes: int


def _rows_plan(heap: int, num_features: int, leaf: bool) -> LaunchPlan:
    """Margins: the largest forest tile that leaves three CTAs an SM, else
    two, else one. Leaf indices: the largest tile one CTA can hold, as a
    row's run of indices written at a time is 4 bytes a tree of the tile.
    When not even two trees and the x tile fit, the walk reads device
    memory."""
    x_bytes = 4 * num_features * _ROW_TILE
    for limit in _SHARED_BUDGETS[-1:] if leaf else _SHARED_BUDGETS:
        for tt in (32, 16, 8, 4, 2):
            b = (16 * tt * heap + x_bytes
                 + (4 * _ROW_TILE * (tt + 1) if leaf else 0))
            if b <= limit:
                return LaunchPlan("rows", 1, tt, True, b)
    return LaunchPlan("rows", 1, 16, False, 4 * _ROW_TILE * 17 if leaf else 0)


def launch_plan(n: int, num_outputs: int, fo: PredictForest, leaf: bool,
                device) -> LaunchPlan:
    """The rows mapping once its 512-row CTAs give every SM one, else the
    windows mapping with R rows a CTA: the most of 8, 4, 2, 1 that still
    gives every SM four CTAs (so a small batch spreads its trees over whole
    CTAs) and whose per-window sums fit a CTA's shared memory. A forest too
    large for even one row's sums takes the rows mapping."""
    k = 1 if leaf else num_outputs
    sms = _sm_count(torch.device(device).index or 0)
    if -(-n // _ROW_TILE) * k < sms:
        r = 8
        while r > 1 and -(-n // r) * k < 4 * sms:
            r //= 2
        # [R][m1][33] contributions and [R][m1] window sums (margins only)
        row_bytes = 0 if leaf else 4 * -(-fo.n_trees // _WINDOW) * (
            _WINDOW + 2)
        while r > 1 and r * row_bytes > _SHARED_MAX:
            r //= 2
        if r * row_bytes <= _SHARED_MAX:
            return LaunchPlan("windows", r, 2, False, r * row_bytes)
    return _rows_plan((2 << fo.max_depth) - 1, fo.num_features, leaf)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _check_x(fo: PredictForest, x: torch.Tensor) -> None:
    _check(x.dtype == torch.float32 and x.dim() == 2 and x.is_contiguous()
           and x.shape[1] == fo.num_features,
           f"B8: x must be contiguous f32 [N, {fo.num_features}] (the "
           f"forest was packed for {fo.num_features} features)")


def _check_forest(fo: PredictForest, x: torch.Tensor) -> None:
    _check(fo.layout in LAYOUTS, f"B8: unknown layout {fo.layout!r}")
    heap = (2 << fo.max_depth) - 1
    _check(1 <= fo.n_trees < _MAX_TREES and fo.n_trees * heap < 2 ** 31,
           f"B8: {fo.n_trees} trees of heap {heap} out of range")
    nodes = fo.nodes
    _check(nodes.device == x.device and nodes.dtype == torch.int32
           and nodes.is_contiguous()
           and nodes.shape == (fo.n_trees * heap, 2)
           and nodes.data_ptr() % 8 == 0,
           f"B8: forest records must be contiguous int32 "
           f"[{fo.n_trees * heap}, 2] on {x.device}")


def _transform_mode(transform: Optional[str], k: int) -> str:
    """The kernel mode of a margin call: ``value`` for a one-output
    transform fused into the kernel's epilogue (the sigmoid of
    ``binary:logistic``, the exp of the log-link objectives and
    ``survival:aft``, hinge's 0/1); the identity (``reg:squarederror`` and
    the other margin-valued objectives, ``reg:quantileerror``'s K outputs)
    launches plain margins; ``softmax`` for the softmax objectives (margins,
    then the softmax pass). Raises for an objective the port does not
    predict values of and for a one-output transform of K > 1 outputs."""
    if transform is None:
        return "margin"
    kind = transform_kind(transform)
    if kind == "softmax":
        return "softmax"
    if k != 1 and kind != "identity":
        raise NotImplementedError(
            f"B8: {transform!r} transforms one output, not K = {k} (the "
            f"port's K-output values are the softmax objectives' and "
            f"reg:quantileerror's)")
    return "margin" if kind == "identity" else "value"


def value_width(transform: str, k: int) -> int:
    """Columns of the values of a ``transform`` call over K outputs: K
    probabilities for ``multi:softprob``, K quantiles for
    ``reg:quantileerror`` with K alphas, else one."""
    if transform == SOFTPROB:
        return k
    return k if transform_kind(transform) == "identity" else 1


def _args(fo: PredictForest, x: torch.Tensor, plan: LaunchPlan, mode: str,
          **kw):
    front0, padded, top, m, front = tree_windows(fo.n_trees)
    a = _build.PredictArgs()
    a.x = x.data_ptr()
    a.nodes = fo.nodes.data_ptr()
    a.n_rows = x.shape[0]
    a.n_features = x.shape[1]
    a.n_trees = fo.n_trees
    a.max_depth = fo.max_depth
    a.layout = LAYOUTS.index(fo.layout)
    a.mode = _MODES[mode]
    a.mapping = MAPPINGS.index(plan.mapping)
    a.has_cat = int(fo.has_cat)
    a.rows_per_block = plan.rows_per_block
    a.trees_per_tile = plan.trees_per_tile
    a.staged = int(plan.staged)
    a.shared_bytes = plan.shared_bytes
    a.front0 = front0
    a.padded = padded
    a.top = top
    for i in range(_KERNEL_LEVELS):
        a.m[i] = m[i] if i < len(m) else 0
        a.front[i] = front[i] if i < len(front) else 0
    for key, value in kw.items():
        setattr(a, key, value)
    return a


def _launch(a, dev, stream, what: str) -> None:
    s = (stream if stream is not None
         else torch.cuda.current_stream(dev)).cuda_stream
    with torch.cuda.device(dev):
        code = _build.library("predict").xrt_predict(ctypes.byref(a), s)
    _build.check(code, what)


def predict_margin(
    fo: PredictForest,
    x: torch.Tensor,
    base: Optional[torch.Tensor] = None,
    base0: float = 0.0,
    num_outputs: int = 1,
    num_parallel_tree: int = 1,
    ntree_limit: int = 0,
    tree_weights: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
    stream: Optional[torch.cuda.Stream] = None,
    transform: Optional[str] = None,
) -> torch.Tensor:
    """B8 margin wrapper: [N, K] f32 (see :func:`predict_margin_plain`);
    with ``transform`` (an objective's name) the values, [N, 1] or, for
    ``multi:softprob``, [N, K] (``value_width``): the transform fused into
    the kernel, or for the softmax objectives the softmax pass after it
    (``out`` then holds the values). ``stream`` defaults to the current
    stream of ``x``'s device."""
    _check_x(fo, x)
    k = num_outputs
    _check(k >= 1 and num_parallel_tree >= 1 and ntree_limit >= 0,
           "B8: num_outputs and num_parallel_tree must be >= 1")
    mode = _transform_mode(transform, k)
    if mode == "softmax":
        shape = (x.shape[0], value_width(transform, k))
        _check(out is None or (out.device == x.device
                               and out.dtype == torch.float32
                               and tuple(out.shape) == shape
                               and out.is_contiguous()),
               f"B8: out must be contiguous f32 {list(shape)} on the device "
               f"of x for {transform!r} values")
        margin = predict_margin(fo, x, base, base0, k, num_parallel_tree,
                                ntree_limit, tree_weights, None, stream)
        if out is None:
            out = torch.empty(shape, dtype=torch.float32, device=x.device)
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with ctx:
            softmax_transform(margin, transform == SOFTPROB,
                              out=out if transform == SOFTPROB
                              else out.view(-1))
        return out
    if not x.is_cuda:
        return predict_margin_plain(fo, x, base, base0, k, num_parallel_tree,
                                    ntree_limit, tree_weights, out, transform)
    _check_forest(fo, x)
    n = x.shape[0]
    dev = x.device
    _check(k < 1 << 16, f"B8: num_outputs={k} is more classes than a grid "
                        f"has rows of CTAs")
    _check(base is None or (base.device == dev and base.dtype == torch.float32
                            and base.shape == (n, k) and base.is_contiguous()),
           "B8: base must be contiguous f32 [N, K] on the device of x")
    _check(tree_weights is None or (
        tree_weights.device == dev and tree_weights.dtype == torch.float32
        and tree_weights.shape == (fo.n_trees,)
        and tree_weights.is_contiguous()),
        "B8: tree_weights must be contiguous f32 [T] on the device of x")
    if out is None:
        out = torch.empty((n, k), dtype=torch.float32, device=dev)
    _check(out.device == dev and out.dtype == torch.float32
           and out.shape == (n, k) and out.is_contiguous(),
           "B8: out must be contiguous f32 [N, K] on the device of x")
    if n == 0:
        return out
    plan = launch_plan(n, k, fo, False, dev)
    a = _args(fo, x, plan, mode, tree_weights=_build.ptr(tree_weights),
              base=_build.ptr(base), out_margin=out.data_ptr(),
              ntree_limit=int(ntree_limit),
              num_parallel_tree=int(num_parallel_tree), num_outputs=k,
              base0=float(base0),
              value_fn=VALUE_FNS.index(transform_kind(transform))
              if mode == "value" else 0)
    _launch(a, dev, stream, f"B8 predict {mode}")
    predict_margin.launches += 1
    predict_margin.launches_by_layout[fo.layout] += 1
    predict_margin.launches_by_mode[mode] += 1
    predict_margin.launches_by_plan[fo.layout, plan.mapping] += 1
    if mode == "value":
        predict_margin.launches_by_value_fn[VALUE_FNS[a.value_fn]] += 1
    return out


predict_margin.launches = 0
#: value-mode launches by the transform fused into the epilogue
predict_margin.launches_by_value_fn = dict.fromkeys(VALUE_FNS, 0)
predict_margin.launches_by_layout = dict.fromkeys(LAYOUTS, 0)
predict_margin.launches_by_mode = dict.fromkeys(("margin", "value"), 0)
predict_margin.launches_by_plan = dict.fromkeys(PLANS, 0)


def predict_leaf_index(
    fo: PredictForest,
    x: torch.Tensor,
    out: Optional[torch.Tensor] = None,
    stream: Optional[torch.cuda.Stream] = None,
) -> torch.Tensor:
    """B8 leaf wrapper: [N, T] int32 heap index of each row's leaf."""
    _check_x(fo, x)
    if not x.is_cuda:
        return predict_leaf_index_plain(fo, x, out)
    _check_forest(fo, x)
    n = x.shape[0]
    dev = x.device
    if out is None:
        out = torch.empty((n, fo.n_trees), dtype=torch.int32, device=dev)
    _check(out.device == dev and out.dtype == torch.int32
           and out.shape == (n, fo.n_trees) and out.is_contiguous(),
           "B8: out must be contiguous int32 [N, T] on the device of x")
    if n == 0:
        return out
    plan = launch_plan(n, 1, fo, True, dev)
    a = _args(fo, x, plan, "leaf", out_leaf=out.data_ptr(), num_outputs=1,
              num_parallel_tree=1)
    _launch(a, dev, stream, "B8 predict leaf")
    predict_leaf_index.launches += 1
    predict_leaf_index.launches_by_layout[fo.layout] += 1
    predict_leaf_index.launches_by_plan[fo.layout, plan.mapping] += 1
    return out


predict_leaf_index.launches = 0
predict_leaf_index.launches_by_layout = dict.fromkeys(LAYOUTS, 0)
predict_leaf_index.launches_by_plan = dict.fromkeys(PLANS, 0)
