"""Forest prediction on raw feature values, and B8, the forest-walk kernel.

Port of ``xgboost_ray_tpu/ops/predict.py``: ``_step_right`` (``:23``),
``_walk_one_tree`` (``:36``), ``predict_margin`` (``:52``) and
``predict_leaf_index`` (``:512``), with the node-array twins of
``ops/node_array.py`` (``_walk_levels`` ``:105``, ``predict_margin_na``
``:141``, ``predict_leaf_index_na`` ``:171``). The forest goes to the device
once as a :class:`PredictForest`: the six fields the walk reads, flat, in
the padded-heap or the node-array layout. One index formula per layout
(``_node_pos``) is all that differs between the two walks, in the plain
version and in the kernel alike:

- heap: ``t * heap + 2**k - 1 + p``;
- node array: ``T * (2**k - 1) + t * 2**k + p``

for slot p of level k of tree t. A row freezes at its first leaf; a row
that meets none reads ``value`` at the level-``max_depth`` node it reaches.
Routing: NaN follows ``default_left``; a categorical feature goes right
when its rounded code (half to even) differs from ``split_bin``; otherwise
``x >= threshold`` goes right. The feature index is clamped to
``[0, F - 1]`` before the gather (leaves and unused slots hold -1).

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
bitwise.

Each wrapper sends CPU tensors to its plain PyTorch version and CUDA
tensors to the kernel (or raises): there is no fallback. ``launches``
counts kernel launches (``launches_by_layout`` splits them by forest
layout). Kernel: ``csrc/predict.cu``.
"""

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from xgboost_ray_tpu_torch.ops import _build
from xgboost_ray_tpu_torch.ops.node_array import forest_to_node_array
from xgboost_ray_tpu_torch.ops.split import tree_sum

#: forest layouts the walk reads: the padded heap and the breadth-first
#: node array (``ops/node_array.py``)
LAYOUTS = ("heap", "node_array")

#: the fields the raw-x walk reads, in ``Tree`` order
WALK_FIELDS = ("feature", "split_bin", "threshold", "default_left", "is_leaf",
               "value")

_WINDOW = 32  # the reference's reduce window over trees
_MAX_TREES = 1 << 20  # four window levels; node indices fit int32 below
_KERNEL_LEVELS = 4  # XRT_LEVELS of csrc/predict.cu
_MAX_SHARED = 48 * 1024  # a launch without the opt-in attribute
#: rows per plain walk step are (this / trees): the [T, rows] temporaries
_PLAIN_CHUNK_ELEMS = 1 << 22


class PredictForest(NamedTuple):
    """The walk's fields on one device: each flat ``[T * heap]`` in
    ``layout`` order."""

    feature: torch.Tensor  # int32
    split_bin: torch.Tensor  # int32
    threshold: torch.Tensor  # float32
    default_left: torch.Tensor  # bool
    is_leaf: torch.Tensor  # bool
    value: torch.Tensor  # float32
    n_trees: int
    max_depth: int
    layout: str


def device_forest(forest, max_depth: int, layout: str = "heap",
                  device="cpu") -> PredictForest:
    """A stacked padded-heap forest (numpy fields ``[T, heap]``, e.g. a
    booster's ``forest``) -> :class:`PredictForest` on ``device``."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown forest layout {layout!r}; one of {LAYOUTS}")
    n_trees, heap = np.asarray(forest.feature).shape
    if heap != (2 << max_depth) - 1:
        raise ValueError(f"heap width {heap} does not match max_depth "
                         f"{max_depth}")
    if layout == "node_array":
        fields = forest_to_node_array(forest, max_depth)
    else:
        fields = [np.asarray(getattr(forest, name)).reshape(-1)
                  for name in WALK_FIELDS]
    dtypes = (np.int32, np.int32, np.float32, np.bool_, np.bool_, np.float32)
    tensors = [torch.from_numpy(np.ascontiguousarray(f, dtype=dt)).to(device)
               for f, dt in zip(fields, dtypes)]
    return PredictForest(*tensors, n_trees=int(n_trees),
                         max_depth=int(max_depth), layout=layout)


def cat_mask(cat_features: Sequence[int], num_features: int,
             device="cpu") -> Optional[torch.Tensor]:
    """[F] bool marking categorical features, or None when there are none
    (``xgboost_ray_tpu/ops/grow.py:78`` ``cat_mask_const``)."""
    if not cat_features:
        return None
    mask = torch.zeros(num_features, dtype=torch.bool, device=device)
    mask[torch.as_tensor(list(cat_features), dtype=torch.long,
                         device=device)] = True
    return mask


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _node_pos(layout: str, k: int, t_col: torch.Tensor, p: torch.Tensor,
              n_trees: int, heap: int) -> torch.Tensor:
    if layout == "heap":
        return t_col * heap + ((1 << k) - 1) + p
    return n_trees * ((1 << k) - 1) + (t_col << k) + p


def _step_right(fo: PredictForest, pos, xv, f, cat):
    """The reference's routing rule (``predict.py:23``) on gathered nodes.
    The categorical test compares the rounded code as a float: for the
    small integer ``split_bin`` values a tree holds it decides as the
    reference's int32 compare does, also where that cast saturates."""
    present_right = xv >= fo.threshold[pos]
    if cat is not None:
        code_differs = torch.round(xv) != fo.split_bin[pos].to(xv.dtype)
        present_right = torch.where(cat[f], code_differs, present_right)
    return torch.where(torch.isnan(xv), ~fo.default_left[pos], present_right)


def walk_plain(fo: PredictForest, x: torch.Tensor,
               cat: Optional[torch.Tensor] = None):
    """Level-synchronous walk of every tree for the rows of ``x`` [n, F]
    (the reference's ``_walk_levels`` on either layout). Returns
    ``(leaf_value [T, n] f32, leaf_heap_index [T, n] int32)``."""
    n, num_features = x.shape
    dev = x.device
    t = fo.n_trees
    heap = (2 << fo.max_depth) - 1
    t_col = torch.arange(t, dtype=torch.long, device=dev)[:, None]
    row_base = (torch.arange(n, dtype=torch.long, device=dev)
                * num_features)[None, :]
    xf = x.reshape(-1)
    p = torch.zeros((t, n), dtype=torch.long, device=dev)
    done = torch.zeros((t, n), dtype=torch.bool, device=dev)
    val = torch.zeros((t, n), dtype=torch.float32, device=dev)
    hidx = torch.zeros((t, n), dtype=torch.long, device=dev)
    for k in range(fo.max_depth):
        pos = _node_pos(fo.layout, k, t_col, p, t, heap)
        leaf_here = fo.is_leaf[pos]
        newly = leaf_here & ~done
        val = torch.where(newly, fo.value[pos], val)
        hidx = torch.where(newly, ((1 << k) - 1) + p, hidx)
        done = done | leaf_here
        f = fo.feature[pos].long().clamp(0, num_features - 1)
        xv = xf[row_base + f]
        go_right = _step_right(fo, pos, xv, f, cat)
        p = torch.where(done, p, 2 * p + go_right.long())
    pos = _node_pos(fo.layout, fo.max_depth, t_col, p, t, heap)
    val = torch.where(done, val, fo.value[pos])
    hidx = torch.where(done, hidx, ((1 << fo.max_depth) - 1) + p)
    return val, hidx.to(torch.int32)


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
    cat: Optional[torch.Tensor] = None,  # [F] bool
    out: Optional[torch.Tensor] = None,  # [N, K] f32
) -> torch.Tensor:
    """[N, K] margins: base + (window-tree sum of each class's weighted
    leaf values) / num_parallel_tree."""
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
        leaf, _ = walk_plain(fo, x[lo:hi], cat)  # [T, m]
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
    return out


def predict_leaf_index_plain(fo: PredictForest, x: torch.Tensor,
                             cat: Optional[torch.Tensor] = None,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """[N, T] int32: the heap index of the leaf each row reaches per tree."""
    n = x.shape[0]
    if out is None:
        out = torch.empty((n, fo.n_trees), dtype=torch.int32, device=x.device)
    step = _plain_rows(fo.n_trees)
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        out[lo:hi] = walk_plain(fo, x[lo:hi], cat)[1].T
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


def rows_per_block(n: int, num_outputs: int, device) -> int:
    """Rows per CTA (R; the CTA's 256 threads walk R rows x 256 / R trees):
    the most of 8, 4, 2, 1 that still gives every SM four CTAs, so a small
    batch spreads its trees over whole CTAs; fewer when the margin's
    per-row sums would not fit the shared memory."""
    ctas = 4 * _sm_count(torch.device(device).index or 0)
    r = 8
    while r > 1 and (-(-n // r) < ctas
                     or _shared_bytes(r, num_outputs) > _MAX_SHARED):
        r //= 2
    return r


def _shared_bytes(r: int, k: int) -> int:
    """csrc/predict.cu's dynamic shared memory for the margin mode:
    contributions [256], slot classes [256], window sums [R * K * W],
    partials [R * K * 4]."""
    w = 256 // r // _WINDOW
    return 4 * (2 * 256 + r * k * w + r * k * _KERNEL_LEVELS)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _check_inputs(fo: PredictForest, x: torch.Tensor, cat) -> None:
    dev = x.device
    _check(fo.layout in LAYOUTS, f"B8: unknown layout {fo.layout!r}")
    _check(x.dtype == torch.float32 and x.dim() == 2 and x.is_contiguous()
           and x.shape[1] >= 1, "B8: x must be contiguous f32 [N, F]")
    heap = (2 << fo.max_depth) - 1
    _check(1 <= fo.n_trees < _MAX_TREES and fo.n_trees * heap < 2 ** 31,
           f"B8: {fo.n_trees} trees of heap {heap} out of range")
    dtypes = (torch.int32, torch.int32, torch.float32, torch.bool,
              torch.bool, torch.float32)
    for name, dt in zip(WALK_FIELDS, dtypes):
        f = getattr(fo, name)
        _check(f.device == dev and f.dtype == dt and f.is_contiguous()
               and f.shape == (fo.n_trees * heap,),
               f"B8: forest field {name} must be contiguous {dt} "
               f"[{fo.n_trees * heap}] on {dev}")
    _check(cat is None or (cat.device == dev and cat.dtype == torch.bool
                           and cat.shape == (x.shape[1],)),
           "B8: cat mask must be bool [F] on the device of x")


def _args(fo: PredictForest, x: torch.Tensor, cat, r: int, **kw):
    front0, padded, top, m, front = tree_windows(fo.n_trees)
    a = _build.PredictArgs()
    a.x = x.data_ptr()
    for name in WALK_FIELDS:
        setattr(a, name, getattr(fo, name).data_ptr())
    a.cat_mask = _build.ptr(cat)
    a.n_rows = x.shape[0]
    a.n_features = x.shape[1]
    a.n_trees = fo.n_trees
    a.max_depth = fo.max_depth
    a.rows_per_block = r
    a.front0 = front0
    a.padded = padded
    a.top = top
    for i in range(_KERNEL_LEVELS):
        a.m[i] = m[i] if i < len(m) else 0
        a.front[i] = front[i] if i < len(front) else 0
    for key, value in kw.items():
        setattr(a, key, value)
    return a


def _launch(a, layout: str, mode: int, dev, stream, what: str) -> None:
    s = (stream if stream is not None
         else torch.cuda.current_stream(dev)).cuda_stream
    with torch.cuda.device(dev):
        code = _build.library("predict").xrt_predict(
            ctypes.byref(a), LAYOUTS.index(layout), mode, s)
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
    cat: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
    stream: Optional[torch.cuda.Stream] = None,
) -> torch.Tensor:
    """B8 margin wrapper: [N, K] f32 (see :func:`predict_margin_plain`).
    ``stream`` defaults to the current stream of ``x``'s device."""
    if not x.is_cuda:
        return predict_margin_plain(fo, x, base, base0, num_outputs,
                                    num_parallel_tree, ntree_limit,
                                    tree_weights, cat, out)
    _check_inputs(fo, x, cat)
    n = x.shape[0]
    k = num_outputs
    dev = x.device
    _check(k >= 1 and num_parallel_tree >= 1 and ntree_limit >= 0,
           "B8: num_outputs and num_parallel_tree must be >= 1")
    _check(_shared_bytes(1, k) <= _MAX_SHARED,
           f"B8: num_outputs={k} needs more shared memory than a CTA has")
    _check(base is None or (base.device == dev and base.dtype == torch.float32
                            and base.shape == (n, k) and base.is_contiguous()),
           "B8: base must be contiguous f32 [N, K] on the device of x")
    _check(tree_weights is None or (
        tree_weights.device == dev and tree_weights.dtype == torch.float32
        and tree_weights.shape == (fo.n_trees,)),
        "B8: tree_weights must be f32 [T] on the device of x")
    if out is None:
        out = torch.empty((n, k), dtype=torch.float32, device=dev)
    _check(out.device == dev and out.dtype == torch.float32
           and out.shape == (n, k) and out.is_contiguous(),
           "B8: out must be contiguous f32 [N, K] on the device of x")
    if n == 0:
        return out
    a = _args(fo, x, cat, rows_per_block(n, k, dev),
              tree_weights=_build.ptr(tree_weights), base=_build.ptr(base),
              out_margin=out.data_ptr(), ntree_limit=int(ntree_limit),
              num_parallel_tree=int(num_parallel_tree), num_outputs=k,
              base0=float(base0))
    _launch(a, fo.layout, 0, dev, stream, "B8 predict margin")
    predict_margin.launches += 1
    predict_margin.launches_by_layout[fo.layout] += 1
    return out


predict_margin.launches = 0
predict_margin.launches_by_layout = dict.fromkeys(LAYOUTS, 0)


def predict_leaf_index(
    fo: PredictForest,
    x: torch.Tensor,
    cat: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
    stream: Optional[torch.cuda.Stream] = None,
) -> torch.Tensor:
    """B8 leaf wrapper: [N, T] int32 heap index of each row's leaf."""
    if not x.is_cuda:
        return predict_leaf_index_plain(fo, x, cat, out)
    _check_inputs(fo, x, cat)
    n = x.shape[0]
    dev = x.device
    if out is None:
        out = torch.empty((n, fo.n_trees), dtype=torch.int32, device=dev)
    _check(out.device == dev and out.dtype == torch.int32
           and out.shape == (n, fo.n_trees) and out.is_contiguous(),
           "B8: out must be contiguous int32 [N, T] on the device of x")
    if n == 0:
        return out
    a = _args(fo, x, cat, rows_per_block(n, 1, dev), out_leaf=out.data_ptr(),
              num_outputs=1, num_parallel_tree=1)
    _launch(a, fo.layout, 1, dev, stream, "B8 predict leaf")
    predict_leaf_index.launches += 1
    predict_leaf_index.launches_by_layout[fo.layout] += 1
    return out


predict_leaf_index.launches = 0
predict_leaf_index.launches_by_layout = dict.fromkeys(LAYOUTS, 0)
