"""Breadth-first node-array forest layout (the FIL-style level-major one).

Port of ``xgboost_ray_tpu/ops/node_array.py``: ``NodeForest`` (``:41``)
and ``forest_to_node_array`` (``:57``) are host numpy, copied. The layout
is a pure permutation of the padded heap: node (tree t, level k, slot p)
lives at ``level_base(k) + t * 2**k + p`` with ``level_base(k) = T *
(2**k - 1)``, and corresponds to heap index ``2**k - 1 + p`` of tree t.
Only the six fields the raw-x walk reads are kept.

The walk over it (the port of ``_walk_levels``, ``:105``) is
``ops/predict.py``'s, which takes the layout as an argument: the plain
version and kernel B8 read either layout through one index formula, from
packed node records that ``level_major`` puts in this order.
"""

from typing import NamedTuple

import numpy as np


class NodeForest(NamedTuple):
    """Breadth-first node-array ensemble: each field flat ``[T * heap]``,
    level-major (all trees' level-k nodes contiguous, ``2**k`` per tree)."""

    feature: np.ndarray       # int32  [T * heap]
    split_bin: np.ndarray     # int32  [T * heap]
    threshold: np.ndarray     # float32[T * heap]
    default_left: np.ndarray  # bool   [T * heap]
    is_leaf: np.ndarray       # bool   [T * heap]
    value: np.ndarray         # float32[T * heap]


def level_base(k: int, num_trees: int) -> int:
    return num_trees * ((1 << k) - 1)


def level_major(arr: np.ndarray, max_depth: int) -> np.ndarray:
    """``[T, heap, ...]`` in heap order -> ``[T * heap, ...]`` in the
    node-array order. Slab k is ``arr[:, 2^k-1 : 2^(k+1)-1]`` flattened
    tree-major: the reshape of the ``[T, 2^k]`` slice lands (t, p) at
    ``t * 2^k + p``."""
    return np.concatenate([
        arr[:, (1 << k) - 1:(2 << k) - 1].reshape((-1,) + arr.shape[2:])
        for k in range(max_depth + 1)
    ])


def forest_to_node_array(forest, max_depth: int) -> NodeForest:
    """Permute a stacked padded-heap forest (fields ``[T, heap]``) into the
    level-major node-array layout. Called once per model."""
    feature = np.asarray(forest.feature)
    t, heap = feature.shape
    if heap != (1 << (max_depth + 1)) - 1:
        raise ValueError(
            f"heap width {heap} does not match max_depth {max_depth} "
            f"(expected {(1 << (max_depth + 1)) - 1})"
        )

    def permute(field, dtype):
        return level_major(np.asarray(field), max_depth).astype(dtype,
                                                                copy=False)

    return NodeForest(
        feature=permute(forest.feature, np.int32),
        split_bin=permute(forest.split_bin, np.int32),
        threshold=permute(forest.threshold, np.float32),
        default_left=permute(forest.default_left, bool),
        is_leaf=permute(forest.is_leaf, bool),
        value=permute(forest.value, np.float32),
    )
