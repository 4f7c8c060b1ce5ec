"""Carry the JAX package's state across to the port.

``booster_from_jax_state`` turns the JAX package's model state, as numpy
arrays (a Tree of ``[T, heap]`` arrays, cuts ``[F, max_bin - 1]`` f32,
base_score, the params dict, and the DART tree weights, feature names and
types and category mappings where the model has them), into the port's
``RayXGBoostBooster``, which then predicts as the JAX model does.
``bins_from_cuts`` bins raw features against given cuts with the port's
binning, so the two growers can be compared on identical bins. The model
JSON is the same format in both packages, so saved files also cross-load
directly (``RayXGBoostBooster.load_model``).
"""

import dataclasses
from typing import Any, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from xgboost_ray_tpu_torch.models.booster import RayXGBoostBooster, forest_to_np
from xgboost_ray_tpu_torch.ops import binning
from xgboost_ray_tpu_torch.ops.grow import Tree
from xgboost_ray_tpu_torch.params import TrainParams


def booster_from_jax_state(
    forest: Union[Mapping[str, Any], Any],
    cuts: np.ndarray,
    base_score: float,
    params: Union[Mapping[str, Any], Any],
    tree_weights: Optional[np.ndarray] = None,
    feature_names: Optional[List[str]] = None,
    feature_types: Optional[List[str]] = None,
    categories: Optional[Mapping[int, Sequence]] = None,
) -> RayXGBoostBooster:
    """``forest``: a mapping of Tree field -> array, or any Tree-shaped
    sequence of arrays in field order (the JAX ``Tree``); ``params``: the
    JAX ``TrainParams`` or its ``asdict``; ``tree_weights``: ``[T]`` DART
    scales; ``categories``: column index -> the training category values."""
    if isinstance(forest, Mapping):
        forest = Tree(**{name: forest[name] for name in Tree._fields})
    if not isinstance(params, Mapping):
        params = dataclasses.asdict(params)
    known = {f.name for f in dataclasses.fields(TrainParams)}
    p = TrainParams(**{k: v for k, v in params.items() if k in known})
    out = RayXGBoostBooster(
        forest_to_np(forest), np.asarray(cuts, np.float32), p,
        float(base_score),
        feature_names=None if feature_names is None else list(feature_names),
        feature_types=None if feature_types is None else list(feature_types),
        tree_weights=(None if tree_weights is None
                      else np.asarray(tree_weights, np.float32)))
    if categories is not None:
        out.categories = {int(k): tuple(v) for k, v in categories.items()}
    return out


def bins_from_cuts(x: np.ndarray, cuts: np.ndarray, max_bin: int,
                   device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """[N, F] raw features -> [N, F] bins on ``device`` against ``cuts``."""
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    ct = torch.as_tensor(np.asarray(cuts, np.float32), device=device)
    return binning.bin_matrix(xt, ct, max_bin)
