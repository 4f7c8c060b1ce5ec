"""The training engine of the port: one device, one world.

Port of ``xgboost_ray_tpu/engine.py`` ``TpuEngine`` for this slice:
``__init__`` (``:176``: shard assembly, objective and base margin, grow
config), ``_sketch_and_bin`` (``:876``), the round body
(``_round_closures``/``step``, ``:1191``/``:1864``) and ``get_booster``
(``:2136``). There is no init booster (``_init_margins_from_bins`` of
``:933`` has nothing to walk), no eval set other than the training set, and
no mesh: the world is the one device the engine runs on, and the histogram
all-reduce of the grower is the identity.

One round is K1/K2/K3 per level (``ops/grow.build_tree``) and one K4 pass
(``ops/objectives.round_update``) that adds the tree to the margins, takes
the metric sums and computes the next round's gradients; the first round's
gradients come from a K4 pass with a zero tree. The only device -> host
read per round is the four metric sums.
"""

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from xgboost_ray_tpu_torch.constants import SHARD_COLUMN_FILLS
from xgboost_ray_tpu_torch.device import resolve_device
from xgboost_ray_tpu_torch.models.booster import RayXGBoostBooster, stack_trees
from xgboost_ray_tpu_torch.ops import binning
from xgboost_ray_tpu_torch.ops.grow import GrowConfig, Tree, build_tree
from xgboost_ray_tpu_torch.ops.metrics import metric_values
from xgboost_ray_tpu_torch.ops.objectives import get_objective, round_update
from xgboost_ray_tpu_torch.ops.split import SplitParams
from xgboost_ray_tpu_torch.params import TrainParams


def _concat_shards(shards: Sequence[Dict[str, Optional[np.ndarray]]]):
    """Merge per-rank shard dicts (rank order) into global host arrays
    (x, label, weight or None, base_margin or None)."""
    fills = SHARD_COLUMN_FILLS
    xs = [np.asarray(sh["data"], np.float32) for sh in shards]

    def column(key):
        cols = [sh.get(key) for sh in shards]
        if all(c is None for c in cols):
            return None
        return np.concatenate([
            np.asarray(c, np.float32) if c is not None
            else np.full(x.shape[0], fills[key], np.float32)
            for c, x in zip(cols, xs)
        ])

    x = np.concatenate(xs, axis=0) if len(xs) > 1 else xs[0]
    label = column("label")
    if label is None:
        label = np.full(x.shape[0], fills["label"], np.float32)
    return x, label, column("weight"), column("base_margin")


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


class TorchEngine:
    def __init__(
        self,
        shards: Sequence[Dict[str, Optional[np.ndarray]]],
        params: TrainParams,
        device=None,
        eval_names: Sequence[str] = (),
        feature_names: Optional[List[str]] = None,
        feature_types: Optional[List[str]] = None,
    ):
        self.params = params
        self.device = resolve_device(device)
        self.feature_names = feature_names
        self.feature_types = feature_types
        self.objective = get_objective(params.objective)
        base_score = (params.base_score if params.base_score is not None
                      else self.objective.default_base_score)
        self.base_score = float(base_score)
        self.base_margin0 = self.objective.base_score_to_margin(self.base_score)
        self.cfg = GrowConfig(
            max_depth=params.max_depth,
            max_bin=params.max_bin,
            split=SplitParams(
                reg_lambda=params.reg_lambda,
                reg_alpha=params.reg_alpha,
                gamma=params.gamma,
                min_child_weight=params.min_child_weight,
                learning_rate=params.learning_rate,
                max_delta_step=params.max_delta_step,
            ),
            sibling_subtract=params.sibling_subtract,
        )
        self.metric_names = list(params.eval_metric) or [
            self.objective.default_metric]
        self.eval_names = list(eval_names)

        x, label, weight, base_margin = _concat_shards(shards)
        self.n_rows, self.n_features = x.shape
        dev = self.device
        x_dev = _to_device(x, dev)
        self.label = _to_device(label, dev)
        self.weight = (_to_device(weight, dev) if weight is not None
                       else torch.ones(self.n_rows, dtype=torch.float32, device=dev))
        t0 = time.perf_counter()
        self.bins, self.cuts, self.feat_has_missing = binning.sketch_and_bin(
            x_dev, self.weight, params.max_bin)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.sketch_seconds = time.perf_counter() - t0
        del x_dev
        margins = np.full(self.n_rows, self.base_margin0, np.float32)
        if base_margin is not None:
            margins = margins + base_margin.astype(np.float32)
        self.margins = _to_device(margins, dev)
        self.trees: List[Tree] = []
        # round 0's gradients: K4 with a zero tree
        self.gh, _ = round_update(
            self.margins, torch.zeros_like(self.margins), self.label,
            self.weight, self.objective.logistic, params.scale_pos_weight)

    def step(self, iteration: int) -> Dict[str, Dict[str, float]]:
        """One boosting round; returns {eval_name: {metric: value}}."""
        tree, row_value = build_tree(
            self.bins, self.gh, self.cuts, self.cfg,
            feat_has_missing=self.feat_has_missing,
        )
        self.trees.append(tree)
        self.gh, sums = round_update(
            self.margins, row_value, self.label, self.weight,
            self.objective.logistic, self.params.scale_pos_weight)
        if not self.eval_names:
            return {}
        values = metric_values(sums, self.metric_names)
        return {name: dict(values) for name in self.eval_names}

    def get_margins(self) -> np.ndarray:
        return self.margins.cpu().numpy()[:, None]

    def get_booster(self) -> RayXGBoostBooster:
        return RayXGBoostBooster(
            stack_trees(self.trees),
            self.cuts.cpu().numpy(),
            self.params,
            self.base_score,
            feature_names=self.feature_names,
            feature_types=self.feature_types,
        )
