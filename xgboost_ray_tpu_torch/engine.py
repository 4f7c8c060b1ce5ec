"""The training engine of the port: one rank's shard of the world.

Port of ``xgboost_ray_tpu/engine.py`` ``TpuEngine`` for this slice:
``__init__`` (``:176``: shard assembly, objective and base margin, grow
config, the init booster's margins and trees, ``:700-728``, and
``iteration_offset``, ``:824``), the eval sets (``_EvalSet``, ``:139``;
``_add_eval_set``, ``:1106-1188``), ``_sketch_and_bin`` (``:876``), the
round body (``_round_closures``/``step``, ``:1191``/``:1864``) and
``get_booster`` (``:2136``, the init forest first, ``:2049``).

The world is the default ``torch.distributed`` process group (one rank at
world 1, where every collective is the identity). Each rank keeps only the
shards it is given (its own, or at world 1 all of them, concatenated in
rank order as the JAX package folds actors onto one device) and merges
through ``distributed.Collectives``, the ``psum``/``pmin``/``pmax`` of the
reference: the sketch's min/max, max|w|, fine histogram and missing counts
(``ops/binning.py``), the global row count once at set-up, and per round
the MAX of (max|g|, max|h|) that sets K1's fixed-point scales, every
histogram and the final totals (``ops/grow.build_tree``'s ``allreduce``),
and the metric partial sums of every eval set in one all-reduce.

One round is K1/K2/K3 per level (``ops/grow.build_tree``) and one K4 pass
(``ops/objectives.round_update``) that adds the tree to the margins, takes
the metric sums and computes the next round's gradients; the first round's
gradients come from a K4 pass with a zero tree. A held-out eval set (binned
once with the merged training cuts; label, weight and margins on the
device) takes one B4 walk of the new tree (``ops/grow.predict_tree_binned``)
and one K4 pass in its eval mode a round (the margin add and the metric
sums, no gradients).

With K outputs (``multi:softprob`` / ``multi:softmax``, ``num_class`` K)
a round is the JAX ``tree_round`` (``engine.py:1315-1420``): margins are
[N, K], the gradients [K, N, 2] planes taken from the round-start margins,
K1's scales per class ([K, 4], one all-reduce MAX of [K, 2] maxima),
``build_tree`` once per class writing class k's tree and row values into
row k of the round's [K, heap] forest and [K, N] row values, then one
softmax pass (``ops/objectives.softmax_update``) in place of K4; a
held-out set takes one B4 launch over the round's K trees and one softmax
pass in its eval mode. A round is K trees, round-major (tree t is class
``t % K``), as the reference stacks them.

On the card K1 sums in fixed point (on the CPU the f32 sums of the JAX
package), so a round on the card gives the same bits at every world size
and on every rerun. The only device -> host read per round is the metric
sums.

An init booster (``xgb_model``) starts every set's margins at ``base +
booster.predict_margin(x) - its base margin`` (B8 on the card, the plain
walk on the CPU) and its forest goes before the new trees.
"""

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from xgboost_ray_tpu_torch.constants import SHARD_COLUMN_FILLS
from xgboost_ray_tpu_torch.device import resolve_device
from xgboost_ray_tpu_torch.distributed import Collectives
from xgboost_ray_tpu_torch.models.booster import RayXGBoostBooster, stack_trees
from xgboost_ray_tpu_torch.ops import binning
from xgboost_ray_tpu_torch.ops.grow import (
    GrowConfig,
    Tree,
    build_tree,
    empty_tree,
    predict_tree_binned,
)
from xgboost_ray_tpu_torch.ops.histogram import (
    build_histogram,
    dequantize,
    partition_leaf_values,
    partition_level,
    quant_scales,
)
from xgboost_ray_tpu_torch.ops.metrics import metric_values
from xgboost_ray_tpu_torch.ops.objectives import (
    get_objective,
    round_update,
    softmax_update,
)
from xgboost_ray_tpu_torch.ops.split import (
    SplitParams,
    find_splits,
    leaf_records,
    split_level,
)
from xgboost_ray_tpu_torch.params import TrainParams


def kernel_counters() -> Dict[str, Callable]:
    """The kernel wrappers of training, by the names the port's records
    give them; each counts its kernel launches in ``.launches``."""
    return {"K1": build_histogram, "K1deq": dequantize, "K2": find_splits,
            "K2level": split_level, "K2leaf": leaf_records,
            "K3": partition_level, "K3leaf": partition_leaf_values,
            "K4": round_update, "B4": predict_tree_binned,
            "SMX": softmax_update}


def kernel_launches() -> Dict[str, int]:
    """Launches of every training kernel since ``reset_kernel_launches``,
    with the eval-mode launches of K4 and of the softmax pass apart as
    ``K4eval`` and ``SMXeval`` (``K4`` and ``SMX`` count both modes)."""
    out = {k: fn.launches for k, fn in kernel_counters().items()}
    out["K4eval"] = round_update.eval_launches
    out["SMXeval"] = softmax_update.eval_launches
    return out


def reset_kernel_launches() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0
    round_update.eval_launches = 0
    softmax_update.eval_launches = 0


def _concat_shards(shards: Sequence[Dict[str, Optional[np.ndarray]]]):
    """Merge shard dicts (rank order) into host arrays (x, label, weight or
    None, base_margin or None)."""
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


class _EvalSet:
    """One entry of ``evals`` (the JAX ``_EvalSet``): the training set
    (``is_train``: its metrics are the training round's), or a held-out set
    whose bins (the training cuts), label, weight and margins stay on the
    device."""

    def __init__(self, name: str, is_train: bool):
        self.name = name
        self.is_train = is_train
        self.bins: Optional[torch.Tensor] = None
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None
        self.margins: Optional[torch.Tensor] = None


class TorchEngine:
    def __init__(
        self,
        shards: Sequence[Dict[str, Optional[np.ndarray]]],
        params: TrainParams,
        device=None,
        evals: Sequence[Tuple[Sequence[Dict[str, Optional[np.ndarray]]],
                              str]] = (),
        init_booster: Optional[RayXGBoostBooster] = None,
        feature_names: Optional[List[str]] = None,
        feature_types: Optional[List[str]] = None,
    ):
        """``shards``: this rank's shard dicts; ``evals``: (shards, name)
        pairs, ``shards`` itself (the same object) for the training set;
        ``init_booster``: the model training continues."""
        self.params = params
        self.device = resolve_device(device)
        self.coll = Collectives()
        self.allreduce_bytes_per_round = 0
        self.feature_names = feature_names
        self.feature_types = feature_types
        self.objective = get_objective(params.objective, params.num_class)
        self.n_outputs = self.objective.num_outputs
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

        x, label, weight, base_margin = _concat_shards(shards)
        self.n_rows, self.n_features = x.shape
        dev = self.device
        self.n_global = int(self.coll.sum(torch.tensor(
            [self.n_rows], dtype=torch.int64, device=dev)).item())
        coll = self.coll if self.coll.world > 1 else None
        x_dev = _to_device(x, dev)
        self.label = _to_device(label, dev)
        self.weight = (_to_device(weight, dev) if weight is not None
                       else torch.ones(self.n_rows, dtype=torch.float32, device=dev))
        t0 = time.perf_counter()
        self.bins, self.cuts, self.feat_has_missing = binning.sketch_and_bin(
            x_dev, self.weight, params.max_bin, coll, self.n_global)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.sketch_seconds = time.perf_counter() - t0
        del x_dev
        self._init_trees: List[Tree] = []
        self._init_has_stats = True
        self.iteration_offset = 0
        if init_booster is not None:
            self._init_has_stats = init_booster._has_node_stats
            self.iteration_offset = init_booster.num_boosted_rounds()
            if init_booster.num_trees:
                self._init_trees = [init_booster.forest]
        self.margins = _to_device(
            self._start_margins(x, base_margin, init_booster), dev)
        # one entry a round: its tree, or with K outputs its K trees
        # ([K, heap] fields)
        self.trees: List[Tree] = []

        self.evals: List[_EvalSet] = []
        for eval_shards, name in evals:
            self._add_eval_set(eval_shards, name, shards, init_booster)

        # round 0's gradients: the round pass with zero trees
        self.gh, _ = self._update(
            self.margins, torch.zeros((self.n_outputs, self.n_rows),
                                      dtype=torch.float32, device=dev),
            self.label, self.weight)
        self.qscale = self._scales()

    def _start_margins(self, x: np.ndarray, base_margin: Optional[np.ndarray],
                       init_booster: Optional[RayXGBoostBooster]) -> np.ndarray:
        """A set's first margins [N, K] f32 on the host: the base margin,
        plus the rows' ``base_margin``, plus the init booster's trees (its
        margin less its base; ``engine.py:700-728``, ``:1172-1183``)."""
        n = x.shape[0]
        margins = np.full((n, self.n_outputs), self.base_margin0, np.float32)
        if base_margin is not None:
            margins = margins + base_margin.reshape(n, -1).astype(np.float32)
        if init_booster is not None and init_booster.num_trees:
            pm = init_booster.predict_margin(
                init_booster._coerce_features(x), device=self.device)
            margins = margins + (pm.reshape(n, -1)
                                 - init_booster.base_score_margin_np())
        return margins

    def _add_eval_set(self, eval_shards, name: str, train_shards,
                      init_booster: Optional[RayXGBoostBooster]) -> None:
        if eval_shards is train_shards:
            self.evals.append(_EvalSet(name, True))
            return
        x, label, weight, base_margin = _concat_shards(eval_shards)
        dev = self.device
        es = _EvalSet(name, False)
        x_dev = _to_device(x, dev)
        es.bins = binning.bin_matrix(x_dev, self.cuts, self.params.max_bin)
        del x_dev
        es.label = _to_device(label, dev)
        es.weight = (_to_device(weight, dev) if weight is not None
                     else torch.ones(x.shape[0], dtype=torch.float32, device=dev))
        es.margins = _to_device(
            self._start_margins(x, base_margin, init_booster), dev)
        self.evals.append(es)

    def _update(self, margins: torch.Tensor, row_value: torch.Tensor,
                label: torch.Tensor, weight: torch.Tensor,
                with_gh: bool = True):
        """The round pass over one set: ``margins`` [N, K] += ``row_value``
        [K, N].T in place; (gh [K, N, 2] or None, its metric partial sums).
        K4 for one output, the softmax pass for K."""
        if self.objective.softmax:
            return softmax_update(margins, row_value, label, weight, with_gh)
        gh, sums = round_update(margins.view(-1), row_value.view(-1), label,
                                weight, self.objective.logistic,
                                self.params.scale_pos_weight, with_gh)
        return (None if gh is None else gh.view(1, -1, 2)), sums

    def _scales(self) -> Optional[torch.Tensor]:
        """K1's fixed-point scales [K, 4] of the gradients ``self.gh`` on
        the card, one row a class (None on the CPU, which sums f32): issued
        as soon as the round pass has produced them, so their few launches
        queue behind it rather than after the round's metric read."""
        if self.device.type != "cuda":
            return None
        return quant_scales(self.gh, self.n_global, self.coll.max)

    def step(self, iteration: int) -> Dict[str, Dict[str, float]]:
        """One boosting round (K trees); returns {eval_name: {metric:
        value}}."""
        coll = self.coll
        coll.bytes.total = 0
        k_out = self.n_outputs
        forest = empty_tree(self.cfg.heap_size, self.device, k_out)
        row_value = torch.empty((k_out, self.n_rows), dtype=torch.float32,
                                device=self.device)
        for k in range(k_out):
            build_tree(
                self.bins, self.gh[k], self.cuts, self.cfg,
                feat_has_missing=self.feat_has_missing,
                allreduce=coll.sum if coll.world > 1 else None,
                qscale=None if self.qscale is None else self.qscale[k],
                tree=Tree(*[f[k] for f in forest]), row_value=row_value[k],
            )
        # one output: the round's tree itself ([heap] fields), as before
        walked = forest if k_out > 1 else Tree(*[f[0] for f in forest])
        self.trees.append(walked)
        self.gh, sums = self._update(self.margins, row_value, self.label,
                                     self.weight)
        self.qscale = self._scales()  # the next round's
        if not self.evals:
            self.allreduce_bytes_per_round = coll.bytes.total
            return {}
        parts = [sums]
        for es in self.evals:
            if not es.is_train:
                value = predict_tree_binned(walked, es.bins,
                                            self.cfg.max_depth,
                                            self.cfg.max_bin)
                parts.append(self._update(es.margins,
                                          value.view(k_out, -1), es.label,
                                          es.weight, with_gh=False)[1])
        parts = coll.sum(torch.stack(parts)).cpu()
        self.allreduce_bytes_per_round = coll.bytes.total
        held_out = iter(parts[1:])
        names = self.objective.partials
        return {es.name: metric_values(parts[0] if es.is_train
                                       else next(held_out), self.metric_names,
                                       names)
                for es in self.evals}

    def get_margins(self) -> np.ndarray:
        """This rank's training margins [n_rows, K]."""
        return self.margins.cpu().numpy()

    def get_booster(self) -> RayXGBoostBooster:
        booster = RayXGBoostBooster(
            stack_trees(self._init_trees + self.trees),
            self.cuts.cpu().numpy(),
            self.params,
            self.base_score,
            feature_names=self.feature_names,
            feature_types=self.feature_types,
        )
        booster._has_node_stats = self._init_has_stats
        return booster
