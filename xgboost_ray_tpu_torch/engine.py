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

Every row-elementwise objective takes K4 (``ops/objectives.round_update``)
in its own mode; ``survival:aft`` reads each set's label bounds on the
device besides (``label_lower_bound`` / ``label_upper_bound``, lower
defaulting to the label, upper to lower; also for the ``aft-nloglik``
metric), and ``reg:quantileerror``'s K alphas take K4's K-output kernel
(``round_update_multi``) on the K-tree round. With ``auc`` / ``aucpr``
each set adds B9a's [2, 4096] histogram of its updated margins
(``ops/metrics.auc_histogram``, int64 fixed point at the set's
``auc_scale``) as float64 to its partial sums in the round's one
all-reduce; the host reads the areas from the merged bins. ``auc_exact``
is a host metric: each rank's rows' rank statistic, combined over the
ranks like a custom metric (``engine.py:1953-1990``).

Stochastic boosting (``engine.py:1315-1420``): a round grows K x T trees
(``num_parallel_tree`` T), tree k T + t with the key
``fold_in(fold_in(PRNGKey(seed), iteration_offset + i), k T + t)``. A
row-sampled tree draws each of this rank's blocks of the JAX layout (the
world's rows in shard order, padded to ``num_actors`` blocks;
``_sample_blocks``) with B12r, grows over the compacted rows (their bins
gathered, a drawn padding slot a row of missing bins and zero gradients)
at its own fixed-point scales (``_tree_scales``), and every training
row's value comes from one B4 walk of the round's trees. The column masks
are B12f's (``ops/grow.build_tree``). K4 adds a round's T trees' values
in turn (its T-tree add), on the training set and each held-out set; with
K outputs the softmax pass and K4's K-output kernel add each output's T
trees the same way.

Monotone and interaction constraints (``engine.py:440-470``) are
validated against the feature count and carried in the grow config; their
device form (``ops/split.TreeConstraints``) is made once and every tree
takes K2's constrained level step (``ops/grow.build_tree``).

Categorical features (``feature_types`` 'c', ``engine.py:432-462``): their
columns are checked to hold codes in [0, max_bin - 2] at load, take the
code cuts (bin c is category c, ``ops/binning.code_cuts``), refuse a
monotone sign, and are carried in the grow config and as [F] flags on the
device (``cat``): K2's categorical search, K3's and B4's one-vs-rest
route. The booster keeps the feature types and the training category
mapping (``categories``, ``engine.py:2151-2155``).

``grow_policy="lossguide"`` grows each tree leaf-wise
(``ops/grow_lossguide.build_tree_lossguide``, the same contract as
``build_tree``) up to the leaf budget ``params.leaf_budget``
(``engine.py:314-322``); everything around the grower is the same.

Quantized gradients (``gh_precision`` int8 / int16, ``engine.py:1320-1335``):
each tree's (g, h) is rounded at the source by B10 (``_quantize``), each of
this rank's device blocks of the reference's layout with the tree's key
folded with ``SALT_SR`` and the block, at the scales of the round's merged
absmax (the MAX all-reduce that also gives K1's fixed-point scales on the
card; ``_round_absmax``), the grid capped by the padded global rows; the
tree grows on the narrow buffer (uniform row sampling gathers it, GOSS
grows on its dequantized values). The quantized histogram wire
(``hist_quant``) is the grower's (``coll``). ``additional_results`` report
the tree path's bytes a round (``hist_allreduce_bytes_per_round``) and a
device block's gh plane (``gh_plane_bytes_per_shard``).

``booster="dart"`` (``engine.py:2830-3090``): the forest lives on the
device in ``n_init + total_rounds K`` slots beside the host's tree weights.
A round draws its drops on the host (``RandomState`` of (seed, iteration)),
takes the training margins under the drops from B4w (``ops/grow.
predict_forest_weighted``) and their gradients from the round pass with
zero trees, grows its K trees into the next slots (the round's tree loop,
so the gbtree options ride along), and gives every set its margins under
the round's weights by B4w again; the booster keeps the weights as
``tree_weights``. ``booster="gblinear"`` is ``linear.LinearEngine``.

An init booster (``xgb_model``) starts every set's margins at ``base +
booster.predict_margin(x) - its base margin`` (B8 on the card, the plain
walk on the CPU) and its forest goes before the new trees.

A custom objective (``custom_objective=True``; ``step(i, gh_custom=(g,
h))``, the JAX engine's ``gh_custom``, ``engine.py:1864``): the round's
gradients are the user's, f32 for this rank's rows, copied to the device
and there made the [K, N, 2] planes K1 reads (K1's fixed-point scales
come from them); the round pass over the training set runs in its
no-gradient mode (K4's or the softmax pass's eval mode: the margin update
and the metric sums), and the built-in gradients are neither computed nor
read, round 0's included.
The host keeps every set's labels and weights for the custom callables
(``host_labels``), and ``combine_host_scalar`` merges a value each rank
computed on its rows into their weighted mean.

Learning to rank (``rank:pairwise`` / ``rank:ndcg`` / ``rank:map``) and
``survival:cox`` take the custom objective's structure
(``engine.py:465-490``): the round pass over the training set is K4's eval
mode (the margin update and the elementwise metric sums), then B13
(``ops/ranking.rank_grad_hess``) or B14 (``ops/cox.cox_round``) computes
the next round's [1, N, 2] gradient plane from the updated margins, and
round 0's from the base margins the same way (no K4 pass). A set with
``qid`` has its query groups (``ops/ranking.GroupLayout``) built per shard,
as the JAX engine builds them per device block (``engine.py:1054-1103``,
``:1154-1157``), padded to the world's largest group (one all-reduce MAX
at set-up). ``ndcg`` / ``map`` (``@k`` too) are B9r
(``ops/metrics.rank_metric_contrib``) over each set's groups, a set's (sum
over groups, groups) joining the round's one all-reduce as f64 partials;
where some set has no groups they are host metrics (``ndcg_np`` /
``map_np`` over each rank's rows, the whole set one group without qid,
combined over the ranks weighted by their groups), as the JAX engine
chooses (``engine.py:748-766``). Cox's risk sets span every row: each rank
gathers a set's labels and weights once (``Collectives.all_gather``) and
its margins every round; ``cox-nloglik`` comes out of B14 over the
gathered rows, the same on every rank, and is not summed over the ranks
again (``ops/metrics.py:301-306``).
"""

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from xgboost_ray_tpu_torch.constants import SHARD_COLUMN_FILLS
from xgboost_ray_tpu_torch.device import resolve_device
from xgboost_ray_tpu_torch.distributed import Collectives
from xgboost_ray_tpu_torch.models.booster import RayXGBoostBooster, stack_trees
from xgboost_ray_tpu_torch.ops import binning
from xgboost_ray_tpu_torch.ops.cox import CoxSetup, cox_round, cox_setup
from xgboost_ray_tpu_torch.ops.grow import (
    SALT_BYTREE,
    SALT_GOSS,
    SALT_SR,
    SALT_SUBSAMPLE,
    GrowConfig,
    Tree,
    build_tree,
    cat_flags,
    empty_tree,
    predict_forest_weighted,
    predict_tree_binned,
    sample_feature_mask,
)
from xgboost_ray_tpu_torch.ops.grow_lossguide import (
    build_tree_lossguide,
    frontier_step,
)
from xgboost_ray_tpu_torch.ops.histogram import (
    build_histogram,
    dequantize,
    form_dequantize,
    gh_absmax,
    partition_leaf_values,
    partition_level,
    quant_scales,
    scales_for,
    wire_accumulate,
    wire_dequantize,
    wire_quantize,
)
from xgboost_ray_tpu_torch.ops.linear import linear_round
from xgboost_ray_tpu_torch.ops.metrics import (
    AUC_BINS,
    COX_METRIC,
    HIST_METRICS,
    HOST_METRICS,
    RANK_METRICS,
    auc_exact_np,
    auc_histogram,
    auc_scale,
    auc_score,
    k4_slot,
    metric_values,
    parse_metric_name,
    rank_metric_contrib,
    rank_metric_np,
    threshold_consts,
)
from xgboost_ray_tpu_torch.ops.objectives import (
    as_alphas,
    dequantize_gh_sums,
    gh_plane_itemsize,
    objective_from_params,
    quantize_gh,
    round_update,
    round_update_multi,
    softmax_update,
)
from xgboost_ray_tpu_torch.ops.random import fold_in, prng_key
from xgboost_ray_tpu_torch.ops.ranking import (
    GroupLayout,
    build_group_rows,
    rank_grad_hess,
    shard_group_offsets,
)
from xgboost_ray_tpu_torch.ops.sampling import (
    row_budget,
    sample_rows,
    spec_from_params,
)
from xgboost_ray_tpu_torch.ops.split import (
    SplitParams,
    TreeConstraints,
    find_splits,
    leaf_records,
    split_level,
    split_nodes,
)
from xgboost_ray_tpu_torch.params import (
    TrainParams,
    cat_feature_indices,
    leaf_budget,
)


def kernel_counters() -> Dict[str, Callable]:
    """The kernel wrappers of training, by the names the port's records
    give them; each counts its kernel launches in ``.launches``."""
    return {"K1": build_histogram, "K1deq": dequantize, "K2": find_splits,
            "K2level": split_level, "K2leaf": leaf_records,
            "K3": partition_level, "K3leaf": partition_leaf_values,
            "K4": round_update, "B4": predict_tree_binned,
            "SMX": softmax_update, "B9a": auc_histogram,
            "B13": rank_grad_hess, "B9r": rank_metric_contrib,
            "B14": cox_round, "B12r": sample_rows,
            "B12f": sample_feature_mask, "K2nodes": split_nodes,
            "LGstep": frontier_step, "B10": quantize_gh,
            "K1form": form_dequantize, "B11q": wire_quantize,
            "B11acc": wire_accumulate, "B11deq": wire_dequantize,
            "B4w": predict_forest_weighted, "B16": linear_round}


def kernel_launches() -> Dict[str, int]:
    """Launches of every training kernel since ``reset_kernel_launches``,
    with the eval-mode launches of K4 and of the softmax pass apart as
    ``K4eval`` and ``SMXeval`` (``K4`` and ``SMX`` count both modes)."""
    out = {k: fn.launches for k, fn in kernel_counters().items()}
    out["K4eval"] = round_update.eval_launches
    out["SMXeval"] = softmax_update.eval_launches
    out["K2masked"] = split_level.launches_masked
    out["K2cons"] = split_level.launches_constrained
    out["K2cat"] = split_level.launches_categorical
    out["K2nodescat"] = split_nodes.launches_categorical
    out["K3cat"] = partition_level.launches_categorical
    out["B4cat"] = predict_tree_binned.launches_categorical
    out["K4trees"] = round_update.tree_launches
    out["SMXtrees"] = softmax_update.tree_launches
    out["K1int"] = build_histogram.launches_int
    return out


def reset_kernel_launches() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0
    round_update.eval_launches = 0
    softmax_update.eval_launches = 0
    split_level.launches_masked = 0
    split_level.launches_constrained = 0
    split_level.launches_categorical = 0
    split_nodes.launches_categorical = 0
    partition_level.launches_categorical = 0
    predict_tree_binned.launches_categorical = 0
    round_update.tree_launches = 0
    softmax_update.tree_launches = 0
    build_histogram.launches_int = 0


def _concat_shards(shards: Sequence[Dict[str, Optional[np.ndarray]]]):
    """Merge shard dicts (rank order) into host arrays (x, label or None,
    weight or None, base_margin or None, label_lower_bound or None,
    label_upper_bound or None)."""
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
    return (x, column("label"), column("weight"), column("base_margin"),
            column("label_lower_bound"), column("label_upper_bound"))


def _shard_qids(shards: Sequence[Dict[str, Optional[np.ndarray]]]
                ) -> Optional[List[np.ndarray]]:
    """Each shard's ``qid`` (rank order), or None where no shard has one."""
    qids = [sh.get("qid") for sh in shards]
    if all(q is None for q in qids):
        return None
    if any(q is None for q in qids):
        raise ValueError("qid is given for some shards of a set but not "
                         "for others")
    return [np.asarray(q) for q in qids]


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
        # dart: the margins without trees the forest's sum starts from
        self.static: Optional[torch.Tensor] = None
        # label bounds on the device (survival:aft, aft-nloglik)
        self.lower: Optional[torch.Tensor] = None
        self.upper: Optional[torch.Tensor] = None
        # B9a's fixed-point scale of this set's weights (auc / aucpr)
        self.auc_scale = 1.0
        # host copies for custom and host metrics: label, weight (None: all
        # 1)
        self.label_np: Optional[np.ndarray] = None
        self.weight_np: Optional[np.ndarray] = None
        # query groups (qid): per shard on the device, and the host offsets
        # over this rank's rows concatenated (host ndcg / map)
        self.groups: Optional[GroupLayout] = None
        self.group_ptr: Optional[np.ndarray] = None
        # the world's rows for survival:cox / cox-nloglik
        self.cox: Optional["_CoxRows"] = None


class _CoxRows:
    """A set's world-wide rows for Cox (``ops/cox.py``): labels and weights
    gathered once, the time order of them (``cox_setup``), every rank's row
    count and this rank's first row in the gathered order."""

    def __init__(self, label: torch.Tensor, weight: torch.Tensor,
                 coll: Collectives):
        self.counts = coll.row_counts(label.shape[0], label.device)
        self.offset = sum(self.counts[:coll.rank])
        self.n_local = label.shape[0]
        self.label = coll.all_gather(label, self.counts)
        self.weight = coll.all_gather(weight, self.counts)
        self.setup: CoxSetup = cox_setup(self.label)

    def margins(self, margins: torch.Tensor, coll: Collectives
                ) -> torch.Tensor:
        """The world's margins [N] (gathered at world > 1)."""
        return coll.all_gather(margins.reshape(-1), self.counts)


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
        custom_objective: bool = False,
        feature_weights: Optional[np.ndarray] = None,
        categories: Optional[Dict[int, tuple]] = None,
        total_rounds: Optional[int] = None,
    ):
        """``shards``: this rank's shard dicts; ``evals``: (shards, name)
        pairs, ``shards`` itself (the same object) for the training set;
        ``init_booster``: the model training continues;
        ``custom_objective``: every round's gradients come from
        ``step(gh_custom=...)``; ``feature_weights``: [F] non-negative
        weights of the column-sampling draws; ``feature_types``: 'c' marks
        a categorical feature; ``categories``: the training category
        mapping the booster keeps; ``total_rounds``: the rounds this run
        boosts (dart's forest capacity)."""
        self.params = params
        self.device = resolve_device(device)
        self.coll = Collectives()
        self.allreduce_bytes_per_round = 0
        self.feature_names = feature_names
        self.feature_types = feature_types
        self.categories = categories
        self.cat_features = cat_feature_indices(feature_types)
        self.objective = objective_from_params(params)
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
            cat_features=self.cat_features,
            max_leaves=leaf_budget(params),
            hist_quant=params.hist_quant,
            hist_quant_min_bytes=int(params.hist_quant_min_bytes),
            hist_quant_block=int(params.hist_quant_block),
        )
        self._setup_metrics(params)
        # ranking and Cox gradients come from B13 / B14 after K4's eval
        # mode (the custom objective's structure)
        self.pair_gh = not custom_objective and (
            self.objective.ranking or self.objective.cox)
        # the world's rows of every set for survival:cox and cox-nloglik
        self.with_cox = self.objective.cox or COX_METRIC in self.metric_names
        # the label bounds go to the device for survival:aft's gradients
        # and for the aft-nloglik metric
        self.with_bounds = self.objective.survival or (
            "aft-nloglik" in self.metric_names)
        if self.with_bounds and self.n_outputs > 1:
            raise NotImplementedError(
                f"eval_metric='aft-nloglik' with {params.objective}: the "
                f"port sums it over one output only")

        self.custom_objective = custom_objective
        self.dart = params.booster == "dart"
        if self.dart and custom_objective:
            raise ValueError("custom objectives are not supported with dart")
        # quantized gradients at the source (``engine.py:266-276``)
        self.gh_mode = params.gh_precision
        if self.gh_mode != "float32" and custom_objective:
            raise NotImplementedError(
                "gh_precision (quantized-gradient training) is not "
                "supported with a custom objective; set "
                "gh_precision='float32' or use a built-in objective.")
        # parallel trees (num_parallel_tree T: a round grows K x T trees,
        # tree k T + t for output k) and the round's random draws
        self.t_par = max(1, int(params.num_parallel_tree))
        self.samp_spec = spec_from_params(params)
        x, label, weight, base_margin, lo, hi = _concat_shards(shards)
        if self.objective.survival and lo is None and label is None:
            raise ValueError(
                "survival:aft requires label_lower_bound/label_upper_bound "
                "(or a plain label, interpreted as uncensored times).")
        label = self._host_label(label, x.shape[0])
        if (self.objective.kind == "squaredlog"
                and bool((label <= -1).any())):
            # xgboost rejects these at data load (``engine.py:498-505``)
            raise ValueError("reg:squaredlogerror requires all labels > -1.")
        self.label_np, self.weight_np = label, weight
        self.n_rows, self.n_features = x.shape
        binning.validate_categorical_codes(x, self.cat_features,
                                           params.max_bin)
        self._constrain(params)
        dev = self.device
        self.cat = cat_flags(self.cat_features, self.n_features, dev)
        self.n_global = int(self.coll.sum(torch.tensor(
            [self.n_rows], dtype=torch.int64, device=dev)).item())
        coll = self.coll if self.coll.world > 1 else None
        x_dev = _to_device(x, dev)
        self.label = _to_device(label, dev)
        self.weight = (_to_device(weight, dev) if weight is not None
                       else torch.ones(self.n_rows, dtype=torch.float32, device=dev))
        self.lower, self.upper = self._bounds(label, lo, hi)
        self.auc_scale = self._auc_scale(weight, self.n_rows)
        t0 = time.perf_counter()
        self.bins, self.cuts, self.feat_has_missing = binning.sketch_and_bin(
            x_dev, self.weight, params.max_bin, coll, self.n_global,
            self.cat_features)
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
        if self.dart:
            self.margins_static = _to_device(
                self._static_margins(x.shape[0], base_margin), dev)
            self._init_dart_forest(init_booster, total_rounds)
        self.groups, self.group_ptr = self._groups(shards)
        if self.objective.ranking and self.groups is None:
            raise ValueError(
                f"objective {params.objective!r} requires qid")
        self.cox = (_CoxRows(self.label, self.weight, self.coll)
                    if self.with_cox else None)
        self.log_fw = self._log_feature_weights(feature_weights)
        # the reference's device blocks: num_actors blocks of ``slots`` rows
        self.n_actors = int(self.coll.sum(torch.tensor(
            [len(shards)], dtype=torch.int64, device=dev)).item())
        self.slots = -(-max(self.n_global, self.n_actors) // self.n_actors)
        self.blocks = (self._sample_blocks()
                       if self.samp_spec is not None
                       or self.gh_mode != "float32" else ())
        # the round's merged (max|g|, max|h|) [K, 2]: B10's scales
        self.gh_absmax = None
        self._absmax_bytes = 0
        self.hist_allreduce_bytes_per_round = 0
        # one entry a round: its tree, or with K outputs its K trees
        # ([K, heap] fields)
        self.trees: List[Tree] = []

        self.evals: List[_EvalSet] = []
        for eval_shards, name in evals:
            self._add_eval_set(eval_shards, name, shards, init_booster)
        self._place_metrics()
        self.gh = self.qscale = None
        if self.pair_gh:
            # round 0's gradients: B13 / B14 on the base margins
            self.gh = self._pair_gh(False)[0]
            self.qscale = self._scales()
        elif not (custom_objective or self.dart):
            # round 0's gradients: the round pass with zero trees
            self.gh, _ = self._update(
                self.margins, torch.zeros((self.n_outputs, self.n_rows),
                                          dtype=torch.float32, device=dev),
                self.label, self.weight, lower=self.lower, upper=self.upper)
            self.qscale = self._scales()

    def _setup_metrics(self, params: TrainParams) -> None:
        """The metrics of a run: their names, which the round pass sums on
        the device and which the host computes, the partial sums the
        all-reduce carries, and the objective K4 runs with this run's
        metric constants."""
        self.metric_names = list(params.eval_metric) or [
            self.objective.default_metric]
        # the round pass's metrics (K4's partial sums, the softmax pass's,
        # B9a's histogram) first, then the host metrics, as the reference
        # orders a round's row (``engine.py:1942-1960``)
        self.host_metrics = [m for m in self.metric_names
                             if parse_metric_name(m)[0] in HOST_METRICS]
        self.device_metrics = [m for m in self.metric_names
                               if m not in self.host_metrics]
        self.with_auc = any(parse_metric_name(m)[0] in HIST_METRICS
                            for m in self.device_metrics)
        # the partial sums the all-reduce carries: K4's first four and the
        # others the metrics read (the softmax pass's three)
        # the softmax pass's column-0 logloss (the reference's logloss
        # under a softmax objective) only where a metric reads it
        self.logloss0 = self.objective.softmax and any(
            parse_metric_name(m)[0] == "logloss" for m in self.metric_names)
        self.live_parts = ((0, 1, 2) + ((3,) if self.logloss0 else ())
                           if self.objective.softmax
                           else tuple(sorted({0, 1, 2, 3} | {
                               k4_slot(m, self.device_metrics)
                               for m in self.device_metrics} - {None})))
        alpha0 = as_alphas(params.quantile_alpha)
        # the objective K4 runs, with this run's metric constants (error@t's
        # threshold, the quantile metric's alpha)
        self.k4_objective = dataclasses.replace(
            self.objective, consts=self.objective.consts._replace(
                **threshold_consts(self.metric_names),
                alpha0=float(np.float32(alpha0[0])) if len(alpha0) == 1
                else 0.5))
        if (any(parse_metric_name(m)[0] == "quantile"
                for m in self.metric_names) and len(alpha0) != 1
                and self.objective.kind != "quantile"):
            raise ValueError(
                f"quantile metric got 1 margin column but {len(alpha0)} "
                f"quantile_alpha values; they must align.")

    def _place_metrics(self) -> None:
        """After the eval sets: the rank metrics move to the host unless
        every set has its query groups, and the device metrics the round
        passes and B9r sum are fixed."""
        # ndcg / map on the device where every set has its groups, else on
        # the host (``engine.py:748-766``)
        if not all(es.groups is not None for es in self.evals):
            self.host_metrics += [
                m for m in self.device_metrics
                if parse_metric_name(m)[0] in RANK_METRICS]
            self.device_metrics = [m for m in self.device_metrics
                                   if m not in self.host_metrics]
        self.rank_device = [m for m in self.device_metrics
                            if parse_metric_name(m)[0] in RANK_METRICS]
        # the training set's cox-nloglik comes out of its B14 gradient call
        self.cox_train_metric = COX_METRIC in self.device_metrics and any(
            es.is_train for es in self.evals)

    def _constrain(self, params: TrainParams) -> None:
        """Monotone and interaction constraints, validated against the
        feature count as the reference validates them
        (``engine.py:440-470``: monotone padded with 0 to F, all zeros no
        constraint) and carried in the grow config; their device form
        (``TreeConstraints``) is made once here."""
        self.constraints = None
        if not (params.monotone_constraints
                or params.interaction_constraints):
            return
        mono = tuple(int(c) for c in params.monotone_constraints)
        if len(mono) > self.n_features:
            raise ValueError(
                f"monotone_constraints has {len(mono)} entries but the "
                f"data has {self.n_features} features.")
        mono = mono + (0,) * (self.n_features - len(mono))
        for fi in self.cat_features:
            if mono[fi] != 0:
                raise ValueError(
                    f"monotone constraint on categorical feature {fi} is "
                    f"not supported (one-vs-rest category splits have no "
                    f"order to be monotone in).")
        ic = params.interaction_constraints
        bad = [i for grp in ic for i in grp if i >= self.n_features]
        if bad:
            raise ValueError(
                f"interaction_constraints reference feature indices "
                f"{sorted(set(bad))} but the data has "
                f"{self.n_features} features.")
        self.cfg = dataclasses.replace(
            self.cfg, monotone_constraints=mono if any(mono) else (),
            interaction_constraints=ic)
        cons = TreeConstraints(self.cfg.monotone_constraints, ic,
                               self.n_features, self.device)
        self.constraints = cons if cons.on else None

    def _log_feature_weights(self, feature_weights: Optional[np.ndarray]
                             ) -> Optional[torch.Tensor]:
        """log(feature_weights) [F] f32 on the device (-inf at weight 0),
        taken on the host as the reference takes it, after its checks
        (``engine.py:475-490``); None without weights."""
        if feature_weights is None:
            return None
        fw = np.asarray(feature_weights, np.float32).ravel()
        if fw.shape[0] != self.n_features:
            raise ValueError(
                f"feature_weights has {fw.shape[0]} entries but the data "
                f"has {self.n_features} features.")
        if (fw < 0).any():
            raise ValueError("feature_weights must be non-negative.")
        if fw.sum() <= 0:
            raise ValueError("feature_weights must not be all zero.")
        with np.errstate(divide="ignore"):
            return _to_device(np.log(fw), self.device)

    def _sample_blocks(self) -> Tuple[Tuple[int, int, int], ...]:
        """The blocks this rank draws row samples and gradient roundings
        over: the JAX package's device blocks (``engine.py:827-856``: the
        world's rows in shard order, padded to ``num_actors`` blocks of
        ``slots`` rows, the padding at the end), each (block index, its
        first row in this rank's rows, its real rows). Each rank's rows must
        be whole blocks: at world 1 they are; above it, shards of the block
        size (``num_actors`` 2, or rows a multiple of ``num_actors``)."""
        dev = self.device
        n_actors, slots = self.n_actors, self.slots
        counts = self.coll.row_counts(self.n_rows, dev)
        start = sum(counts[:self.coll.rank])
        end = start + self.n_rows
        n = self.n_global
        if start % slots or (end % slots and end != n):
            raise NotImplementedError(
                f"row sampling / gh_precision: this rank's rows [{start}, "
                f"{end}) are not whole blocks of {slots} rows (the "
                f"reference's device blocks at num_actors={n_actors}); use "
                f"num_actors 1 or 2 or a row count divisible by "
                f"num_actors.")
        last = n_actors if end == n else end // slots
        self.sample_slots = slots
        if self.samp_spec is not None:
            self.sample_rows_global = n_actors * row_budget(slots,
                                                            self.samp_spec)
        self.sample_padding = last * slots > end
        return tuple((d, d * slots - start,
                      max(0, min(slots, n - d * slots)))
                     for d in range(start // slots, last))

    @staticmethod
    def _host_label(label: Optional[np.ndarray], n: int) -> np.ndarray:
        """A set's labels: its label column, else zeros (the reference's
        fill, also for survival data given by its bounds alone)."""
        return label if label is not None else np.full(n, 0.0, np.float32)

    def _bounds(self, label: np.ndarray, lo: Optional[np.ndarray],
                hi: Optional[np.ndarray]):
        """A set's (lower, upper) on the device where the objective or a
        metric reads them (lower defaults to the label, upper to lower:
        uncensored times), else (None, None)."""
        if not self.with_bounds:
            return None, None
        lo = label if lo is None else lo
        hi = lo if hi is None else hi
        return _to_device(lo, self.device), _to_device(hi, self.device)

    def _auc_scale(self, weight: Optional[np.ndarray], n: int) -> float:
        """B9a's scale for a set of ``n`` rows on this rank (``auc_scale``
        over the world's largest |weight| and global row count)."""
        if not self.with_auc:
            return 1.0
        wmax = float(np.max(np.abs(weight))) if weight is not None and n \
            else (1.0 if n else 0.0)
        both = self.coll.max(torch.tensor([wmax], dtype=torch.float64,
                                          device=self.device))
        n_global = self.coll.sum(torch.tensor([n], dtype=torch.int64,
                                              device=self.device))
        return auc_scale(float(both.item()), int(n_global.item()))

    def _static_margins(self, n: int, base_margin: Optional[np.ndarray]
                        ) -> np.ndarray:
        """A set's margins without trees [N, K] f32 on the host: the base
        margin, plus the rows' ``base_margin`` (``engine.py:699-706``)."""
        margins = np.full((n, self.n_outputs), self.base_margin0, np.float32)
        if base_margin is not None:
            margins = margins + base_margin.reshape(n, -1).astype(np.float32)
        return margins

    def _start_margins(self, x: np.ndarray, base_margin: Optional[np.ndarray],
                       init_booster: Optional[RayXGBoostBooster]) -> np.ndarray:
        """A set's first margins [N, K] f32 on the host: the static margins
        plus the init booster's trees (its margin less its base;
        ``engine.py:700-728``, ``:1172-1183``)."""
        n = x.shape[0]
        margins = self._static_margins(n, base_margin)
        if init_booster is not None and init_booster.num_trees:
            pm = init_booster.predict_margin(
                init_booster._coerce_features(x), device=self.device)
            margins = margins + (pm.reshape(n, -1)
                                 - init_booster.base_score_margin_np())
        return margins

    def _groups(self, shards) -> Tuple[Optional[GroupLayout],
                                       Optional[np.ndarray]]:
        """A set's query groups (None without qid): the device layout, each
        shard's groups on its own rows, padded to the world's largest group
        (an all-reduce MAX), and the host offsets over this rank's rows
        concatenated (``build_group_rows``' group_ptr, for host ndcg / map)."""
        qids = _shard_qids(shards)
        if qids is None:
            return None, None
        offsets = shard_group_offsets(qids)
        sizes = np.diff(offsets)
        local = torch.tensor([int(sizes.max()) if sizes.size else 0],
                             dtype=torch.int64, device=self.device)
        width = int(self.coll.max(local).item())
        ptr = build_group_rows(np.concatenate(qids))[1]
        layout = GroupLayout(_to_device(offsets, self.device), max(width, 1))
        return layout, ptr

    def _pair_gh(self, with_metric: bool):
        """The next round's [1, N, 2] gradients of a ranking objective (B13
        over the groups) or of survival:cox (B14 over the world's gathered
        margins, with the cox-nloglik sums where ``with_metric``), from the
        current margins: (gh, sums or None)."""
        if self.objective.ranking:
            gh = rank_grad_hess(self.margins, self.label, self.weight,
                                self.groups, self.objective.name)
            return gh.view(1, -1, 2), None
        cox = self.cox
        gh, sums = cox_round(cox.margins(self.margins, self.coll), cox.label,
                             cox.weight, cox.setup, cox.offset, cox.n_local,
                             with_metric)
        return gh.view(1, -1, 2), sums

    def _cox_metric(self, cox: _CoxRows, margins: torch.Tensor
                    ) -> torch.Tensor:
        """A set's cox-nloglik sums [2] f64 (B14 over its world's rows)."""
        return cox_round(cox.margins(margins, self.coll), cox.label,
                         cox.weight, cox.setup, cox.offset, 0, True)[1]

    def _add_eval_set(self, eval_shards, name: str, train_shards,
                      init_booster: Optional[RayXGBoostBooster]) -> None:
        if eval_shards is train_shards:
            es = _EvalSet(name, True)
            es.groups, es.group_ptr, es.cox = (self.groups, self.group_ptr,
                                               self.cox)
            self.evals.append(es)
            return
        x, label, weight, base_margin, lo, hi = _concat_shards(eval_shards)
        label = self._host_label(label, x.shape[0])
        dev = self.device
        es = _EvalSet(name, False)
        x_dev = _to_device(x, dev)
        es.bins = binning.bin_matrix(x_dev, self.cuts, self.params.max_bin)
        del x_dev
        es.label_np, es.weight_np = label, weight
        es.label = _to_device(label, dev)
        es.weight = (_to_device(weight, dev) if weight is not None
                     else torch.ones(x.shape[0], dtype=torch.float32, device=dev))
        es.lower, es.upper = self._bounds(label, lo, hi)
        es.auc_scale = self._auc_scale(weight, x.shape[0])
        es.margins = _to_device(
            self._start_margins(x, base_margin, init_booster), dev)
        if self.dart:
            es.static = _to_device(
                self._static_margins(x.shape[0], base_margin), dev)
        es.groups, es.group_ptr = self._groups(eval_shards)
        if self.with_cox:
            es.cox = _CoxRows(es.label, es.weight, self.coll)
        self.evals.append(es)

    def _update(self, margins: torch.Tensor, row_value: torch.Tensor,
                label: torch.Tensor, weight: torch.Tensor,
                with_gh: bool = True, lower: Optional[torch.Tensor] = None,
                upper: Optional[torch.Tensor] = None):
        """The round pass over one set: ``margins`` [N, K] += ``row_value``
        [K T, N] in place (T parallel trees an output, tree k T + t of
        output k, added tree by tree where T > 1); (gh [K, N, 2] or None,
        its metric partial sums). K4 for one output (its AFT modes with the
        label bounds), K4's K-output kernel for K quantiles, the softmax
        pass for K classes."""
        obj = self.objective
        if obj.softmax:
            return softmax_update(margins, row_value, label, weight, with_gh,
                                  self.logloss0)
        if obj.kind == "quantile":
            return round_update_multi(margins, row_value, label, weight,
                                      self.k4_objective,
                                      with_gh, self.device_metrics)
        rv = row_value if row_value.shape[0] > 1 else row_value.view(-1)
        gh, sums = round_update(margins.view(-1), rv, label,
                                weight, self.k4_objective,
                                self.params.scale_pos_weight, with_gh,
                                self.device_metrics, lower, upper)
        return (None if gh is None else gh.view(1, -1, 2)), sums

    def _set_parts(self, sums: torch.Tensor, margins: torch.Tensor,
                   label: torch.Tensor, weight: torch.Tensor,
                   scale: float, groups: Optional[GroupLayout] = None
                   ) -> torch.Tensor:
        """A set's contribution to the round's metric all-reduce: its live
        partial sums (``live_parts``: a slice where they are the first ones),
        with auc / aucpr B9a's histogram of its updated margins as float64
        (exact: ``auc_scale``), then B9r's (sum, groups) of each ndcg / map
        metric."""
        live = self.live_parts
        sums = (sums[:len(live)] if live == tuple(range(len(live)))
                else sums[list(live)])
        out = [sums]
        if self.with_auc:
            hist = auc_histogram(auc_score(margins), label, weight, scale)
            out.append(hist.view(-1).to(torch.float64))
        for name in self.rank_device:
            base, k = parse_metric_name(name)
            out.append(rank_metric_contrib(base, margins, label, groups, k))
        return out[0] if len(out) == 1 else torch.cat(out)

    def _scales(self) -> Optional[torch.Tensor]:
        """K1's fixed-point scales [K, 4] of the gradients ``self.gh`` on
        the card, one row a class (None on the CPU, which sums f32): issued
        as soon as the round pass has produced them, so their few launches
        queue behind it rather than after the round's metric read. Their
        merged (max|g|, max|h|) is also B10's under ``gh_precision``
        (``_round_absmax``)."""
        absmax = self._round_absmax()
        if self.device.type != "cuda":
            return None
        return scales_for(absmax, self.n_global)

    def _round_absmax(self) -> Optional[torch.Tensor]:
        """The world's per-class (max|g|, max|h|) [K, 2] of ``self.gh``, one
        all-reduce MAX (kept in ``gh_absmax`` for B10's scales, its bytes in
        ``_absmax_bytes``): on the card, and on the CPU under
        ``gh_precision`` (None there otherwise)."""
        if self.device.type != "cuda" and self.gh_mode == "float32":
            return None
        before = self.coll.bytes.total
        absmax = self.coll.max(gh_absmax(self.gh))
        self._absmax_bytes = self.coll.bytes.total - before
        self.gh_absmax = absmax
        return absmax

    def _quantize(self, key, gh: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One tree's quantized gradients (``engine.py:1320-1335``): each of
        this rank's device blocks rounds its rows with the tree's key folded
        with ``SALT_SR`` and the block (B10), at the scales of output
        ``k``'s merged absmax, the grid capped by the padded global rows.
        Returns (gh_q [n, 2] int8 / int16, scale [2] f32)."""
        skey = fold_in(key, SALT_SR)
        amax = self.gh_absmax[k]
        max_rows = self.n_actors * self.slots
        parts = [quantize_gh(gh[off:off + n_valid], self.gh_mode,
                             fold_in(skey, d), amax, max_rows)
                 for d, off, n_valid in self.blocks]
        scale = parts[0][1]
        q = (torch.cat([q for q, _ in parts]) if len(parts) > 1
             else parts[0][0])
        return q, scale

    def gh_plane_bytes_per_shard(self) -> int:
        """One tree's (g, h) plane of a device block of the reference's
        layout: ``slots * 2 * itemsize`` of the ``gh_precision`` dtype
        (``engine.py:2118-2127``)."""
        return self.slots * 2 * gh_plane_itemsize(self.gh_mode)

    def _user_gh(self, g, h) -> torch.Tensor:
        """A custom objective's (g, h) for this rank's rows ([n] or [n, K]
        each) as the [K, n, 2] f32 planes on the device: g and h are copied
        as they are and interleaved there (an interleave on the host costs
        more than both copies)."""
        n, k = self.n_rows, self.n_outputs

        def plane(a) -> torch.Tensor:  # [K, n]
            return _to_device(np.asarray(a, np.float32).reshape(n, k),
                              self.device).T

        return torch.stack([plane(g), plane(h)], dim=2)

    def step(self, iteration: int, gh_custom=None
             ) -> Dict[str, Dict[str, float]]:
        """One boosting round (K trees) on the built-in gradients, or with
        ``custom_objective`` on ``gh_custom`` = (g, h); returns
        {eval_name: {metric: value}}."""
        if (gh_custom is not None) != self.custom_objective:
            raise ValueError(
                "step(): gh_custom is required with a custom objective and "
                "refused without one")
        if gh_custom is not None:
            self.gh = self._user_gh(*gh_custom)
            self.qscale = self._scales()
        if self.dart:
            return self._step_dart(iteration)
        self.coll.bytes.total = 0
        walked, row_value = self._grow_round(iteration, True)
        self.gh, sums = self._update(
            self.margins, row_value, self.label, self.weight,
            with_gh=not (self.custom_objective or self.pair_gh),
            lower=self.lower, upper=self.upper)
        cox_sums = None
        if self.pair_gh:
            self.gh, cox_sums = self._pair_gh(self.cox_train_metric)
        if not self.custom_objective:
            self.qscale = self._scales()  # the next round's
        n_trees = self.n_outputs * self.t_par

        def held_out(es):
            value = predict_tree_binned(walked, es.bins, self.cfg.max_depth,
                                        self.cfg.max_bin, cat=self.cat)
            return self._update(es.margins, value.view(n_trees, -1),
                                es.label, es.weight, with_gh=False,
                                lower=es.lower, upper=es.upper)[1]

        return self._round_metrics(sums, cox_sums, held_out)

    def _grow_round(self, iteration: int, with_row_value: bool):
        """Grow the round's K x T trees on ``self.gh`` (the tree loop of the
        round, ``engine.py:1315-1420``), appending them to ``trees``:
        (the round's forest, [heap] fields for one tree, else [K T, heap];
        every training row's values [K T, N] where ``with_row_value``, else
        None)."""
        coll = self.coll
        p = self.params
        k_out, t_par = self.n_outputs, self.t_par
        n_trees = k_out * t_par
        forest = empty_tree(self.cfg.heap_size, self.device, n_trees)
        sampled = self.samp_spec is not None
        quant_gh = self.gh_mode != "float32"
        row_value = (None if sampled else
                     torch.empty((n_trees, self.n_rows), dtype=torch.float32,
                                 device=self.device))
        per_level = p.colsample_bylevel < 1.0 or p.colsample_bynode < 1.0
        # the round's key (``engine.py:1884``), only where a draw reads it;
        # tree k T + t folds in its index (``:1317``)
        rng = (fold_in(prng_key(p.seed), self.iteration_offset + iteration)
               if sampled or per_level or p.colsample_bytree < 1.0
               or quant_gh else None)
        tree_bytes0 = coll.bytes.total
        for k in range(k_out):
            for t in range(t_par):
                i = k * t_par + t
                key = None if rng is None else fold_in(rng, i)
                bins, gh = self.bins, self.gh[k]
                qscale = None if self.qscale is None else self.qscale[k]
                gh_scale = None
                if quant_gh:
                    gh, gh_scale = self._quantize(key, gh, k)
                    qscale = None
                if sampled:
                    bins, gh, qscale, gh_scale = self._sample(key, gh,
                                                              gh_scale)
                fmask = None
                if p.colsample_bytree < 1.0:
                    fmask = sample_feature_mask(
                        fold_in(key, SALT_BYTREE), self.n_features,
                        p.colsample_bytree, self.log_fw, device=self.device)
                tree = Tree(*[f[i] for f in forest])
                rv = None if sampled else row_value[i]
                allreduce = coll.sum if coll.world > 1 else None
                if self.cfg.max_leaves:
                    build_tree_lossguide(
                        bins, gh, self.cuts, self.cfg,
                        feat_has_missing=self.feat_has_missing,
                        allreduce=allreduce, qscale=qscale, tree=tree,
                        row_value=rv, feature_mask=fmask, cat=self.cat,
                        gh_scale=gh_scale, coll=coll)
                    continue
                build_tree(
                    bins, gh, self.cuts, self.cfg,
                    feat_has_missing=self.feat_has_missing,
                    allreduce=allreduce, qscale=qscale, tree=tree,
                    row_value=rv, feature_mask=fmask,
                    level_key=key if per_level else None,
                    colsample_bylevel=p.colsample_bylevel,
                    colsample_bynode=p.colsample_bynode,
                    feature_log_weights=self.log_fw,
                    constraints=self.constraints, cat=self.cat,
                    gh_scale=gh_scale, coll=coll,
                )
        # the tree path's bytes (``main.py:497-507``): the merges of every
        # histogram and exact reduction, and the absmax merge of the
        # round's scales
        self.hist_allreduce_bytes_per_round = (
            coll.bytes.total - tree_bytes0 + self._absmax_bytes)
        # one tree a round: the round's tree itself ([heap] fields)
        walked = forest if n_trees > 1 else Tree(*[f[0] for f in forest])
        self.trees.append(walked)
        if sampled and with_row_value:
            # a sampled tree holds only its rows' values: every training
            # row's comes from a walk of the round's trees (``:1412``)
            row_value = predict_tree_binned(
                walked, self.bins, self.cfg.max_depth,
                self.cfg.max_bin, cat=self.cat).view(n_trees, -1)
        return walked, row_value

    def _round_metrics(self, sums: torch.Tensor,
                       cox_sums: Optional[torch.Tensor],
                       held_out: Callable) -> Dict[str, Dict[str, float]]:
        """The round's metrics: the training set's from its round pass's
        ``sums`` (and ``cox_sums``), each held-out set's from
        ``held_out(es)`` (its margin update; its pass's sums), merged over
        the world in one all-reduce."""
        coll = self.coll
        if not self.evals:
            self.allreduce_bytes_per_round = coll.bytes.total
            return {}
        if self.cox_train_metric and cox_sums is None:
            cox_sums = self._cox_metric(self.cox, self.margins)
        parts = [self._set_parts(sums, self.margins, self.label, self.weight,
                                 self.auc_scale, self.groups)]
        cox_parts = [cox_sums]
        for es in self.evals:
            if not es.is_train:
                es_sums = held_out(es)
                parts.append(self._set_parts(es_sums, es.margins, es.label,
                                             es.weight, es.auc_scale,
                                             es.groups))
                cox_parts.append(self._cox_metric(es.cox, es.margins)
                                 if COX_METRIC in self.device_metrics
                                 else None)
        parts = coll.sum(torch.stack(parts)).cpu()
        self.allreduce_bytes_per_round = coll.bytes.total
        held_out = iter(zip(parts[1:], cox_parts[1:]))
        out = {}
        for es in self.evals:
            row, cox = ((parts[0], cox_parts[0]) if es.is_train
                        else next(held_out))
            out[es.name] = self._set_metrics(row, cox)
            for name in self.host_metrics:
                out[es.name][name] = self.combine_host_scalar(
                    self._host_metric(es, name), es,
                    groups=parse_metric_name(name)[0] in RANK_METRICS)
        return out

    # ------------------------------------------------------------------
    # dart (``engine.py:2830-3090``): the round's margins come from the
    # forest so far under the round's tree weights (B4w), so dropping trees
    # is a weight-vector edit.
    # ------------------------------------------------------------------

    def _init_dart_forest(self, init_booster: Optional[RayXGBoostBooster],
                          total_rounds: Optional[int]) -> None:
        """The capacity-padded forest on the device (``_init_dart_forest``,
        ``engine.py:2838``): ``n_init + max(1, total_rounds) K`` slots, the
        init booster's trees first, empty slots a root leaf of value 0; the
        host's tree weights (the init booster's, or 1), 0 beyond them."""
        k_out = self.n_outputs
        heap = self.cfg.heap_size
        init = self._init_trees[0] if self._init_trees else None
        n_init = 0 if init is None else int(np.asarray(init.feature).shape[0])
        t_cap = n_init + max(1, int(total_rounds or 0)) * k_out
        forest = empty_tree(heap, self.device, t_cap)
        forest.is_leaf[:, 0] = True
        if n_init:
            for name, field in zip(Tree._fields, forest):
                field[:n_init] = torch.as_tensor(
                    np.asarray(getattr(init, name)), device=self.device)
        self.dart_forest = forest
        self.dart_weights = np.zeros(t_cap, np.float32)
        if n_init:
            self.dart_weights[:n_init] = (
                init_booster.tree_weights
                if init_booster.tree_weights is not None
                else np.ones(n_init, np.float32))
        self.dart_t = n_init
        self.dart_t_cap = t_cap

    def _dart_sample_drops(self, iteration: int) -> np.ndarray:
        """The round's dropped slots [t_cap] bool (``engine.py:2969-2991``):
        host draws of ``RandomState((seed * 1_000_003 + iteration_offset +
        iteration) mod 2^31)``, bitwise the reference's."""
        params = self.params
        t = self.dart_t
        rng = np.random.RandomState(
            (params.seed * 1_000_003 + self.iteration_offset + iteration)
            % (2 ** 31))
        drop = np.zeros(self.dart_t_cap, bool)
        if t == 0 or (params.skip_drop > 0 and rng.rand() < params.skip_drop):
            return drop
        weights = np.maximum(self.dart_weights[:t], 0.0)
        if params.sample_type == "weighted":
            probs = weights / max(weights.sum(), 1e-12)
            drop[:t] = rng.rand(t) < np.minimum(probs * t * params.rate_drop,
                                                1.0)
        else:
            drop[:t] = rng.rand(t) < params.rate_drop
        if params.one_drop and not drop.any():
            if params.sample_type == "weighted" and weights.sum() > 0:
                idx = rng.choice(t, p=weights / weights.sum())
            else:
                idx = rng.randint(t)
            drop[idx] = True
        return drop

    def _dart_weights(self, iteration: int):
        """(w_eff, w_full) [t_cap] f32 of the round (``step_dart``,
        ``engine.py:3008-3020``): the drops' weights 0 for growing, and
        after the round the dropped ones scaled and the K new slots at
        ``new_w``, with the tree / forest normalisation."""
        lr = self.params.learning_rate
        drop = self._dart_sample_drops(iteration)
        k_dropped = int(drop.sum())
        if k_dropped:
            if self.params.normalize_type == "forest":
                new_w, drop_scale = 1.0 / (1.0 + lr), 1.0 / (1.0 + lr)
            else:  # "tree"
                new_w = 1.0 / (k_dropped + lr)
                drop_scale = k_dropped / (k_dropped + lr)
        else:
            new_w, drop_scale = 1.0, 1.0
        w_eff = self.dart_weights.copy()
        w_eff[drop] = 0.0
        w_full = self.dart_weights.copy()
        w_full[drop] *= drop_scale
        w_full[self.dart_t:self.dart_t + self.n_outputs] = new_w
        return w_eff, w_full

    def _forest_margins(self, bins: torch.Tensor, static: torch.Tensor,
                        weights: torch.Tensor, n_trees: int) -> torch.Tensor:
        """A set's margins [N, K] from the dart forest's first ``n_trees``
        slots under ``weights`` (B4w)."""
        return predict_forest_weighted(
            self.dart_forest, n_trees, bins, static, weights,
            self.cfg.max_depth, self.cfg.max_bin, cat=self.cat)

    def _step_dart(self, iteration: int) -> Dict[str, Dict[str, float]]:
        """One dart round (``step_dart``, ``engine.py:2993-3075``): the
        margins under the drops (B4w over the slots so far), their
        gradients (the round pass with zero trees; B13 / B14 for ranking
        and Cox), the K trees grown on them into slots [dart_t, dart_t +
        K), then every set's margins under the round's final weights (B4w
        over the slots so far and the new ones) and their metrics."""
        k_out = self.n_outputs
        if self.dart_t + k_out > self.dart_t_cap:
            raise RuntimeError(
                f"dart forest capacity exhausted: slot {self.dart_t} + "
                f"{k_out} trees > t_cap {self.dart_t_cap}")
        self.coll.bytes.total = 0
        dev = self.device
        w_eff, w_full = self._dart_weights(iteration)
        m_eff = self._forest_margins(self.bins, self.margins_static,
                                     _to_device(w_eff, dev), self.dart_t)
        zeros = torch.zeros((k_out, self.n_rows), dtype=torch.float32,
                            device=dev)
        if self.pair_gh:
            self.margins = m_eff
            self.gh = self._pair_gh(False)[0]
        else:
            self.gh = self._update(m_eff, zeros, self.label, self.weight,
                                   lower=self.lower, upper=self.upper)[0]
        self.qscale = self._scales()
        walked, _ = self._grow_round(iteration, False)
        slots = slice(self.dart_t, self.dart_t + k_out)
        for field, new in zip(self.dart_forest, walked):
            field[slots] = new.view((k_out, -1))
        n_trees = self.dart_t + k_out
        w_dev = _to_device(w_full, dev)
        self.margins = self._forest_margins(self.bins, self.margins_static,
                                            w_dev, n_trees)
        self.dart_weights = w_full
        self.dart_t = n_trees
        if not self.evals:
            self.allreduce_bytes_per_round = self.coll.bytes.total
            return {}
        sums = self._update(self.margins, zeros, self.label, self.weight,
                            with_gh=False, lower=self.lower,
                            upper=self.upper)[1]

        def held_out(es):
            es.margins = self._forest_margins(es.bins, es.static, w_dev,
                                              n_trees)
            zero = torch.zeros((k_out, es.margins.shape[0]),
                               dtype=torch.float32, device=dev)
            return self._update(es.margins, zero, es.label, es.weight,
                                with_gh=False, lower=es.lower,
                                upper=es.upper)[1]

        return self._round_metrics(sums, None, held_out)

    def _sample(self, key, gh: torch.Tensor,
                gh_scale: Optional[torch.Tensor] = None):
        """One tree's row sample (``engine.py:1340-1361``): each of this
        rank's blocks draws with the tree's key folded with the policy's
        salt and the block's index (B12r); returns the compacted (bins [M,
        F], gh [M, 2], K1's scales or None, the quantized gradients' scales
        or None). A selected padding slot is a row of missing bins and zero
        gradients, as the reference's. Quantized gradients (``gh`` int8 /
        int16 with ``gh_scale``): the uniform draw gathers the narrow
        buffer; GOSS draws over their dequantized values and grows on the
        f32 path (its amplification is real-valued; ``sampling.py:144-190``
        of the reference)."""
        spec = self.samp_spec
        skey = fold_in(key, SALT_GOSS if spec.policy == "gradient_based"
                       else SALT_SUBSAMPLE)
        narrow = None
        if gh_scale is not None:
            narrow, gh = gh, dequantize_gh_sums(gh, gh_scale)
            if spec.policy == "gradient_based":
                narrow = gh_scale = None
        parts = [sample_rows(gh[off:off + n_valid], self.sample_slots,
                             fold_in(skey, d), spec, row_offset=off)
                 for d, off, n_valid in self.blocks]
        rows = torch.cat([r for r, _ in parts]) if len(parts) > 1 \
            else parts[0][0]
        gh_sel = torch.cat([g for _, g in parts]) if len(parts) > 1 \
            else parts[0][1]
        rows = rows.long()
        if self.sample_padding:
            pad = rows >= self.n_rows
            bins = self.bins[rows.clamp(max=self.n_rows - 1)]
            bins[pad] = self.params.max_bin
        else:
            bins = self.bins[rows]
        if narrow is not None:
            gh_sel = narrow[rows.clamp(max=self.n_rows - 1)]
            if self.sample_padding:
                gh_sel[rows >= self.n_rows] = 0
            return bins, gh_sel, None, gh_scale
        return bins, gh_sel, self._tree_scales(gh_sel), None

    def _tree_scales(self, gh_sel: torch.Tensor) -> Optional[torch.Tensor]:
        """K1's fixed-point scales [4] of a sampled tree on the card: from
        its compacted gradients over the world's compacted rows, merged by
        one all-reduce MAX (GOSS amplifies rows beyond the round's maxima);
        None on the CPU."""
        if self.device.type != "cuda":
            return None
        return quant_scales(gh_sel, self.sample_rows_global, self.coll.max)

    def _set_metrics(self, row: torch.Tensor, cox: Optional[torch.Tensor]
                     ) -> Dict[str, float]:
        """A set's device metrics, in ``device_metrics`` order, from its row
        of the merged partial sums (``_set_parts``' layout) and its
        cox-nloglik sums (not merged: the same on every rank)."""
        names = self.objective.partials
        n_live = len(self.live_parts)
        sums = torch.zeros(len(names), dtype=torch.float64)
        sums[list(self.live_parts)] = row[:n_live]
        off = n_live + (2 * AUC_BINS if self.with_auc else 0)
        hist = (row[n_live:off].numpy().reshape(2, AUC_BINS)
                if self.with_auc else None)
        vals = metric_values(sums, [
            m for m in self.device_metrics
            if m not in self.rank_device and m != COX_METRIC], names, hist)
        for i, name in enumerate(self.rank_device):
            num, den = row[off + 2 * i:off + 2 * i + 2].tolist()
            vals[name] = num / max(den, 1e-12)
        if cox is not None:
            num, den = cox.cpu().tolist()
            vals[COX_METRIC] = num / max(den, 1e-12)
        return {m: vals[m] for m in self.device_metrics}

    def _host_metric(self, es: _EvalSet, name: str) -> float:
        """A host metric of this rank's rows of ``es``: ``auc_exact``
        (``_auc_np``, as the reference's host path computes it), or ndcg /
        map over the set's groups (``ndcg_np`` / ``map_np``; the whole set
        one group without qid)."""
        label, weight = self.host_labels(es)
        margins = self.get_margins(es)
        if parse_metric_name(name)[0] in RANK_METRICS:
            return rank_metric_np(name, margins, label, es.group_ptr)
        score = auc_score(torch.from_numpy(margins)).numpy()
        return auc_exact_np(score, label, weight)

    @property
    def rounds_done(self) -> int:
        """Rounds boosted by this engine (a booster of them differs from one
        of fewer)."""
        return len(self.trees)

    def get_margins(self, es: Optional[_EvalSet] = None) -> np.ndarray:
        """This rank's margins [n_rows, K] of the training set (or of the
        eval set ``es``)."""
        if es is None or es.is_train:
            return self.margins.cpu().numpy()
        return es.margins.cpu().numpy()

    def host_labels(self, es: Optional[_EvalSet] = None
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(label, weight or None) of this rank's rows of the training set
        (or of the eval set ``es``), on the host."""
        if es is None or es.is_train:
            return self.label_np, self.weight_np
        return es.label_np, es.weight_np

    def combine_host_scalar(self, value: float,
                            es: Optional[_EvalSet] = None,
                            groups: bool = False) -> float:
        """A metric value each rank computed on its rows -> their mean
        weighted by each rank's weight sum (or row count; with ``groups``
        and a set with qid, its query groups), the same on every rank (the
        JAX engine's, ``engine.py:2018``); the identity at world 1. The
        ranks' (value x weight, weight) pairs are summed in rank order on
        the host: each rank all-reduces a [world, 2] f64
        tensor holding only its own row, which adds nothing but zeros."""
        if self.coll.world == 1:
            return float(value)
        label, weight = self.host_labels(es)
        ptr = (self.group_ptr if es is None or es.is_train
               else es.group_ptr)
        if groups and ptr is not None:
            wt = float(len(ptr) - 1)
        else:
            wt = (float(np.sum(weight)) if weight is not None
                  else float(len(label)))
        rows = torch.zeros((self.coll.world, 2), dtype=torch.float64,
                           device=self.device)
        rows[self.coll.rank, 0] = float(value) * wt
        rows[self.coll.rank, 1] = wt
        num, den = 0.0, 0.0
        for v, w in self.coll.sum(rows).cpu().tolist():
            num, den = num + v, den + w
        return num / max(den, 1e-12)

    def get_booster(self) -> RayXGBoostBooster:
        booster = RayXGBoostBooster(
            stack_trees(self._init_trees + self.trees),
            self.cuts.cpu().numpy(),
            self.params,
            self.base_score,
            feature_names=self.feature_names,
            feature_types=self.feature_types,
            tree_weights=(self.dart_weights[:self.dart_t].copy()
                          if self.dart else None),
        )
        booster._has_node_stats = self._init_has_stats
        booster.categories = self.categories
        return booster
