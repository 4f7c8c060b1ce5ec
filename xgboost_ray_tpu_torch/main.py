"""``train()``, ``predict()``, ``RayParams`` and the ranks' records of the
port.

Port of ``xgboost_ray_tpu/main.py``: ``RayParams`` (``:134``),
``_validate_ray_params`` (``:177``), ``RayXGBoostActor`` (``:222-264``: a
rank's record, the training call's queue and stop event, its distributed
callbacks and the shards it loads), ``train`` (``:1681``, driving the
round loop of ``_train`` at ``:678``): validation, eval sets (the training matrix or
held-out matrices, each loaded like ``dtrain``), ``evals_result``,
``verbose_eval``, ``additional_results``, early stopping on the last metric
of the last eval set (``early_stopping_rounds``, ``maximize``;
``:1276-1285``, ``:1520-1534``, ``best_iteration`` and ``best_score`` at
``:1558-1562``), warm start from ``xgb_model``, the training callbacks
(``wrap_callbacks`` and the tune callback inside a tuning session,
``:1789-1793``; ``before_training`` / ``before_iteration`` /
``after_iteration`` / ``after_training``, ``after_iteration`` returning
True stops training, as in xgboost) and the distributed callbacks' hooks
where the JAX package fires them (``on_init`` and the data-loading hooks,
``:236-264``; ``before_train``, ``:905``; ``after_round``, ``:927-938``;
``after_train``, ``:1569``; ``before_predict`` / ``after_predict``,
``:2145-2207``); a custom objective ``obj`` and metric ``feval`` /
``custom_metric`` (``:1433-1472``: the objective takes this rank's
training margins and gives its rows' gradients, which the engine trains
on; the metric takes each eval set's margins, and a value a rank computed
is combined across ranks as a weighted mean); ``serve_registry`` (the
trained model is published into a ``serve.ModelRegistry``); and
``predict`` (``:2306``) with ``_predict`` (``:2137``): the ranks' shards
are concatenated in rank order and walked in one pass on the device, as
the reference's ``_predict_shards_spmd`` (``:2214``) does on its mesh,
then split back per rank and re-assembled per sharding mode.

Ranks (``distributed.py``). Inside an initialised ``torch.distributed``
world of W ranks (``distributed.init_distributed``, the JAX package's
multi-host flow), rank r trains on shard r of the RayDMatrix when
``num_actors`` equals W (with more actors, on the r-th of W contiguous
groups of shards, folded in rank order; fewer raise) and evaluates on the
same shards of every eval matrix, the ranks merge histograms, sketch and
metrics by all-reduce, and every rank returns the same booster. Each
process makes the records of the ranks it trains and fires their hooks.
Called alone with ``num_actors > 1`` on the cards of a host with two or
more CUDA devices (``device`` None or ``"cuda"``), ``train`` spawns
``min(num_actors, device_count)`` ranks over NCCL, one card each, runs
itself inside that world (``distributed._train_rank``) and returns rank
0's booster. On one card (the host's only one, or ``device="cuda:k"``) or
on the CPU the shards fold onto the one device, as the JAX package folds
actors onto the available devices (``main.py:401-402``,
``engine.py:239-244``).

Categorical data (``main.py:775-860``, ``:2150-2170``): an eval set whose
auto-encoded category set differs from the training matrix's is
translated onto the training mapping (``translate_shard_categories``),
and one that auto-encoded where the training matrix was built from codes
is refused; ``predict`` translates a frame's categories onto the model's
the same way. The booster keeps the training feature types and mapping.
"""

import logging
import pickle
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from xgboost_ray_tpu_torch import distributed, session
from xgboost_ray_tpu_torch import tune as tune_mod
from xgboost_ray_tpu_torch.callback import (
    DistributedCallback,
    DistributedCallbackContainer,
)
from xgboost_ray_tpu_torch.compat import wrap_callbacks
from xgboost_ray_tpu_torch.engine import TorchEngine
from xgboost_ray_tpu_torch.exceptions import RayXGBoostTrainingStopped
from xgboost_ray_tpu_torch.matrix import (
    RayDMatrix,
    RayShardingMode,
    _get_sharding_indices,
    combine_data,
    translate_shard_categories,
)
from xgboost_ray_tpu_torch.linear import LinearEngine, RayLinearBooster
from xgboost_ray_tpu_torch.models.booster import (
    RayXGBoostBooster,
    coerce_model,
    load_raw_model,
)
from xgboost_ray_tpu_torch.ops.metrics import is_maximize_metric
from xgboost_ray_tpu_torch.params import parse_params
from xgboost_ray_tpu_torch.util import Event, Queue

logger = logging.getLogger(__name__)


@dataclass
class RayParams:
    """Distributed-training parameters (API of ``xgboost_ray_tpu.RayParams``).
    ``num_actors``, ``verbose`` and ``distributed_callbacks`` act; the
    fault-tolerance settings other than their defaults raise in ``train``
    (ROADMAP A18), and the placement settings have nothing to place."""

    num_actors: int = 0
    cpus_per_actor: int = 0
    gpus_per_actor: int = -1
    tpus_per_actor: int = -1
    resources_per_actor: Optional[Dict] = None
    elastic_training: bool = False
    max_failed_actors: int = 0
    max_actor_restarts: int = 0
    checkpoint_frequency: int = 5
    distributed_callbacks: Optional[List[DistributedCallback]] = None
    verbose: Optional[bool] = None
    placement_options: Optional[Dict[str, Any]] = None


def _check_ray_params(ray_params: Union[None, RayParams, dict]) -> RayParams:
    """The reference's validation (``main.py:177``)."""
    if ray_params is None:
        ray_params = RayParams()
    elif isinstance(ray_params, dict):
        ray_params = RayParams(**ray_params)
    elif not isinstance(ray_params, RayParams):
        raise ValueError(
            f"`ray_params` must be a `RayParams` instance, a dict, or None, "
            f"but it was {type(ray_params)}."
        )
    if ray_params.num_actors <= 0:
        raise ValueError(
            "The `num_actors` parameter is set to 0. Please always specify "
            "the number of distributed workers you want to use "
            "(`RayParams(num_actors=X)`)."
        )
    elif ray_params.num_actors < 2:
        warnings.warn(
            f"`num_actors` in `ray_params` is smaller than 2 "
            f"({ray_params.num_actors}). Training will NOT be distributed!"
        )
    return ray_params


def _validate_ray_params(ray_params: Union[None, RayParams, dict]) -> RayParams:
    """Training's validation: the reference's, and the fault-tolerance
    settings other than their defaults raise."""
    ray_params = _check_ray_params(ray_params)
    for key, bad in (
        ("elastic_training", ray_params.elastic_training),
        ("max_failed_actors", ray_params.max_failed_actors != 0),
        ("max_actor_restarts", ray_params.max_actor_restarts != 0),
    ):
        if bad:
            raise NotImplementedError(
                f"RayParams.{key} is not supported by xgboost_ray_tpu_torch "
                f"yet (fault tolerance comes in a later slice)."
            )
    return ray_params


class RayXGBoostActor:
    """One rank's record (``main.py:222-264``): its rank among
    ``num_actors``, the training call's queue and stop event, the shards it
    loaded, and its distributed callbacks, whose ``on_init`` fires when
    the record is made. Its compute is the engine's; the record carries
    the rank's lifecycle hooks."""

    def __init__(self, rank: int, num_actors: int,
                 queue: Optional[Queue] = None,
                 stop_event: Optional[Event] = None,
                 distributed_callbacks: Optional[
                     List[DistributedCallback]] = None):
        self.rank = rank
        self.num_actors = num_actors
        self.queue = queue
        self.stop_event = stop_event
        self._loaded: List[RayDMatrix] = []
        self._distributed_callbacks = DistributedCallbackContainer(
            distributed_callbacks)
        self._distributed_callbacks.on_init(self)

    def load_data(self, data: RayDMatrix) -> None:
        """Load this rank's shard of ``data`` once, between the
        data-loading hooks."""
        if any(d is data for d in self._loaded):
            return
        self._distributed_callbacks.before_data_loading(self, data)
        data.load_data(self.num_actors, ranks=[self.rank])
        self._loaded.append(data)
        self._distributed_callbacks.after_data_loading(self, data)

    def get_shard(self, data: RayDMatrix) -> Dict[str, Optional[np.ndarray]]:
        return data.shards([self.rank])[0]


def _make_actors(ranks, num_actors: int, queue: Queue, stop_event: Event,
                 distributed_callbacks) -> List[RayXGBoostActor]:
    return [RayXGBoostActor(r, num_actors, queue, stop_event,
                            distributed_callbacks) for r in ranks]


def _handle_queue(queue: Queue, callback_returns: Dict) -> None:
    """Drain the callback queue (``xgboost_ray/main.py:902-922``): a
    callable runs, anything else is kept under its rank."""
    while not queue.empty():
        rank, item = queue.get()
        if callable(item):
            item()
        else:
            callback_returns.setdefault(rank, []).append(item)


class _FauxDMatrix:
    """What a custom objective or metric gets beside the predictions: the
    xgboost DMatrix accessors they use, over this rank's rows."""

    def __init__(self, label, weight):
        self._label = label
        self._weight = weight

    def get_label(self):
        return self._label

    def get_weight(self):
        return self._weight if self._weight is not None else np.array([])

    def get_group(self):
        return np.array([])

    def num_row(self):
        return len(self._label)


class _EngineBoosterProxy:
    """What training callbacks get as the model: the engine's attributes
    (its margins, bins and cuts), and beyond them the booster of the
    rounds so far (``save_model``, ``predict``, ...), made only when a
    callback asks for one of its attributes and again only after another
    round."""

    def __init__(self, engine: TorchEngine):
        self._engine = engine
        self._cached: Optional[RayXGBoostBooster] = None
        self._cached_rounds = -1

    def _booster(self) -> RayXGBoostBooster:
        n = self._engine.rounds_done
        if self._cached is None or self._cached_rounds != n:
            self._cached = self._engine.get_booster()
            self._cached_rounds = n
        return self._cached

    def __getattr__(self, item):
        if item.startswith("__") or "_engine" not in self.__dict__:
            raise AttributeError(item)
        try:
            return getattr(self._engine, item)
        except AttributeError:
            return getattr(self._booster(), item)


#: train() keyword arguments of this slice; anything else raises
_KNOWN_KWARGS = {"verbose_eval", "callbacks", "serve_registry",
                 "early_stopping_rounds", "maximize", "xgb_model", "obj",
                 "feval", "custom_metric"}
#: train() keyword arguments of the JAX package outside this slice
_OUT_OF_SLICE_KWARGS = {"_remote"}


def _matrix_max_bin(params: Dict, dtrain: RayDMatrix) -> Dict:
    """``params`` with a ``RayDeviceQuantileDMatrix``'s ``max_bin`` unless
    they name another, which wins with a warning (``main.py:760-770``)."""
    params = dict(params or {})
    dm_max_bin = getattr(dtrain, "max_bin", None)
    if dm_max_bin:
        if "max_bin" in params and int(params["max_bin"]) != int(dm_max_bin):
            logger.warning("params['max_bin']=%s overrides %s(max_bin=%s).",
                           params["max_bin"], type(dtrain).__name__,
                           dm_max_bin)
        else:
            params["max_bin"] = int(dm_max_bin)
    return params


def train(
    params: Dict,
    dtrain: RayDMatrix,
    num_boost_round: int = 10,
    *args,
    evals: Union[List[Tuple[RayDMatrix, str]], Tuple] = (),
    evals_result: Optional[Dict] = None,
    additional_results: Optional[Dict] = None,
    ray_params: Union[None, RayParams, Dict] = None,
    device=None,
    **kwargs,
) -> RayXGBoostBooster:
    """Train a gbtree model (signature of ``xgboost_ray_tpu.train``).

    ``device``: ``None`` (or ``"cuda"``) trains on the host's cards, one
    rank a card up to ``num_actors`` where there are two or more, else on
    the current CUDA device, and raises when there is none; ``"cuda:k"``
    trains on card k alone; ``"cpu"`` runs the plain PyTorch versions of
    the kernels on the CPU (what the tests use). There is no silent
    fallback.
    ``serve_registry``: a ``serve.ModelRegistry`` the trained model is
    loaded into (its version lands in ``additional_results``).
    ``xgb_model``: a model to continue (a booster, its pickled bytes, a
    saved-model path or its JSON document: ``coerce_model``); its trees come
    first in the result and ``num_boost_round`` more are added.
    ``early_stopping_rounds``: stop when the last metric of the last eval
    set has not improved for that many rounds (larger is better for the
    metrics of ``is_maximize_metric`` unless ``maximize`` says otherwise);
    the booster's ``best_iteration`` / ``best_score`` record the best round.
    ``obj``: ``obj(margins, dtrain) -> (grad, hess)``, called every round
    with this rank's training margins ([n] for one output, [n, K]) and a
    ``_FauxDMatrix`` of its labels and weights; the gradients, f32 of the
    same shape, are what the round's trees are grown on (the objective of
    ``params`` still gives the base score, the transform and the default
    metric). ``feval`` / ``custom_metric``: ``feval(margins, dmatrix) ->
    (name, value)`` on every eval set's margins each round, its value
    recorded under ``name`` (a weighted mean across ranks).
    ``callbacks``: training callbacks, or legacy ``callback(env)``
    functions (``compat.wrap_callbacks``); inside a tuning session a
    ``tune.TuneReportCheckpointCallback`` is added unless one is given.
    ``additional_results["callback_returns"]`` holds what callbacks put on
    the training call's queue (``session.put_queue``), by rank.
    """
    start_time = time.time()
    if args:
        raise TypeError(
            "train() takes keyword arguments after num_boost_round; got "
            f"positional {args}"
        )
    for key in kwargs:
        if key in _OUT_OF_SLICE_KWARGS:
            if kwargs[key]:
                raise NotImplementedError(
                    f"train({key}=...) is not supported by "
                    f"xgboost_ray_tpu_torch yet."
                )
        elif key not in _KNOWN_KWARGS:
            raise TypeError(f"train() got an unexpected keyword argument {key!r}")
    ray_params = _validate_ray_params(ray_params)
    if isinstance(evals, tuple) and len(evals) == 2 and isinstance(evals[1], str):
        evals = [evals]
    if not isinstance(dtrain, RayDMatrix):
        raise ValueError(
            f"The `dtrain` argument passed to `train()` is not a RayDMatrix, "
            f"but of type {type(dtrain)}. FIX THIS by instantiating a "
            f"RayDMatrix first: `dtrain = RayDMatrix(data, labels)`."
        )
    evals = list(evals)
    for deval, name in evals:
        if not isinstance(deval, RayDMatrix):
            raise ValueError(
                f"Evaluation data must be a RayDMatrix, got {type(deval)} "
                f"for eval set {name!r}."
            )
    callbacks = wrap_callbacks(kwargs.get("callbacks"), num_boost_round)
    callbacks = tune_mod._try_add_tune_callback(callbacks)
    params = _matrix_max_bin(params, dtrain)
    parsed = parse_params(params)
    if (kwargs.get("serve_registry") is not None
            and parsed.booster == "gblinear"):
        # before training: the serving layer walks forests, which a linear
        # model lacks (``main.py:1796-1800``)
        raise ValueError(
            "serve_registry is not supported with booster='gblinear' "
            "(the serving layer compiles tree-walk programs). Train "
            "without serve_registry and serve the model another way.")
    init_booster = (None if kwargs.get("xgb_model") is None
                    else coerce_model(kwargs["xgb_model"]))
    run = dict(num_boost_round=num_boost_round,
               verbose_eval=kwargs.get("verbose_eval", False),
               callbacks=callbacks,
               early_stopping_rounds=kwargs.get("early_stopping_rounds"),
               maximize=kwargs.get("maximize"),
               obj=kwargs.get("obj"),
               feval=kwargs.get("feval") or kwargs.get("custom_metric"))

    t_load = time.time()
    world = distributed.process_count()
    num_actors = ray_params.num_actors
    n_spawn = _spawn_ranks(device, num_actors) if world == 1 else 1
    if n_spawn > 1:
        booster, result, stats = _train_spawned(
            dtrain, params, num_actors, n_spawn, "cuda",
            dict(eval_names=[name for _, name in evals],
                 eval_matrices=[None if deval is dtrain else deval
                                for deval, _ in evals],
                 xgb_model=None if init_booster is None
                 else init_booster.save_raw(),
                 distributed_callbacks=ray_params.distributed_callbacks,
                 **run))
    else:
        if world > 1:
            if num_actors < world:
                raise ValueError(
                    f"train() inside a world of {world} ranks needs "
                    f"RayParams(num_actors>={world}), got {num_actors}.")
            ranks = [int(r) for r in np.array_split(
                np.arange(num_actors), world)[distributed.process_index()]]
        else:
            ranks = list(range(num_actors))
        queue, stop_event = Queue(), Event()
        actors = _make_actors(ranks, num_actors, queue, stop_event,
                              ray_params.distributed_callbacks)
        for dm in [dtrain] + [deval for deval, _ in evals]:
            dm.assert_enough_shards_for_actors(num_actors)
            dm.assign_shards_to_actors(num_actors)
        for actor in actors:
            actor.load_data(dtrain)
            for deval, _ in evals:
                actor.load_data(deval)
        shards = dtrain.shards(ranks)
        train_cats = dtrain.resolved_categories
        eval_shards = [(shards if deval is dtrain else
                        [translate_shard_categories(
                            sh, _eval_categories(deval, name, train_cats),
                            train_cats) for sh in deval.shards(ranks)],
                        name) for deval, name in evals]
        engine_cls = (LinearEngine if parsed.booster == "gblinear"
                      else TorchEngine)
        engine = engine_cls(
            shards, parsed, device=device, evals=eval_shards,
            init_booster=init_booster,
            feature_names=dtrain.resolved_feature_names,
            feature_types=dtrain.resolved_feature_types,
            custom_objective=run["obj"] is not None,
            feature_weights=dtrain.feature_weights,
            categories=train_cats, total_rounds=num_boost_round)
        for actor in actors:
            actor._distributed_callbacks.before_train(actor)
        booster, result, stats = _run_rounds(
            engine, time.time() - t_load, actors=actors, queue=queue, **run)
    serve_registry = kwargs.get("serve_registry")
    if evals_result is not None:
        evals_result.update(result)
    if additional_results is not None:
        additional_results.update(stats)
        additional_results["total_time_s"] = time.time() - start_time
    if serve_registry is not None:
        version = serve_registry.load(booster)
        if additional_results is not None:
            additional_results["serve_model_version"] = version
    return booster


def _eval_categories(deval: RayDMatrix, name: str, train_cats):
    """A loaded eval matrix's auto-encoded categories, refused where the
    training matrix was built from codes (``main.py:808-816``)."""
    ecats = deval.resolved_categories
    if ecats and not train_cats:
        raise ValueError(
            f"eval set {name!r} auto-encoded categorical columns, "
            f"but the training matrix was built from integer "
            f"codes — the mappings cannot be aligned. Encode the "
            f"eval set with the same codes, or train from a "
            f"DataFrame with enable_categorical=True.")
    return ecats


def _host_preds(margins: np.ndarray) -> np.ndarray:
    """[n] for one output, else [n, K]: what custom callables get."""
    return margins[:, 0] if margins.shape[1] == 1 else margins


def _run_rounds(engine: TorchEngine, setup_s: float, num_boost_round: int,
                verbose_eval, callbacks, early_stopping_rounds=None,
                maximize=None, obj: Optional[Callable] = None,
                feval: Optional[Callable] = None,
                actors: List[RayXGBoostActor] = (),
                queue: Optional[Queue] = None):
    """The round loop of one rank: (booster, evals_result, stats). Every
    rank sees the same all-reduced metrics, so callbacks and early stopping
    that decide from them stop every rank in the same round. With ``obj``
    a round's time includes the objective (and its margin and gradient
    copies), as in the JAX package."""
    queue = queue if queue is not None else Queue()
    session.init_session(queue=queue)
    callback_returns: Dict[int, List[Any]] = {}
    model = _EngineBoosterProxy(engine)
    result: Dict[str, Dict[str, List[float]]] = {}
    es_set = es_metric = None
    es_maximize, es_best, es_best_iter = False, None, -1
    if early_stopping_rounds is not None and engine.evals:
        es_set = engine.evals[-1].name
        es_metric = engine.metric_names[-1]
        es_maximize = (maximize if maximize is not None
                       else is_maximize_metric(es_metric))
    round_times = []
    t_train = time.time()
    for cb in callbacks:
        if hasattr(cb, "before_training"):
            cb.before_training(model)
    for i in range(num_boost_round):
        if any(a.stop_event is not None and a.stop_event.is_set()
               for a in actors):
            raise RayXGBoostTrainingStopped("Training was aborted.")
        for cb in callbacks:
            if hasattr(cb, "before_iteration"):
                cb.before_iteration(model, i, result)
        t0 = time.perf_counter()
        if obj is not None:
            label, weight = engine.host_labels()
            metrics = engine.step(i, gh_custom=obj(
                _host_preds(engine.get_margins()), _FauxDMatrix(label, weight)))
        else:
            metrics = engine.step(i)
        round_times.append(time.perf_counter() - t0)
        if feval is not None:
            for es in engine.evals:
                label, weight = engine.host_labels(es)
                name, value = feval(_host_preds(engine.get_margins(es)),
                                    _FauxDMatrix(label, weight))
                metrics.setdefault(es.name, {})[name] = (
                    engine.combine_host_scalar(value, es))
        for set_name, row in metrics.items():
            for metric_name, value in row.items():
                result.setdefault(set_name, {}).setdefault(
                    metric_name, []).append(value)
        if actors and actors[0]._distributed_callbacks.callbacks:
            record = {"round": engine.iteration_offset + i, "iteration": i,
                      "duration_s": round_times[-1],
                      "world": actors[0].num_actors, "metrics": metrics}
            for actor in actors:
                actor._distributed_callbacks.after_round(actor, record)
        if verbose_eval and engine.coll.rank == 0 and (
            verbose_eval is True or (i % max(int(verbose_eval), 1) == 0)
        ):
            flat = "\t".join(
                f"{sn}-{mn}:{v[-1]:.5f}"
                for sn, ms in result.items() for mn, v in ms.items()
            )
            print(f"[{i}]\t{flat}")
        _handle_queue(queue, callback_returns)
        stop = False
        for cb in callbacks:
            if hasattr(cb, "after_iteration"):
                stop = bool(cb.after_iteration(model, i, result)) or stop
        if es_metric is not None:
            cur = result[es_set][es_metric][-1]
            if (es_best is None or (es_maximize and cur > es_best)
                    or (not es_maximize and cur < es_best)):
                es_best, es_best_iter = cur, i
            elif i - es_best_iter >= early_stopping_rounds:
                stop = True
        if stop:
            break
    booster = engine.get_booster()
    if es_best_iter >= 0:
        # the round of the whole model, init booster's rounds included
        booster.best_iteration = engine.iteration_offset + es_best_iter
        booster.best_score = es_best
    for cb in callbacks:
        if hasattr(cb, "after_training"):
            cb.after_training(model)
    for actor in actors:
        actor._distributed_callbacks.after_train(actor,
                                                 {"evals_result": result})
    _handle_queue(queue, callback_returns)
    stats = {
        "train_n": engine.n_global,
        "device": str(engine.device),
        "world_size": engine.coll.world,
        "backend": engine.coll.backend,
        "allreduce_bytes_per_round": engine.allreduce_bytes_per_round,
        # the tree path's bytes and the gh plane a device block holds
        # (``main.py:484-507`` of the reference)
        "hist_allreduce_bytes_per_round":
            engine.hist_allreduce_bytes_per_round,
        "gh_plane_bytes_per_shard": engine.gh_plane_bytes_per_shard(),
        "setup_time_s": setup_s,
        "sketch_time_s": engine.sketch_seconds,
        "training_time_s": time.time() - t_train,
        "round_times_s": round_times,
        "callback_returns": callback_returns,
    }
    return booster, result, stats


def _spawn_ranks(device, num_actors: int) -> int:
    """Ranks ``train`` spawns when called alone: one a card, up to
    ``num_actors``, where ``device`` names the host's cards (None or
    ``"cuda"``; not one card ``"cuda:k"``, nor the CPU) and there are two
    or more; 1 (no spawn: the shards fold onto one device) otherwise."""
    if num_actors < 2 or not torch.cuda.is_available():
        return 1
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda" or dev.index is not None:
            return 1
    return min(num_actors, torch.cuda.device_count())


def _train_spawned(dtrain: RayDMatrix, params: Dict, num_actors: int,
                   n_ranks: int, device_type: str, options: Dict):
    """Spawn ``n_ranks`` ranks (``distributed.World``: NCCL with a card
    each, gloo on the CPU) that run ``train()`` inside their world
    (``distributed._train_rank``) on ``dtrain``'s data and every held-out
    eval matrix's, each shared once (a matrix of files or partitions is
    sent as its source, which each rank reads its shards of), each rank
    loading its own shards of ``num_actors``; rank 0's (booster,
    evals_result, additional_results). ``options``: ``eval_names``,
    ``eval_matrices`` (beside the names: None for ``dtrain``, else the eval
    RayDMatrix; default all None), ``num_boost_round``, ``verbose_eval``,
    ``callbacks``, ``distributed_callbacks``, ``early_stopping_rounds``,
    ``maximize``, ``obj``, ``feval``, ``xgb_model`` (``save_raw`` bytes or
    None)."""
    options = dict(options)
    sent = {k: options.get(k) for k in ("callbacks", "distributed_callbacks",
                                       "obj", "feval")}
    try:
        pickle.dumps(sent)
    except (pickle.PicklingError, AttributeError, TypeError) as exc:
        raise ValueError(
            f"train() spawns {n_ranks} ranks here and sends them the "
            f"callbacks, objective and metric, which must be picklable: "
            f"{exc}") from exc
    data = _matrix_data(dtrain)
    train_cats = dtrain.resolved_categories
    options["eval_data"] = [
        None if dm is None else dict(
            _matrix_data(dm, train_cats, name), sharding=dm.sharding.name)
        for dm, name in zip(options.pop("eval_matrices", None)
                            or [None] * len(options["eval_names"]),
                            options["eval_names"])]
    rounds = options.pop("num_boost_round")
    options.update(
        sharding=dtrain.sharding.name, num_actors=num_actors,
        device=None if device_type == "cuda" else device_type,
        feature_names=dtrain.resolved_feature_names,
        feature_types=dtrain.resolved_feature_types,
        feature_weights=dtrain.feature_weights)
    out = distributed.launch_world(distributed._train_rank, n_ranks,
                                   device_type, data, params, rounds, options)
    booster = load_raw_model(out[0]["model"])
    if not isinstance(booster, RayLinearBooster):
        booster.categories = train_cats
    return (booster, out[0]["evals_result"], out[0]["additional_results"])


def _matrix_data(dm: RayDMatrix, train_cats=None,
                 name: Optional[str] = None) -> Dict[str, Any]:
    """What a rank rebuilds ``dm`` from (``distributed._matrix``): a
    central matrix's loaded fields as tensors in shared memory (an eval
    set's, ``name``, with its category codes translated onto
    ``train_cats``), or a distributed matrix's source and column names,
    which each rank reads its own shards of."""
    loader = dm.loader
    if dm.distributed:
        return {"source": loader.data, "label": loader.label,
                "weight": loader.weight, "base_margin": loader.base_margin,
                "label_lower_bound": loader.label_lower_bound,
                "label_upper_bound": loader.label_upper_bound,
                "qid": loader.qid, "ignore": loader.ignore,
                "filetype": loader.filetype,
                "missing": loader.missing, "kwargs": loader.kwargs}
    fields = loader.load_fields()
    if name is not None:
        fields = translate_shard_categories(
            fields, _eval_categories(dm, name, train_cats), train_cats)
    return distributed.share({"x": fields["data"], "label": fields["label"],
                              "weight": fields["weight"],
                              "base_margin": fields["base_margin"],
                              "label_lower_bound": fields["label_lower_bound"],
                              "label_upper_bound": fields["label_upper_bound"],
                              "qid": fields["qid"]})


def _user_base_margin_shards(data: RayDMatrix, user_bm, sizes: List[int]):
    """A user ``base_margin`` addresses global rows (original order): each
    rank's shard gets its own rows' slice (``main.py:2172-2190``; under
    FIXED sharding the shards are consecutive)."""
    user_bm = np.asarray(user_bm)
    if data.sharding == RayShardingMode.FIXED:
        return np.split(user_bm, np.cumsum(sizes)[:-1], axis=0)
    return [user_bm[_get_sharding_indices(data.sharding, r, len(sizes),
                                          len(user_bm))]
            for r in range(len(sizes))]


def _predict(model: RayXGBoostBooster, data: RayDMatrix, device,
             actors: List[RayXGBoostActor], **kwargs) -> np.ndarray:
    model_cats = getattr(model, "categories", None)
    if data.resolved_categories and not model_cats and model.cat_features:
        raise ValueError(
            "the prediction data auto-encoded categorical columns, but the "
            "model was trained on integer codes — the mappings cannot be "
            "aligned. Encode the data with the training codes instead.")
    shards = [translate_shard_categories(actor.get_shard(data),
                                         data.resolved_categories,
                                         model_cats) for actor in actors]
    predict_kwargs = dict(kwargs)
    user_bm = predict_kwargs.pop("base_margin", None)
    xs = [model._coerce_features(sh["data"]) for sh in shards]
    sizes = [x.shape[0] for x in xs]
    x_all = np.concatenate(xs, axis=0) if len(xs) > 1 else xs[0]
    if user_bm is not None:
        bms = _user_base_margin_shards(data, user_bm, sizes)
    elif any(sh.get("base_margin") is not None for sh in shards):
        bms = [sh["base_margin"] for sh in shards]
    else:
        bms = None
    base_margin = None
    if bms is not None:
        base_margin = np.concatenate([
            np.asarray(b, np.float32).reshape(sz, -1)
            for b, sz in zip(bms, sizes)], axis=0)
    pred = model.predict(x_all, base_margin=base_margin, device=device,
                         **predict_kwargs)
    results = np.split(pred, np.cumsum(sizes)[:-1], axis=0)
    for actor, part in zip(actors, results):
        actor._distributed_callbacks.after_predict(actor, part)
    if data.sharding == RayShardingMode.FIXED:
        return np.concatenate(results, axis=0)
    return combine_data(data.sharding, results)


def predict(
    model,
    data: RayDMatrix,
    ray_params: Union[None, RayParams, Dict] = None,
    _remote: Optional[bool] = None,
    device=None,
    **kwargs,
) -> Optional[np.ndarray]:
    """Distributed prediction (signature of ``xgboost_ray_tpu.predict``):
    every rank's shard in one walk on ``device`` (the card unless
    ``device="cpu"``), returned in the matrix's original row order, each
    rank's records firing ``before_predict`` once its shard is loaded and
    ``after_predict`` with its rows' predictions. ``kwargs`` are
    ``RayXGBoostBooster.predict``'s (``output_margin``, ``pred_leaf``,
    ``pred_contribs``, ``pred_interactions``, ``approx_contribs``,
    ``iteration_range``, ``ntree_limit``, ``base_margin``): SHAP outputs
    (``xgboost_ray_tpu/main.py:2235-2292``) come from B15 over the shards
    concatenated in rank order, a shard's ``base_margin`` in its rows' bias
    column, and are split back per rank for ``after_predict``.
    """
    ray_params = _check_ray_params(ray_params)
    if _remote:
        raise NotImplementedError(
            "predict(_remote=True) is not supported by xgboost_ray_tpu_torch "
            "yet.")
    if not isinstance(data, RayDMatrix):
        raise ValueError(
            f"The `data` argument passed to `predict()` is not a RayDMatrix, "
            f"but of type {type(data)}. FIX THIS by instantiating a "
            f"RayDMatrix first: `data = RayDMatrix(data)`."
        )
    model = coerce_model(model)
    num_actors = ray_params.num_actors
    actors = _make_actors(range(num_actors), num_actors, Queue(), Event(),
                          ray_params.distributed_callbacks)
    data.assign_shards_to_actors(num_actors)
    for actor in actors:
        actor.load_data(data)
        actor._distributed_callbacks.before_predict(actor)
    return _predict(model, data, device, actors, **kwargs)
