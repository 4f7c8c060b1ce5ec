"""``train()``, ``predict()`` and ``RayParams`` of the port.

Port of ``xgboost_ray_tpu/main.py`` for this slice: ``RayParams``
(``:134``), ``_validate_ray_params`` (``:177``), ``train`` (``:1681``,
driving the round loop of ``_train`` at ``:678``): validation, eval sets
(the training matrix or held-out matrices, each loaded like ``dtrain``),
``evals_result``, ``verbose_eval``, ``additional_results``, early stopping
on the last metric of the last eval set (``early_stopping_rounds``,
``maximize``; ``:1276-1285``, ``:1520-1534``, ``best_iteration`` and
``best_score`` at ``:1558-1562``), warm start from ``xgb_model``, the
``before_training``/``before_iteration``/``after_iteration``/
``after_training`` hooks of training callbacks (``after_iteration``
returning True stops training, as in xgboost) and ``serve_registry`` (the
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
metrics by all-reduce, and every rank returns the same booster. Called
alone with ``num_actors > 1`` on the cards of a host with two or more CUDA
devices (``device`` None or ``"cuda"``), ``train`` spawns
``min(num_actors, device_count)`` ranks over NCCL, one card each, runs
itself inside that world (``distributed._train_rank``) and returns rank
0's booster. On one card (the host's only one, or ``device="cuda:k"``) or
on the CPU the shards fold onto the one device, as the JAX package folds
actors onto the available devices (``main.py:401-402``,
``engine.py:239-244``).
"""

import pickle
import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from xgboost_ray_tpu_torch import distributed
from xgboost_ray_tpu_torch.engine import TorchEngine
from xgboost_ray_tpu_torch.matrix import (
    RayDMatrix,
    _get_sharding_indices,
    combine_data,
)
from xgboost_ray_tpu_torch.models.booster import RayXGBoostBooster, coerce_model
from xgboost_ray_tpu_torch.ops.metrics import is_maximize_metric
from xgboost_ray_tpu_torch.params import parse_params


@dataclass
class RayParams:
    """Distributed-training parameters (API of ``xgboost_ray_tpu.RayParams``).
    Only ``num_actors`` and ``verbose`` act in this slice; fault-tolerance
    settings other than their defaults raise in ``train``."""

    num_actors: int = 0
    cpus_per_actor: int = 0
    gpus_per_actor: int = -1
    tpus_per_actor: int = -1
    resources_per_actor: Optional[Dict] = None
    elastic_training: bool = False
    max_failed_actors: int = 0
    max_actor_restarts: int = 0
    checkpoint_frequency: int = 5
    distributed_callbacks: Optional[List[Any]] = None
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
        ("distributed_callbacks", bool(ray_params.distributed_callbacks)),
    ):
        if bad:
            raise NotImplementedError(
                f"RayParams.{key} is not supported by xgboost_ray_tpu_torch "
                f"yet (fault tolerance comes in a later slice)."
            )
    return ray_params


#: train() keyword arguments of this slice; anything else raises
_KNOWN_KWARGS = {"verbose_eval", "callbacks", "serve_registry",
                 "early_stopping_rounds", "maximize", "xgb_model"}
#: train() keyword arguments of the JAX package outside this slice
_OUT_OF_SLICE_KWARGS = {"obj", "feval", "custom_metric", "_remote"}


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
    """
    start_time = time.time()
    if args:
        raise TypeError(
            "train() takes keyword arguments after num_boost_round; got "
            f"positional {args}"
        )
    for key in kwargs:
        if key in _OUT_OF_SLICE_KWARGS:
            if kwargs[key] is not None:
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
    parsed = parse_params(params)
    init_booster = (None if kwargs.get("xgb_model") is None
                    else coerce_model(kwargs["xgb_model"]))
    run = dict(num_boost_round=num_boost_round,
               verbose_eval=kwargs.get("verbose_eval", False),
               callbacks=list(kwargs.get("callbacks") or []),
               early_stopping_rounds=kwargs.get("early_stopping_rounds"),
               maximize=kwargs.get("maximize"))

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
                 else init_booster.save_raw(), **run))
    else:
        if world > 1:
            if num_actors < world:
                raise ValueError(
                    f"train() inside a world of {world} ranks needs "
                    f"RayParams(num_actors>={world}), got {num_actors}.")
            ranks = [int(r) for r in np.array_split(
                np.arange(num_actors), world)[distributed.process_index()]]
        else:
            ranks = None
        dtrain.load_data(num_actors, ranks=ranks)
        shards = dtrain.shards(ranks)
        eval_shards = []
        for deval, name in evals:
            if deval is not dtrain:
                deval.load_data(num_actors, ranks=ranks)
            eval_shards.append(
                (shards if deval is dtrain else deval.shards(ranks), name))
        engine = TorchEngine(
            shards, parsed, device=device, evals=eval_shards,
            init_booster=init_booster,
            feature_names=dtrain.resolved_feature_names,
            feature_types=dtrain.feature_types)
        booster, result, stats = _run_rounds(engine, time.time() - t_load,
                                             **run)
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


def _run_rounds(engine: TorchEngine, setup_s: float, num_boost_round: int,
                verbose_eval, callbacks, early_stopping_rounds=None,
                maximize=None):
    """The round loop of one rank: (booster, evals_result, stats). Every
    rank sees the same all-reduced metrics, so callbacks and early stopping
    that decide from them stop every rank in the same round."""
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
            cb.before_training(engine)
    for i in range(num_boost_round):
        for cb in callbacks:
            if hasattr(cb, "before_iteration"):
                cb.before_iteration(engine, i, result)
        t0 = time.perf_counter()
        metrics = engine.step(i)
        round_times.append(time.perf_counter() - t0)
        for set_name, row in metrics.items():
            for metric_name, value in row.items():
                result.setdefault(set_name, {}).setdefault(
                    metric_name, []).append(value)
        if verbose_eval and engine.coll.rank == 0 and (
            verbose_eval is True or (i % max(int(verbose_eval), 1) == 0)
        ):
            flat = "\t".join(
                f"{sn}-{mn}:{v[-1]:.5f}"
                for sn, ms in result.items() for mn, v in ms.items()
            )
            print(f"[{i}]\t{flat}")
        stop = False
        for cb in callbacks:
            if hasattr(cb, "after_iteration"):
                stop = bool(cb.after_iteration(engine, i, result)) or stop
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
            cb.after_training(engine)
    stats = {
        "train_n": engine.n_global,
        "device": str(engine.device),
        "world_size": engine.coll.world,
        "backend": engine.coll.backend,
        "allreduce_bytes_per_round": engine.allreduce_bytes_per_round,
        "setup_time_s": setup_s,
        "sketch_time_s": engine.sketch_seconds,
        "training_time_s": time.time() - t_train,
        "round_times_s": round_times,
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
    eval matrix's, each shared once, each rank loading its own shards of
    ``num_actors``; rank 0's (booster, evals_result, additional_results).
    ``options``: ``eval_names``, ``eval_matrices`` (beside the names: None
    for ``dtrain``, else the eval RayDMatrix; default all None),
    ``num_boost_round``, ``verbose_eval``, ``callbacks``,
    ``early_stopping_rounds``, ``maximize``, ``xgb_model`` (``save_raw``
    bytes or None)."""
    options = dict(options)
    try:
        pickle.dumps(options["callbacks"])
    except (pickle.PicklingError, AttributeError, TypeError) as exc:
        raise ValueError(
            f"train() spawns {n_ranks} ranks here and sends them the "
            f"callbacks, which must be picklable: {exc}") from exc
    data = _share_fields(dtrain)
    options["eval_data"] = [
        None if dm is None else dict(_share_fields(dm),
                                     sharding=dm.sharding.name)
        for dm in options.pop("eval_matrices", None)
        or [None] * len(options["eval_names"])]
    rounds = options.pop("num_boost_round")
    options.update(
        sharding=dtrain.sharding.name, num_actors=num_actors,
        device=None if device_type == "cuda" else device_type,
        feature_names=dtrain.resolved_feature_names,
        feature_types=dtrain.feature_types)
    out = distributed.launch_world(distributed._train_rank, n_ranks,
                                   device_type, data, params, rounds, options)
    return (RayXGBoostBooster.load_raw(out[0]["model"]),
            out[0]["evals_result"], out[0]["additional_results"])


def _share_fields(dm: RayDMatrix):
    """A matrix's loaded fields as tensors in shared memory, for the ranks
    (each rank rebuilds the matrix and loads its own shards)."""
    fields = dm.loader.load_fields()
    return distributed.share({"x": fields["data"], "label": fields["label"],
                              "weight": fields["weight"],
                              "base_margin": fields["base_margin"]})


def _user_base_margin_shards(data: RayDMatrix, user_bm, n_shards: int):
    """A user ``base_margin`` addresses global rows (original order): each
    rank's shard gets its own rows' slice (``main.py:2172-2190``)."""
    user_bm = np.asarray(user_bm)
    return [user_bm[_get_sharding_indices(data.sharding, r, n_shards,
                                          len(user_bm))]
            for r in range(n_shards)]


def _predict(model: RayXGBoostBooster, data: RayDMatrix, device,
             **kwargs) -> np.ndarray:
    shards = data.shards()
    predict_kwargs = dict(kwargs)
    user_bm = predict_kwargs.pop("base_margin", None)
    xs = [model._coerce_features(sh["data"]) for sh in shards]
    sizes = [x.shape[0] for x in xs]
    x_all = np.concatenate(xs, axis=0) if len(xs) > 1 else xs[0]
    if user_bm is not None:
        bms = _user_base_margin_shards(data, user_bm, len(shards))
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
    ``device="cpu"``), returned in the matrix's original row order.
    ``kwargs`` are ``RayXGBoostBooster.predict``'s (``output_margin``,
    ``pred_leaf``, ``iteration_range``, ``ntree_limit``, ``base_margin``).
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
    data.load_data(ray_params.num_actors)
    return _predict(model, data, device, **kwargs)
