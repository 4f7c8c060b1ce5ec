"""``train()``, ``predict()`` and ``RayParams`` of the port.

Port of ``xgboost_ray_tpu/main.py`` for this slice: ``RayParams``
(``:134``), ``_validate_ray_params`` (``:177``), ``train`` (``:1681``,
driving the round loop of ``_train`` at ``:678``): validation,
``evals_result``, ``verbose_eval``, ``additional_results``, the
``after_iteration`` hook of training callbacks (returning True stops
training, as in xgboost) and ``serve_registry`` (the trained model is
published into a ``serve.ModelRegistry``); and ``predict`` (``:2306``)
with ``_predict`` (``:2137``): the ranks' shards are concatenated in rank
order and walked in one pass on the device, as the reference's
``_predict_shards_spmd`` (``:2214``) does on its mesh, then split back per
rank and re-assembled per sharding mode.

World size: the port trains on one device. ``RayParams(num_actors=N)``
shards the data into N ranks (the JAX package's sharding and
concatenation order) and runs them on that device, as the JAX package does
on a host with one device (``main.py:401-402`` folds actors onto the
available devices). NCCL ranks come in a later slice.
"""

import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from xgboost_ray_tpu_torch.engine import TorchEngine
from xgboost_ray_tpu_torch.matrix import (
    RayDMatrix,
    _get_sharding_indices,
    combine_data,
)
from xgboost_ray_tpu_torch.models.booster import RayXGBoostBooster, coerce_model
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
_KNOWN_KWARGS = {"verbose_eval", "callbacks", "serve_registry"}
#: train() keyword arguments of the JAX package outside this slice
_OUT_OF_SLICE_KWARGS = {
    "obj", "feval", "custom_metric", "early_stopping_rounds", "maximize",
    "xgb_model", "_remote",
}


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

    ``device``: ``None`` trains on the current CUDA device and raises when
    there is none; ``"cpu"`` runs the plain PyTorch versions of the kernels
    on the CPU (what the tests use). There is no silent fallback.
    ``serve_registry``: a ``serve.ModelRegistry`` the trained model is
    loaded into (its version lands in ``additional_results``).
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
    eval_names = []
    for deval, name in evals:
        if deval is not dtrain:
            raise NotImplementedError(
                f"eval set {name!r} is not the training matrix: "
                f"xgboost_ray_tpu_torch evaluates on the training set only "
                f"in this slice."
            )
        eval_names.append(name)
    parsed = parse_params(params)
    verbose_eval = kwargs.get("verbose_eval", False)
    callbacks = list(kwargs.get("callbacks") or [])

    t_load = time.time()
    dtrain.load_data(ray_params.num_actors)
    engine = TorchEngine(
        dtrain.shards(), parsed, device=device,
        eval_names=eval_names, feature_names=dtrain.resolved_feature_names,
        feature_types=dtrain.feature_types,
    )
    setup_s = time.time() - t_load

    result: Dict[str, Dict[str, List[float]]] = {}
    round_times = []
    t_train = time.time()
    for i in range(num_boost_round):
        t0 = time.perf_counter()
        metrics = engine.step(i)
        round_times.append(time.perf_counter() - t0)
        for set_name, row in metrics.items():
            for metric_name, value in row.items():
                result.setdefault(set_name, {}).setdefault(
                    metric_name, []).append(value)
        if verbose_eval and (
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
        if stop:
            break
    booster = engine.get_booster()
    serve_registry = kwargs.get("serve_registry")
    if evals_result is not None:
        evals_result.update(result)
    if additional_results is not None:
        additional_results.update({
            "train_n": engine.n_rows,
            "device": str(engine.device),
            "setup_time_s": setup_s,
            "sketch_time_s": engine.sketch_seconds,
            "training_time_s": time.time() - t_train,
            "total_time_s": time.time() - start_time,
            "round_times_s": round_times,
        })
    if serve_registry is not None:
        version = serve_registry.load(booster)
        if additional_results is not None:
            additional_results["serve_model_version"] = version
    return booster


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
