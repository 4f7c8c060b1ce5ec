"""Data-parallel ranks over ``torch.distributed``.

Counterpart of ``xgboost_ray_tpu/distributed.py:26-89``: where the JAX
package joins a multi-host world with ``jax.distributed.initialize`` and
merges histograms with ``lax.psum`` over its mesh, a rank of the port is one
process in a ``torch.distributed`` process group, and the engine merges its
histograms, sketch and metric sums with all-reduces (:class:`Collectives`).

- :func:`init_distributed` / :func:`shutdown_distributed` /
  :func:`process_count` / :func:`process_index`: the user-facing rendezvous
  (one call per process before ``train()``; ``torchrun`` style environment
  variables fill what is not passed).
- Backend rule (:func:`choose_backend`): NCCL when every rank has its own
  CUDA device, gloo on the CPU or when ranks share a card. It is decided
  before ``init_process_group``, logged, and never switched after a failure.
- :class:`World` / :func:`launch_world`: one process per rank on this host
  (``torch.multiprocessing``, start method ``spawn``) joined through a
  ``file://`` rendezvous in a temporary directory, so concurrent worlds
  never race for a port. Shards reach the ranks as ``share_memory_()``
  tensors (passed by handle, not pickled), and each rank runs a function of
  this package (``_train_rank``: ``train()`` inside the world, what
  ``train`` alone spawns on a host of several cards), so a rank process
  imports ``xgboost_ray_tpu_torch`` and nothing else of its parent.
"""

import datetime
import logging
import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from xgboost_ray_tpu_torch.ops.histogram import AllreduceBytes

logger = logging.getLogger(__name__)

#: seconds a collective (and a World's wait for a result) may take
DEFAULT_TIMEOUT_S = 600.0


def choose_backend(world_size: int, device_type: str,
                   local_world_size: Optional[int] = None) -> str:
    """``"nccl"`` when the ranks run on CUDA and every rank of this host has
    its own device, else ``"gloo"`` (the CPU, or ranks sharing a card)."""
    local = world_size if local_world_size is None else local_world_size
    if (device_type == "cuda" and torch.cuda.is_available()
            and torch.cuda.device_count() >= local):
        return "nccl"
    return "gloo"


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the world (once per process, before ``train()``).

    Arguments left out come from ``WORLD_SIZE`` / ``RANK`` /
    ``LOCAL_WORLD_SIZE`` / ``LOCAL_RANK`` (1 / 0 / the world / the rank) and
    ``init_method`` from ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``).
    The backend follows :func:`choose_backend` unless given. Where CUDA is
    present the process's device becomes ``LOCAL_RANK`` modulo the device
    count, so ``train()`` and the collectives run there."""
    if dist.is_initialized():
        return
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    local_rank = int(env.get("LOCAL_RANK", rank % max(local_world, 1)))
    if backend is None:
        backend = choose_backend(
            world_size, "cuda" if torch.cuda.is_available() else "cpu",
            local_world)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    logger.info("[RayXGBoost] rank %d of %d joins over %s (%s)", rank,
                world_size, backend, init_method or "env://")
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def shutdown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Collectives:
    """The engine's collectives over the default process group: in-place
    all-reduce SUM / MIN / MAX of a contiguous tensor, each recording its
    ring-model bytes in ``bytes`` (:class:`AllreduceBytes`). At world 1
    every one is the identity and moves nothing."""

    def __init__(self):
        self.world = process_count()
        self.rank = process_index()
        self.backend = (str(dist.get_backend()) if dist.is_initialized()
                        else None)
        self.bytes = AllreduceBytes(self.world)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.world == 1:
            return t
        if not t.is_contiguous():
            raise ValueError("Collectives: all-reduce of a non-contiguous tensor")
        self.bytes.add_allreduce(t)
        dist.all_reduce(t, op=op)
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.SUM)

    def min(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MIN)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)


# --------------------------------------------------------------------------
# one process per rank on this host
# --------------------------------------------------------------------------


def _rank_main(rank: int, world: int, backend: str, init_method: str,
               timeout_s: float, threads: int, tasks, results) -> None:
    """A rank process: join the world, then run ``(target, args)`` tasks
    until ``None``; every result (or traceback) goes to ``results``."""
    os.environ.setdefault("LOCAL_RANK", str(rank))
    torch.set_num_threads(threads)
    init_distributed(backend, init_method, world, rank, timeout_s)
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            target, args = item
            try:
                results.put((rank, True, target(rank, world, *args)))
            except Exception:  # noqa: BLE001 - reported to the parent
                results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown_distributed()


class World:
    """``world`` rank processes on this host, kept for several tasks.

    ``device_type`` ("cpu" or "cuda") picks the backend by
    :func:`choose_backend` unless ``backend`` is given; with CUDA, rank r
    uses device r modulo the device count. The host's cores are split
    evenly between the ranks' intra-op thread pools (ranks that each spin
    all of them take turns waiting on one another's collectives). :meth:`run` sends
    ``target(rank, world, *args)`` to every rank and returns the results
    in rank order. A rank's exception raises once every rank has answered;
    a rank that dies, or no result within ``timeout_s``, closes the world
    and raises. ``target`` must be
    importable (a module-level function of this package); tensors in
    ``args`` should be ``share_memory_()`` CPU tensors."""

    def __init__(self, world: int, device_type: str = "cpu",
                 backend: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        if world < 1:
            raise ValueError(f"World needs at least one rank, got {world}")
        self.world = world
        self.device_type = device_type
        self.backend = backend or choose_backend(world, device_type)
        self.timeout_s = timeout_s
        logger.info("[RayXGBoost] launching %d ranks on %s over %s", world,
                    device_type, self.backend)
        self._dir = tempfile.mkdtemp(prefix="xrt_world_")
        init_method = "file://" + os.path.join(self._dir, "rendezvous")
        threads = max(1, (os.cpu_count() or 1) // world)
        ctx = torch.multiprocessing.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                r, world, self.backend, init_method, timeout_s, threads,
                self._tasks[r], self._results))
            for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, target: Callable, *args) -> List[Any]:
        for q in self._tasks:
            q.put((target, args))
        out: Dict[int, Any] = {}
        errors = []
        waited = 0.0
        while len(out) + len(errors) < self.world:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                if dead or waited > self.timeout_s:
                    self.close()
                    raise RuntimeError(
                        f"rank(s) {dead} died" if dead else
                        f"no result within {self.timeout_s} s") from None
                continue
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:  # every rank answered: the world stays usable
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
        return [out[r] for r in range(self.world)]

    def close(self) -> None:
        for q in self._tasks:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def launch_world(target: Callable, world: int, device_type: str = "cpu",
                 *args, backend: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Spawn ``world`` ranks, run ``target(rank, world, *args)`` on each
    once, close the world; the results in rank order."""
    with World(world, device_type, backend, timeout_s) as w:
        return w.run(target, *args)


def share(arrays: Dict[str, Optional[np.ndarray]]
          ) -> Dict[str, Optional[torch.Tensor]]:
    """Host arrays as tensors in shared memory (one copy each), for
    :meth:`World.run`."""
    out: Dict[str, Optional[torch.Tensor]] = {}
    for k, v in arrays.items():
        if v is not None:
            v = np.asarray(v)
            dtype = torch.from_numpy(np.empty(0, v.dtype)).dtype
            t = torch.empty(v.shape, dtype=dtype).share_memory_()
            t.numpy()[...] = v
            v = t
        out[k] = v
    return out


# --------------------------------------------------------------------------
# rank functions (run inside a World)
# --------------------------------------------------------------------------


class _KeepEngine:
    """A training callback that keeps the engine of the last round."""

    engine = None

    def after_iteration(self, engine, i, result):
        self.engine = engine


def _numpy(data: Dict[str, Optional[torch.Tensor]], key: str):
    t = data.get(key)
    return None if t is None else t.numpy()


def _matrix(data: Dict[str, Any], sharding: str, **kwargs):
    from xgboost_ray_tpu_torch.matrix import RayDMatrix, RayShardingMode

    return RayDMatrix(_numpy(data, "x"), _numpy(data, "label"),
                      weight=_numpy(data, "weight"),
                      base_margin=_numpy(data, "base_margin"),
                      sharding=RayShardingMode[sharding], **kwargs)


def _train_rank(rank: int, world: int, data: Dict[str, Optional[torch.Tensor]],
                params: Dict, num_boost_round: int,
                options: Optional[Dict] = None) -> Dict[str, Any]:
    """``train()`` inside the world on a RayDMatrix over ``data`` (``x``,
    ``label``, optional ``weight`` / ``base_margin``; every rank gets the
    whole set and loads only its own shards). ``options``: ``sharding`` (a
    ``RayShardingMode`` name), ``num_actors`` (default: the world size),
    ``device``, ``eval_names`` (default ``["train"]``), ``eval_data``
    (beside the names: None for the training matrix, else a held-out set's
    ``data`` with its ``sharding``; default all None), ``feature_names``,
    ``feature_types``, ``callbacks``, ``verbose_eval``,
    ``early_stopping_rounds``, ``maximize``, ``xgb_model`` (``save_raw``
    bytes), ``keep_bins``.
    Returns the model (``save_raw`` bytes), evals_result,
    additional_results, this rank's final training margins ([n] for one
    output, [n, K] for K), the launches of
    every training kernel in ``train()`` (``engine.kernel_launches``, set
    to 0 just before it) and, with ``keep_bins``, its bins and the cuts."""
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )
    from xgboost_ray_tpu_torch.main import RayParams, train
    from xgboost_ray_tpu_torch.models.booster import RayXGBoostBooster

    options = dict(options or {})
    dm = _matrix(data, options.get("sharding", "INTERLEAVED"),
                 feature_names=options.get("feature_names"),
                 feature_types=options.get("feature_types"))
    names = options.get("eval_names", ["train"])
    evals = [(dm if ed is None else _matrix(ed, ed["sharding"]), name)
             for ed, name in zip(options.get("eval_data") or
                                 [None] * len(names), names)]
    raw = options.get("xgb_model")
    keep = _KeepEngine()
    ev, extra = {}, {}
    reset_kernel_launches()
    bst = train(params, dm, num_boost_round, evals=evals,
                evals_result=ev, additional_results=extra,
                ray_params=RayParams(num_actors=options.get("num_actors",
                                                            world)),
                device=options.get("device"),
                verbose_eval=options.get("verbose_eval", False),
                callbacks=[*options.get("callbacks", ()), keep],
                early_stopping_rounds=options.get("early_stopping_rounds"),
                maximize=options.get("maximize"),
                xgb_model=None if raw is None else RayXGBoostBooster.load_raw(raw))
    launches = kernel_launches()
    eng = keep.engine
    margins = eng.get_margins()
    out = {"model": bst.save_raw(), "evals_result": ev,
           "additional_results": extra, "launches": launches,
           "margins": margins[:, 0] if margins.shape[1] == 1 else margins}
    if options.get("keep_bins"):
        out["bins"] = eng.bins.cpu().numpy()
        out["cuts"] = eng.cuts.cpu().numpy()
    return out
