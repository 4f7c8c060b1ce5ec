"""Online inference serving of the port's models, on one device.

Port of ``xgboost_ray_tpu/serve``: a padded-bucket predictor over kernels
B8 and B15 (``predictor.CompiledPredictor``: power-of-two buckets with
preallocated device buffers; no kernel builds after warmup; kinds
``value``, ``margin``, ``leaf`` and ``contribs``), a microbatching queue
coalescing concurrent requests under a latency deadline (``MicroBatcher``),
a model registry with drain-then-flip hot-swap (``ModelRegistry``), a
threaded stdlib HTTP front-end with ``/predict``, ``/healthz``,
``/metrics`` and ``/models`` (``create_server``); on top of it a replica
pool behind a least-queue router with admission control (``Router``,
``n_replicas=`` on ``create_server``), a p99- and queue-driven
``AutoScaler`` with hysteresis, and the train -> refresh -> serve loop
(``refresh`` and ``CanaryController``: shadow traffic, canary gate,
automatic rollback). Everything runs on the card unless ``device="cpu"``.

Typical use::

    from xgboost_ray_tpu_torch import serve

    bst = train(params, dtrain, ray_params=RayParams(num_actors=1))
    handle = serve.create_server(bst, port=8000, max_batch=256,
                                 max_delay_ms=2.0, n_replicas=2)
    ...
    handle.registry.load(new_bst)   # atomic hot-swap, drains in-flight
    handle.shutdown()

or publish straight from training::

    reg = serve.ModelRegistry()
    train(params, dtrain, ray_params=rp, serve_registry=reg)
"""

from xgboost_ray_tpu_torch.models.booster import coerce_model
from xgboost_ray_tpu_torch.serve.autoscale import AutoScaler
from xgboost_ray_tpu_torch.serve.batcher import (
    MicroBatcher,
    OverloadedError,
    ShuttingDownError,
)
from xgboost_ray_tpu_torch.serve.canary import (
    CanaryController,
    binary_logloss,
    refresh,
)
from xgboost_ray_tpu_torch.serve.http import ServeHandle, create_server
from xgboost_ray_tpu_torch.serve.metrics import ServeMetrics
from xgboost_ray_tpu_torch.serve.pool import NoReplicasError, Replica, Router
from xgboost_ray_tpu_torch.serve.predictor import (
    KINDS,
    LAYOUTS,
    CompiledPredictor,
    bucket_rows,
    compile_count,
)
from xgboost_ray_tpu_torch.serve.registry import ModelRegistry, NoModelError

__all__ = [
    "KINDS",
    "LAYOUTS",
    "AutoScaler",
    "CanaryController",
    "CompiledPredictor",
    "MicroBatcher",
    "ModelRegistry",
    "NoModelError",
    "NoReplicasError",
    "OverloadedError",
    "Replica",
    "Router",
    "ServeHandle",
    "ShuttingDownError",
    "ServeMetrics",
    "binary_logloss",
    "bucket_rows",
    "coerce_model",
    "compile_count",
    "create_server",
    "refresh",
]
