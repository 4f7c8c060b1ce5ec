"""Online inference serving of the port's models, on one device.

Port of ``xgboost_ray_tpu/serve`` for one replica: a padded-bucket
predictor over kernel B8 (``predictor.CompiledPredictor``: power-of-two
buckets with preallocated device buffers; no kernel builds after warmup),
a microbatching queue coalescing concurrent requests under a latency
deadline (``MicroBatcher``), a model registry with drain-then-flip hot-swap
(``ModelRegistry``), and a threaded stdlib HTTP front-end with
``/predict``, ``/healthz``, ``/metrics`` and ``/models``
(``create_server``). Everything runs on the card unless ``device="cpu"``.

Typical use::

    from xgboost_ray_tpu_torch import serve

    bst = train(params, dtrain, ray_params=RayParams(num_actors=1))
    handle = serve.create_server(bst, port=8000, max_batch=256,
                                 max_delay_ms=2.0)
    ...
    handle.registry.load(new_bst)   # atomic hot-swap, drains in-flight
    handle.shutdown()

or publish straight from training::

    reg = serve.ModelRegistry()
    train(params, dtrain, ray_params=rp, serve_registry=reg)

The replica pool, autoscaler and canary controller, and SHAP outputs, are
later slices.
"""

from xgboost_ray_tpu_torch.models.booster import coerce_model
from xgboost_ray_tpu_torch.serve.batcher import (
    MicroBatcher,
    OverloadedError,
    ShuttingDownError,
)
from xgboost_ray_tpu_torch.serve.http import ServeHandle, create_server
from xgboost_ray_tpu_torch.serve.metrics import ServeMetrics
from xgboost_ray_tpu_torch.serve.predictor import (
    KINDS,
    LAYOUTS,
    SERVED_KINDS,
    CompiledPredictor,
    bucket_rows,
    compile_count,
)
from xgboost_ray_tpu_torch.serve.registry import ModelRegistry, NoModelError

__all__ = [
    "KINDS",
    "LAYOUTS",
    "SERVED_KINDS",
    "CompiledPredictor",
    "MicroBatcher",
    "ModelRegistry",
    "NoModelError",
    "OverloadedError",
    "ServeHandle",
    "ShuttingDownError",
    "ServeMetrics",
    "bucket_rows",
    "coerce_model",
    "compile_count",
    "create_server",
]
