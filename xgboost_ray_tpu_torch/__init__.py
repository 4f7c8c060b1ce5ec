"""xgboost_ray_tpu_torch: the PyTorch/CUDA port of xgboost_ray_tpu.

Trains gradient-boosted trees on an NVIDIA H100 with hand-written kernels
(``csrc/`` CUDA C++ for the histogram, split search, row partition, the
fused objective/metric passes and the tree walks; no Triton), behind the
same API as the JAX package: ``train``, ``predict``, ``RayDMatrix``,
``RayParams``, a booster that saves the same model file, and ``serve``
(online inference). This package imports ``torch`` and nothing of
``jax`` or ``xgboost_ray_tpu``. Entry points run on the CUDA device unless
the caller passes ``device="cpu"`` (the plain PyTorch path the tests use).
"""

from xgboost_ray_tpu_torch import serve
from xgboost_ray_tpu_torch.main import RayParams, predict, train
from xgboost_ray_tpu_torch.matrix import RayDMatrix, RayShardingMode
from xgboost_ray_tpu_torch.models.booster import Booster, RayXGBoostBooster

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "RayParams",
    "RayDMatrix",
    "RayShardingMode",
    "train",
    "predict",
    "serve",
    "Booster",
    "RayXGBoostBooster",
]
