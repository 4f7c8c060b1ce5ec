"""xgboost_ray_tpu_torch: the PyTorch/CUDA port of xgboost_ray_tpu.

Trains gradient-boosted trees on an NVIDIA H100 with hand-written kernels
(``csrc/`` CUDA C++ for the histogram, split search, row partition, the
fused objective/metric passes and the tree walks; no Triton), behind the
same API as the JAX package: ``train`` (with custom objectives and
metrics, training and distributed callbacks, tune hooks), ``predict``,
``RayDMatrix`` (numpy and pandas data, CSV and Parquet files, partition
lists; loaded centrally or by each rank from its own files),
``RayParams``, a booster that saves the same model file, the sklearn
estimators, and ``serve`` (online inference). This package imports
``torch`` and nothing of ``jax`` or ``xgboost_ray_tpu``. Entry points run
on the CUDA device unless the caller passes ``device="cpu"`` (the plain
PyTorch path the tests use); the estimators take it as a constructor
argument.
"""

from xgboost_ray_tpu_torch import serve
from xgboost_ray_tpu_torch.callback import DistributedCallback, TrainingCallback
from xgboost_ray_tpu_torch.data_sources import RayFileType
from xgboost_ray_tpu_torch.main import (
    RayParams,
    RayXGBoostActor,
    predict,
    train,
)
from xgboost_ray_tpu_torch.matrix import (
    Data,
    RayDeviceQuantileDMatrix,
    RayDMatrix,
    RayQuantileDMatrix,
    RayShardingMode,
    combine_data,
)
from xgboost_ray_tpu_torch.models.booster import Booster, RayXGBoostBooster

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "RayParams",
    "RayDMatrix",
    "RayDeviceQuantileDMatrix",
    "RayQuantileDMatrix",
    "RayFileType",
    "RayShardingMode",
    "Data",
    "combine_data",
    "train",
    "predict",
    "serve",
    "Booster",
    "RayXGBoostBooster",
    "RayXGBoostActor",
    "DistributedCallback",
    "TrainingCallback",
]

try:
    from xgboost_ray_tpu_torch.sklearn import (
        RayXGBClassifier,
        RayXGBRanker,
        RayXGBRegressor,
        RayXGBRFClassifier,
        RayXGBRFRegressor,
    )

    __all__ += [
        "RayXGBClassifier",
        "RayXGBRegressor",
        "RayXGBRFClassifier",
        "RayXGBRFRegressor",
        "RayXGBRanker",
    ]
except ImportError:
    pass
