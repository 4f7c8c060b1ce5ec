"""Ordered data-source registry of the port (``xgboost_ray/data_sources``).

Port of ``xgboost_ray_tpu/data_sources/__init__.py``: numpy and pandas
data, CSV and Parquet files (the CSV reader is native, ``native/``),
partition lists (``ObjectStore``) and ``__partitioned__`` objects, and the
modin, dask, Ray Dataset and Petastorm sources, each gated on its package.
Probe order matters: path-based sources after the frame types.
"""

from xgboost_ray_tpu_torch.data_sources.csv import CSV
from xgboost_ray_tpu_torch.data_sources.dask import Dask
from xgboost_ray_tpu_torch.data_sources.data_source import DataSource, RayFileType
from xgboost_ray_tpu_torch.data_sources.modin import Modin
from xgboost_ray_tpu_torch.data_sources.numpy import Numpy
from xgboost_ray_tpu_torch.data_sources.object_store import ObjectStore
from xgboost_ray_tpu_torch.data_sources.pandas import Pandas
from xgboost_ray_tpu_torch.data_sources.parquet import Parquet
from xgboost_ray_tpu_torch.data_sources.partitioned import Partitioned
from xgboost_ray_tpu_torch.data_sources.petastorm import Petastorm
from xgboost_ray_tpu_torch.data_sources.ray_dataset import RayDataset

data_sources = [
    Numpy,
    Pandas,
    Modin,
    Dask,
    RayDataset,
    Partitioned,
    Petastorm,
    CSV,
    Parquet,
    ObjectStore,
]

__all__ = [
    "DataSource",
    "RayFileType",
    "Numpy",
    "Pandas",
    "CSV",
    "Parquet",
    "ObjectStore",
    "Partitioned",
    "Modin",
    "Dask",
    "RayDataset",
    "Petastorm",
    "data_sources",
]
