"""Ordered data-source registry of the port: in-memory numpy and pandas
data (the sources of this slice; file and distributed sources are queued).
"""

from xgboost_ray_tpu_torch.data_sources.data_source import DataSource
from xgboost_ray_tpu_torch.data_sources.numpy import Numpy
from xgboost_ray_tpu_torch.data_sources.pandas import Pandas

data_sources = [Numpy, Pandas]

__all__ = ["DataSource", "Numpy", "Pandas", "data_sources"]
