"""Numpy ndarray data source (mirrors ``xgboost_ray/data_sources/numpy.py``)."""

from typing import Any, Optional, Sequence

import numpy as np
import pandas as pd

from xgboost_ray_tpu_torch.data_sources.data_source import DataSource
from xgboost_ray_tpu_torch.data_sources.pandas import Pandas


class Numpy(DataSource):
    @staticmethod
    def is_data_type(data: Any, filetype: Optional[Any] = None) -> bool:
        return isinstance(data, np.ndarray)

    @staticmethod
    def load_data(
        data: np.ndarray,
        ignore: Optional[Sequence[str]] = None,
        indices: Optional[Sequence[int]] = None,
        **kwargs,
    ) -> pd.DataFrame:
        arr = data if data.ndim == 2 else data.reshape(data.shape[0], -1)
        # column naming parity: f0, f1, ... (reference numpy.py:26-33)
        frame = pd.DataFrame(arr, columns=[f"f{i}" for i in range(arr.shape[1])])
        return Pandas.load_data(frame, ignore=ignore, indices=indices)
