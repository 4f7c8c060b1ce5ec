"""Pandas DataFrame/Series data source (mirrors ``xgboost_ray/data_sources/pandas.py``)."""

from typing import Any, Optional, Sequence

import pandas as pd

from xgboost_ray_tpu_torch.data_sources.data_source import DataSource


class Pandas(DataSource):
    @staticmethod
    def is_data_type(data: Any, filetype: Optional[Any] = None) -> bool:
        return isinstance(data, (pd.DataFrame, pd.Series))

    @staticmethod
    def load_data(
        data: Any,
        ignore: Optional[Sequence[str]] = None,
        indices: Optional[Sequence[int]] = None,
        **kwargs,
    ) -> pd.DataFrame:
        if isinstance(data, pd.Series):
            data = pd.DataFrame(data)
        if indices is not None:
            data = data.iloc[list(indices)]
        if ignore:
            keep = [c for c in data.columns if c not in set(ignore)]
            data = data[keep]
        return data
