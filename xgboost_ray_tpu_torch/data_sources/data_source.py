"""DataSource interface: polymorphic in-memory ingestion for RayDMatrix.

The part of ``xgboost_ray_tpu/data_sources/data_source.py`` that the
numpy and pandas sources need: every source is a class of static methods,
probed in order with ``is_data_type``.
"""

from typing import Any, Optional, Sequence, Union

import numpy as np
import pandas as pd


class DataSource:
    """Interface for a supported data input type."""

    @staticmethod
    def is_data_type(data: Any, filetype: Optional[Any] = None) -> bool:
        return False

    @staticmethod
    def load_data(
        data: Any,
        ignore: Optional[Sequence[str]] = None,
        indices: Optional[Union[Sequence[int], Sequence[Any]]] = None,
        **kwargs,
    ) -> pd.DataFrame:
        raise NotImplementedError

    @staticmethod
    def convert_to_series(data: Any) -> pd.Series:
        if isinstance(data, pd.DataFrame):
            return pd.Series(data.squeeze())
        if isinstance(data, pd.Series):
            return data
        return pd.Series(np.asarray(data).ravel())

    @classmethod
    def get_column(cls, data: pd.DataFrame, column: Any) -> tuple:
        """Resolve a label/weight/etc. reference to a series.

        Returns (series, column_name_to_exclude_or_None); a string selects a
        column of ``data`` (and excludes it from the features), anything else
        is converted to a standalone series.
        """
        if isinstance(column, str):
            return data[column], column
        if column is not None:
            return cls.convert_to_series(column), None
        return None, None
