"""DataSource interface: polymorphic ingestion for RayDMatrix.

Port of ``xgboost_ray_tpu/data_sources/data_source.py`` (the reference's
static-method DataSource, ``xgboost_ray/data_sources/data_source.py:22-155``):
every source is a class of static methods, probed in the registry's order
with ``is_data_type``; file and partition sources also give their file type
(``get_filetype``), their count of files or partitions (``get_n``, what
distributed loading shards) and, for distributed frames, their own
partition-to-rank assignment (``get_actor_shards``).
"""

import enum
from typing import Any, List, Optional, Sequence, Union

import numpy as np
import pandas as pd


class RayFileType(enum.Enum):
    """File formats of file loading (``data_source.py:13-19``)."""

    CSV = 1
    PARQUET = 2
    PETASTORM = 3


class DataSource:
    """Interface for a supported data input type."""

    supports_distributed_loading: bool = False

    @staticmethod
    def is_data_type(data: Any, filetype: Optional[RayFileType] = None) -> bool:
        return False

    @staticmethod
    def get_filetype(data: Any) -> Optional[RayFileType]:
        return None

    @staticmethod
    def load_data(
        data: Any,
        ignore: Optional[Sequence[str]] = None,
        indices: Optional[Union[Sequence[int], Sequence[Any]]] = None,
        **kwargs,
    ) -> pd.DataFrame:
        raise NotImplementedError

    @staticmethod
    def update_feature_names(
        x: pd.DataFrame, feature_names: Optional[List[str]]
    ) -> pd.DataFrame:
        if feature_names:
            x.columns = feature_names
        return x

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

    @staticmethod
    def get_n(data: Any) -> int:
        return len(data)

    @staticmethod
    def get_actor_shards(data: Any, actors: Sequence[Any]) -> tuple:
        """Distributed frames: (data, {rank: partitions}); others (data,
        None)."""
        return data, None


def drop_ignored(df: pd.DataFrame, ignore: Optional[Sequence[str]]
                 ) -> pd.DataFrame:
    """``df`` without the columns named in ``ignore``."""
    if not ignore:
        return df
    drop = set(ignore)
    return df[[c for c in df.columns if c not in drop]]
