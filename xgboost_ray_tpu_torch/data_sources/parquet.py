"""Parquet file data source (``xgboost_ray/data_sources/parquet.py``).

Port of ``xgboost_ray_tpu/data_sources/parquet.py``: a path or a list of
paths, read by ``pandas.read_parquet`` (pyarrow); distributed loading
shards on the file level.
"""

from typing import Any, Optional, Sequence, Union

import pandas as pd

from xgboost_ray_tpu_torch.data_sources.data_source import (
    DataSource,
    RayFileType,
    drop_ignored,
)


def _is_parquet_path(p: Any) -> bool:
    return isinstance(p, str) and p.endswith(".parquet")


class Parquet(DataSource):
    supports_distributed_loading = True

    @staticmethod
    def is_data_type(data: Any, filetype: Optional[RayFileType] = None) -> bool:
        if filetype == RayFileType.PARQUET:
            return True
        if isinstance(data, str):
            return _is_parquet_path(data)
        if isinstance(data, Sequence) and not isinstance(data, str):
            return len(data) > 0 and all(_is_parquet_path(p) for p in data)
        return False

    @staticmethod
    def get_filetype(data: Any) -> Optional[RayFileType]:
        probe = data[0] if isinstance(data, (list, tuple)) and data else data
        return RayFileType.PARQUET if _is_parquet_path(probe) else None

    @staticmethod
    def load_data(
        data: Union[str, Sequence[str]],
        ignore: Optional[Sequence[str]] = None,
        indices: Optional[Sequence[int]] = None,
        **kwargs,
    ) -> pd.DataFrame:
        if isinstance(data, (list, tuple)):
            files = list(data)
            if indices is not None:
                files = [files[i] for i in indices]
            frames = [pd.read_parquet(f, **kwargs) for f in files]
            df = pd.concat(frames, ignore_index=True) if len(frames) > 1 else frames[0]
        else:
            df = pd.read_parquet(data, **kwargs)
            if indices is not None:
                df = df.iloc[list(indices)]
        return drop_ignored(df, ignore)
