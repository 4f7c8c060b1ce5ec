"""Pre-partitioned in-memory data source.

Port of ``xgboost_ray_tpu/data_sources/object_store.py``: the reference's
ObjectStore source takes ``List[ray.ObjectRef]``
(``xgboost_ray/data_sources/object_store.py:15-32``); here a list of
materialized partitions (pandas frames or series, numpy arrays, or
zero-argument callables giving one). Distributed loading shards on the
partition level.
"""

from typing import Any, Optional, Sequence

import numpy as np
import pandas as pd

from xgboost_ray_tpu_torch.data_sources.data_source import (
    DataSource,
    RayFileType,
    drop_ignored,
)


def _is_partition(p: Any) -> bool:
    return isinstance(p, (pd.DataFrame, pd.Series, np.ndarray)) or callable(p)


def _materialize(p: Any) -> pd.DataFrame:
    if callable(p):
        p = p()
    if isinstance(p, np.ndarray):
        arr = p if p.ndim == 2 else p.reshape(p.shape[0], -1)
        return pd.DataFrame(arr, columns=[f"f{i}" for i in range(arr.shape[1])])
    if isinstance(p, pd.Series):
        return pd.DataFrame(p)
    return p


class ObjectStore(DataSource):
    supports_distributed_loading = True

    @staticmethod
    def is_data_type(data: Any, filetype: Optional[RayFileType] = None) -> bool:
        return (
            isinstance(data, (list, tuple))
            and len(data) > 0
            and all(_is_partition(p) for p in data)
            and not isinstance(data[0], str)
        )

    @staticmethod
    def load_data(
        data: Sequence[Any],
        ignore: Optional[Sequence[str]] = None,
        indices: Optional[Sequence[int]] = None,
        **kwargs,
    ) -> pd.DataFrame:
        parts = list(data)
        if indices is not None:
            parts = [parts[i] for i in indices]
        frames = [_materialize(p) for p in parts]
        df = pd.concat(frames, ignore_index=True) if len(frames) > 1 else frames[0]
        return drop_ignored(df, ignore)
