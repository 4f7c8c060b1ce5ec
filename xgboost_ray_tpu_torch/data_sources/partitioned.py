"""``__partitioned__`` protocol data source.

Port of ``xgboost_ray_tpu/data_sources/partitioned.py``
(``xgboost_ray/data_sources/partitioned.py``, Intel's distributed
dataframe protocol): an object whose ``__partitioned__`` holds a
``partitions`` dict (``{pos: {"start": ..., "shape": ..., "data": obj}}``)
and a ``get`` callable resolving the partitions' references.
"""

from typing import Any, Optional, Sequence

import numpy as np
import pandas as pd

from xgboost_ray_tpu_torch.data_sources.data_source import (
    DataSource,
    RayFileType,
    drop_ignored,
)
from xgboost_ray_tpu_torch.data_sources.object_store import _materialize


class Partitioned(DataSource):
    supports_distributed_loading = True

    @staticmethod
    def is_data_type(data: Any, filetype: Optional[RayFileType] = None) -> bool:
        return hasattr(data, "__partitioned__")

    @staticmethod
    def load_data(
        data: Any,
        ignore: Optional[Sequence[str]] = None,
        indices: Optional[Sequence[Any]] = None,
        **kwargs,
    ) -> pd.DataFrame:
        meta = data.__partitioned__
        getter = meta.get("get", lambda x: x)
        parts = meta["partitions"]
        # partitions in the order of their start offsets
        items = sorted(parts.items(),
                       key=lambda kv: tuple(np.ravel(kv[1].get("start", kv[0]))))
        keys = [k for k, _ in items]
        if indices is not None:
            keys = [keys[i] for i in indices]
        frames = [_materialize(getter(parts[k]["data"])) for k in keys]
        df = pd.concat(frames, ignore_index=True) if len(frames) > 1 else frames[0]
        return drop_ignored(df, ignore)

    @staticmethod
    def get_n(data: Any) -> int:
        return len(data.__partitioned__["partitions"])
