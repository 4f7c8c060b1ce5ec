"""CSV file data source (``xgboost_ray/data_sources/csv.py``).

Port of ``xgboost_ray_tpu/data_sources/csv.py``: a path or a list of
paths; with a list, distributed loading shards on the file level (indices
select files). A headered numeric CSV read with no pandas options takes
the native parser (``xgboost_ray_tpu_torch/native``), anything else
``pandas.read_csv``. Unlike the JAX package, which falls back to pandas
silently, ``read_csv_file.reads`` counts the files each parser read, as the
kernel wrappers count their launches, and a failed native build is logged.
"""

from typing import Any, Optional, Sequence, Union

import pandas as pd

from xgboost_ray_tpu_torch import native
from xgboost_ray_tpu_torch.data_sources.data_source import (
    DataSource,
    RayFileType,
    drop_ignored,
)


def read_csv_file(path: str, **kwargs) -> pd.DataFrame:
    """One CSV file as a frame: the native parser where it can, else
    pandas (``read_csv_file.reads`` counts each)."""
    if not kwargs:
        result = native.read_csv_numpy(path)
        if result is not None:
            read_csv_file.reads["native"] += 1
            matrix, names = result
            return pd.DataFrame(matrix, columns=names, copy=False)
    read_csv_file.reads["pandas"] += 1
    return pd.read_csv(path, **kwargs)


read_csv_file.reads = {"native": 0, "pandas": 0}


def _is_csv_path(p: Any) -> bool:
    return isinstance(p, str) and (p.endswith(".csv") or p.endswith(".csv.gz"))


class CSV(DataSource):
    supports_distributed_loading = True

    @staticmethod
    def is_data_type(data: Any, filetype: Optional[RayFileType] = None) -> bool:
        if filetype == RayFileType.CSV:
            return True
        if isinstance(data, str):
            return _is_csv_path(data)
        if isinstance(data, Sequence) and not isinstance(data, str):
            return len(data) > 0 and all(_is_csv_path(p) for p in data)
        return False

    @staticmethod
    def get_filetype(data: Any) -> Optional[RayFileType]:
        probe = data[0] if isinstance(data, (list, tuple)) and data else data
        return RayFileType.CSV if _is_csv_path(probe) else None

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
            frames = [read_csv_file(f, **kwargs) for f in files]
            df = pd.concat(frames, ignore_index=True) if len(frames) > 1 else frames[0]
        else:
            df = read_csv_file(data, **kwargs)
            if indices is not None:
                df = df.iloc[list(indices)]
        return drop_ignored(df, ignore)
