"""Petastorm data source (``xgboost_ray/data_sources/petastorm.py``).

A copy of ``xgboost_ray_tpu/data_sources/petastorm.py``; without the package
``is_data_type`` is False, so a RayDMatrix of its data raises "Unable to
infer data source" as in the JAX package.

Gated on petastorm being importable; reads s3/gs/hdfs/file parquet URLs via
``make_batch_reader`` (``petastorm.py:45-85``).
"""

from typing import Any, Optional, Sequence, Union

import pandas as pd

from xgboost_ray_tpu_torch.data_sources.data_source import DataSource, RayFileType


def _petastorm_installed() -> bool:
    try:
        import petastorm  # noqa: F401

        return True
    except ImportError:
        return False


_SCHEMES = ("s3://", "gs://", "hdfs://", "file://")


class Petastorm(DataSource):
    supports_distributed_loading = True

    @staticmethod
    def is_data_type(data: Any, filetype: Optional[RayFileType] = None) -> bool:
        if not _petastorm_installed():
            return False
        if filetype == RayFileType.PETASTORM:
            return True
        if isinstance(data, str):
            return data.startswith(_SCHEMES) and data.endswith(".parquet")
        if isinstance(data, Sequence) and not isinstance(data, str):
            return len(data) > 0 and all(
                isinstance(p, str) and p.startswith(_SCHEMES) and p.endswith(".parquet")
                for p in data
            )
        return False

    @staticmethod
    def get_filetype(data: Any) -> Optional[RayFileType]:
        probe = data[0] if isinstance(data, (list, tuple)) and data else data
        if isinstance(probe, str) and probe.startswith(_SCHEMES) and probe.endswith(".parquet"):
            return RayFileType.PETASTORM
        return None

    @staticmethod
    def load_data(
        data: Union[str, Sequence[str]],
        ignore: Optional[Sequence[str]] = None,
        indices: Optional[Sequence[int]] = None,
        **kwargs,
    ) -> pd.DataFrame:
        from petastorm import make_batch_reader

        urls = [data] if isinstance(data, str) else list(data)
        if indices is not None:
            urls = [urls[i] for i in indices]
        frames = []
        with make_batch_reader(urls if len(urls) > 1 else urls[0]) as reader:
            for batch in reader:
                frames.append(pd.DataFrame(batch._asdict()))
        df = pd.concat(frames, ignore_index=True)
        if ignore:
            df = df[[c for c in df.columns if c not in set(ignore)]]
        return df
