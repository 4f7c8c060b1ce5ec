"""Dask DataFrame data source (``xgboost_ray/data_sources/dask.py``).

A copy of ``xgboost_ray_tpu/data_sources/dask.py``, gated on dask being
importable (without it ``is_data_type`` is False, so a RayDMatrix of a dask
frame raises "Unable to infer data source" as in the JAX package).
Partitions (delayed frames) are computed per rank; locality discovery,
which the reference does through a map_partitions node-IP probe
(``dask.py:137-161``), is the process assignment of ``_distributed.py``.
"""

from typing import Any, Dict, List, Optional, Sequence, Tuple

import pandas as pd

from xgboost_ray_tpu_torch.data_sources.data_source import DataSource, RayFileType
from xgboost_ray_tpu_torch.data_sources._distributed import (
    assign_partitions_to_actors,
    get_actor_rank_hosts,
)


def _dask_installed() -> bool:
    try:
        import dask  # noqa: F401

        return True
    except ImportError:
        return False


class Dask(DataSource):
    supports_distributed_loading = True

    @staticmethod
    def is_data_type(data: Any, filetype: Optional[RayFileType] = None) -> bool:
        if not _dask_installed():
            return False
        import dask.dataframe as dd

        return isinstance(data, (dd.DataFrame, dd.Series))

    @staticmethod
    def load_data(
        data: Any,
        ignore: Optional[Sequence[str]] = None,
        indices: Optional[Sequence[Any]] = None,
        **kwargs,
    ) -> pd.DataFrame:
        if indices is not None:
            import dask

            frames = list(dask.compute(*indices))
            df = pd.concat(frames, ignore_index=True)
        else:
            df = data.compute()
        if isinstance(df, pd.Series):
            df = pd.DataFrame(df)
        if ignore:
            df = df[[c for c in df.columns if c not in set(ignore)]]
        return df

    @staticmethod
    def get_actor_shards(data: Any, actors: Sequence[Any]) -> Tuple[Any, Dict[int, List[Any]]]:
        parts = data.to_delayed()
        hosts = get_actor_rank_hosts(len(actors))
        assignment = assign_partitions_to_actors({"localhost": list(parts)}, hosts)
        return data, assignment

    @staticmethod
    def get_n(data: Any) -> int:
        return int(data.npartitions)
