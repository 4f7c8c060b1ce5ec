"""Modin DataFrame data source (``xgboost_ray/data_sources/modin.py``).

A copy of ``xgboost_ray_tpu/data_sources/modin.py``, gated on modin being
importable (without it ``is_data_type`` is False, so a RayDMatrix of a
modin frame raises "Unable to infer data source" as in the JAX package);
partitions are unwrapped and assigned with host locality, the reference's
flow (``modin.py:114-135``) without the Ray object references.
"""

from typing import Any, Dict, List, Optional, Sequence, Tuple

import pandas as pd

from xgboost_ray_tpu_torch.data_sources.data_source import DataSource, RayFileType
from xgboost_ray_tpu_torch.data_sources._distributed import (
    assign_partitions_to_actors,
    get_actor_rank_hosts,
)


def _modin_installed() -> bool:
    try:
        import modin  # noqa: F401

        return True
    except ImportError:
        return False


class Modin(DataSource):
    supports_distributed_loading = True

    @staticmethod
    def is_data_type(data: Any, filetype: Optional[RayFileType] = None) -> bool:
        if not _modin_installed():
            return False
        from modin.pandas import DataFrame as ModinDataFrame
        from modin.pandas import Series as ModinSeries

        return isinstance(data, (ModinDataFrame, ModinSeries))

    @staticmethod
    def load_data(
        data: Any,
        ignore: Optional[Sequence[str]] = None,
        indices: Optional[Sequence[Any]] = None,
        **kwargs,
    ) -> pd.DataFrame:
        local_df = data
        if indices is not None:
            # indices are partition objects assigned via get_actor_shards
            frames = [p if isinstance(p, pd.DataFrame) else p._to_pandas()
                      for p in indices]
            df = pd.concat(frames, ignore_index=True)
        else:
            df = local_df._to_pandas() if hasattr(local_df, "_to_pandas") else (
                local_df.to_pandas() if hasattr(local_df, "to_pandas") else local_df
            )
        if isinstance(df, pd.Series):
            df = pd.DataFrame(df)
        if ignore:
            df = df[[c for c in df.columns if c not in set(ignore)]]
        return df

    @staticmethod
    def get_actor_shards(data: Any, actors: Sequence[Any]) -> Tuple[Any, Dict[int, List[Any]]]:
        """Unwrap partitions and assign them to ranks with locality."""
        from modin.distributed.dataframe.pandas import unwrap_partitions

        parts = unwrap_partitions(data, axis=0)
        hosts = get_actor_rank_hosts(len(actors))
        assignment = assign_partitions_to_actors({"localhost": list(parts)}, hosts)
        return data, assignment

    @staticmethod
    def get_n(data: Any) -> int:
        return len(data)
