"""Ray Dataset data source (``xgboost_ray/data_sources/ray_dataset.py``).

A copy of ``xgboost_ray_tpu/data_sources/ray_dataset.py``; without the package
``is_data_type`` is False, so a RayDMatrix of its data raises "Unable to
infer data source" as in the JAX package.

Gated on ray.data being importable; splits the dataset into one sub-dataset
per rank (``ray_dataset.py:87-103``).
"""

from typing import Any, Dict, List, Optional, Sequence, Tuple

import pandas as pd

from xgboost_ray_tpu_torch.data_sources.data_source import DataSource, RayFileType


def _ray_data_installed() -> bool:
    try:
        import ray.data  # noqa: F401

        return True
    except ImportError:
        return False


class RayDataset(DataSource):
    supports_distributed_loading = True

    @staticmethod
    def is_data_type(data: Any, filetype: Optional[RayFileType] = None) -> bool:
        if not _ray_data_installed():
            return False
        import ray.data

        return isinstance(data, ray.data.Dataset)

    @staticmethod
    def load_data(
        data: Any,
        ignore: Optional[Sequence[str]] = None,
        indices: Optional[Sequence[Any]] = None,
        **kwargs,
    ) -> pd.DataFrame:
        if indices is not None:
            frames = [shard.to_pandas() for shard in indices]
            df = pd.concat(frames, ignore_index=True)
        else:
            df = data.to_pandas()
        if ignore:
            df = df[[c for c in df.columns if c not in set(ignore)]]
        return df

    @staticmethod
    def get_actor_shards(data: Any, actors: Sequence[Any]) -> Tuple[Any, Dict[int, List[Any]]]:
        splits = data.split(len(actors), equal=True)
        return data, {rank: [splits[rank]] for rank in range(len(actors))}

    @staticmethod
    def get_n(data: Any) -> int:
        return int(data.num_blocks())
