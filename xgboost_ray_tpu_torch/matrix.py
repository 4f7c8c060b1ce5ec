"""RayDMatrix: the data handle for ``train()``.

Port of ``xgboost_ray_tpu/matrix.py`` (``:33`` ``RayShardingMode``,
``:71`` ``combine_data``, ``:159``/``:320`` the central loader, ``:420``
``RayDMatrix``) for this slice: the calling process loads in-memory numpy
or pandas data once and row-shards it per actor rank (a rank of a
``torch.distributed`` world takes only its own shard: no other rank's rows
are copied); the engine concatenates the shards it is given in rank order
and moves them to the training device (a RayDMatrix holds host arrays
only, so it follows whatever device ``train`` uses). Distributed (per-rank file) loading, streaming, query
groups, label bounds, categorical columns and feature weights raise
``NotImplementedError``.
"""

from enum import Enum
from typing import Any, Dict, Iterable, List, Optional, Union

import numpy as np
import pandas as pd

from xgboost_ray_tpu_torch.data_sources import data_sources

Data = Union[np.ndarray, pd.DataFrame, pd.Series]


class RayShardingMode(Enum):
    """How rows map to actor ranks: INTERLEAVED strides rows over ranks,
    BATCH gives contiguous blocks (FIXED pins partitions of distributed
    sources, which this slice does not load)."""

    INTERLEAVED = 1
    BATCH = 2
    FIXED = 3


def _batch_split_points(num_actors: int, n: int) -> np.ndarray:
    n_per_actor, extras = divmod(n, num_actors)
    sizes = [n_per_actor + 1] * extras + [n_per_actor] * (num_actors - extras)
    return np.concatenate([[0], np.cumsum(sizes)])


def _get_sharding_indices(sharding: RayShardingMode, rank: int,
                          num_actors: int, n: int):
    if sharding == RayShardingMode.BATCH:
        points = _batch_split_points(num_actors, n)
        return slice(int(points[rank]), int(points[rank + 1]))
    if sharding == RayShardingMode.INTERLEAVED:
        return slice(rank, n, num_actors)
    raise ValueError(
        f"Invalid value for `sharding` parameter: {sharding}. Pass "
        f"RayShardingMode.BATCH or RayShardingMode.INTERLEAVED."
    )


def combine_data(sharding: RayShardingMode, data: Iterable) -> np.ndarray:
    """Re-assemble per-rank prediction shards into original row order (the
    inverse of ``_get_sharding_indices``)."""
    if sharding not in (RayShardingMode.BATCH, RayShardingMode.INTERLEAVED):
        raise ValueError(
            f"Invalid value for `sharding` parameter: {sharding}. Pass a "
            f"RayShardingMode enum member, e.g. RayShardingMode.BATCH."
        )
    parts = [np.asarray(d) for d in data if len(d)]
    if not parts:
        return np.array([])
    if sharding == RayShardingMode.BATCH:
        return np.concatenate(parts, axis=0)
    # INTERLEAVED: ranks may be off by one for uneven splits. Stacking on a
    # new axis 1 then flattening restores row order for any trailing shape
    # (scalars, [K] margins, [T] leaf indices).
    min_len = min(len(d) for d in parts)
    res = np.stack([d[:min_len] for d in parts], axis=1).reshape(
        (len(parts) * min_len,) + parts[0].shape[1:]
    )
    tails = [d[min_len:] for d in parts if len(d) > min_len]
    if tails:
        res = np.concatenate([res] + tails, axis=0)
    return res


def _not_in_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"RayDMatrix({what}) is not supported by xgboost_ray_tpu_torch yet; "
        f"use the JAX package xgboost_ray_tpu for it."
    )


class _CentralRayDMatrixLoader:
    """The driver loads the full dataset once, then row-shards per rank."""

    def __init__(self, data, label=None, weight=None, base_margin=None,
                 missing=None, feature_names=None, ignore=None):
        self.data = data
        self.label = label
        self.weight = weight
        self.base_margin = base_margin
        self.missing = missing
        self.feature_names = feature_names
        self.ignore = ignore
        self._resolved_feature_names: Optional[List[str]] = None

    def get_data_source(self):
        for source in data_sources:
            if source.is_data_type(self.data, None):
                return source
        raise ValueError(
            f"Unable to infer data source for data of type {type(self.data)}. "
            f"This port loads numpy arrays and pandas frames."
        )

    def load_fields(self) -> Dict[str, Optional[np.ndarray]]:
        source = self.get_data_source()
        df = source.load_data(self.data, ignore=self.ignore)
        exclude: List[str] = []

        def pick(ref):
            series, col = source.get_column(df, ref)
            if col is not None:
                exclude.append(col)
            return series

        label = pick(self.label)
        weight = pick(self.weight)
        base_margin = pick(self.base_margin)
        x = df.drop(columns=[c for c in exclude if c in df.columns])
        non_numeric = [c for c in x.columns
                       if not pd.api.types.is_numeric_dtype(x[c].dtype)]
        if non_numeric:
            raise _not_in_slice(f"categorical/object columns {non_numeric}")
        self._resolved_feature_names = (
            self.feature_names or [str(c) for c in x.columns])
        feats = x.to_numpy(dtype=np.float32, copy=False)
        if self.missing is not None and not np.isnan(self.missing):
            feats = np.where(feats == np.float32(self.missing), np.nan, feats)

        def arr(v):
            return None if v is None else np.asarray(v, dtype=np.float32).ravel()

        return {"data": feats, "label": arr(label), "weight": arr(weight),
                "base_margin": arr(base_margin)}

    def load_data(self, num_actors: int, sharding: RayShardingMode,
                  ranks: Iterable[int]):
        """The shards of ``ranks`` only: {rank: fields}, and the row count."""
        fields = self.load_fields()
        n = fields["data"].shape[0]
        if num_actors > n:
            raise RuntimeError(
                f"Trying to shard data for {num_actors} actors, but the "
                f"dataset has only {n} rows. Use fewer actors."
            )
        refs = {}
        for rank in ranks:
            idx = _get_sharding_indices(sharding, rank, num_actors, n)
            refs[rank] = {k: (v[idx] if v is not None else None)
                          for k, v in fields.items()}
        return refs, n


class RayDMatrix:
    """Data handle (API of ``xgboost_ray_tpu.RayDMatrix``). Lazy by default:
    ``train()`` loads it with its actor count."""

    def __init__(
        self,
        data: Data,
        label: Optional[Data] = None,
        weight: Optional[Data] = None,
        feature_weights: Optional[Data] = None,
        base_margin: Optional[Data] = None,
        missing: Optional[float] = None,
        label_lower_bound: Optional[Data] = None,
        label_upper_bound: Optional[Data] = None,
        feature_names: Optional[List[str]] = None,
        feature_types: Optional[List[Any]] = None,
        qid: Optional[Data] = None,
        enable_categorical: Optional[bool] = None,
        num_actors: Optional[int] = None,
        filetype: Optional[Any] = None,
        ignore: Optional[List[str]] = None,
        distributed: Optional[bool] = None,
        sharding: RayShardingMode = RayShardingMode.INTERLEAVED,
        lazy: bool = False,
        stream: bool = False,
        **kwargs,
    ):
        for name, val in (("feature_weights", feature_weights),
                          ("label_lower_bound", label_lower_bound),
                          ("label_upper_bound", label_upper_bound),
                          ("qid", qid), ("filetype", filetype)):
            if val is not None:
                raise _not_in_slice(name)
        if stream:
            raise _not_in_slice("stream=True")
        if distributed:
            raise _not_in_slice("distributed=True")
        if enable_categorical:
            raise _not_in_slice("enable_categorical=True")
        if feature_types and any(str(t).lower() in ("c", "categorical")
                                 for t in feature_types):
            raise _not_in_slice("categorical feature_types")
        if kwargs:
            raise _not_in_slice(", ".join(sorted(kwargs)))
        if sharding not in (RayShardingMode.BATCH, RayShardingMode.INTERLEAVED):
            raise _not_in_slice(f"sharding={sharding}")
        if not any(s.is_data_type(data, None) for s in data_sources):
            raise _not_in_slice(f"data of type {type(data).__name__}")
        self.feature_names = feature_names
        self.feature_types = feature_types
        self.missing = missing
        self.num_actors = num_actors
        self.sharding = sharding
        self.loader = _CentralRayDMatrixLoader(
            data, label=label, weight=weight, base_margin=base_margin,
            missing=missing, feature_names=feature_names, ignore=ignore)
        self.refs: Dict[int, Dict[str, Optional[np.ndarray]]] = {}
        self.n: Optional[int] = None
        self.loaded = False
        if num_actors is not None and not lazy:
            self.load_data(num_actors)

    def load_data(self, num_actors: Optional[int] = None,
                  ranks: Optional[Iterable[int]] = None):
        """Shard the data for ``num_actors`` ranks, materialising the shards
        of ``ranks`` (default: every rank) that are not loaded yet."""
        if num_actors is not None:
            if self.num_actors is not None and self.num_actors != num_actors:
                raise ValueError(
                    f"The number of actors of a RayDMatrix cannot change once "
                    f"set ({self.num_actors} -> {num_actors})."
                )
            self.num_actors = num_actors
        if self.num_actors is None:
            raise ValueError("Pass `num_actors` to load a RayDMatrix.")
        wanted = range(self.num_actors) if ranks is None else ranks
        todo = [r for r in wanted if r not in self.refs]
        if not todo:
            return
        refs, self.n = self.loader.load_data(self.num_actors, self.sharding,
                                             todo)
        self.refs.update(refs)
        self.loaded = len(self.refs) == self.num_actors

    def shards(self, ranks: Optional[Iterable[int]] = None
               ) -> List[Dict[str, Optional[np.ndarray]]]:
        """The shards of ``ranks`` (default: every rank), in rank order."""
        ranks = range(self.num_actors) if ranks is None else ranks
        missing = [r for r in ranks if r not in self.refs]
        if missing:
            raise RuntimeError(f"RayDMatrix: shards {missing} are not loaded")
        return [self.refs[r] for r in ranks]

    @property
    def resolved_feature_names(self) -> Optional[List[str]]:
        return self.feature_names or self.loader._resolved_feature_names
