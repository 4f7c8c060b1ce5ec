"""RayDMatrix: the data handle for ``train()`` and ``predict()``.

Port of ``xgboost_ray_tpu/matrix.py``: ``RayShardingMode`` (``:33``),
``combine_data`` (``:71``), the loaders (``:159`` the shared split of a
frame into features, label, weight and base margin; ``:320`` central
loading; ``:349-418`` distributed loading), ``RayDMatrix`` (``:420``, with
``assert_enough_shards_for_actors`` ``:563`` and the FIXED assignment
``assign_shards_to_actors``) and ``RayQuantileDMatrix`` /
``RayDeviceQuantileDMatrix`` (``:838-851``). Sources are the registry of
``data_sources``: numpy and pandas data, CSV and Parquet files (a path, a
list of paths, a directory or a glob), partition lists and
``__partitioned__`` objects.

Central loading: the calling process reads the data once (cached on the
loader while the matrix lives; each shard is a view of it) and row-shards
it per actor rank. Distributed loading (``distributed=True``, the default
for file lists, directories, single Parquet files and partition lists):
each rank reads only its own files or partitions, chosen by the sharding
mode over the file list, or by the locality assignment under
``RayShardingMode.FIXED``; in a ``torch.distributed`` world a process
reads only the files of the ranks it trains. The engine concatenates the
shards it is given in rank order and moves them to the training device (a
RayDMatrix holds host arrays only). Label bounds (``label_lower_bound``,
``label_upper_bound``: survival:aft) are carried, sharded and loaded like
labels (``matrix.py:238-241``, ``:313-316``, ``:356``), and so are query
ids (``qid``: an array, or a column name under distributed loading): a
loaded frame's rows are stable-sorted by ``qid`` first, so each query's
rows are contiguous (``matrix.py:98-113``, ``:241-256``); ``qid`` with
``weight`` raises (per-group weights are not implemented). Categorical
columns (``matrix.py:255-300``): a frame's ``category`` and object columns
are encoded as f32 codes of their sorted categories (a missing value NaN)
under ``enable_categorical=True`` and central loading, and recorded in
``resolved_feature_types`` / ``resolved_categories``; numeric codes with
``feature_types=["c", ...]`` need no encoding. ``translate_category_codes``
/ ``translate_shard_categories`` (``matrix.py:116-160``) map codes of one
category set onto another (eval sets and predict frames onto the
training mapping). Streaming raises ``NotImplementedError``.
"""

import glob
import os
from enum import Enum
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import pandas as pd

from xgboost_ray_tpu_torch.data_sources import RayFileType, data_sources
from xgboost_ray_tpu_torch.data_sources._distributed import (
    assign_partitions_to_actors,
    get_actor_rank_hosts,
)

Data = Union[str, List[str], np.ndarray, pd.DataFrame, pd.Series, Sequence[Any]]


class RayShardingMode(Enum):
    """How rows (or files, for distributed loading) map to actor ranks:
    INTERLEAVED strides over ranks, BATCH gives contiguous blocks, FIXED
    pins partitions assigned by locality (``xgboost_ray/matrix.py:106-124``)."""

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


def qid_sort_order(qid) -> Optional[np.ndarray]:
    """Stable order making query groups contiguous, or None if already sorted
    (``matrix.py:98-104``)."""
    order = np.argsort(np.asarray(qid), kind="stable")
    if np.all(order == np.arange(len(order))):
        return None
    return order


def translate_category_codes(col: np.ndarray, from_cats: Sequence[Any],
                             to_cats: Sequence[Any]) -> np.ndarray:
    """Codes of ``col`` encoded against ``from_cats`` re-mapped onto
    ``to_cats``; a category absent from ``to_cats`` becomes NaN (missing),
    as xgboost treats an unseen category at predict time."""
    mapping = np.full(len(from_cats), np.nan, np.float32)
    to_index = {v: i for i, v in enumerate(to_cats)}
    for i, v in enumerate(from_cats):
        if v in to_index:
            mapping[i] = to_index[v]
    out = np.full(col.shape, np.nan, np.float32)
    valid = ~np.isnan(col)
    out[valid] = mapping[col[valid].astype(np.int64)]
    return out


def translate_shard_categories(
        shard: Dict[str, Optional[np.ndarray]],
        from_cats: Optional[Dict[int, Sequence[Any]]],
        to_cats: Optional[Dict[int, Sequence[Any]]]
) -> Dict[str, Optional[np.ndarray]]:
    """A shard whose auto-encoded codes (``from_cats``) are aligned with a
    reference mapping (``to_cats``, the training matrix's): frames with
    other category sets would give the same value other codes. The shard
    itself where there is nothing to translate."""
    if not from_cats or not to_cats or from_cats == to_cats:
        return shard
    data = np.array(shard["data"], copy=True)
    for col, cats in from_cats.items():
        target = to_cats.get(col)
        if target is None or tuple(cats) == tuple(target):
            continue
        data[:, col] = translate_category_codes(data[:, col], cats, target)
    out = dict(shard)
    out["data"] = data
    return out


def _not_in_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"RayDMatrix({what}) is not supported by xgboost_ray_tpu_torch yet; "
        f"use the JAX package xgboost_ray_tpu for it."
    )


#: the per-row fields besides the features: each a column name of the
#: source, or an array-like (central loading only)
ROW_FIELDS = ("label", "weight", "base_margin", "label_lower_bound",
              "label_upper_bound", "qid")

#: RayDMatrix keyword arguments of streaming (ROADMAP A17)
_STREAM_KWARGS = ("chunk_rows", "budget_mb", "sketch_capacity")


class _RayDMatrixLoader:
    """Source resolution and the split of a loaded frame into fields."""

    def __init__(self, data, label=None, weight=None, base_margin=None,
                 missing=None, feature_names=None, filetype=None, ignore=None,
                 label_lower_bound=None, label_upper_bound=None, qid=None,
                 feature_types=None, enable_categorical=False, **kwargs):
        self.data = data
        self.label = label
        self.weight = weight
        self.base_margin = base_margin
        self.label_lower_bound = label_lower_bound
        self.label_upper_bound = label_upper_bound
        self.qid = qid
        self.missing = missing
        self.feature_names = feature_names
        self.filetype = filetype
        self.ignore = ignore
        self.kwargs = kwargs
        self.feature_types = feature_types
        self.enable_categorical = enable_categorical
        self.data_source: Optional[type] = None
        self._resolved_feature_names: Optional[List[str]] = None
        self._resolved_feature_types: Optional[List[str]] = None
        self._resolved_categories: Optional[Dict[int, tuple]] = None

    def get_data_source(self) -> type:
        if self.data_source is not None:
            return self.data_source
        filetype = self.filetype
        for source in data_sources:
            if filetype is None:
                filetype = source.get_filetype(self.data) or filetype
        for source in data_sources:
            if source.is_data_type(self.data, filetype):
                self.data_source, self.filetype = source, filetype
                return source
        raise ValueError(
            f"Unable to infer data source for data of type "
            f"{type(self.data)}. Pass a supported data type (numpy array, "
            f"pandas frame, csv/parquet path(s), partition list) or specify "
            f"`filetype`."
        )

    def _split_dataframe(self, df: pd.DataFrame) -> Dict[str, Optional[np.ndarray]]:
        """Label, weight, base margin, label bound and qid columns out of
        ``df`` (a string names a column, which leaves the features; an
        array-like attaches as is), ``ignore``'s columns dropped, the
        ``category`` and object columns encoded (``_encode_categories``),
        the features f32; with a qid, every field's rows stable-sorted by
        it."""
        source = self.get_data_source()
        exclude: List[str] = []

        def pick(ref):
            series, col = source.get_column(df, ref)
            if col is not None:
                exclude.append(col)
            return series

        label = pick(self.label)
        weight = pick(self.weight)
        base_margin = pick(self.base_margin)
        lower = pick(self.label_lower_bound)
        upper = pick(self.label_upper_bound)
        qid = pick(self.qid)
        x = df.drop(columns=[c for c in exclude if c in df.columns])
        if self.ignore:
            x = x.drop(columns=[c for c in self.ignore if c in x.columns])
        self._resolved_feature_names = (
            self.feature_names or [str(c) for c in x.columns])
        x = self._encode_categories(x)
        feats = x.to_numpy(dtype=np.float32, copy=False)
        if self.missing is not None and not np.isnan(self.missing):
            feats = np.where(feats == np.float32(self.missing), np.nan, feats)

        order = None if qid is None else qid_sort_order(qid)

        def arr(v, dtype=np.float32):
            if v is None:
                return None
            v = np.asarray(v, dtype=dtype).ravel()
            return v if order is None else v[order]

        return {"data": feats if order is None else feats[order],
                "label": arr(label), "weight": arr(weight),
                "base_margin": arr(base_margin),
                "label_lower_bound": arr(lower),
                "label_upper_bound": arr(upper),
                "qid": arr(qid, None)}

    def _encode_categories(self, x: pd.DataFrame) -> pd.DataFrame:
        """The reference's encoding (``matrix.py:258-300``): each
        ``category`` or object column becomes the f32 codes of its sorted
        categories (-1, a missing value, NaN), recorded in
        ``_resolved_categories``; the feature types ('c' for those columns)
        in ``_resolved_feature_types``. Refused without
        ``enable_categorical`` and under distributed loading (each shard's
        category set would differ)."""
        cat_cols = [c for c in x.columns
                    if isinstance(x[c].dtype, pd.CategoricalDtype)
                    or not pd.api.types.is_numeric_dtype(x[c].dtype)]
        ftypes = list(self.feature_types) if self.feature_types else None
        if cat_cols:
            if not self.enable_categorical:
                raise ValueError(
                    f"DataFrame has categorical/object columns {cat_cols}; "
                    f"pass enable_categorical=True (or encode them "
                    f"numerically) — mirroring xgboost.DMatrix semantics.")
            if isinstance(self, _DistributedRayDMatrixLoader):
                raise ValueError(
                    "categorical columns cannot be auto-encoded under "
                    "distributed loading (per-shard category sets would "
                    "disagree); encode to integer codes and pass "
                    "feature_types, or use central loading.")
            if ftypes is None:
                ftypes = ["c" if c in cat_cols else "q" for c in x.columns]
            x = x.copy()
            categories: Dict[int, tuple] = {}
            col_pos = {c: i for i, c in enumerate(x.columns)}
            for c in cat_cols:
                as_cat = x[c].astype("category")
                categories[col_pos[c]] = tuple(as_cat.cat.categories.tolist())
                codes = as_cat.cat.codes.astype(np.float32)
                x[c] = codes.where(codes >= 0, np.nan)  # -1 == missing
            self._resolved_categories = categories
        elif self.enable_categorical and ftypes is None:
            ftypes = ["q"] * len(x.columns)
        self._resolved_feature_types = ftypes
        return x


class _CentralRayDMatrixLoader(_RayDMatrixLoader):
    """The calling process loads the data once, then row-shards per rank
    (``matrix.py:320``)."""

    _fields: Optional[Dict[str, Optional[np.ndarray]]] = None

    def load_fields(self) -> Dict[str, Optional[np.ndarray]]:
        """Every row's fields, read once: the shards are views of them."""
        if self._fields is None:
            source = self.get_data_source()
            df = source.load_data(self.data, ignore=self.ignore, **self.kwargs)
            df = source.update_feature_names(df, None)
            self._fields = self._split_dataframe(df)
        return self._fields

    def load_data(self, num_actors: int, sharding: RayShardingMode,
                  ranks: Iterable[int]):
        """The shards of ``ranks`` only: {rank: fields}, and the row count."""
        if sharding == RayShardingMode.FIXED:
            raise ValueError(
                "RayShardingMode.FIXED pins files or partitions to ranks; "
                "pass file paths or a partition list (distributed loading), "
                "or use BATCH / INTERLEAVED.")
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


class _DistributedRayDMatrixLoader(_RayDMatrixLoader):
    """Each rank loads only its own files or partitions
    (``matrix.py:349-418``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # a rank's rows come from its files: an array cannot be aligned
        # with them, only a column name can (``matrix.py:533-538``)
        for field in ROW_FIELDS:
            val = getattr(self, field)
            if val is not None and not isinstance(val, str):
                raise ValueError(
                    f"Distributed data loading only works with column names "
                    f"for `{field}`, got {type(val)}. Pass the name of the "
                    f"column in your data files, or use central loading "
                    f"(`distributed=False`)."
                )
        self.actor_shards: Optional[Dict[int, List[Any]]] = None

    def _expand(self) -> Any:
        """A directory -> its files (recursively, sorted); a glob of more
        than one file -> the files; anything else as given."""
        data = self.data
        if isinstance(data, str) and os.path.isdir(data):
            files = sorted(glob.glob(os.path.join(data, "**", "*"),
                                     recursive=True))
            return [f for f in files if os.path.isfile(f)]
        if isinstance(data, str):
            hits = sorted(glob.glob(data))
            if len(hits) > 1:
                return hits
        return data

    def get_data_source(self) -> type:
        if self.data_source is None:
            self.data = self._expand()
        return super().get_data_source()

    def load_shard(self, rank: int, num_actors: int,
                   sharding: RayShardingMode) -> Dict[str, Optional[np.ndarray]]:
        source = self.get_data_source()
        if sharding == RayShardingMode.FIXED:
            if self.actor_shards is None:
                self.assign_shards(num_actors)
            indices = self.actor_shards.get(rank, [])
        else:
            n_parts = source.get_n(self.data)
            if num_actors > n_parts:
                raise RuntimeError(
                    f"Trying to shard {n_parts} files/partitions across "
                    f"{num_actors} actors: use fewer actors or central "
                    f"loading."
                )
            indices = list(range(n_parts))[
                _get_sharding_indices(sharding, rank, num_actors, n_parts)]
        df = source.load_data(self.data, ignore=self.ignore, indices=indices,
                              **self.kwargs)
        df = source.update_feature_names(df, None)
        return self._split_dataframe(df)

    def assign_shards(self, num_actors: int) -> None:
        """FIXED sharding: the locality assignment of files or partitions
        to ranks (``matrix.py:595-612``, ``_distributed.py``); a
        distributed frame source assigns its own partitions."""
        source = self.get_data_source()
        _, assignment = source.get_actor_shards(self.data,
                                                list(range(num_actors)))
        if assignment:
            self.actor_shards = assignment
            return
        hosts = get_actor_rank_hosts(num_actors)
        self.actor_shards = assign_partitions_to_actors(
            {"localhost": list(range(source.get_n(self.data)))}, hosts)


class RayDMatrix:
    """Data handle (API of ``xgboost_ray_tpu.RayDMatrix``). Lazy by default:
    ``train()`` / ``predict()`` load it with their actor count, each rank
    (``RayXGBoostActor.load_data``) its own shard."""

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
        filetype: Optional[RayFileType] = None,
        ignore: Optional[List[str]] = None,
        distributed: Optional[bool] = None,
        sharding: RayShardingMode = RayShardingMode.INTERLEAVED,
        lazy: bool = False,
        stream: bool = False,
        **kwargs,
    ):
        if qid is not None and weight is not None:
            raise NotImplementedError("per-group weight is not implemented.")
        if stream or any(k in kwargs for k in _STREAM_KWARGS):
            raise _not_in_slice("stream=True")
        if kwargs.get("group") is not None:
            raise ValueError(
                "`group` parameter is not supported; use `qid` instead.")
        kwargs.pop("group", None)
        if distributed is None:
            distributed = self._can_load_distributed(data)
        elif distributed and not self._can_load_distributed(data):
            raise ValueError(
                f"Distributed loading is not supported for data of type "
                f"{type(data)}; pass file paths or partition lists."
            )
        self.distributed = bool(distributed)
        loader_cls = (_DistributedRayDMatrixLoader if self.distributed
                      else _CentralRayDMatrixLoader)
        self.loader = loader_cls(
            data, label=label, weight=weight, base_margin=base_margin,
            missing=missing, feature_names=feature_names, filetype=filetype,
            ignore=ignore, label_lower_bound=label_lower_bound,
            label_upper_bound=label_upper_bound, qid=qid,
            feature_types=feature_types,
            enable_categorical=bool(enable_categorical), **kwargs)
        source = self.loader.get_data_source()
        if kwargs and source.get_filetype(self.loader.data) is None \
                and filetype is None:
            # reader options go to the file readers; elsewhere they would
            # be dropped unread
            raise _not_in_slice(", ".join(sorted(kwargs)))
        self.feature_names = feature_names
        self.feature_types = feature_types
        self._feature_weights = feature_weights
        self.missing = missing
        self.num_actors = num_actors
        self.sharding = sharding
        if self.distributed and source.__name__ in ("Modin", "Dask",
                                                     "RayDataset"):
            # distributed frames pin their partitions to ranks
            self.sharding = RayShardingMode.FIXED
        self.refs: Dict[int, Dict[str, Optional[np.ndarray]]] = {}
        self.n: Optional[int] = None
        self.loaded = False
        if num_actors is not None and not lazy:
            self.load_data(num_actors)

    @property
    def feature_weights(self) -> Optional[np.ndarray]:
        """Per-feature weights of the column-sampling draws (length
        n_features) as float32, or None (``matrix.py:534``); the engine
        checks them."""
        if self._feature_weights is None:
            return None
        return np.asarray(self._feature_weights, dtype=np.float32).ravel()

    @staticmethod
    def _can_load_distributed(data: Data) -> bool:
        if isinstance(data, str):
            # one CSV cannot be split by rank; a Parquet file can, and
            # directories expand to files (``matrix.py:1036-1060``)
            return data.endswith(".parquet") or os.path.isdir(data)
        if isinstance(data, (list, tuple)) and data:
            return True  # file or partition list
        if hasattr(data, "__partitioned__"):
            return True
        return any(source.supports_distributed_loading
                   and source.is_data_type(data, None)
                   for source in data_sources)

    def assert_enough_shards_for_actors(self, num_actors: int) -> None:
        """Distributed loading: fail fast when there are fewer files or
        partitions than actors (``matrix.py:563``)."""
        if not self.distributed:
            return
        n_shards = self.loader.get_data_source().get_n(self.loader.data)
        if num_actors > n_shards:
            raise RuntimeError(
                f"Trying to shard data for {num_actors} actors, but it only "
                f"has {n_shards} files/partitions. Use fewer actors, "
                f"re-partition, or pass `distributed=False` for centralized "
                f"row sharding."
            )

    def assign_shards_to_actors(self, num_actors: int) -> bool:
        """FIXED sharding of distributed data: assign the files or
        partitions to the ranks before they load (``matrix.py:595-612``)."""
        if self.sharding != RayShardingMode.FIXED or not self.distributed:
            return False
        if self.loader.actor_shards is None:
            self.loader.assign_shards(num_actors)
        return True

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
        if self.distributed:
            for rank in todo:
                self.refs[rank] = self.loader.load_shard(
                    rank, self.num_actors, self.sharding)
        else:
            refs, self.n = self.loader.load_data(self.num_actors,
                                                 self.sharding, todo)
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

    @property
    def resolved_feature_types(self) -> Optional[List[str]]:
        """Per-feature types ('c' categorical, 'q' numeric): the user's
        ``feature_types``, or those of the loaded frame's encoded
        columns."""
        if self.feature_types:
            return list(self.feature_types)
        return self.loader._resolved_feature_types

    @property
    def resolved_categories(self) -> Optional[Dict[int, tuple]]:
        """Column index -> category values of the auto-encoded columns (the
        mapping eval sets and predict frames are translated onto)."""
        return self.loader._resolved_categories

    @property
    def has_label(self) -> bool:
        return self.loader.label is not None


class RayQuantileDMatrix(RayDMatrix):
    """RayDMatrix under the reference's name (``matrix.py:971-975``): every
    matrix of the port is quantile-binned on the device."""


class RayDeviceQuantileDMatrix(RayDMatrix):
    """RayDMatrix with a ``max_bin`` (``matrix.py:977-1033``): ``train()``
    bins with it unless its params name another ``max_bin``, which wins
    with a warning."""

    def __init__(self, *args, max_bin: Optional[int] = None, **kwargs):
        self.max_bin = max_bin
        super().__init__(*args, **kwargs)
