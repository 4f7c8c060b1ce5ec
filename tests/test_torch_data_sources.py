"""The port's file and partition data sources against the JAX package's.

Every source loads the arrays the JAX package loads, bitwise: CSV files
through the native parser and through pandas (each read counted by the
port's per-parser counter), Parquet files (pyarrow), partition lists
(``ObjectStore``), ``__partitioned__`` objects, each loaded centrally and
per rank under INTERLEAVED, BATCH and FIXED sharding, with ``ignore`` and
``filetype``; the locality assigner gives the JAX package's assignment on
the reference's even and uneven cases (``tests/test_data_source.py``);
``distributed=True`` over a 2-rank gloo world reads each rank's own files
and trains the JAX package's ``num_actors=2`` model; the modin, dask, Ray
Dataset and Petastorm sources are gated on their packages as the JAX
package's are.
"""

import sys
import types
import warnings

import numpy as np
import pandas as pd
import pytest

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from _torch_hooks import (
    RecordingCallback,
    logistic_objective,
    weighted_error,
)
from xgboost_ray_tpu.data_sources import _distributed as jd
from xgboost_ray_tpu_torch import distributed as D
from xgboost_ray_tpu_torch.data_sources import _distributed as td
from xgboost_ray_tpu_torch.data_sources.csv import read_csv_file

FIELDS = ("data", "label", "weight", "base_margin")
N_FILES, ROWS = 4, 100
PARAMS = {"objective": "binary:logistic", "eval_metric": ["logloss"],
          "max_depth": 3}


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():  # num_actors=1: "NOT be distributed"
        warnings.simplefilter("ignore", UserWarning)
        yield


def _frame(n=N_FILES * ROWS, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, 5)) * [1, 10, 100, 0.01, 3]).astype(np.float32)
    x[rng.random((n, 5)) < 0.05] = np.nan
    df = pd.DataFrame(x, columns=[f"f{i}" for i in range(5)])
    df["label"] = (np.nan_to_num(x[:, 0]) + 0.1 * np.nan_to_num(x[:, 1])
                   > 0).astype(np.float32)
    df["w"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return df


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The frame as N_FILES CSV and Parquet files of ROWS rows each."""
    root = tmp_path_factory.mktemp("files")
    df = _frame()
    out = {"frame": df, "csv": [], "parquet": [], "dir": str(root / "pq")}
    (root / "pq").mkdir()
    for i in range(N_FILES):
        part = df.iloc[i * ROWS:(i + 1) * ROWS]
        out["csv"].append(str(root / f"part{i}.csv"))
        part.to_csv(out["csv"][-1], index=False)
        out["parquet"].append(str(root / "pq" / f"part{i}.parquet"))
        part.to_parquet(out["parquet"][-1])
    return out


def _port_shards(dm, n):
    dm.load_data(n)
    return dm.shards()


def _jax_shards(dm, n):
    dm.load_data(n)
    dm.assign_shards_to_actors([None] * n)
    return [dm.get_data(r, n) for r in range(n)]


def _assert_same_shards(tdm, jdm, n):
    tsh, jsh = _port_shards(tdm, n), _jax_shards(jdm, n)
    assert len(tsh) == len(jsh)
    for t, j in zip(tsh, jsh):
        for k in FIELDS:
            if j[k] is None:
                assert t[k] is None, k
            else:
                assert np.array_equal(t[k], j[k], equal_nan=True), k
                assert t[k].dtype == j[k].dtype, k
    assert tdm.resolved_feature_names == jdm.resolved_feature_names


def _reset_reads():
    read_csv_file.reads.update(native=0, pandas=0)


def test_csv_native_parser_loads_jax_arrays(files):
    _reset_reads()
    tdm = tx.RayDMatrix(files["csv"], label="label", weight="w",
                        distributed=False)
    jdm = jx.RayDMatrix(files["csv"], label="label", weight="w",
                        distributed=False)
    _assert_same_shards(tdm, jdm, 2)
    assert read_csv_file.reads == {"native": N_FILES, "pandas": 0}


def test_csv_pandas_parser_loads_jax_arrays(files, monkeypatch):
    _reset_reads()
    # a reader option takes pandas in both packages
    tdm = tx.RayDMatrix(files["csv"], label="label", sep=",",
                        distributed=False)
    jdm = jx.RayDMatrix(files["csv"], label="label", sep=",",
                        distributed=False)
    _assert_same_shards(tdm, jdm, 3)
    assert read_csv_file.reads == {"native": 0, "pandas": N_FILES}
    _reset_reads()
    monkeypatch.setenv("RXGB_DISABLE_NATIVE_CSV", "1")
    dm = tx.RayDMatrix(files["csv"][:2], label="label", distributed=False)
    _port_shards(dm, 1)
    assert read_csv_file.reads == {"native": 0, "pandas": 2}


def test_native_parser_agrees_with_pandas(files):
    native = tx.RayDMatrix(files["csv"], label="label", distributed=False)
    pandas = tx.RayDMatrix(files["csv"], label="label", sep=",",
                           distributed=False)
    a, b = _port_shards(native, 1)[0], _port_shards(pandas, 1)[0]
    for k in ("data", "label"):
        assert np.array_equal(a[k], b[k], equal_nan=True)


@pytest.mark.parametrize("kind", ["csv", "parquet"])
@pytest.mark.parametrize("sharding", ["INTERLEAVED", "BATCH", "FIXED"])
def test_distributed_file_shards_match_jax(files, kind, sharding):
    _reset_reads()
    kw = dict(label="label", weight="w", ignore=["f2"])
    tdm = tx.RayDMatrix(files[kind], sharding=tx.RayShardingMode[sharding],
                        **kw)
    jdm = jx.RayDMatrix(files[kind], sharding=jx.RayShardingMode[sharding],
                        **kw)
    assert tdm.distributed and jdm.distributed
    _assert_same_shards(tdm, jdm, 2)
    assert "f2" not in tdm.resolved_feature_names
    if kind == "csv":
        assert read_csv_file.reads["native"] == N_FILES


def test_directory_and_filetype(files, tmp_path):
    # a directory reads its files in sorted order (the JAX package resolves
    # the source before it expands a directory, so it is given the list)
    tdm = tx.RayDMatrix(files["dir"], label="label")
    jdm = jx.RayDMatrix(sorted(files["parquet"]), label="label")
    _assert_same_shards(tdm, jdm, 2)
    with pytest.raises(ValueError, match="Unable to infer"):
        jx.RayDMatrix(files["dir"], label="label").get_data(0, 1)
    # a file type named where the paths have no extension
    plain = []
    for i, src in enumerate(files["csv"][:2]):
        plain.append(str(tmp_path / f"part{i}.txt"))
        with open(src) as f, open(plain[-1], "w") as g:
            g.write(f.read())
    tdm = tx.RayDMatrix(plain, label="label", filetype=tx.RayFileType.CSV)
    jdm = jx.RayDMatrix(plain, label="label", filetype=jx.RayFileType.CSV)
    _assert_same_shards(tdm, jdm, 2)


def _partitions(df, n=N_FILES):
    return [df.iloc[i * ROWS:(i + 1) * ROWS].reset_index(drop=True)
            for i in range(n)]


class _Partitioned:
    """An object of the ``__partitioned__`` protocol over frames."""

    def __init__(self, parts):
        self.__partitioned__ = {
            "partitions": {(i,): {"start": (i * ROWS,), "shape": p.shape,
                                  "data": p} for i, p in enumerate(parts)},
            "get": lambda ref: ref}


@pytest.mark.parametrize("kind", ["object_store", "partitioned"])
@pytest.mark.parametrize("sharding", ["INTERLEAVED", "BATCH", "FIXED"])
def test_partition_sources_match_jax(files, kind, sharding):
    parts = _partitions(files["frame"])
    src = parts if kind == "object_store" else _Partitioned(parts)
    tdm = tx.RayDMatrix(src, label="label",
                        sharding=tx.RayShardingMode[sharding])
    jdm = jx.RayDMatrix(src, label="label",
                        sharding=jx.RayShardingMode[sharding])
    _assert_same_shards(tdm, jdm, 2)
    central_t = tx.RayDMatrix(src, label="label", distributed=False)
    central_j = jx.RayDMatrix(src, label="label", distributed=False)
    _assert_same_shards(central_t, central_j, 3)


def test_too_few_files_and_column_names_raise(files):
    for pkg in (tx, jx):
        dm = pkg.RayDMatrix(files["csv"][:3], label="label")
        with pytest.raises(RuntimeError, match="only has 3"):
            dm.assert_enough_shards_for_actors(4)
        with pytest.raises(ValueError, match="column names"):
            pkg.RayDMatrix(files["csv"], label=np.zeros(N_FILES * ROWS))
        with pytest.raises(ValueError, match="Distributed loading is not"):
            pkg.RayDMatrix(np.zeros((4, 2)), distributed=True)


def _scenarios():
    """The reference's grid (``tests/test_data_source.py:38-166``):
    (partition hosts, actor hosts)."""
    return [
        ([0, 0, 1, 1, 2, 2, 3, 3], [0, 1, 2, 3]),
        ([0, 0, 0, 1, 1, 1, 2, 2], [0, 0, 1, 2]),
        ([0, 0, 0, 0, 0, 0, 0, 0], [0, 1, 2, 3]),
        ([0, 0, 0, 1, 1, 2, 2, 2], [0, 1, 2]),
        ([0, 0, 1, 1, 1, 1, 2, 3], [0, 1, 2]),
        ([0, 0, 0, 0, 0, 0, 0], [0, 0, 1]),
        ([1, 1, 1, 1, 0, 0, 0], [1, 1, 2]),
        ([0] * 10, [0] * 4),
        ([0] * 6 + [], [0, 1, 1]),
    ]


@pytest.mark.parametrize("part_nodes,actor_nodes", _scenarios())
def test_assign_partitions_matches_jax(part_nodes, actor_nodes):
    host_to_parts = {}
    for part, node in enumerate(part_nodes):
        host_to_parts.setdefault(f"node{node}", []).append(part)
    actors = {rank: f"node{node}" for rank, node in enumerate(actor_nodes)}
    out = td.assign_partitions_to_actors(host_to_parts, actors)
    assert out == jd.assign_partitions_to_actors(host_to_parts, actors)
    assert sorted(p for v in out.values() for p in v) == list(
        range(len(part_nodes)))
    sizes = [len(v) for v in out.values()]
    assert max(sizes) - min(sizes) <= 1
    assert td.get_actor_rank_hosts(len(actor_nodes)) == \
        jd.get_actor_rank_hosts(len(actor_nodes))


# ------------------------------------------------- distributed=True, 2 ranks


def _jax_files_train(files, **kw):
    dm = jx.RayDMatrix(files["csv"], label="label", weight="w")
    ev = {}
    bst = jx.train(PARAMS, dm, 3, evals=[(dm, "train")], evals_result=ev,
                   ray_params=jx.RayParams(num_actors=2), **kw)
    return bst, ev


@pytest.fixture(scope="module")
def jax_files_model(files):
    return _jax_files_train(files)


@pytest.fixture(scope="module")
def jax_files_custom(files):
    return _jax_files_train(files, obj=logistic_objective, feval=weighted_error)


def test_jax_reference_reads_its_files(jax_files_model, files):
    bst, ev = jax_files_model
    assert bst.num_boosted_rounds() == 3
    assert ev["train"]["logloss"][-1] < ev["train"]["logloss"][0]


@pytest.fixture(scope="module")
def world2():
    with D.World(2, "cpu") as world:
        yield world


def _world_files_train(world, files, **options):
    return world.run(
        D._train_rank, {"source": files["csv"], "label": "label",
                        "weight": "w"}, PARAMS, 3,
        {"device": "cpu", **options})


@pytest.fixture(scope="module")
def world_files_run(world2, files):
    return _world_files_train(world2, files,
                              distributed_callbacks=[RecordingCallback()])


def test_distributed_files_over_two_gloo_ranks(world_files_run,
                                               jax_files_model, files):
    bst, ev = jax_files_model
    for rank, o in enumerate(world_files_run):
        model = tx.RayXGBoostBooster.load_raw(o["model"])
        assert model.get_dump() == bst.get_dump()
        np.testing.assert_allclose(o["evals_result"]["train"]["logloss"],
                                   ev["train"]["logloss"], rtol=0, atol=1e-6)
        # rank r read its INTERLEAVED files only: r and r + 2
        assert len(o["margins"]) == 2 * ROWS
        assert o["additional_results"]["world_size"] == 2
        assert o["additional_results"]["train_n"] == N_FILES * ROWS


def test_each_rank_fires_its_own_hooks(world_files_run):
    for rank, o in enumerate(world_files_run):
        calls = o["distributed_callbacks"][0].calls
        assert calls == (
            [("on_init", rank), ("before_data_loading", rank),
             ("after_data_loading", rank), ("before_train", rank)]
            + [("after_round", rank, i) for i in range(3)]
            + [("after_train", rank)])


def test_custom_objective_and_metric_over_two_gloo_ranks(
        world2, files, jax_files_custom):
    """Each rank's objective takes its own rows; each rank's metric value
    is combined as a weighted mean: the JAX package's ``num_actors=2``
    model and history."""
    bst, ev = jax_files_custom
    out = _world_files_train(world2, files, obj=logistic_objective,
                             feval=weighted_error)
    for o in out:
        assert tx.RayXGBoostBooster.load_raw(o["model"]).get_dump() == \
            bst.get_dump()
        for metric in ("logloss", "werror"):
            np.testing.assert_allclose(o["evals_result"]["train"][metric],
                                       ev["train"][metric], rtol=0, atol=1e-6)
        assert o["launches"] == out[0]["launches"]


def test_device_quantile_matrix_max_bin():
    df = _frame(200)
    x, y = df[[f"f{i}" for i in range(5)]].to_numpy(), df["label"].to_numpy()
    dm = tx.RayDeviceQuantileDMatrix(x, y, max_bin=16)
    bst = tx.train({"objective": "binary:logistic"}, dm, 1, device="cpu",
                   ray_params=tx.RayParams(num_actors=1))
    assert bst.params.max_bin == 16
    assert isinstance(tx.RayQuantileDMatrix(x, y), tx.RayDMatrix)
    bst = tx.train({"objective": "binary:logistic", "max_bin": 8},
                   tx.RayDeviceQuantileDMatrix(x, y, max_bin=16), 1,
                   device="cpu", ray_params=tx.RayParams(num_actors=1))
    assert bst.params.max_bin == 8


# ----------------------------------------------------------- gated sources


class _FakeModinFrame:
    """Duck-typed stand-in for modin.pandas.DataFrame."""

    def __init__(self, df, npartitions=4):
        self._df = df
        self._npartitions = npartitions

    def _to_pandas(self):
        return self._df

    def __len__(self):
        return len(self._df)

    def partitions(self):
        return _partitions(self._df, self._npartitions)


@pytest.fixture
def fake_modin():
    names = ["modin", "modin.pandas", "modin.distributed",
             "modin.distributed.dataframe",
             "modin.distributed.dataframe.pandas"]
    mods = {n: types.ModuleType(n) for n in names}
    mods["modin.pandas"].DataFrame = _FakeModinFrame
    mods["modin.pandas"].Series = type("Series", (), {})
    mods["modin.distributed.dataframe.pandas"].unwrap_partitions = (
        lambda data, axis=0: data.partitions())
    for n in names:
        assert n not in sys.modules
        sys.modules[n] = mods[n]
    yield
    for n in names:
        sys.modules.pop(n, None)


@pytest.mark.parametrize("source", ["Modin", "Dask", "RayDataset",
                                    "Petastorm"])
def test_gated_sources_raise_as_jax(source):
    import xgboost_ray_tpu.data_sources as jds
    import xgboost_ray_tpu_torch.data_sources as tds

    frame = _FakeModinFrame(_frame(40))
    url = "s3://bucket/part0.parquet"
    for obj in (frame, url):
        assert getattr(tds, source).is_data_type(obj) is \
            getattr(jds, source).is_data_type(obj) is False
    for pkg in (tx, jx):
        with pytest.raises(ValueError, match="Unable to infer data source"):
            pkg.RayDMatrix(frame, label="label").load_data(1)


def test_modin_source_with_its_package(fake_modin):
    df = _frame()
    tdm = tx.RayDMatrix(_FakeModinFrame(df), label="label")
    jdm = jx.RayDMatrix(_FakeModinFrame(df), label="label")
    assert tdm.distributed and tdm.sharding == tx.RayShardingMode.FIXED
    _assert_same_shards(tdm, jdm, 2)
