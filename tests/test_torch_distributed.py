"""The port's data-parallel ranks (``xgboost_ray_tpu_torch/distributed.py``)
on the CPU: gloo worlds of rank processes against the JAX package.

One 2-rank and one 3-rank world serve the whole module (a spawn costs a few
seconds); every rank runs a function of the port's package. Tolerances:

- at ``num_actors=2`` the port's ranks sum each histogram over their own
  rows and merge by all-reduce, the JAX package sums per device and
  ``psum``s, and a 2-rank sum is ``a + b`` either way: cuts, bins and
  ``get_dump()`` are bitwise, the eval history within 1e-7 (the metric
  partials are float32 sums of the same rows taken in another order);
- the port's worlds 1, 2 and 3 predict within atol 1e-5 (the f32 histogram
  sums are associated per rank), as
  ``tests/test_engine.py::test_world_size_invariance`` holds the reference.

The card's fixed-point sums make worlds bitwise equal; that is held on the
card (``tests/test_torch_cuda.py``), the fixed-point plain functions here
in ``tests/test_torch_histogram.py``.
"""

import numpy as np
import pytest
import torch
from sklearn.datasets import load_breast_cancer, load_diabetes

import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu.engine import TpuEngine
from xgboost_ray_tpu.params import parse_params as jax_parse_params
from xgboost_ray_tpu_torch import distributed as D
from xgboost_ray_tpu_torch import main as tmain
from xgboost_ray_tpu_torch.matrix import RayShardingMode, combine_data
from xgboost_ray_tpu_torch.ops import histogram as th

README_PARAMS = {"objective": "binary:logistic",
                 "eval_metric": ["logloss", "error"]}
SQ_PARAMS = {"objective": "reg:squarederror", "eval_metric": "rmse",
             "max_depth": 4, "eta": 0.2}
#: the reference's world-size invariance config (tests/test_engine.py)
ONE_HOT_PARAMS = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.5,
                  "eval_metric": ["logloss", "error"], "reg_lambda": 0.0,
                  "min_child_weight": 0.0}


@pytest.fixture(scope="module")
def worlds():
    """Both worlds, started together (their ranks boot in parallel)."""
    with D.World(2, "cpu") as w2, D.World(3, "cpu") as w3:
        yield {2: w2, 3: w3}


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[2]


@pytest.fixture(scope="module")
def world3(worlds):
    return worlds[3]


def _cancer():
    d = load_breast_cancer()
    return d.data.astype(np.float32), d.target.astype(np.float32)


def _diabetes():
    d = load_diabetes()
    return d.data.astype(np.float32), d.target.astype(np.float32)


def _jax_engine(params, x, y, num_actors, rounds):
    """The JAX engine at ``num_actors`` on INTERLEAVED shards (what
    ``RayDMatrix`` gives each rank): (engine, eval history)."""
    shards = [{"data": x[r::num_actors], "label": y[r::num_actors]}
              for r in range(num_actors)]
    eng = TpuEngine(shards, jax_parse_params(params), num_actors=num_actors,
                    evals=[(shards, "train")])
    hist = {}
    for i in range(rounds):
        for name, v in eng.step(i)["train"].items():
            hist.setdefault(name, []).append(v)
    return eng, hist


def _rank_margins(out, sharding=RayShardingMode.INTERLEAVED):
    return combine_data(sharding, [o["margins"] for o in out])


@pytest.fixture(scope="module")
def readme_world2(world2):
    x, y = _cancer()
    eng, hist = _jax_engine(README_PARAMS, x, y, 2, 10)  # while ranks boot
    out = world2.run(D._train_rank, D.share({"x": x, "label": y}),
                     README_PARAMS, 10, {"device": "cpu", "keep_bins": True})
    return x, out, eng, hist


def test_world2_readme_matches_jax_at_two_actors(readme_world2):
    x, out, eng, hist = readme_world2
    bst = tx.RayXGBoostBooster.load_raw(out[0]["model"])
    jb = eng.get_booster()
    assert np.array_equal(out[0]["cuts"], np.asarray(eng.cuts))
    assert np.array_equal(np.concatenate([o["bins"] for o in out]),
                          np.asarray(eng.bins)[:x.shape[0]])
    assert bst.get_dump() == jb.get_dump()
    assert bst.get_dump(with_stats=True) == jb.get_dump(with_stats=True)
    for metric in ("logloss", "error"):
        np.testing.assert_allclose(out[0]["evals_result"]["train"][metric],
                                   hist[metric], rtol=0, atol=1e-7)


def test_world2_ranks_agree_and_report(readme_world2):
    _, out, _, _ = readme_world2
    assert out[0]["model"] == out[1]["model"]
    assert out[0]["evals_result"] == out[1]["evals_result"]
    extra = out[0]["additional_results"]
    assert extra["world_size"] == 2 and extra["backend"] == "gloo"
    assert extra["train_n"] == 569
    assert extra["allreduce_bytes_per_round"] > 0
    # each rank kept its own shard's rows only
    assert [o["bins"].shape[0] for o in out] == [285, 284]


def test_world2_squarederror_matches_jax(world2):
    x, y = _diabetes()
    out = world2.run(D._train_rank, D.share({"x": x, "label": y}), SQ_PARAMS,
                     5, {"device": "cpu"})
    eng, hist = _jax_engine(SQ_PARAMS, x, y, 2, 5)
    bst = tx.RayXGBoostBooster.load_raw(out[0]["model"])
    assert bst.get_dump() == eng.get_booster().get_dump()
    np.testing.assert_allclose(out[0]["evals_result"]["train"]["rmse"],
                               hist["rmse"], rtol=1e-7, atol=0)


def _one_hot_fixture():
    eye = np.eye(4, dtype=np.float32)
    x = np.concatenate([np.tile(eye[[0, 1]], (8, 1)),
                        np.tile(eye[[2, 3]], (8, 1))])
    y = np.concatenate([np.tile([1.0, 0.0], 8),
                        np.tile([1.0, 0.0], 8)]).astype(np.float32)
    perm = np.random.RandomState(0).permutation(x.shape[0])
    return x[perm], y[perm]


def test_world_size_invariance(world2, world3):
    x, y = _one_hot_fixture()
    dm = tx.RayDMatrix(x, y)
    with pytest.warns(UserWarning):
        one = tx.train(ONE_HOT_PARAMS, dm, 10, device="cpu",
                       ray_params=tx.RayParams(num_actors=1))
    preds = [one.predict(x, device="cpu")]
    for w in (world2, world3):
        out = w.run(D._train_rank, D.share({"x": x, "label": y}),
                    ONE_HOT_PARAMS, 10, {"device": "cpu"})
        preds.append(tx.RayXGBoostBooster.load_raw(out[0]["model"]).predict(
            x, device="cpu"))
    np.testing.assert_allclose(preds[0], preds[1], atol=1e-5)
    np.testing.assert_allclose(preds[0], preds[2], atol=1e-5)


def _tree_bytes(f, nbt, depth, itemsize):
    """Per-rank bytes at world 2 (ring factor 1) of one tree's merges:
    every level's histogram (the root's, then each parent's smaller child),
    the per-child row counts of each level that has a next one (int64), the
    final totals."""
    hist = f * nbt * 2 * itemsize * (1 + sum(1 << (d - 1)
                                             for d in range(1, depth)))
    counts = sum(2 * (1 << d) * 8 for d in range(depth - 1))
    return hist + counts + (1 << depth) * 2 * itemsize


def test_allreduce_bytes_of_a_known_tree(readme_world2):
    """The README flow's trees are full (depth 6, every level built): the
    ring bytes of one round are its f32 merges plus the four f64 metric
    partials (the card's int64 payload: ``tests/test_torch_cuda.py``)."""
    x, out, _, _ = readme_world2
    f, nbt, depth = x.shape[1], 257, 6
    metrics = 4 * 8
    for o in out:
        assert o["additional_results"]["allreduce_bytes_per_round"] == (
            _tree_bytes(f, nbt, depth, 4) + metrics)
    counter = th.AllreduceBytes(3)
    counter.add_allreduce(torch.zeros(30, dtype=torch.int64))
    assert counter.total == int(2 * 2 * 240 / 3)
    assert th.AllreduceBytes(1).n == 1


def test_spawned_train_folds_actors_onto_ranks(readme_world2):
    """``train``'s spawn path (NCCL on a host of two or more cards) through
    gloo on the CPU: ``train()`` inside a spawned 2-rank world with four
    actors' shards, two a rank; rank 0's booster, the world's report, and
    the cuts of the 2-actor world (the sketch's counts are exact)."""
    x, out, _, _ = readme_world2
    y = np.asarray(load_breast_cancer().target, np.float32)
    opts = dict(eval_names=["train"], num_boost_round=3, verbose_eval=False,
                callbacks=[])
    bst, ev, stats = tmain._train_spawned(tx.RayDMatrix(x, y), README_PARAMS,
                                          4, 2, "cpu", opts)
    assert stats["world_size"] == 2 and stats["backend"] == "gloo"
    assert stats["train_n"] == x.shape[0] and len(ev["train"]["logloss"]) == 3
    assert bst.num_boosted_rounds() == 3
    ref = tx.RayXGBoostBooster.load_raw(out[0]["model"])
    assert np.array_equal(bst.cuts, ref.cuts)
    with pytest.raises(ValueError, match="picklable"):
        tmain._train_spawned(tx.RayDMatrix(x, y), README_PARAMS, 4, 2, "cpu",
                             dict(opts, callbacks=[lambda *a: None]))


def test_world_folds_actor_shards_onto_ranks(world2):
    """Inside a world of 2 with four actors, rank r trains on the shards of
    actors 2r and 2r + 1, concatenated in rank order."""
    x, y = _cancer()
    out = world2.run(D._train_rank, D.share({"x": x, "label": y}),
                     README_PARAMS, 1, {"device": "cpu", "num_actors": 4,
                                        "keep_bins": True})
    assert out[0]["model"] == out[1]["model"]
    assert [o["bins"].shape[0] for o in out] == [
        len(x[0::4]) + len(x[1::4]), len(x[2::4]) + len(x[3::4])]
    rows = np.concatenate([np.arange(len(x))[r::4] for r in range(4)])
    bins = np.concatenate([o["bins"] for o in out])
    keep = D._KeepEngine()
    with pytest.warns(UserWarning):
        tx.train(README_PARAMS, tx.RayDMatrix(x[rows], y[rows]), 1,
                 device="cpu", callbacks=[keep],
                 ray_params=tx.RayParams(num_actors=1))
    assert np.array_equal(bins, keep.engine.bins.numpy())
    assert out[0]["additional_results"]["train_n"] == len(x)


def test_train_in_a_world_needs_num_actors_at_least_world(world2):
    x, y = _cancer()
    with pytest.raises(RuntimeError, match="num_actors>=2"):
        world2.run(D._train_rank, D.share({"x": x, "label": y}),
                   README_PARAMS, 1, {"device": "cpu", "num_actors": 1})


def test_backend_rule(monkeypatch):
    assert D.choose_backend(2, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert D.choose_backend(2, "cuda") == "nccl"
    assert D.choose_backend(3, "cuda") == "gloo"  # ranks share a card
    assert D.choose_backend(4, "cuda", local_world_size=2) == "nccl"
    assert D.choose_backend(2, "cpu") == "gloo"
    assert D.process_count() == 1 and D.process_index() == 0
    # None and "cuda" name the host's cards alike; "cuda:k" one card
    assert tmain._spawn_ranks(None, 4) == 2
    assert tmain._spawn_ranks("cuda", 4) == 2
    assert tmain._spawn_ranks("cuda:0", 4) == 1
    assert tmain._spawn_ranks(torch.device("cuda", 1), 4) == 1
    assert tmain._spawn_ranks("cpu", 4) == 1
    assert tmain._spawn_ranks(None, 1) == 1


def test_rank_loads_only_its_shard():
    x, y = _cancer()
    dm = tx.RayDMatrix(x, y, sharding=RayShardingMode.BATCH)
    dm.load_data(3, ranks=[1])
    assert sorted(dm.refs) == [1]
    (shard,) = dm.shards([1])
    assert np.array_equal(shard["data"], x[190:380])
    with pytest.raises(RuntimeError, match="not loaded"):
        dm.shards()
    dm.load_data(3)  # the rest, for a later whole-matrix use
    assert [s["data"].shape[0] for s in dm.shards()] == [190, 190, 189]
