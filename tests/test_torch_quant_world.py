"""``train()`` with quantized gradients and the quantized histogram wire in
a 2-rank gloo world against the JAX package at ``num_actors`` 2, and the
tree path's bytes a round.

Each rank holds its INTERLEAVED shard, which is one device block of the
reference's layout, so B10's draws are the reference's; the wire rounds
what each rank holds, as each of the reference's actors does. Tolerances
as ``tests/test_torch_quant_train.py`` (C9): structure exactly, statistics
within 5e-5 relative, the history within 1e-6. Quantized gradients with
an exact merge are the same sums however the rows lie, so those runs also
fold both actors onto one rank (``num_actors=2`` at world 1) against the
same reference run (GOSS grows on f32 values, summed per rank: not
folded).

Bytes. ``hist_allreduce_bytes_per_round`` equals the reference's but for
one itemised term: the port merges each level's children's row counts as
int64 inside K3 (8 bytes a node; the reference's f32 counts ride its
packed [n, 3] side-psum or their own psum, 4 bytes a node), and needs no
count column at a root whose histogram takes the quantized wire.
"""

import numpy as np
import pytest
import torch

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu_torch import distributed as D
from xgboost_ray_tpu_torch.ops.histogram import wire_quantized
from test_torch_quant_train import BASE, _data, assert_same_model

#: depth 2 (a root and one level of siblings): the JAX compiles of depth 3
#: at two actors would take this file past its time
WBASE = dict(BASE, max_depth=2)


@pytest.fixture(scope="module")
def world():
    with D.World(2, "cpu") as w:
        # the ranks boot and import the port's modules outside any test
        w.run(D._hist_wire_rank, torch.zeros((2, 1, 1, 3, 2)).share_memory_(),
              "int8", 0, 64)
        yield w


def _count_bytes(params, n_features, nbt, rounds_trees=1):
    """The port's extra count bytes a tree at world 2 (ring factor 1):
    4 more a node for the children's counts of every level below the
    root, 12 fewer at a root on the quantized wire (its count column)."""
    depth = params["max_depth"]
    extra = sum(4 * (1 << d) for d in range(1, depth))
    if wire_quantized(params.get("hist_quant", "none"),
                      n_features * nbt * 2,
                      params.get("hist_quant_min_bytes", 32768)):
        extra -= 4
    return extra * rounds_trees


def _run(world, params, data, rounds=2, keep=None, fold=False, **jkw):
    """(port at 2 ranks, reference at num_actors 2[, port folded on one
    rank]) as (booster, history, additional results)."""
    shared = D.share(data)
    out = world.run(D._train_rank, shared, params, rounds,
                    {"device": "cpu", **(keep or {})})
    tb = tx.RayXGBoostBooster.load_raw(out[0]["model"])
    assert out[0]["model"] == out[1]["model"]
    ref_dm = jx.RayDMatrix(data["x"], data["label"], **jkw)
    jev, jextra = {}, {}
    jb = jx.train(params, ref_dm, rounds, evals=[(ref_dm, "train")],
                  evals_result=jev, additional_results=jextra,
                  ray_params=jx.RayParams(num_actors=2))
    res = [(tb, out[0]["evals_result"], out[0]["additional_results"]),
           (jb, jev, jextra)]
    if fold:
        dm = tx.RayDMatrix(data["x"], data["label"], **jkw)
        ev = {}
        fb = tx.train(params, dm, rounds, evals=[(dm, "train")],
                      evals_result=ev, device="cpu",
                      ray_params=tx.RayParams(num_actors=2))
        res.append((fb, ev, None))
    return res


def _same(res, metric="logloss"):
    (tb, tev, _), (jb, jev, _) = res[:2]
    assert_same_model(tb, jb)
    np.testing.assert_allclose(tev["train"][metric], jev["train"][metric],
                               rtol=1e-6, atol=1e-7)
    if len(res) > 2:  # the fold onto one rank: the same integer sums
        assert res[2][0].get_dump(with_stats=True) == tb.get_dump(
            with_stats=True)


WORLD_CONFIGS = {
    "gh_int8": ({"gh_precision": "int8"}, True),
    "wire_int8": ({"hist_quant": "int8"}, False),
    "wire_int8_block": ({"hist_quant": "int8_block"}, False),
    "gh_int8_wire_int8_block": ({"gh_precision": "int8",
                                 "hist_quant": "int8_block"}, False),
    "gh_int8_goss": ({"gh_precision": "int8",
                      "sampling_method": "gradient_based", "top_rate": 0.2,
                      "other_rate": 0.2}, False),
}


@pytest.mark.parametrize("name", list(WORLD_CONFIGS))
def test_world_matches_jax(world, name):
    extra, fold = WORLD_CONFIGS[name]
    params = dict(WBASE, **extra)
    x, y = _data(241)  # odd: the second block holds a padding row
    res = _run(world, params, {"x": x, "label": y}, fold=fold)
    _same(res)
    port, ref = res[0][2], res[1][2]
    assert port["gh_plane_bytes_per_shard"] == ref["gh_plane_bytes_per_shard"]
    assert (port["hist_allreduce_bytes_per_round"]
            - ref["hist_allreduce_bytes_per_round"]
            == _count_bytes(params, x.shape[1], params["max_bin"] + 1))


def test_world_ranking_int8_gh(world):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((240, 4)).astype(np.float32)
    rel = np.clip(np.round(x[:, 0] + rng.standard_normal(240)), 0, 3)
    qid = np.repeat(np.arange(24), 10)
    params = dict(WBASE, objective="rank:ndcg", eval_metric=["ndcg@5"],
                  gh_precision="int8")
    res = _run(world, params, {"x": x, "label": rel.astype(np.float32),
                               "qid": qid}, qid=qid)
    _same(res, "ndcg@5")


def test_world_categorical_int8_wire(world):
    rng = np.random.default_rng(5)
    n = 240
    codes = rng.integers(0, 6, n).astype(np.float32)
    num = rng.standard_normal(n).astype(np.float32)
    x = np.stack([codes, num], axis=1)
    y = ((codes % 3 == 0) ^ (num > 0.3)).astype(np.float32)
    params = dict(WBASE, hist_quant="int8")
    res = _run(world, params, {"x": x, "label": y},
               keep={"feature_types": ["c", "q"]}, feature_types=["c", "q"])
    _same(res)
