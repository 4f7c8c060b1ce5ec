"""``booster="gblinear"`` in a 2-rank gloo world against the JAX package at
``num_actors=2`` (``tests/_torch_dart.py``'s configurations): each rank
holds its rows, B16's plain version sums them in its blocked order and one
all-reduce merges each coordinate's [2K] sums; weights and bias within
``LINEAR_RTOL``, the exact zeros where the reference's are zero, the history
and ``predict`` within 1e-5 (``_torch_dart.check_linear``), the two ranks'
models the same bytes. Without weights every rank takes the world's row
count as the weight sum; with weights, the world's weights gathered in
shard order."""

import numpy as np
import pytest

import _torch_dart as S
from xgboost_ray_tpu_torch import distributed as D
from xgboost_ray_tpu_torch import linear as TL


@pytest.fixture(scope="module")
def world2():
    with D.World(2, "cpu") as w:
        yield w


@pytest.mark.parametrize("name", sorted(S.LINEAR_CASES))
def test_train_matches_jax_two_ranks(name, world2):
    jb, jev = S.jax_linear(name, 2)
    tb, tev = S.port_linear(name, world2)
    assert isinstance(tb, TL.RayLinearBooster)
    S.check_linear(jb, jev, tb, tev)


def test_weighted_rows_two_ranks(world2):
    """Instance weights: the penalties' weight sum over the world's rows
    (each rank holds half) is the reference's ``np.sum``."""
    import warnings

    import xgboost_ray_tpu as jx

    x, y = S.XL[:S.N_TRAIN], S.YR[:S.N_TRAIN]
    w = np.random.default_rng(2).uniform(0.5, 2.0, S.N_TRAIN).astype(
        np.float32)
    params = dict(S.linear_params("squared_l1l2"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jb = jx.train(params, jx.RayDMatrix(x, y, weight=w), 5,
                      ray_params=jx.RayParams(num_actors=2))
    out = world2.run(D._train_rank,
                     D.share({"x": x, "label": y, "weight": w}), params, 5,
                     {"device": "cpu", "num_actors": 2})
    assert out[0]["model"] == out[1]["model"]
    tb = TL.RayLinearBooster.load_raw(out[0]["model"])
    np.testing.assert_allclose(tb.weights, jb.weights, rtol=0,
                               atol=S.LINEAR_RTOL * np.abs(jb.weights).max())
