"""``booster="dart"`` in a 2-rank gloo world against the JAX package at
``num_actors=2`` (``tests/_torch_dart.py``'s configurations): dumps with
stats and tree weights equal, the history and ``predict`` within 1e-6, the
two ranks' models the same bytes. The drops are host draws of (seed,
iteration), the same on every rank; B4w walks each rank's rows."""

import functools

import pytest

import _torch_dart as S
from xgboost_ray_tpu_torch import distributed as D


@pytest.fixture(scope="module")
def world2():
    with D.World(2, "cpu") as w:
        yield w


@functools.lru_cache(maxsize=None)
def _port(name, world):
    return S.port_dart(name, world)


@pytest.mark.parametrize("name", sorted(S.DART_CASES))
def test_train_matches_jax_two_ranks(name, world2):
    jb, jev = S.jax_dart(name, 2)
    tb, tev = _port(name, world2)
    S.check_dart(jb, jev, tb, tev)


@pytest.mark.parametrize("name", sorted(S.DART_CASES))
def test_predict_matches_jax_two_ranks(name, world2):
    S.check_dart_predict(S.jax_dart(name, 2)[0], _port(name, world2)[0])
