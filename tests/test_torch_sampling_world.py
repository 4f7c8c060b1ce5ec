"""The port's sampled ``train()`` in a 2-rank gloo world against the JAX
package at ``num_actors=2`` (``tests/_torch_sampling.py``'s
configurations). Each rank draws its own block of the reference's layout
(2,001 rows: the second block holds 1,000 rows and a padding slot, which
competes in the draws and, where drawn, is grown as a zero-gradient row of
missing bins). Tolerances as in ``tests/test_torch_sampling_train.py``; the
two ranks' models are the same bytes.
"""

import pytest

import _torch_sampling as S
from xgboost_ray_tpu_torch import distributed as D


@pytest.fixture(scope="module")
def world2():
    with D.World(2, "cpu") as w:
        yield w


@pytest.mark.parametrize("name", list(S.CASES))
def test_train_matches_jax_two_actors(name, world2):
    jb, jev = S.jax_train(name, 2)
    tb, tev = S.port_train(name, 2, world2)
    S.check_pair(jb, jev, tb, tev)
