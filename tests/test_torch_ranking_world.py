"""Learning to rank at ``num_actors=2`` against the JAX package on the
CPU: the port as a 2-rank gloo world (each rank's queries its own groups,
the padded width the world's largest group), ``rank:pairwise`` /
``rank:ndcg`` / ``rank:map``, with a held-out set.

Tolerances (those of ``tests/test_torch_ranking_train.py``, whose data and
checks these share, ``tests/_torch_ranking.py``):
``get_dump(with_stats=True)`` equal, the history within 1e-6 relative,
predictions within 1e-6 (relative above 1).
"""

import numpy as np
import pytest

from _torch_ranking import check_pair
from xgboost_ray_tpu_torch import distributed as D


@pytest.fixture(scope="module")
def world2():
    """A 2-rank gloo world, its ranks started (each rank's first task
    imports the package and joins the process group: a one-round run)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 2)).astype(np.float32)
    with D.World(2, "cpu") as w:
        w.run(D._train_rank, D.share({"x": x, "label": (x[:, 0] > 0).astype(
            np.float32)}), {"max_depth": 1}, 1, {"device": "cpu"})
        yield w


@pytest.mark.parametrize("objective", ["rank:pairwise", "rank:ndcg",
                                       "rank:map"])
def test_train_matches_jax_two_ranks(objective, world2):
    check_pair(objective, 2, world2)
