"""The port's sampled ``train()`` against the JAX package at ``num_actors``
1 (``tests/_torch_sampling.py``'s configurations: uniform rows with bytree
and bynode masks and two error@t thresholds, GOSS with bylevel masks,
feature weights, a sampled softmax model with ``logloss`` and ``auc``, a
softmax model with ``logloss`` and ``aucpr``, a random forest of 3 parallel
trees); the same configurations at ``num_actors`` 2 are in
``tests/test_torch_sampling_world.py``. Models cross-load both ways and
predict equally, and training continues from a forest (``xgb_model``).

Tolerances: ``get_dump(with_stats=True)`` equal (the draws are the JAX
package's bit for bit), the history within 1e-6 (metric sums in f32 in
another order), predictions within 1e-6; a loaded model's margins within
the f32 summation bound of the package's that saved it (bitwise its kernel,
B8, on the card: ``tests/test_torch_cuda.py``).
"""

import functools
import warnings

import numpy as np
import pytest

import _torch_sampling as S
import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx


@functools.lru_cache(maxsize=None)
def _runs(name):
    return S.jax_train(name, 1), S.port_train(name, 1)


@pytest.mark.parametrize("name", list(S.CASES))
def test_train_matches_jax(name):
    (jb, jev), (tb, tev) = _runs(name)
    S.check_pair(jb, jev, tb, tev)
    if name == "weights":  # a feature of weight 0 is never split on
        used = set(np.asarray(tb.forest.feature).ravel().tolist())
        assert not used & {2, 5}
    if name == "forest":
        assert tb.num_boosted_rounds() == S.ROUNDS
        assert tb.forest.feature.shape[0] == 3 * S.ROUNDS


@pytest.mark.parametrize("name", ["uniform", "forest", "softprob"])
def test_models_cross_load(name, tmp_path):
    """A sampled and a forest model saved by either package load in the
    other: margins bitwise, the loader's own prediction equal."""
    (jb, _), (tb, _) = _runs(name)
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jb.save_model(jpath)
    tb.save_model(tpath)
    from_jax = tx.RayXGBoostBooster.load_model(jpath)
    from_port = jx.RayXGBoostBooster.load_model(tpath)
    assert from_jax.get_dump(with_stats=True) == jb.get_dump(with_stats=True)
    jm = np.asarray(jb.predict(S.X, output_margin=True))
    got = from_jax.predict(S.X, output_margin=True, device="cpu")
    # the f32 sum over T trees in another order (XLA fuses a few trees'
    # adds its own way): within T eps sum |leaf value| + 2 eps |margin|
    leaves = from_jax.predict(S.X, pred_leaf=True, device="cpu")
    n_trees = leaves.shape[1]
    terms = np.abs(np.asarray(from_jax.forest.value)[
        np.arange(n_trees)[None, :], leaves]).sum(1)
    eps = np.finfo(np.float32).eps
    bound = n_trees * eps * terms + 2 * eps * np.abs(jm).reshape(len(jm), -1).max(1)
    err = np.abs(got - jm).reshape(len(jm), -1).max(1)
    assert (err <= bound).all()
    np.testing.assert_allclose(np.asarray(from_port.predict(S.X)),
                               tb.predict(S.X, device="cpu"), rtol=1e-6,
                               atol=1e-6)


def test_warm_start_from_a_forest():
    """Two more rounds from the JAX package's forest (``xgb_model``): the
    forest first, its rounds counted in parallel trees, the continued trees
    the JAX package's split for split (leaf values within 1e-5) and the
    history within 1e-5. (The
    start margins are each package's predict of the forest: equal within
    the f32 summation bound, an ulp apart on some rows, so the continued
    trees' covers may differ in their last digit.)"""
    (jb, _), _ = _runs("forest")
    params = S.params_of("forest")
    out = []
    for pkg, kw in ((jx, {}), (tx, {"device": "cpu"})):
        dm = pkg.RayDMatrix(S.X[:S.N_TRAIN], S.Y[:S.N_TRAIN])
        ev = {}
        init = jb if pkg is jx else tx.RayXGBoostBooster.load_raw(
            jb.save_raw())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            bst = pkg.train(params, dm, 2, evals=[(dm, "train")],
                            evals_result=ev, xgb_model=init,
                            ray_params=pkg.RayParams(num_actors=1), **kw)
        out.append((bst, ev))
    (jw, jev), (tw, tev) = out
    assert tw.num_boosted_rounds() == jw.num_boosted_rounds() == S.ROUNDS + 2
    first = 3 * S.ROUNDS
    assert (tw.get_dump(with_stats=True)[:first]
            == jw.get_dump(with_stats=True)[:first])
    for name in ("feature", "split_bin", "threshold", "default_left",
                 "is_leaf"):
        assert np.array_equal(np.asarray(getattr(tw.forest, name)),
                              np.asarray(getattr(jw.forest, name))), name
    np.testing.assert_allclose(np.asarray(tw.forest.value),
                               np.asarray(jw.forest.value), rtol=1e-5,
                               atol=1e-6)
    for m in jev["train"]:
        np.testing.assert_allclose(tev["train"][m], jev["train"][m], rtol=0,
                                   atol=1e-5)


def test_feature_weights_refused_as_jax():
    """The reference's checks of ``feature_weights``: one a feature,
    non-negative, not all zero."""
    x, y = S.X[:200], S.Y[:200]
    for fw, msg in ((np.ones(3), "entries"), (-np.ones(8), "non-negative"),
                    (np.zeros(8), "all zero")):
        with pytest.raises(ValueError, match=msg):
            tx.train({"objective": "binary:logistic",
                      "colsample_bynode": 0.5},
                     tx.RayDMatrix(x, y, feature_weights=fw), 1,
                     device="cpu", ray_params=tx.RayParams(num_actors=1))
