"""The port's custom objectives and metrics, callbacks and tune hooks
against the JAX package's.

``obj`` / ``feval`` / ``custom_metric`` train the JAX package's model on
breast_cancer (binary) and on a seeded K = 3 set at ``num_actors=1``:
dumps equal, history within 1e-6 absolute (f32 metric sums taken in
another order). With ``obj`` no round pass computes gradients (the
wrappers are counted on the CPU path). ``DistributedCallback`` hooks fire
in the JAX package's order, ``LegacyCallbackAdapter`` and
``EarlyStopException`` stop training as there, and the tune callbacks
report, checkpoint and load as the JAX package's do.
"""

import os
import warnings

import numpy as np
import pytest
from sklearn.datasets import load_breast_cancer

import xgboost_ray_tpu as jx
import xgboost_ray_tpu.tune as jtune
import xgboost_ray_tpu_torch as tx
import xgboost_ray_tpu_torch.tune as ttune
from _torch_hooks import RecordingCallback
from xgboost_ray_tpu_torch import engine as E
from xgboost_ray_tpu_torch import session
from xgboost_ray_tpu_torch.compat import (
    EarlyStopException,
    LegacyCallbackAdapter,
    wrap_callbacks,
)

ATOL = 1e-6
ROUNDS = 4


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():  # num_actors=1: "NOT be distributed"
        warnings.simplefilter("ignore", UserWarning)
        yield


def _bc():
    x, y = load_breast_cancer(return_X_y=True)
    return x.astype(np.float32), y.astype(np.float32)


def _k3(n=600, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    y = np.digitize(x[:, 0] + 0.5 * x[:, 1], [-0.5, 0.5]).astype(np.float32)
    return x, y


def logistic_obj(preds, dtrain):
    p = 1.0 / (1.0 + np.exp(-preds))
    y = dtrain.get_label()
    return (p - y).astype(np.float32), (p * (1.0 - p)).astype(np.float32)


def softmax_obj(preds, dtrain):
    e = np.exp(preds - preds.max(axis=1, keepdims=True))
    p = e / e.sum(axis=1, keepdims=True)
    onehot = np.eye(preds.shape[1], dtype=np.float32)[
        dtrain.get_label().astype(int)]
    return ((p - onehot).astype(np.float32),
            np.maximum(2.0 * p * (1.0 - p), 1e-6).astype(np.float32))


def error_metric(preds, dmat):
    label = dmat.get_label()
    if preds.ndim == 2:
        return "my_merror", float(np.mean(preds.argmax(axis=1) != label))
    return "my_error", float(np.mean((preds > 0) != (label > 0.5)))


def _train(pkg, params, x, y, rounds=ROUNDS, held_out=True, **kw):
    n = int(len(y) * 0.7)
    dtrain = pkg.RayDMatrix(x[:n], y[:n])
    evals = [(dtrain, "train")]
    if held_out:
        evals.append((pkg.RayDMatrix(x[n:], y[n:]), "valid"))
    ev = {}
    if pkg is tx:
        kw.setdefault("device", "cpu")
    bst = pkg.train(params, dtrain, rounds, evals=evals, evals_result=ev,
                    ray_params=pkg.RayParams(num_actors=1), **kw)
    return bst, ev


def _assert_same(tb, tev, jb, jev):
    assert tb.get_dump(with_stats=True) == jb.get_dump(with_stats=True)
    assert tev.keys() == jev.keys()
    for name in jev:
        assert tev[name].keys() == jev[name].keys()
        for metric in jev[name]:
            np.testing.assert_allclose(tev[name][metric], jev[name][metric],
                                       rtol=0, atol=ATOL)


CASES = {
    "binary": (_bc, {"objective": "binary:logistic",
                     "eval_metric": ["logloss", "error"]},
               dict(obj=logistic_obj, feval=error_metric)),
    "k3": (_k3, {"objective": "multi:softprob", "num_class": 3,
                 "eval_metric": ["mlogloss"], "max_depth": 3},
           dict(obj=softmax_obj, custom_metric=error_metric)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def custom_runs(request):
    make, params, kw = CASES[request.param]
    x, y = make()
    jb, jev = _train(jx, params, x, y, **kw)
    tb, tev = _train(tx, params, x, y, **kw)
    return request.param, x, y, tb, tev, jb, jev


def test_custom_objective_and_metric_match_jax(custom_runs):
    case, x, _, tb, tev, jb, jev = custom_runs
    _assert_same(tb, tev, jb, jev)
    metric = "my_merror" if case == "k3" else "my_error"
    assert len(tev["valid"][metric]) == ROUNDS
    np.testing.assert_allclose(tb.predict(x, device="cpu"), jb.predict(x),
                               rtol=0, atol=ATOL)


class _GhModes:
    """Records ``with_gh`` of every round pass the engine makes."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("round_update", "softmax_update"):
            real = getattr(E, name)

            # with_gh's position: round_update's 7th, softmax_update's 5th
            pos = 4 if name == "softmax_update" else 6

            def spy(*args, _real=real, _pos=pos, **kwargs):
                self.calls.append(args[_pos] if len(args) > _pos
                                  else kwargs.get("with_gh", True))
                return _real(*args, **kwargs)

            monkeypatch.setattr(E, name, spy)


@pytest.mark.parametrize("case", sorted(CASES))
def test_custom_objective_computes_no_gradients(case, monkeypatch):
    make, params, kw = CASES[case]
    x, y = make()
    modes = _GhModes(monkeypatch)
    _train(tx, params, x, y, held_out=False, obj=kw["obj"])
    # one pass a round over the training set, none of them with gradients
    # (round 0's built-in pass included)
    assert modes.calls == [False] * ROUNDS
    modes.calls.clear()
    _train(tx, params, x, y, held_out=False)
    assert modes.calls == [True] * (ROUNDS + 1)


def test_custom_squared_error_is_the_builtin_model():
    x, y = _bc()
    y = y * 3.0 + x[:, 0] / 10

    def squared(preds, dtrain):
        g = (preds - dtrain.get_label()).astype(np.float32)
        return g, np.ones_like(g)

    params = {"objective": "reg:squarederror", "base_score": 0.5}
    tb, tev = _train(tx, params, x, y, obj=squared)
    bb, bev = _train(tx, params, x, y)
    assert tb.get_dump(with_stats=True) == bb.get_dump(with_stats=True)
    assert tev == bev


def test_engine_refuses_mixed_gradients():
    x, y = _bc()
    dm = tx.RayDMatrix(x, y)
    dm.load_data(1)
    from xgboost_ray_tpu_torch.params import parse_params

    eng = E.TorchEngine(dm.shards(), parse_params({}), device="cpu",
                        custom_objective=True)
    with pytest.raises(ValueError, match="gh_custom"):
        eng.step(0)
    assert eng.gh is None


# ---------------------------------------------------------- hooks and order


def _hooks_run(pkg, actors=2):
    x, y = _bc()
    cb = RecordingCallback()
    rp = pkg.RayParams(num_actors=actors, distributed_callbacks=[cb])
    dtrain, dvalid = pkg.RayDMatrix(x[:400], y[:400]), pkg.RayDMatrix(
        x[400:], y[400:])
    kw = {"device": "cpu"} if pkg is tx else {}
    bst = pkg.train({"objective": "binary:logistic", "max_depth": 2}, dtrain,
                    2, evals=[(dtrain, "train"), (dvalid, "valid")],
                    ray_params=rp, **kw)
    train_calls = list(cb.calls)
    cb.calls.clear()
    pkg.predict(bst, pkg.RayDMatrix(x[:101]), ray_params=rp, **kw)
    return train_calls, list(cb.calls)


def test_distributed_callback_hooks_in_jax_order():
    t_train, t_pred = _hooks_run(tx)
    j_train, j_pred = _hooks_run(jx)
    assert t_train == j_train
    assert t_pred == j_pred
    assert t_train[:2] == [("on_init", 0), ("on_init", 1)]
    assert ("after_round", 1, 1) in t_train and t_train[-1] == ("after_train", 1)
    assert t_pred[-2:] == [("after_predict", 0, 51), ("after_predict", 1, 50)]


def test_session_queue_and_rank():
    x, y = _bc()

    class Put:
        def after_iteration(self, model, epoch, evals_log):
            session.put_queue({"epoch": epoch,
                               "rank": session.get_actor_rank()})
            session.put_queue(lambda: called.append(epoch))
            return False

    called = []
    extra = {}
    tx.train({"objective": "binary:logistic"}, tx.RayDMatrix(x, y), 2,
             device="cpu", callbacks=[Put()], additional_results=extra,
             ray_params=tx.RayParams(num_actors=1))
    assert extra["callback_returns"] == {0: [{"epoch": 0, "rank": 0},
                                             {"epoch": 1, "rank": 0}]}
    assert called == [0, 1]
    assert session.get_rabit_rank() == 0


def test_callbacks_get_the_model_so_far(tmp_path):
    x, y = _bc()
    saved = []

    class Save:
        def after_iteration(self, model, epoch, evals_log):
            path = str(tmp_path / f"m{epoch}.json")
            model.save_model(path)  # the booster of the rounds so far
            saved.append((path, model.num_boosted_rounds(),
                          model.get_margins().shape))
            return False

    bst = tx.train({"objective": "binary:logistic"}, tx.RayDMatrix(x, y), 3,
                   device="cpu", callbacks=[Save()],
                   ray_params=tx.RayParams(num_actors=1))
    assert [s[1] for s in saved] == [1, 2, 3]
    assert saved[0][2] == (len(y), 1)
    assert tx.RayXGBoostBooster.load_model(saved[-1][0]).get_dump() == \
        bst.get_dump()


def test_legacy_callbacks_and_early_stop_exception():
    import xgboost_ray_tpu.compat as jcompat

    x, y = _bc()
    envs = []
    stop = {tx: EarlyStopException, jx: jcompat.EarlyStopException}

    def legacy(env, pkg=tx):
        envs.append((env.iteration, env.end_iteration,
                     dict(env.evaluation_result_list)))
        if env.iteration == 1:
            raise stop[pkg](best_iteration=1)

    wrapped = wrap_callbacks([legacy], 10)
    assert isinstance(wrapped[0], LegacyCallbackAdapter)
    with pytest.raises(TypeError):
        wrap_callbacks([42], 10)
    runs = {}
    for pkg in (tx, jx):
        envs.clear()
        dm = pkg.RayDMatrix(x, y)
        kw = {"device": "cpu"} if pkg is tx else {}
        bst = pkg.train({"objective": "binary:logistic"}, dm, 10,
                        evals=[(dm, "train")],
                        callbacks=[lambda env, pkg=pkg: legacy(env, pkg)],
                        ray_params=pkg.RayParams(num_actors=1), **kw)
        runs[pkg.__name__] = (bst.num_boosted_rounds(),
                              [(i, e, sorted(r)) for i, e, r in envs])
    assert runs["xgboost_ray_tpu_torch"] == runs["xgboost_ray_tpu"]
    assert runs["xgboost_ray_tpu_torch"][0] == 2


def test_fault_tolerance_settings_still_raise():
    x, y = _bc()
    with pytest.raises(NotImplementedError, match="elastic_training"):
        tx.train({}, tx.RayDMatrix(x, y), 1, device="cpu",
                 ray_params=tx.RayParams(num_actors=1, elastic_training=True))
    with pytest.raises(NotImplementedError, match="_remote"):
        tx.train({}, tx.RayDMatrix(x, y), 1, device="cpu", _remote=True,
                 ray_params=tx.RayParams(num_actors=1))


# -------------------------------------------------------------------- tune


def test_tune_callback_reports_every_round(tmp_path):
    x, y = _bc()
    sess = ttune.init_session(str(tmp_path))
    try:
        assert ttune.is_session_enabled()
        dm = tx.RayDMatrix(x, y)
        bst = tx.train({"objective": "binary:logistic",
                        "eval_metric": ["logloss"]}, dm, 6,
                       evals=[(dm, "train")], device="cpu",
                       ray_params=tx.RayParams(num_actors=1))
    finally:
        ttune.shutdown_session()
    assert not ttune.is_session_enabled()
    # the callback train() added reports every round, checkpoints every 5th
    assert [r["training_iteration"] for r in sess.results] == list(range(1, 7))
    assert all("train-logloss" in r for r in sess.results)
    ckpt = sess.last_checkpoint_path
    assert ckpt == os.path.join(str(tmp_path), "checkpoint_000005")
    loaded = ttune.load_model(ckpt)
    assert loaded.num_boosted_rounds() == 5
    assert loaded.get_dump() == bst.get_dump()[:5]


def test_tune_callback_metrics_and_scheduler(tmp_path):
    x, y = _bc()

    class StopAt3:
        def on_report(self, trial_id, iteration, metrics):
            return iteration >= 3

    sess = ttune.init_session(str(tmp_path))
    sess.scheduler = StopAt3()
    try:
        cb = ttune.TuneReportCallback({"loss": "train-logloss"})
        assert ttune._try_add_tune_callback([cb]) == [cb]
        dm = tx.RayDMatrix(x, y)
        bst = tx.train({"objective": "binary:logistic",
                        "eval_metric": ["logloss"]}, dm, 10,
                       evals=[(dm, "train")], callbacks=[cb], device="cpu",
                       ray_params=tx.RayParams(num_actors=1))
    finally:
        ttune.shutdown_session()
    assert bst.num_boosted_rounds() == 3 and sess.stopped_by_scheduler
    assert [sorted(r) for r in sess.results] == [["loss",
                                                  "training_iteration"]] * 3
    assert sess.last_checkpoint_path is None


def test_tune_resources_match_jax():
    args = (4, 2, 1, 0, {"custom": 2}, {"strategy": "SPREAD", "x": 1})
    t, j = ttune._get_tune_resources(*args), jtune._get_tune_resources(*args)
    assert (t.bundles, t.strategy, t.options) == (j.bundles, j.strategy,
                                                  j.options)
    assert t.required_resources() == j.required_resources()
    assert ttune._try_add_tune_callback([]) == []
