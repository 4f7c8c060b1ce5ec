"""End-to-end parity of the port's ``train()`` with the JAX package.

The README quick-start (``examples/readme.py``) runs through both packages
on sklearn's bundled breast_cancer at ``num_actors=1`` (the JAX reference
once per module). Tolerances: eval history within 1e-6 absolute (the
metric sums are float32 sums taken in another order), ``get_dump()`` equal,
cuts and tree arrays bitwise. Models cross-load both ways. Importing the
port pulls in no JAX module, training without ``device="cpu"`` on a host
without CUDA raises, and every setting outside the slice raises
``NotImplementedError`` naming its key (held-out eval sets, early stopping
and ``xgb_model`` are in: ``tests/test_torch_evals.py``; custom objectives
and metrics: ``tests/test_torch_callbacks.py``).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from sklearn.datasets import load_breast_cancer, load_diabetes

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu_torch.convert import booster_from_jax_state

README_PARAMS = {"objective": "binary:logistic", "eval_metric": ["logloss", "error"]}
TREE_FIELDS = ("feature", "split_bin", "threshold", "default_left", "is_leaf",
               "value", "gain", "cover", "base_weight")


def _run(pkg, params, x, y, rounds, **kw):
    dm = pkg.RayDMatrix(x, y)
    ev = {}
    bst = pkg.train(params, dm, num_boost_round=rounds, evals=[(dm, "train")],
                    evals_result=ev, verbose_eval=False,
                    ray_params=pkg.RayParams(num_actors=1), **kw)
    return bst, ev


@pytest.fixture(scope="module")
def readme_runs():
    data = load_breast_cancer()
    x = data.data.astype(np.float32)
    y = data.target.astype(np.float32)
    with pytest.warns(UserWarning):
        jb, jev = _run(jx, README_PARAMS, x, y, 10)
    tb, tev = _run(tx, README_PARAMS, x, y, 10, device="cpu")
    return jb, jev, tb, tev


def test_readme_flow_matches_jax(readme_runs):
    jb, jev, tb, tev = readme_runs
    for metric in ("logloss", "error"):
        assert np.allclose(tev["train"][metric], jev["train"][metric],
                           rtol=0, atol=1e-6), metric
    assert tev["train"]["logloss"][-1] < tev["train"]["logloss"][0]
    assert tb.get_dump() == jb.get_dump()
    assert tb.get_dump(with_stats=True) == jb.get_dump(with_stats=True)
    assert np.array_equal(tb.cuts, np.asarray(jb.cuts))
    for name in TREE_FIELDS:
        assert np.array_equal(getattr(tb.forest, name),
                              np.asarray(getattr(jb.forest, name))), name


def test_models_cross_load(readme_runs, tmp_path):
    jb, _, tb, _ = readme_runs
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    jb.save_model(jpath)
    tb.save_model(tpath)
    from_jax = tx.RayXGBoostBooster.load_model(jpath)
    from_torch = jx.RayXGBoostBooster.load_model(tpath)
    assert from_jax.get_dump() == jb.get_dump()
    assert from_torch.get_dump() == tb.get_dump()
    x = load_breast_cancer().data.astype(np.float32)
    assert np.array_equal(from_torch.predict(x), jb.predict(x))
    assert from_jax.num_boosted_rounds() == 10
    # save_raw is stable across a load (fixed zip timestamps)
    assert tx.RayXGBoostBooster.load_raw(tb.save_raw()).save_raw() == tb.save_raw()
    # the state carry-across gives the same model
    conv = booster_from_jax_state(jb.forest._asdict(), jb.cuts, jb.base_score,
                                  dataclasses.asdict(jb.params))
    assert conv.get_dump() == jb.get_dump()


def test_squarederror_matches_jax():
    data = load_diabetes()
    x = data.data.astype(np.float32)
    y = data.target.astype(np.float32)
    params = {"objective": "reg:squarederror", "eval_metric": "rmse",
              "max_depth": 4, "eta": 0.2}
    with pytest.warns(UserWarning):
        jb, jev = _run(jx, params, x, y, 5)
    tb, tev = _run(tx, params, x, y, 5, device="cpu")
    assert np.allclose(tev["train"]["rmse"], jev["train"]["rmse"],
                       rtol=1e-6, atol=0)
    assert tb.get_dump() == jb.get_dump()


@pytest.mark.parametrize("impl", ["auto", "scatter", "onehot", "partition", "mixed"])
def test_every_hist_impl_is_the_one_histogram(impl):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((400, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    ref, _ = _run(tx, {"objective": "binary:logistic"}, x, y, 2, device="cpu")
    bst, _ = _run(tx, {"objective": "binary:logistic", "hist_impl": impl,
                       "hist_precision": "fast"}, x, y, 2, device="cpu")
    assert bst.get_dump() == ref.get_dump()


def test_import_pulls_in_no_jax():
    code = (
        "import sys, xgboost_ray_tpu_torch, xgboost_ray_tpu_torch.convert\n"
        "import xgboost_ray_tpu_torch.sklearn, xgboost_ray_tpu_torch.tune\n"
        "import xgboost_ray_tpu_torch.callback, xgboost_ray_tpu_torch.compat\n"
        "import xgboost_ray_tpu_torch.session, xgboost_ray_tpu_torch.util\n"
        "import xgboost_ray_tpu_torch.native, xgboost_ray_tpu_torch.obs.trace\n"
        "import xgboost_ray_tpu_torch.ops.shap\n"
        "import xgboost_ray_tpu_torch.models.xgb_export\n"
        "from xgboost_ray_tpu_torch.serve import autoscale, canary, pool\n"
        "from xgboost_ray_tpu_torch.data_sources import (\n"
        "    csv, dask, modin, object_store, parquet, partitioned, petastorm,\n"
        "    ray_dataset, _distributed)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'xgboost_ray_tpu' or m.startswith('xgboost_ray_tpu.')]\n"
        "print(bad)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_train_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: train() runs there")
    x = np.random.default_rng(0).standard_normal((50, 3)).astype(np.float32)
    dm = tx.RayDMatrix(x, (x[:, 0] > 0).astype(np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tx.train({"objective": "binary:logistic"}, dm, 1,
                 ray_params=tx.RayParams(num_actors=1))


@pytest.mark.parametrize("key,value", [
    ("gh_precision", "int8"),
    ("hist_quant", "int8_block"),
    ("subsample", 0.5),
    ("colsample_bytree", 0.5),
    ("colsample_bylevel", 0.5),
    ("colsample_bynode", 0.5),
    ("sampling_method", "gradient_based"),
    ("grow_policy", "lossguide"),
    ("booster", "dart"),
    ("booster", "gblinear"),
    ("monotone_constraints", "(1,0,0)"),
    ("interaction_constraints", [[0, 1]]),
    ("objective", "reg:absoluteerror"),
    ("objective", "reg:gamma"),
    ("eval_metric", "auc"),
    ("num_parallel_tree", 2),
    ("feature_parallel", 2),
])
def test_out_of_slice_params_raise(key, value):
    x = np.random.default_rng(0).standard_normal((50, 3)).astype(np.float32)
    dm = tx.RayDMatrix(x, (x[:, 0] > 0).astype(np.float32))
    params = {"objective": "binary:logistic", key: value}
    with pytest.raises(NotImplementedError, match=key):
        tx.train(params, dm, 1, device="cpu",
                 ray_params=tx.RayParams(num_actors=1))


def test_out_of_slice_data_and_evals_raise():
    x = np.random.default_rng(0).standard_normal((50, 3)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    for kwargs, key in ((dict(stream=True), "stream"),
                        (dict(qid=np.zeros(50)), "qid"),
                        (dict(feature_types=["c", "q", "q"]), "categorical"),
                        (dict(feature_weights=np.ones(3)), "feature_weights")):
        with pytest.raises(NotImplementedError, match=key):
            tx.RayDMatrix(x, y, **kwargs)
    dm = tx.RayDMatrix(x, y)
    # custom objectives and metrics are in (tests/test_torch_callbacks.py);
    # the remote-execution tier is not
    with pytest.raises(NotImplementedError, match="_remote"):
        tx.train({"objective": "binary:logistic"}, dm, 1, device="cpu",
                 _remote=True, ray_params=tx.RayParams(num_actors=1))
