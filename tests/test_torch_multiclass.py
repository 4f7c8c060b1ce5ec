"""Multiclass training, held-out evaluation, prediction and serving of the
port (``multi:softprob`` / ``multi:softmax``) against the JAX package on
the CPU.

The data: 3,000 rows x 12 features (8 continuous, then a one-hot group of
4 columns, exactly one of them 1 in every row), labels a seeded function of
the features with K = 3 or 7 classes; the first 2,400 rows train, the last
600 are the held-out set; depth 4, 5 rounds. Both packages get the same
numpy arrays. Tolerances:

- gradients and hessians bitwise (the plain softmax takes the max and the
  sum over classes in class order, evaluates exp with the reference's own
  float32 exp and flushes subnormal results, as XLA's CPU program does);
  probabilities and classes of the transform bitwise;
- ``mlogloss`` / ``merror`` partial sums within 1e-6 relative (float32
  sums in another order; the log is not the reference's), NaN where the
  reference's is NaN;
- tree structure (``feature``, ``split_bin``, ``default_left``,
  ``is_leaf``) equal, ``get_dump()`` equal, leaf values, training and
  held-out margins, ``evals_result``, ``best_score`` and predicted values
  within 1e-6 absolute (the reference sums a K-output forest with a
  one-hot matrix product whose order the CPU GEMM picks,
  ``ops/predict.py``), ``multi:softmax`` classes equal;
- at ``num_actors=2`` the port runs as a 2-rank gloo world (its ranks
  merge as the reference's 2-device ``psum`` does), and its all-reduce
  bytes per round equal the ring model's count of K trees' merges;
- B4 over T = 3 trees in one call bitwise equal to three calls of the
  plain walk and to the JAX ``predict_tree_binned``.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu.engine import TpuEngine
from xgboost_ray_tpu.ops import grow as jg
from xgboost_ray_tpu.ops import metrics as jm
from xgboost_ray_tpu.ops import objectives as jo
from xgboost_ray_tpu.params import parse_params as jax_parse_params
from xgboost_ray_tpu_torch import distributed as D
from xgboost_ray_tpu_torch import serve
from xgboost_ray_tpu_torch.ops import grow as tg
from xgboost_ray_tpu_torch.ops import histogram as th
from xgboost_ray_tpu_torch.ops import metrics as tm
from xgboost_ray_tpu_torch.ops import objectives as to
from xgboost_ray_tpu_torch.params import parse_params

N_TRAIN, N_ROWS, N_FEATURES, DEPTH, ROUNDS = 2400, 3000, 12, 4, 5
STRUCTURE = ("feature", "split_bin", "default_left", "is_leaf")
CPU = "cpu"


def _params(k, objective="multi:softprob", **kw):
    return {"objective": objective, "num_class": k, "max_depth": DEPTH,
            "eval_metric": ["merror", "mlogloss"], **kw}


def _data(k, seed=0):
    """(x [3000, 12] f32, y [3000] f32 classes 0..k-1)."""
    rng = np.random.RandomState(seed + k)
    cont = rng.standard_normal((N_ROWS, 8)).astype(np.float32)
    group = rng.randint(0, 4, N_ROWS)
    x = np.concatenate([cont, np.eye(4, dtype=np.float32)[group]], axis=1)
    w = rng.standard_normal((8, k)).astype(np.float32)
    b = rng.standard_normal((4, k)).astype(np.float32)
    score = cont @ w + b[group] + 0.5 * rng.standard_normal((N_ROWS, k))
    return x, np.argmax(score, axis=1).astype(np.float32)


def _rows(k, seed, n=20000, special=False):
    """Margins with wide spreads, tied rows and out-of-range labels; with
    ``special`` also rows holding NaN, +-inf and +-1e30 margins."""
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal((n, k)) * rng.choice([0.1, 3.0, 40.0], (n, 1))
         ).astype(np.float32)
    m[:50] = np.round(m[:50])  # ties inside a row
    m[50:60] = 1.5  # all classes tied
    m[60:70, 0] = 200.0  # one class far above the rest
    if special:
        m[70, 1] = np.nan
        m[71, 0] = np.inf
        m[72, -1] = -np.inf
        m[73] = -np.inf
        m[74, 0], m[74, 1] = np.inf, np.inf
        m[75, 0], m[75, -1] = 1e30, -1e30
        m[76] = 1e30
    y = rng.integers(0, k, n).astype(np.float32)
    y[:8] = [-1.0, float(k), 2.5, np.nan, 1e10, -1e10, -float(k), 0.99]
    w = rng.uniform(0.2, 3.0, n).astype(np.float32)
    return m, y, w


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _same(a, b):
    """Bitwise equal where the reference is a number; NaN where it is NaN
    (NaN payloads are not compared)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(b)
    return (a.shape == b.shape and np.array_equal(np.isnan(a), nan)
            and np.array_equal(_bits(a)[~nan], _bits(b)[~nan]))


def _t(*arrays):
    """Tensors of copies (the passes update margins in place)."""
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


# --------------------------------------------------------------------------
# the objective, metrics and the plain softmax pass
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k", [3, 7, 32, 33, 100])
def test_softmax_grad_hess_bitwise(k):
    """Gradients of the plain pass against ``_make_softmax``'s closure
    compiled on the CPU, labels outside [0, K) included (their one-hot row
    is zero, as ``jax.nn.one_hot`` gives)."""
    m, y, w = _rows(k, 1, special=True)
    g, h = jax.jit(jo._make_softmax(k, True).grad_hess)(m, y, w)
    tg_, th_ = to.softmax_grad_hess(*_t(m, y, w))
    assert _same(tg_.numpy(), g) and _same(th_.numpy(), h)
    assert not np.isnan(np.asarray(g)[200:]).any()  # numbers past the rows


@pytest.mark.parametrize("k", [3, 7, 32, 33, 100])
def test_softmax_metric_terms_and_partials(k):
    """Per-row ``mlogloss`` / ``merror`` terms against the reference's
    (``take_along_axis``: a label in [-K, 0) wraps, one beyond is NaN;
    ``argmax`` keeps the first maximum), and the partial sums against
    ``_mlogloss`` / ``_merror`` within 1e-6 relative."""
    m, y, w = _rows(k, 2, special=True)

    def jax_terms(m, y):
        logp = jax.nn.log_softmax(m, axis=-1)
        c = y.astype(jnp.int32)
        ll = -jnp.take_along_axis(logp, c[:, None], axis=1)[:, 0]
        return ll, jnp.where(jnp.argmax(m, axis=-1) != c, 1.0, 0.0)

    jll, jwrong = (np.asarray(a) for a in jax.jit(jax_terms)(m, y))
    tm_, ty = _t(m, y)
    tll = tm.mlogloss_terms(tm_, ty).numpy()
    assert np.array_equal(np.isnan(tll), np.isnan(jll))
    ok = ~np.isnan(jll)
    np.testing.assert_allclose(tll[ok], jll[ok], rtol=1e-6, atol=1e-6)
    assert np.array_equal(tm.merror_terms(tm_, ty).numpy(), jwrong)
    # sums over the rows whose label is in range and whose margins are
    # finite (all but rows 0-7 and the special rows 70-76), then all rows
    # (NaN)
    finite = np.ones(len(m), bool)
    finite[:8] = finite[70:77] = False
    for rows in (finite, slice(None)):
        sums = tm.softmax_partials(*_t(m[rows], y[rows], w[rows])).numpy()
        jl = jax.jit(jm._mlogloss)(m[rows], y[rows], w[rows])
        je = jax.jit(jm._merror)(m[rows], y[rows], w[rows])
        ref = np.array([float(jl[0]), float(je[0]), float(jl[1])])
        assert np.array_equal(np.isnan(sums), np.isnan(ref))
        np.testing.assert_allclose(sums[~np.isnan(ref)], ref[~np.isnan(ref)],
                                   rtol=1e-6)


@pytest.mark.parametrize("prob", [True, False])
@pytest.mark.parametrize("k", [3, 7, 32, 33, 100])
def test_softmax_transform_bitwise(k, prob):
    """The transform mode against ``_make_softmax(K, prob).transform``,
    compiled and eager (the reference's booster transforms eagerly):
    probabilities bitwise, classes the first argmax of the probabilities
    (ties included)."""
    m, _, _ = _rows(k, 3, special=True)
    obj = jo._make_softmax(k, prob)
    got = to.softmax_transform(torch.from_numpy(m), prob).numpy()
    for ref in (np.asarray(jax.jit(obj.transform)(m)),
                np.asarray(obj.transform(jnp.asarray(m)))):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert _same(got, ref)


@pytest.mark.parametrize("k", [3, 7, 32, 33, 100])
def test_softmax_pass_modes_compose(k):
    """The plain pass's three modes against their composition: training
    adds the K trees' row values to the margins in place, then takes the
    partials and the [K, N, 2] gradient planes of the new margins; eval
    mode the same without gradients; the CPU wrappers are the plain
    versions."""
    m, y, w = _rows(k, 4, n=3000)
    y[:8] = 1.0  # labels in range: sums without NaN
    rv = np.random.default_rng(5).standard_normal((k, 3000)).astype(np.float32)
    new = m + rv.T
    ref_sums = tm.softmax_partials(*_t(new, y, w))
    g, h = to.softmax_grad_hess(*_t(new, y, w))
    for fn in (to.softmax_update_plain, to.softmax_update):
        tm_, trv, ty, tw = _t(m, rv, y, w)
        gh, sums = fn(tm_, trv, ty, tw)
        assert np.array_equal(_bits(tm_.numpy()), _bits(new))
        assert gh.shape == (k, 3000, 2) and gh.is_contiguous()
        assert torch.equal(gh[:, :, 0], g.T) and torch.equal(gh[:, :, 1], h.T)
        assert torch.equal(sums, ref_sums) and sums.dtype == torch.float64
        tm_ = torch.from_numpy(m.copy())
        gh, sums = fn(tm_, trv, ty, tw, with_gh=False)
        assert gh is None and torch.equal(sums, ref_sums)
        assert np.array_equal(_bits(tm_.numpy()), _bits(new))
    out = torch.empty(3000, k)
    assert to.softmax_transform(torch.from_numpy(new), True, out=out) is out
    assert torch.equal(out, to.softmax_probs(torch.from_numpy(new)))
    classes = to.softmax_transform(torch.from_numpy(new), False)
    assert torch.equal(classes, to.first_argmax(out).float())


def test_first_argmax_and_label_cast():
    """``jnp.argmax``'s rule (the first maximum; a NaN is the maximum) and
    XLA's float32 -> int32 cast (truncation, saturation, NaN -> 0)."""
    v = np.array([[1, 3, 3], [2, 2, 2], [np.nan, 5, np.nan], [0, np.nan, 1],
                  [-np.inf, -np.inf, -np.inf]], np.float32)
    ref = np.asarray(jax.jit(lambda a: jnp.argmax(a, axis=-1))(v))
    assert np.array_equal(to.first_argmax(torch.from_numpy(v)).numpy(), ref)
    lab = np.array([0, 1.7, -0.5, -1, 3, np.nan, 2.9999, 1e10, -1e10, np.inf,
                    -np.inf], np.float32)
    ref = np.asarray(jax.jit(lambda a: a.astype(jnp.int32))(lab))
    assert np.array_equal(to.label_class(torch.from_numpy(lab)).numpy(), ref)


def test_quant_scales_per_class_one_allreduce():
    """K1's fixed-point scales of K classes: one pass over [K, N, 2] and one
    all-reduce of the [K, 2] maxima; row k equals class k's own scales."""
    rng = np.random.default_rng(6)
    gh = torch.from_numpy((rng.standard_normal((5, 1000, 2))
                           * np.array([1e-3, 1.0, 50.0, 0.0, 7.0])[:, None, None]
                           ).astype(np.float32))
    calls = []

    def reduce_max(t):
        calls.append(tuple(t.shape))
        return t

    qs = th.quant_scales(gh, 4000, reduce_max)
    assert calls == [(5, 2)] and qs.shape == (5, 4)
    for k in range(5):
        assert torch.equal(qs[k], th.quant_scales(gh[k], 4000))


def test_params_and_objectives_of_the_slice():
    p = parse_params(_params(3))
    assert (p.objective, p.num_class) == ("multi:softprob", 3)
    assert parse_params({"objective": "multi:softmax", "num_class": 2}
                        ).eval_metric == []
    for bad in ({"objective": "multi:softprob"},
                {"objective": "multi:softmax", "num_class": 1}):
        with pytest.raises(ValueError, match="num_class"):
            parse_params(bad)
        with pytest.raises(ValueError, match="num_class"):
            jax_parse_params(bad)
    for bad in ({"objective": "binary:logistic", "eval_metric": "mlogloss"},
                {**_params(3), "eval_metric": ["logloss"]},
                {**_params(3), "eval_metric": "auc"},
                {"objective": "binary:logistic", "num_class": 3}):
        with pytest.raises(NotImplementedError):
            parse_params(bad)
    for name in ("multi:softprob", "multi:softmax"):
        j, t = jo.get_objective(name, 7), to.get_objective(name, 7)
        assert (t.num_outputs, t.default_metric) == (j.num_outputs,
                                                     j.default_metric)
        assert t.base_score_to_margin(0.3) == j.base_score_to_margin(0.3) == 0


# --------------------------------------------------------------------------
# the JAX package's runs (module fixtures: compiling the reference's K-tree
# round takes 5-17 s a configuration, so each runs once here)
# --------------------------------------------------------------------------


def _jax_reference(k):
    """The JAX engine trained for ROUNDS rounds on the split: its engine,
    eval history, booster and its predictions of every row (values,
    margins, and the classes of the same trees as ``multi:softmax``)."""
    x, y = _data(k)
    tr = [{"data": x[:N_TRAIN], "label": y[:N_TRAIN]}]
    va = [{"data": x[N_TRAIN:], "label": y[N_TRAIN:]}]
    eng = TpuEngine(tr, jax_parse_params(_params(k)), num_actors=1,
                    evals=[(tr, "train"), (va, "valid")])
    hist = {}
    for i in range(ROUNDS):
        for s, row in eng.step(i).items():
            for name, v in row.items():
                hist.setdefault(s, {}).setdefault(name, []).append(v)
    jb = eng.get_booster()
    classes = jx.RayXGBoostBooster.load_raw(jb.save_raw())
    classes.params = dataclasses.replace(classes.params,
                                         objective="multi:softmax")
    return {"engine": eng, "hist": hist, "booster": jb,
            "values": jb.predict(x), "margins": jb.predict(
                x, output_margin=True), "classes": classes.predict(x)}


@pytest.fixture(scope="module")
def jax_k3():
    return _jax_reference(3)


@pytest.fixture(scope="module")
def jax_k7():
    return _jax_reference(7)


@pytest.fixture(scope="module", params=[3, 7], ids=["k3", "k7"])
def jax_ref(request):
    """(K, the JAX reference of K classes) for K = 3 and 7."""
    return request.param, request.getfixturevalue(f"jax_k{request.param}")


def _both_train(params, rounds, **kw):
    """(JAX booster, its evals_result) of ``train`` on the K = 3 split with
    the held-out set, and the port's on the same arguments."""
    x, y = _data(3)
    res = []
    for pkg in (jx, tx):
        dtrain = pkg.RayDMatrix(x[:N_TRAIN], y[:N_TRAIN])
        ev = {}
        extra = {"device": CPU} if pkg is tx else {}
        with warnings.catch_warnings():  # num_actors=1: "NOT distributed"
            warnings.simplefilter("ignore", UserWarning)
            bst = pkg.train(params, dtrain, rounds,
                            evals=[(dtrain, "train"),
                                   (pkg.RayDMatrix(x[N_TRAIN:], y[N_TRAIN:]),
                                    "valid")],
                            evals_result=ev,
                            ray_params=pkg.RayParams(num_actors=1),
                            **kw, **extra)
        res.append((bst, ev))
    return res


@pytest.fixture(scope="module")
def early_stopped():
    """Both packages with ``early_stopping_rounds=2`` on a config whose
    held-out ``mlogloss`` turns up after about ten rounds."""
    return _both_train(_params(3, eta=1.5), 30, early_stopping_rounds=2)


@pytest.fixture(scope="module")
def warm_started(jax_k3, tmp_path_factory):
    """Both packages continuing the JAX package's 5-round model (saved to a
    file) for 2 rounds."""
    path = str(tmp_path_factory.mktemp("warm") / "init.json")
    jax_k3["booster"].save_model(path)
    return _both_train(_params(3), 2, xgb_model=path)


# --------------------------------------------------------------------------
# B4 over a round's trees
# --------------------------------------------------------------------------


def test_b4_three_trees_one_call_bitwise(jax_k3):
    k = 3
    eng, jb = jax_k3["engine"], jax_k3["booster"]
    bins = np.array(eng.bins)[:N_TRAIN]
    forest = tg.Tree(*[torch.from_numpy(np.array(f)[-k:]) for f in jb.forest])
    tb = torch.from_numpy(bins)
    got = tg.predict_tree_binned(forest, tb, DEPTH, 256)
    assert got.shape == (k, N_TRAIN)
    for t in range(k):
        one = tg.Tree(*[f[t] for f in forest])
        ref = tg.predict_tree_binned_plain(one, tb, DEPTH, 256)
        jref = jg.predict_tree_binned(
            jg.Tree(*[jnp.asarray(np.asarray(f)[-k + t]) for f in jb.forest]),
            jnp.asarray(bins), DEPTH, 256)
        assert np.array_equal(_bits(got[t].numpy()), _bits(ref.numpy()))
        assert np.array_equal(_bits(got[t].numpy()), _bits(jref))


# --------------------------------------------------------------------------
# training against the JAX package
# --------------------------------------------------------------------------


class _Keep:
    engine = None

    def after_iteration(self, engine, i, result):
        self.engine = engine


def _port_train(k, objective="multi:softprob", rounds=ROUNDS, held_out=True,
                params=None):
    x, y = _data(k)
    dtrain = tx.RayDMatrix(x[:N_TRAIN], y[:N_TRAIN])
    evals = [(dtrain, "train")]
    if held_out:
        evals.append((tx.RayDMatrix(x[N_TRAIN:], y[N_TRAIN:]), "valid"))
    keep, ev = _Keep(), {}
    with warnings.catch_warnings():  # num_actors=1: "NOT be distributed"
        warnings.simplefilter("ignore", UserWarning)
        bst = tx.train(params or _params(k, objective), dtrain, rounds,
                       evals=evals, evals_result=ev, callbacks=[keep],
                       device=CPU, ray_params=tx.RayParams(num_actors=1))
    return bst, ev, keep.engine


def _assert_forest_close(tb, jb):
    for name in STRUCTURE:
        assert np.array_equal(getattr(tb.forest, name),
                              np.asarray(getattr(jb.forest, name))), name
    np.testing.assert_allclose(tb.forest.value, np.asarray(jb.forest.value),
                               rtol=0, atol=1e-6)


def _assert_history_close(tev, jev):
    assert list(tev) == list(jev)
    for s in jev:
        assert tev[s].keys() == jev[s].keys()
        for m in jev[s]:
            np.testing.assert_allclose(tev[s][m], jev[s][m], rtol=0,
                                       atol=1e-6, err_msg=f"{s}-{m}")


def test_train_matches_jax(jax_ref):
    """One rank: trees, eval history, training and held-out margins, and
    ``predict`` values; K trees a round, round-major."""
    k, ref = jax_ref
    eng, jb = ref["engine"], ref["booster"]
    tb, tev, te = _port_train(k)
    assert tb.num_trees == jb.num_trees == k * ROUNDS
    assert tb.num_boosted_rounds() == ROUNDS
    _assert_forest_close(tb, jb)
    assert tb.get_dump() == jb.get_dump()
    _assert_history_close(tev, ref["hist"])
    assert tev["valid"]["mlogloss"][-1] < tev["valid"]["mlogloss"][0]
    np.testing.assert_allclose(te.get_margins(),
                               np.asarray(eng.margins)[:N_TRAIN],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(te.evals[1].margins.numpy(),
                               np.asarray(eng.evals[1].margins)[:600],
                               rtol=0, atol=1e-6)
    x, _ = _data(k)
    pt = tb.predict(x, device=CPU)
    assert pt.shape == ref["values"].shape == (N_ROWS, k)
    np.testing.assert_allclose(pt, ref["values"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(pt.sum(1), 1.0, atol=1e-6)
    mt = tb.predict(x, output_margin=True, device=CPU)
    np.testing.assert_allclose(mt, ref["margins"], rtol=0, atol=1e-6)
    # the held-out margins are the model's margins of those rows
    np.testing.assert_allclose(te.evals[1].margins.numpy(), mt[N_TRAIN:],
                               rtol=0, atol=1e-6)


def test_softmax_objective_classes_match_jax(jax_k3):
    """``multi:softmax`` trains the same trees as ``multi:softprob`` (its
    default metric is ``merror``) and predicts the first argmax class."""
    k = 3
    tb_prob, _, _ = _port_train(k, held_out=False)
    params = _params(k, "multi:softmax")
    del params["eval_metric"]
    tb, ev, _ = _port_train(k, held_out=False, params=params)
    assert list(ev["train"]) == ["merror"]
    assert tb.get_dump() == tb_prob.get_dump()
    x, _ = _data(k)
    got = tb.predict(x, device=CPU)
    assert got.shape == jax_k3["classes"].shape == (N_ROWS,)
    assert got.dtype == np.float32
    assert np.array_equal(got, jax_k3["classes"])
    np.testing.assert_array_equal(
        got, np.argmax(tb_prob.predict(x, device=CPU), axis=1))


@pytest.fixture(scope="module")
def world2():
    with D.World(2, "cpu") as w:
        yield w


def _tree_bytes(f, nbt, depth, itemsize):
    """Per-rank bytes at world 2 (ring factor 1) of one tree's merges (as
    ``tests/test_torch_distributed.py``): every level's histogram, the
    per-child row counts of each level with a next one, the final totals."""
    hist = f * nbt * 2 * itemsize * (1 + sum(1 << (d - 1)
                                             for d in range(1, depth)))
    counts = sum(2 * (1 << d) * 8 for d in range(depth - 1))
    return hist + counts + (1 << depth) * 2 * itemsize


@pytest.fixture(scope="module")
def jax_two_actors():
    """The JAX package's ``train`` at ``num_actors=2`` on the K = 3 split."""
    x, y = _data(3)
    jev = {}
    dtrain = jx.RayDMatrix(x[:N_TRAIN], y[:N_TRAIN])
    jb = jx.train(_params(3), dtrain, ROUNDS,
                  evals=[(dtrain, "train"),
                         (jx.RayDMatrix(x[N_TRAIN:], y[N_TRAIN:]), "valid")],
                  evals_result=jev, ray_params=jx.RayParams(num_actors=2))
    return jb, jev


def test_two_actors_matches_jax(world2, jax_two_actors):
    """``num_actors=2``: a 2-rank gloo world of the port against the JAX
    package's two devices; the ranks agree; a round's all-reduce bytes are
    K trees' merges plus the two sets' three f64 partials."""
    k = 3
    x, y = _data(k)
    held = [dict(D.share({"x": x[N_TRAIN:], "label": y[N_TRAIN:]}),
                 sharding="INTERLEAVED")]
    out = world2.run(D._train_rank,
                     D.share({"x": x[:N_TRAIN], "label": y[:N_TRAIN]}),
                     _params(k), ROUNDS,
                     {"device": CPU, "eval_names": ["train", "valid"],
                      "eval_data": [None, *held]})
    assert out[0]["model"] == out[1]["model"]
    assert out[0]["evals_result"] == out[1]["evals_result"]
    assert out[0]["margins"].shape == (N_TRAIN // 2, k)
    jb, jev = jax_two_actors
    tb = tx.RayXGBoostBooster.load_raw(out[0]["model"])
    _assert_forest_close(tb, jb)
    assert tb.get_dump() == jb.get_dump()
    _assert_history_close(out[0]["evals_result"], jev)
    extra = out[0]["additional_results"]
    assert extra["world_size"] == 2
    assert extra["allreduce_bytes_per_round"] == (
        k * _tree_bytes(N_FEATURES, 257, DEPTH, 4) + 2 * 3 * 8)


def test_early_stopping_matches_jax(early_stopped):
    """Early stopping on the held-out ``mlogloss`` (the last metric of the
    last set): the same round, ``best_iteration`` and ``best_score``."""
    (jb, jev), (tb, tev) = early_stopped
    _assert_history_close(tev, jev)
    hist = tev["valid"]["mlogloss"]
    assert len(hist) < 30 and len(hist) == len(jev["valid"]["mlogloss"])
    assert tb.best_iteration == jb.best_iteration == int(np.argmin(hist))
    assert len(hist) == tb.best_iteration + 3
    assert tb.best_score == pytest.approx(jb.best_score, abs=1e-6)
    assert tb.num_trees == jb.num_trees == 3 * len(hist)


def test_warm_start_from_a_jax_model_matches_jax(warm_started):
    """A K-output ``xgb_model``: the JAX package's 5-round model saved,
    then 2 more rounds from it in both packages (the init trees first, a
    round is K trees, class ``t % K``)."""
    (jb, jev), (tb, tev) = warm_started
    assert tb.num_trees == jb.num_trees == 3 * (ROUNDS + 2)
    assert tb.num_boosted_rounds() == ROUNDS + 2
    _assert_forest_close(tb, jb)
    _assert_history_close(tev, jev)
    x, _ = _data(3)
    np.testing.assert_allclose(tb.predict(x, device=CPU),
                               jb.predict(x), rtol=0, atol=1e-6)


def test_models_cross_load_both_ways(jax_k7, tmp_path):
    """A JAX-trained ``multi:softprob`` model predicts its values in the
    port, and the port's in the JAX package, within 1e-6."""
    k = 7
    x, _ = _data(k)
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jax_k7["booster"].save_model(jpath)
    in_port = tx.RayXGBoostBooster.load_model(jpath)
    np.testing.assert_allclose(in_port.predict(x, device=CPU),
                               jax_k7["values"], rtol=0, atol=1e-6)
    tb, _, _ = _port_train(k, held_out=False)
    tb.save_model(tpath)
    in_jax = jx.RayXGBoostBooster.load_model(tpath)
    got = in_jax.predict(x)
    assert got.shape == (N_ROWS, k)
    np.testing.assert_allclose(got, tb.predict(x, device=CPU), rtol=0,
                               atol=1e-6)


def test_predict_over_shards():
    """``predict()`` over a sharded RayDMatrix at ``num_actors=2``: the
    booster's values in row order, [N, K] probabilities or [N] classes."""
    k = 3
    tb, _, _ = _port_train(k, held_out=False)
    x, _ = _data(k)
    got = tx.predict(tb, tx.RayDMatrix(x), ray_params=tx.RayParams(
        num_actors=2), device=CPU)
    assert got.shape == (N_ROWS, k)
    assert np.array_equal(got, tb.predict(x, device=CPU))
    tb.params = dataclasses.replace(tb.params, objective="multi:softmax")
    got = tx.predict(tb, tx.RayDMatrix(x), ray_params=tx.RayParams(
        num_actors=2), device=CPU)
    assert got.shape == (N_ROWS,)
    assert np.array_equal(got, tb.predict(x, device=CPU))


@pytest.mark.parametrize("objective", ["multi:softprob", "multi:softmax"])
def test_serve_value_matches_predict(objective):
    """The padded-bucket predictor and the HTTP server: every served kind
    bitwise equal to ``booster.predict`` ([rows, K] probabilities or [rows]
    classes for ``value``)."""
    k = 7
    tb, _, _ = _port_train(k, objective, rounds=2, held_out=False)
    x, _ = _data(k)
    pred = serve.CompiledPredictor(tb, device=CPU)
    for n in (1, 5, 37):
        for kind, kw in (("value", {}), ("margin", {"output_margin": True}),
                         ("leaf", {"pred_leaf": True})):
            got = pred.predict(x[:n], kind)
            ref = tb.predict(x[:n], device=CPU, **kw)
            assert got.shape == ref.shape and np.array_equal(got, ref), (
                kind, n)
    h = serve.create_server(tb, max_batch=64, max_delay_ms=1.0, device=CPU)
    try:
        import json
        import urllib.request

        req = urllib.request.Request(
            h.url + "/predict",
            json.dumps({"data": x[:9].tolist(), "kind": "value"}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            got = np.asarray(json.loads(r.read())["predictions"], np.float32)
        assert np.array_equal(got, tb.predict(x[:9], device=CPU))
    finally:
        h.shutdown()
