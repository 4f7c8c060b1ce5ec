"""scikit-learn estimators of the port.

Port of ``xgboost_ray_tpu/sklearn.py`` (the API of ``xgboost_ray/sklearn.py``):
``RayXGBRegressor``, ``RayXGBClassifier``, ``RayXGBRFRegressor``,
``RayXGBRFClassifier`` and ``RayXGBRanker`` expose the xgboost sklearn
surface (fit / predict / predict_proba / apply, eval_set, early stopping,
sample weights, base margins, a callable objective or eval_metric,
clone / get_params) and route everything through the port's ``train()`` /
``predict()`` over RayDMatrix. The module imports without scikit-learn, as
the JAX module does; the estimators then have no sklearn base classes.

The port adds one constructor argument, ``device`` (default None: the
card; ``"cpu"``: the plain PyTorch path), passed to ``train()`` and
``predict()`` and kept by ``get_params`` / ``clone``. The classifier
encodes its labels with ``np.unique(..., return_inverse=True)``: the codes
of the JAX module's per-row dict loop, without its per-row Python cost.
The random-forest pair (``subsample``, ``colsample_bynode``,
``num_parallel_tree``: ROADMAP A11) is defined with the JAX module's
defaults, and its ``fit`` raises ``NotImplementedError`` naming the key
the port refuses. ``RayXGBRanker`` trains ``rank:*`` over ``qid`` groups.
"""

import logging
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from xgboost_ray_tpu_torch.main import RayParams, predict as ray_predict, train as ray_train
from xgboost_ray_tpu_torch.matrix import RayDMatrix
from xgboost_ray_tpu_torch.models.booster import RayXGBoostBooster

logger = logging.getLogger(__name__)

_SKLEARN_INSTALLED = True
try:
    from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin
except ImportError:
    _SKLEARN_INSTALLED = False

    # distinct empty bases (``object`` itself as a base beside the mixins
    # gives no consistent method resolution order)
    class BaseEstimator:
        pass

    class ClassifierMixin:
        pass

    class RegressorMixin:
        pass


_PARAM_NAMES = [
    "n_estimators",
    "max_depth",
    "learning_rate",
    "verbosity",
    "objective",
    "booster",
    "tree_method",
    "n_jobs",
    "gamma",
    "min_child_weight",
    "max_delta_step",
    "subsample",
    "sampling_method",
    "top_rate",
    "other_rate",
    "colsample_bytree",
    "colsample_bylevel",
    "colsample_bynode",
    "reg_alpha",
    "reg_lambda",
    "scale_pos_weight",
    "base_score",
    "random_state",
    "missing",
    "num_parallel_tree",
    "max_bin",
    "eval_metric",
    "early_stopping_rounds",
]


def _check_if_params_are_ray_dmatrix(X, sample_weight, base_margin, eval_set,
                                     sample_weight_eval_set, base_margin_eval_set):
    """RayDMatrix passthrough with warnings (mirror ``sklearn.py:280-334``)."""
    train_dmatrix = None
    evals = ()
    if isinstance(X, RayDMatrix):
        params_to_warn = []
        if sample_weight is not None:
            params_to_warn.append("sample_weight")
        if base_margin is not None:
            params_to_warn.append("base_margin")
        if params_to_warn:
            warnings.warn(
                f"X is a RayDMatrix; {params_to_warn} will be ignored "
                f"(set them on the RayDMatrix instead)."
            )
        train_dmatrix = X
        if not X.has_label:
            raise ValueError(
                "X is a RayDMatrix without a label; pass the label to the "
                "RayDMatrix constructor."
            )
        if eval_set:
            if any(not isinstance(e[0], RayDMatrix) for e in eval_set):
                raise ValueError(
                    "If X is a RayDMatrix, all eval_set entries must be "
                    "(RayDMatrix, name) tuples."
                )
            evals = [
                (e[0], e[1] if len(e) > 1 and isinstance(e[1], str) else f"validation_{i}")
                for i, e in enumerate(eval_set)
            ]
    return train_dmatrix, evals


class _SklearnObjectiveAdapter:
    """xgboost's sklearn estimators take ``objective(y_true, y_pred) ->
    (grad, hess)`` and wrap it into the Booster-level ``obj(preds, dmatrix)``
    convention (xgboost ``_objective_decorator``). A module-level class, so
    it pickles to the ranks ``train()`` spawns on several cards."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, preds, dmat):
        return self.fn(dmat.get_label(), preds)


class _SklearnMetricAdapter:
    """Picklable wrapper turning a sklearn-style ``metric(y_true, y_pred)``
    into the train() custom-metric contract ``(preds, dmat) -> (name, value)``
    with the objective's prediction transform applied first. A module-level
    class, so it pickles to the ranks ``train()`` spawns on several cards."""

    def __init__(self, fn, obj_name: str, num_class: int, raw: bool = False):
        self.fn = fn
        self.obj_name = obj_name
        self.num_class = num_class
        # xgboost contract: with a CUSTOM objective the metric receives raw
        # margins (the metric applies the inverse link itself)
        self.raw = raw

    def __call__(self, preds, dmat):
        y = dmat.get_label()
        if self.raw:
            yp = np.asarray(preds).reshape(len(y), -1)
            if yp.shape[1] == 1:
                yp = yp[:, 0]
        else:
            import torch

            from xgboost_ray_tpu_torch.ops.objectives import (
                get_objective,
                transform_kind,
                value_transform,
            )

            m = torch.from_numpy(np.ascontiguousarray(
                np.asarray(preds, np.float32).reshape(len(y), -1)))
            kind = transform_kind(self.obj_name)
            if kind == "softmax":
                yp = get_objective(self.obj_name, self.num_class).transform(m)
            elif m.shape[1] > 1:  # reg:quantileerror's K quantiles
                yp = m
            else:
                yp = value_transform(m[:, 0], kind)
            yp = yp.numpy()
        w = dmat.get_weight()
        if w is not None and np.asarray(w).size:
            # xgboost's _metric_decorator passes eval-set weights through
            return self.fn.__name__, float(self.fn(y, yp, sample_weight=w))
        return self.fn.__name__, float(self.fn(y, yp))


class RayXGBMixin:
    """Shared plumbing for all estimators."""

    def _get_ray_params(self, ray_params) -> RayParams:
        if isinstance(ray_params, dict):
            ray_params = RayParams(**ray_params)
        if ray_params is None:
            n_jobs = getattr(self, "n_jobs", None) or 1
            ray_params = RayParams(num_actors=int(n_jobs))
        return ray_params

    def get_xgb_params(self) -> Dict[str, Any]:
        params = {}
        for name in _PARAM_NAMES:
            if name in ("n_estimators", "early_stopping_rounds", "eval_metric",
                        "missing", "n_jobs", "verbosity"):
                continue
            val = getattr(self, name, None)
            if val is not None:
                params[name] = val
        for name in getattr(self, "_extra_xgb_params", ()):
            if name in ("enable_categorical", "feature_types"):
                continue  # DMatrix-construction args, not training params
            val = getattr(self, name, None)
            if val is not None:
                params[name] = val
        if getattr(self, "eval_metric", None) is not None:
            params["eval_metric"] = self.eval_metric
        if getattr(self, "random_state", None) is not None:
            params["seed"] = self.random_state
        return params

    def _num_boost_round(self) -> int:
        return int(getattr(self, "n_estimators", None) or 100)

    def _build_matrices(
        self,
        X,
        y,
        *,
        sample_weight=None,
        base_margin=None,
        qid=None,
        eval_set=None,
        sample_weight_eval_set=None,
        base_margin_eval_set=None,
        eval_qid=None,
        feature_weights=None,
        ray_dmatrix_params=None,
    ):
        dm_params = dict(ray_dmatrix_params or {})
        missing = getattr(self, "missing", None)
        if missing is not None and not (isinstance(missing, float) and np.isnan(missing)):
            dm_params.setdefault("missing", missing)
        # estimator-level categorical knobs are DMatrix construction args
        # (reference sklearn.py:404-407 passes enable_categorical through)
        if getattr(self, "enable_categorical", False):
            dm_params.setdefault("enable_categorical", True)
        if getattr(self, "feature_types", None) is not None:
            dm_params.setdefault("feature_types", self.feature_types)
        train_dmatrix = RayDMatrix(
            X, label=y, weight=sample_weight, base_margin=base_margin,
            qid=qid, feature_weights=feature_weights, **dm_params,
        )
        evals = []
        if eval_set:
            for i, (ex, ey) in enumerate(eval_set):
                w = sample_weight_eval_set[i] if sample_weight_eval_set else None
                bm = base_margin_eval_set[i] if base_margin_eval_set else None
                q = eval_qid[i] if eval_qid else None
                if ex is X and ey is y and w is None and bm is None and q is None:
                    evals.append((train_dmatrix, f"validation_{i}"))
                else:
                    evals.append(
                        (
                            RayDMatrix(ex, label=ey, weight=w, base_margin=bm,
                                       qid=q, **dm_params),
                            f"validation_{i}",
                        )
                    )
        return train_dmatrix, evals

    def _fit_common(
        self,
        params: Dict[str, Any],
        train_dmatrix: RayDMatrix,
        evals: List[Tuple[RayDMatrix, str]],
        *,
        verbose=True,
        xgb_model=None,
        callbacks=None,
        early_stopping_rounds=None,
        ray_params=None,
        _remote=None,
        num_boost_round=None,
    ):
        evals_result: Dict = {}
        additional_results: Dict = {}
        extra = {}
        obj = None
        if callable(params.get("objective")):
            # sklearn-level custom objective: fn(y_true, y_pred) semantics
            obj = _SklearnObjectiveAdapter(params.pop("objective"))
            params["objective"] = self._default_objective_for_custom()
        if obj is not None:
            extra["obj"] = obj

        # xgboost >= 1.6 sklearn API: eval_metric may be a sklearn-style
        # callable metric(y_true, y_pred) (e.g. sklearn.metrics.log_loss);
        # route it through the train() custom-metric hook with the
        # objective's prediction transform applied first.
        em = params.get("eval_metric")
        metric_fn = None
        if callable(em):
            metric_fn = em
            params.pop("eval_metric")
        elif isinstance(em, (list, tuple)) and any(callable(m) for m in em):
            fns = [m for m in em if callable(m)]
            if len(fns) > 1:
                raise ValueError(
                    "at most one callable eval_metric is supported per fit"
                )
            metric_fn = fns[0]
            rest = [m for m in em if not callable(m)]
            if rest:
                params["eval_metric"] = list(rest)
            else:
                params.pop("eval_metric")
        if metric_fn is not None:
            extra["custom_metric"] = _SklearnMetricAdapter(
                metric_fn,
                params.get("objective", "reg:squarederror"),
                int(params.get("num_class", 0) or 0),
                raw=obj is not None,
            )
        esr = early_stopping_rounds
        if esr is None:
            esr = getattr(self, "early_stopping_rounds", None)
        if esr is not None:
            extra["early_stopping_rounds"] = esr
        # a refit must not inherit a previous fit's early-stop state: a stale
        # best_iteration would silently truncate predict() on the new model
        self.best_iteration = None
        self.best_score = None
        booster = ray_train(
            params,
            train_dmatrix,
            num_boost_round=num_boost_round or self._num_boost_round(),
            evals=evals,
            evals_result=evals_result,
            additional_results=additional_results,
            ray_params=self._get_ray_params(ray_params),
            _remote=_remote,
            verbose_eval=verbose,
            xgb_model=xgb_model,
            callbacks=callbacks,
            device=getattr(self, "device", None),
            **extra,
        )
        self._Booster = booster
        self.evals_result_ = evals_result
        self.additional_results_ = additional_results
        if booster.best_iteration is not None:
            self.best_iteration = booster.best_iteration
            self.best_score = booster.best_score
        self.n_features_in_ = booster.num_features
        return self

    def get_booster(self) -> RayXGBoostBooster:
        if not hasattr(self, "_Booster") or self._Booster is None:
            raise ValueError("need to call fit or load_model beforehand")
        return self._Booster

    def evals_result(self) -> Dict:
        return getattr(self, "evals_result_", {})

    def _ray_predict_margin_or_value(
        self,
        X,
        output_margin=False,
        ntree_limit=None,
        validate_features=True,
        base_margin=None,
        iteration_range=None,
        ray_params=None,
        _remote=None,
        ray_dmatrix_params=None,
    ) -> np.ndarray:
        """Route through the distributed predict (mirror ``sklearn.py:357-390``)."""
        booster = self.get_booster()
        kwargs = dict(
            output_margin=output_margin,
            validate_features=validate_features,
        )
        if ntree_limit:
            kwargs["ntree_limit"] = ntree_limit
        iteration_range = self._resolve_iteration_range(ntree_limit, iteration_range)
        if iteration_range is not None:
            kwargs["iteration_range"] = iteration_range
        if isinstance(X, RayDMatrix):
            data = X
        else:
            dm_params = dict(ray_dmatrix_params or {})
            if getattr(self, "enable_categorical", False):
                dm_params.setdefault("enable_categorical", True)
            if getattr(self, "feature_types", None) is not None:
                dm_params.setdefault("feature_types", self.feature_types)
            data = RayDMatrix(X, base_margin=base_margin, **dm_params)
        return ray_predict(
            booster, data, ray_params=self._get_ray_params(ray_params),
            _remote=_remote, device=getattr(self, "device", None), **kwargs,
        )

    def _default_objective_for_custom(self) -> str:
        """The objective whose transform/base-score semantics apply when the
        user supplies a callable objective: the estimator family's default
        (keeps predict_proba meaningful, xgboost's behavior of retaining the
        class default)."""
        if getattr(self, "n_classes_", 0) > 2:
            return "multi:softprob"
        return getattr(self, "_default_objective", "reg:squarederror")

    def _resolve_iteration_range(self, ntree_limit, iteration_range):
        """The xgboost sklearn early-stopping contract, in ONE place: when
        neither ntree_limit nor an explicit range is given, default to the
        best model (reference's ported suite checks best_iteration feeding
        predict, ``tests/test_sklearn.py``)."""
        if iteration_range is None and not ntree_limit:
            best_it = getattr(self, "best_iteration", None)
            if best_it is not None:
                return (0, int(best_it) + 1)
        return iteration_range

    def apply(self, X, ntree_limit: int = 0, iteration_range=None) -> np.ndarray:
        """Per-tree leaf heap index for each sample (xgboost ``apply``
        analog, incl. the >=1.6 ``iteration_range`` and best-model default
        after early stopping)."""
        booster = self.get_booster()
        iteration_range = self._resolve_iteration_range(ntree_limit, iteration_range)
        x = booster._coerce_features(X)
        leaves = booster.predict(
            x, pred_leaf=True, validate_features=False,
            iteration_range=iteration_range,
            device=getattr(self, "device", None),
        )
        if ntree_limit:
            leaves = leaves[:, :ntree_limit]
        return leaves

    @property
    def feature_importances_(self) -> np.ndarray:
        """Normalized importance; type from ``importance_type`` (default
        "gain", matching xgboost's sklearn wrapper), falling back to split
        counts ("weight")."""
        booster = self.get_booster()
        importance_type = getattr(self, "importance_type", None) or "gain"
        names = booster.feature_names or [
            f"f{i}" for i in range(booster.num_features)
        ]
        score = booster.get_score(importance_type=importance_type)
        vals = np.array([score.get(n, 0.0) for n in names], np.float64)
        total = vals.sum()
        return (vals / total) if total > 0 else vals

    @property
    def coef_(self) -> np.ndarray:
        """Linear coefficients — defined for ``booster="gblinear"`` only
        (xgboost sklearn convention: [F] or [K, F] for multi-output)."""
        booster = self.get_booster()
        if not hasattr(booster, "weights"):
            raise AttributeError(
                "coef_ is only defined for booster='gblinear' models."
            )
        w = np.asarray(booster.weights)  # [F, K]
        return w[:, 0] if w.shape[1] == 1 else w.T

    @property
    def intercept_(self) -> np.ndarray:
        """Linear bias — defined for ``booster="gblinear"`` only."""
        booster = self.get_booster()
        if not hasattr(booster, "weights"):
            raise AttributeError(
                "intercept_ is only defined for booster='gblinear' models."
            )
        return np.asarray(booster.bias)

    def save_model(self, fname: str):
        self.get_booster().save_model(fname)

    def load_model(self, fname: str):
        self._Booster = RayXGBoostBooster.load_model(fname)
        return self


class _RayXGBEstimator(BaseEstimator, RayXGBMixin):
    _default_objective = "reg:squarederror"

    def __init__(
        self,
        n_estimators: int = 100,
        max_depth: Optional[int] = None,
        learning_rate: Optional[float] = None,
        verbosity: Optional[int] = None,
        objective: Optional[Union[str, Callable]] = None,
        booster: Optional[str] = None,
        tree_method: Optional[str] = None,
        n_jobs: Optional[int] = None,
        gamma: Optional[float] = None,
        min_child_weight: Optional[float] = None,
        max_delta_step: Optional[float] = None,
        subsample: Optional[float] = None,
        sampling_method: Optional[str] = None,
        top_rate: Optional[float] = None,
        other_rate: Optional[float] = None,
        colsample_bytree: Optional[float] = None,
        colsample_bylevel: Optional[float] = None,
        colsample_bynode: Optional[float] = None,
        reg_alpha: Optional[float] = None,
        reg_lambda: Optional[float] = None,
        scale_pos_weight: Optional[float] = None,
        base_score: Optional[float] = None,
        random_state: Optional[int] = None,
        missing: float = np.nan,
        num_parallel_tree: Optional[int] = None,
        max_bin: Optional[int] = None,
        eval_metric: Optional[Union[str, List[str]]] = None,
        early_stopping_rounds: Optional[int] = None,
        device: Optional[str] = None,
        **kwargs,
    ):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.verbosity = verbosity
        self.objective = objective
        self.booster = booster
        self.tree_method = tree_method
        self.n_jobs = n_jobs
        self.gamma = gamma
        self.min_child_weight = min_child_weight
        self.max_delta_step = max_delta_step
        self.subsample = subsample
        # explicit ctor params (not **kwargs) so sklearn clone()/set_params
        # carry the GOSS config through CV/pipelines
        self.sampling_method = sampling_method
        self.top_rate = top_rate
        self.other_rate = other_rate
        self.colsample_bytree = colsample_bytree
        self.colsample_bylevel = colsample_bylevel
        self.colsample_bynode = colsample_bynode
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.scale_pos_weight = scale_pos_weight
        self.base_score = base_score
        self.random_state = random_state
        self.missing = missing
        self.num_parallel_tree = num_parallel_tree
        self.max_bin = max_bin
        self.eval_metric = eval_metric
        self.early_stopping_rounds = early_stopping_rounds
        # where train() and predict() run: None the card, "cpu" the CPU
        self.device = device
        # arbitrary xgboost params (dart knobs, constraints, ...) ride along
        # and are forwarded by get_xgb_params — the training-params parser is
        # the single place that accepts/rejects them (no silent drops)
        self._extra_xgb_params = list(kwargs)
        for key, value in kwargs.items():
            setattr(self, key, value)

    def _more_tags(self):
        return {"non_deterministic": False, "allow_nan": True}

    def fit(
        self,
        X,
        y=None,
        *,
        sample_weight=None,
        base_margin=None,
        eval_set=None,
        sample_weight_eval_set=None,
        base_margin_eval_set=None,
        verbose=False,
        xgb_model=None,
        feature_weights=None,
        callbacks=None,
        early_stopping_rounds=None,
        ray_params=None,
        _remote=None,
        ray_dmatrix_params=None,
    ):
        params = self.get_xgb_params()
        params.setdefault("objective", self._default_objective)
        dm, evals = _check_if_params_are_ray_dmatrix(
            X, sample_weight, base_margin, eval_set,
            sample_weight_eval_set, base_margin_eval_set,
        )
        if dm is None:
            dm, evals = self._build_matrices(
                X, y, sample_weight=sample_weight, base_margin=base_margin,
                eval_set=eval_set,
                sample_weight_eval_set=sample_weight_eval_set,
                base_margin_eval_set=base_margin_eval_set,
                feature_weights=feature_weights,
                ray_dmatrix_params=ray_dmatrix_params,
            )
        return self._fit_common(
            params, dm, list(evals), verbose=verbose, xgb_model=xgb_model,
            callbacks=callbacks, early_stopping_rounds=early_stopping_rounds,
            ray_params=ray_params, _remote=_remote,
        )

    def predict(
        self,
        X,
        output_margin=False,
        ntree_limit=None,
        validate_features=True,
        base_margin=None,
        iteration_range=None,
        ray_params=None,
        _remote=None,
        ray_dmatrix_params=None,
    ):
        return self._ray_predict_margin_or_value(
            X, output_margin=output_margin, ntree_limit=ntree_limit,
            validate_features=validate_features, base_margin=base_margin,
            iteration_range=iteration_range, ray_params=ray_params,
            _remote=_remote, ray_dmatrix_params=ray_dmatrix_params,
        )


def encode_labels(classes: np.ndarray, y) -> np.ndarray:
    """f32 codes of labels ``y`` in the sorted ``classes`` (what
    ``np.unique``'s inverse gives the training labels); a label outside
    ``classes`` raises."""
    y = np.asarray(y).reshape(-1)
    idx = np.searchsorted(classes, y)
    ok = idx < len(classes)
    ok[ok] = classes[idx[ok]] == y[ok]
    if not ok.all():
        raise ValueError(
            f"labels {np.unique(y[~ok])[:5].tolist()} are not among the "
            f"classes of the training labels {classes.tolist()[:10]}")
    return idx.astype(np.float32)


class RayXGBRegressor(RegressorMixin, _RayXGBEstimator):
    """Distributed XGBoost-style regressor (mirror ``sklearn.py:602-644``).

    Mixin-first base order so sklearn's tag system (``__sklearn_tags__``)
    reports estimator_type="regressor" — meta-estimators (Stacking*, CV
    selectors) validate on it."""

    _default_objective = "reg:squarederror"


class RayXGBClassifier(ClassifierMixin, _RayXGBEstimator):
    """Distributed XGBoost-style classifier (mirror ``sklearn.py:451-600``)."""

    _default_objective = "binary:logistic"

    def fit(
        self,
        X,
        y=None,
        *,
        sample_weight=None,
        base_margin=None,
        eval_set=None,
        sample_weight_eval_set=None,
        base_margin_eval_set=None,
        verbose=False,
        xgb_model=None,
        feature_weights=None,
        callbacks=None,
        early_stopping_rounds=None,
        ray_params=None,
        _remote=None,
        ray_dmatrix_params=None,
    ):
        params = self.get_xgb_params()
        dm, evals = _check_if_params_are_ray_dmatrix(
            X, sample_weight, base_margin, eval_set,
            sample_weight_eval_set, base_margin_eval_set,
        )
        if dm is not None:
            num_class = params.get("num_class", 0)
            self.classes_ = np.arange(max(2, num_class))
            self.n_classes_ = max(2, int(num_class))
            y_enc = None
        else:
            self.classes_, codes = np.unique(np.asarray(y),
                                             return_inverse=True)
            self.n_classes_ = len(self.classes_)
            y_enc = codes.reshape(-1).astype(np.float32)

        if self.n_classes_ > 2:
            if callable(params.get("objective")):
                # custom objective: transforms fall back to softprob semantics
                params["num_class"] = self.n_classes_
            else:
                params.setdefault("objective", "multi:softprob")
                if params["objective"].startswith("multi"):
                    params["num_class"] = self.n_classes_
        else:
            params.setdefault("objective", self._default_objective)

        if dm is None:
            enc_eval_set = None
            if eval_set:
                enc_eval_set = [(ex, encode_labels(self.classes_, ey))
                                for ex, ey in eval_set]
            dm, evals = self._build_matrices(
                X, y_enc, sample_weight=sample_weight, base_margin=base_margin,
                eval_set=enc_eval_set,
                sample_weight_eval_set=sample_weight_eval_set,
                base_margin_eval_set=base_margin_eval_set,
                feature_weights=feature_weights,
                ray_dmatrix_params=ray_dmatrix_params,
            )
        return self._fit_common(
            params, dm, list(evals), verbose=verbose, xgb_model=xgb_model,
            callbacks=callbacks, early_stopping_rounds=early_stopping_rounds,
            ray_params=ray_params, _remote=_remote,
        )

    def predict_proba(
        self,
        X,
        ntree_limit=None,
        validate_features=True,
        base_margin=None,
        iteration_range=None,
        ray_params=None,
        _remote=None,
        ray_dmatrix_params=None,
    ) -> np.ndarray:
        raw = self._ray_predict_margin_or_value(
            X, output_margin=False, ntree_limit=ntree_limit,
            validate_features=validate_features, base_margin=base_margin,
            iteration_range=iteration_range, ray_params=ray_params,
            _remote=_remote, ray_dmatrix_params=ray_dmatrix_params,
        )
        raw = np.asarray(raw)
        if raw.ndim == 2:
            return raw
        return np.stack([1.0 - raw, raw], axis=1)

    def predict(
        self,
        X,
        output_margin=False,
        ntree_limit=None,
        validate_features=True,
        base_margin=None,
        iteration_range=None,
        ray_params=None,
        _remote=None,
        ray_dmatrix_params=None,
    ):
        raw = self._ray_predict_margin_or_value(
            X, output_margin=output_margin, ntree_limit=ntree_limit,
            validate_features=validate_features, base_margin=base_margin,
            iteration_range=iteration_range, ray_params=ray_params,
            _remote=_remote, ray_dmatrix_params=ray_dmatrix_params,
        )
        if output_margin:
            return raw
        raw = np.asarray(raw)
        if raw.ndim == 2:
            idx = raw.argmax(axis=1)
        else:
            booster = self.get_booster()
            if booster.params.objective == "multi:softmax":
                idx = raw.astype(int)
            else:
                idx = (raw > 0.5).astype(int)
        classes = getattr(self, "classes_", None)
        if classes is None:
            return idx
        return np.asarray(classes)[idx]


class RayXGBRFRegressor(RayXGBRegressor):
    """Random-forest variant (mirror ``sklearn.py:880-919``): one boosting
    round of ``n_estimators`` parallel trees, lr=1, row/column subsampling."""

    def __init__(self, *, learning_rate=1.0, subsample=0.8, colsample_bynode=0.8,
                 reg_lambda=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, subsample=subsample,
                         colsample_bynode=colsample_bynode,
                         reg_lambda=reg_lambda, **kwargs)

    def get_xgb_params(self):
        params = super().get_xgb_params()
        params["num_parallel_tree"] = self.n_estimators
        return params

    def _num_boost_round(self):
        return 1


class RayXGBRFClassifier(RayXGBClassifier):
    """Random-forest classifier variant (mirror ``sklearn.py:631-637``)."""

    def __init__(self, *, learning_rate=1.0, subsample=0.8, colsample_bynode=0.8,
                 reg_lambda=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, subsample=subsample,
                         colsample_bynode=colsample_bynode,
                         reg_lambda=reg_lambda, **kwargs)

    def get_xgb_params(self):
        params = super().get_xgb_params()
        params["num_parallel_tree"] = self.n_estimators
        return params

    def _num_boost_round(self):
        return 1


class RayXGBRanker(_RayXGBEstimator):
    """Learning-to-rank estimator (mirror ``sklearn.py:921-1040``): ``qid``
    (and ``eval_qid``, one per eval set) groups the rows into queries."""

    _default_objective = "rank:pairwise"

    def fit(
        self,
        X,
        y=None,
        *,
        qid=None,
        sample_weight=None,
        base_margin=None,
        eval_set=None,
        eval_qid=None,
        sample_weight_eval_set=None,
        base_margin_eval_set=None,
        verbose=False,
        xgb_model=None,
        feature_weights=None,
        callbacks=None,
        early_stopping_rounds=None,
        ray_params=None,
        _remote=None,
        ray_dmatrix_params=None,
    ):
        params = self.get_xgb_params()
        params.setdefault("objective", self._default_objective)
        if not params["objective"].startswith("rank:"):
            raise ValueError(
                "RayXGBRanker requires a rank:* objective, got "
                f"{params['objective']!r}"
            )
        dm, evals = _check_if_params_are_ray_dmatrix(
            X, sample_weight, base_margin, eval_set,
            sample_weight_eval_set, base_margin_eval_set,
        )
        if dm is None:
            if qid is None:
                raise ValueError(
                    "RayXGBRanker requires the `qid` argument (or a RayDMatrix "
                    "constructed with qid)."
                )
            dm, evals = self._build_matrices(
                X, y, sample_weight=sample_weight, base_margin=base_margin,
                qid=qid, eval_set=eval_set, eval_qid=eval_qid,
                sample_weight_eval_set=sample_weight_eval_set,
                base_margin_eval_set=base_margin_eval_set,
                feature_weights=feature_weights,
                ray_dmatrix_params=ray_dmatrix_params,
            )
        elif dm.loader.qid is None:
            raise ValueError("RayXGBRanker requires a RayDMatrix with qid.")
        return self._fit_common(
            params, dm, list(evals), verbose=verbose, xgb_model=xgb_model,
            callbacks=callbacks, early_stopping_rounds=early_stopping_rounds,
            ray_params=ray_params, _remote=_remote,
        )
