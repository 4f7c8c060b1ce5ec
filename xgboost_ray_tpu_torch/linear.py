"""gblinear: the linear booster of the port.

Port of ``xgboost_ray_tpu/linear.py``: ``RayLinearBooster`` (``:44-250``:
weights [F, K], bias [K], predict, save / load and the xgboost-JSON export
and import in the same format, so a gblinear model written by either
package loads in the other) and ``LinearEngine`` (``:263-597``), the engine
``train()`` runs for ``booster="gblinear"``.

A round (``_build_round_fn``, ``:460-525``): the margins ``x @ w + b +
user_margin + base_margin`` (``ops/linear.linear_margins``, on the
device), the objective's gradients from them (K4's gh mode with a zero tree,
the softmax pass for ``multi:*``, K4's K-output kernel for quantiles: the
port's gradient code, bitwise its plain ``grad_hess``), then B16
(``ops/linear.linear_round``): the bias step and the cyclic pass over the
features. Missing values are implicit zeros. Both updater names run the
deterministic cyclic pass, as in the reference.

The reference's world is one process over several devices; the port's is
its ``torch.distributed`` world (``num_actors`` ranks, gloo on the CPU, a
card each over NCCL), each rank holding its rows, with one all-reduce of a
coordinate's [2K] sums (the reference's two psums, in one call). The
penalties are denormalized by the world's weight sum, taken on the host
with numpy over the world's weights in shard order, as the reference takes
it. Metrics are the tree engine's: the round pass over each set's new
margins in its eval mode, merged in one all-reduce.
"""

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from xgboost_ray_tpu_torch.device import resolve_device
from xgboost_ray_tpu_torch.engine import (
    TorchEngine,
    _concat_shards,
    _EvalSet,
    _shard_qids,
    _to_device,
)
from xgboost_ray_tpu_torch.distributed import Collectives
from xgboost_ray_tpu_torch.ops.linear import linear_margins, linear_round
from xgboost_ray_tpu_torch.ops.objectives import objective_from_params
from xgboost_ray_tpu_torch.params import TrainParams, cat_feature_indices


#: ``save_raw``'s document (the xgboost JSON and the training parameters)
RAW_FORMAT = "xgboost_ray_tpu_torch.gblinear"


class RayLinearBooster:
    """A trained linear model: ``margin = x @ weights + bias + m0``
    (``linear.py:44``), with the tree booster's surface where it applies
    (predict / save_model / load_model / save_raw / export_xgboost_json)."""

    def __init__(self, weights: np.ndarray, bias: np.ndarray,
                 params: TrainParams, base_score: float,
                 feature_names: Optional[List[str]] = None,
                 rounds: int = 0):
        self.weights = np.asarray(weights, np.float32)  # [F, K]
        self.bias = np.asarray(bias, np.float32)  # [K]
        self.params = params
        self.base_score = float(base_score)
        self.feature_names = feature_names
        self.rounds = int(rounds)
        self._attrs: Dict[str, str] = {}
        self.best_iteration: Optional[int] = None
        self.best_score: Optional[float] = None
        self.categories = None

    # ---- introspection ---------------------------------------------------
    @property
    def num_features(self) -> int:
        return int(self.weights.shape[0])

    @property
    def num_outputs(self) -> int:
        return int(self.weights.shape[1])

    @property
    def cat_features(self) -> tuple:
        return ()

    def num_boosted_rounds(self) -> int:
        return self.rounds

    def attributes(self) -> Dict[str, str]:
        return dict(self._attrs)

    def set_attr(self, **kwargs) -> None:
        for k, v in kwargs.items():
            if v is None:
                self._attrs.pop(k, None)
            else:
                self._attrs[k] = str(v)

    def attr(self, key: str) -> Optional[str]:
        return self._attrs.get(key)

    def _objective(self):
        return objective_from_params(self.params)

    def _coerce_features(self, data) -> np.ndarray:
        x = np.asarray(data, np.float32)
        if x.ndim != 2 or x.shape[1] != self.num_features:
            raise ValueError(
                f"feature shape mismatch: the model has {self.num_features} "
                f"features, the data {x.shape}")
        return x

    # ---- prediction ------------------------------------------------------
    def predict_margin(self, x, base_margin: Optional[np.ndarray] = None,
                       device=None) -> torch.Tensor:
        """[n, K] margins on ``device`` (the card unless ``"cpu"``): ``(x @
        weights + bias) + m0`` (NaN as 0), plus ``base_margin``. ``x @
        weights`` is ``linear_margins``' sum over the features in order,
        so a row's margin is the same bits wherever the row stands (a
        library product's blocking depends on it) and on either device,
        and equals its training margin."""
        dev = resolve_device(device)
        x = np.nan_to_num(self._coerce_features(x), nan=0.0)
        m0 = float(self._objective().base_score_to_margin(self.base_score))
        rows = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        w = torch.from_numpy(self.weights).to(dev)
        b = torch.from_numpy(self.bias).to(dev)
        margin = linear_margins(rows.T, w, b, None, m0)
        if base_margin is not None:
            margin = margin + torch.from_numpy(np.asarray(
                base_margin, np.float32).reshape(x.shape[0], -1)).to(dev)
        return margin

    def predict(self, x, output_margin: bool = False,
                base_margin: Optional[np.ndarray] = None, device=None,
                **kwargs):
        """Values or margins (``output_margin``) of ``x`` (``linear.py:111``):
        [n] for one output, else [n, K] (``multi:softmax``: [n] classes).
        ``iteration_range`` may only name the whole model ((0, 0) in any
        form), as there; tree outputs raise."""
        unsupported = [
            k for k in ("pred_contribs", "pred_interactions", "pred_leaf")
            if kwargs.get(k)
        ]
        it_range = kwargs.get("iteration_range")
        if it_range is not None:
            try:
                it_range = tuple(int(v) for v in it_range)
            except (TypeError, ValueError):
                it_range = kwargs.get("iteration_range")
        if kwargs.get("ntree_limit") or it_range not in (None, (0, 0)):
            unsupported.append("iteration_range/ntree_limit")
        if unsupported:
            raise NotImplementedError(
                f"gblinear predict does not support {unsupported} (a linear "
                f"model has no trees to slice or walk)."
            )
        margin = self.predict_margin(x, base_margin, device)
        if output_margin:
            out = margin[:, 0] if self.num_outputs == 1 else margin
            return out.cpu().numpy()
        return self._objective().transform(margin).cpu().numpy()

    # ---- serialization ---------------------------------------------------
    def save_model(self, fname: str) -> None:
        self.export_xgboost_json(fname)

    @classmethod
    def load_model(cls, fname: str) -> "RayLinearBooster":
        return cls.import_xgboost_json(fname)

    def _to_dict(self) -> Dict:
        """The xgboost document with every training parameter and the
        early-stopping record beside it (``save_raw``, pickles)."""
        return {"format": RAW_FORMAT,
                "params": dataclasses.asdict(self.params),
                "best_iteration": self.best_iteration,
                "best_score": self.best_score,
                "model": json.loads(self.export_xgboost_json())}

    @classmethod
    def _from_dict(cls, d: Dict) -> "RayLinearBooster":
        out = cls.import_xgboost_json(d["model"])
        known = {f.name for f in dataclasses.fields(TrainParams)}
        out.params = TrainParams(**{k: v for k, v in d["params"].items()
                                    if k in known})
        out.best_iteration = d.get("best_iteration")
        out.best_score = d.get("best_score")
        return out

    def save_raw(self) -> bytes:
        return json.dumps(self._to_dict()).encode("utf-8")

    @classmethod
    def load_raw(cls, raw: bytes) -> "RayLinearBooster":
        return cls._from_dict(json.loads(raw.decode("utf-8")))

    def __getstate__(self):
        return self._to_dict()

    def __setstate__(self, state):
        self.__dict__.update(self._from_dict(state).__dict__)

    def export_xgboost_json(self, fname: Optional[str] = None) -> str:
        """xgboost's gblinear JSON schema (``linear.py:156``): flat
        ``weights`` of length ``(F+1)*K``, feature-major with the K bias
        entries last; the objective's own parameter block."""
        from xgboost_ray_tpu_torch.models.xgb_export import (
            objective_param_entry,
        )

        f, k = self.weights.shape
        flat = np.concatenate(
            [self.weights.reshape(f * k), self.bias]).astype(float)
        obj_name, pkey, pval = objective_param_entry(self.params)
        doc = {
            "learner": {
                "attributes": dict(self._attrs),
                "feature_names": list(self.feature_names or []),
                "feature_types": [],
                "gradient_booster": {
                    "name": "gblinear",
                    "model": {
                        "param": {"num_feature": str(f),
                                  "num_output_group": str(max(k, 1))},
                        "boosted_rounds": int(self.rounds),
                        "weights": [float(v) for v in flat],
                    },
                },
                "learner_model_param": {
                    "base_score": str(self.base_score),
                    "boost_from_average": "1",
                    "num_class": str(int(self.params.num_class or 0)),
                    "num_feature": str(f),
                    "num_target": "1",
                },
                "objective": {"name": obj_name, pkey: pval},
            },
            "version": [2, 0, 0],
        }
        out = json.dumps(doc)
        if fname:
            with open(fname, "w") as fh:
                fh.write(out)
        return out

    @classmethod
    def import_xgboost_json(cls, data) -> "RayLinearBooster":
        """Load from a parsed dict, a path or a JSON string (``:200``),
        told apart by type and then by the path's existence."""
        if isinstance(data, dict):
            doc = data
        else:
            text = os.fspath(data) if isinstance(data, os.PathLike) else data
            if isinstance(text, bytes):
                text = text.decode()
            if os.path.exists(text):
                with open(text) as fh:
                    doc = json.load(fh)
            else:
                doc = json.loads(text)
        learner = doc["learner"]
        gb = learner["gradient_booster"]
        if gb.get("name") != "gblinear":
            raise ValueError(
                f"not a gblinear model: {gb.get('name')!r} (tree models load "
                f"via RayXGBoostBooster.import_xgboost_json)"
            )
        model = gb["model"]
        f = int(model.get("param", {}).get(
            "num_feature", learner["learner_model_param"]["num_feature"]))
        k = max(1, int(model.get("param", {}).get("num_output_group", "1")))
        flat = np.asarray(model["weights"], np.float32)
        params = TrainParams()
        params.booster = "gblinear"
        params.objective = learner.get("objective", {}).get(
            "name", "reg:squarederror")
        params.num_class = int(
            learner["learner_model_param"].get("num_class", "0") or 0)
        out = cls(
            flat[: f * k].reshape(f, k), flat[f * k: (f + 1) * k], params,
            base_score=float(
                learner["learner_model_param"].get("base_score", "0.5")),
            feature_names=list(learner.get("feature_names") or []) or None,
            rounds=int(model.get("boosted_rounds", 0) or 0),
        )
        for key, val in (learner.get("attributes") or {}).items():
            out.set_attr(**{key: val})
        return out


class LinearEngine(TorchEngine):
    """The engine of ``booster="gblinear"`` (``linear.py:263``): the tree
    engine's surface that ``train()``'s round loop uses (``step``,
    ``get_booster``, ``get_margins``, the metrics), one rank's rows of
    the world."""

    def __init__(
        self,
        shards: Sequence[Dict[str, Optional[np.ndarray]]],
        params: TrainParams,
        device=None,
        evals: Sequence[Tuple[Sequence[Dict[str, Optional[np.ndarray]]],
                              str]] = (),
        init_booster: Optional[RayLinearBooster] = None,
        feature_names: Optional[List[str]] = None,
        feature_types: Optional[List[str]] = None,
        custom_objective: bool = False,
        **_ignored,
    ):
        if cat_feature_indices(feature_types):
            raise NotImplementedError(
                "categorical features with booster='gblinear' are not "
                "supported (a single linear coefficient on category CODES "
                "would silently misread them as ordinal); one-hot encode "
                "the columns or use a tree booster."
            )
        self.params = params
        self.device = resolve_device(device)
        self.coll = Collectives()
        self.feature_names = feature_names
        self.objective = objective_from_params(params)
        if self.objective.ranking or self.objective.survival \
                or self.objective.cox:
            raise NotImplementedError(
                f"booster='gblinear' does not support objective "
                f"{params.objective!r} here (tree boosters do)."
            )
        if custom_objective:
            raise NotImplementedError(
                "custom objectives with booster='gblinear' are not supported."
            )
        self.custom_objective = False
        self.n_outputs = self.objective.num_outputs
        self.base_score = float(
            params.base_score if params.base_score is not None
            else self.objective.default_base_score)
        self.base_margin0 = float(
            self.objective.base_score_to_margin(self.base_score))
        self._setup_metrics(params)
        x, label, weight, base_margin, _, _ = _concat_shards(shards)
        if _shard_qids(shards) is not None:
            raise NotImplementedError("gblinear does not support qid groups.")
        if label is None:
            raise ValueError("gblinear training requires labels.")
        dev = self.device
        self.n_rows, self.n_features = x.shape
        self.label_np, self.weight_np = label, weight
        self.n_global = int(self.coll.sum(torch.tensor(
            [self.n_rows], dtype=torch.int64, device=dev)).item())
        self.sum_w = self._weight_sum(weight)
        self.xt = self._features(x)
        self.label = _to_device(label, dev)
        self.weight = (_to_device(weight, dev) if weight is not None
                       else torch.ones(self.n_rows, dtype=torch.float32,
                                       device=dev))
        self.user_margin = self._user_margin(base_margin, self.n_rows)
        self.lower = self.upper = None
        self.groups = self.group_ptr = self.cox = None
        self.auc_scale = self._auc_scale(weight, self.n_rows)
        k = self.n_outputs
        if init_booster is not None:
            if not isinstance(init_booster, RayLinearBooster):
                raise ValueError(
                    "xgb_model for booster='gblinear' must be a gblinear "
                    "model (got a tree booster)."
                )
            self.w = _to_device(init_booster.weights, dev)
            self.b = _to_device(init_booster.bias, dev)
            self.iteration_offset = init_booster.num_boosted_rounds()
        else:
            self.w = torch.zeros((self.n_features, k), dtype=torch.float32,
                                 device=dev)
            self.b = torch.zeros((k,), dtype=torch.float32, device=dev)
            self.iteration_offset = 0
        self._rounds_done = self.iteration_offset
        self.margins = None
        self.evals: List[_EvalSet] = []
        for eval_shards, name in evals:
            if eval_shards is shards:
                self.evals.append(_EvalSet(name, True))
                continue
            ex, el, ew, ebm, _, _ = _concat_shards(eval_shards)
            es = _EvalSet(name, False)
            es.xt = self._features(ex)
            es.label_np = self._host_label(el, ex.shape[0])
            es.weight_np = ew
            es.label = _to_device(es.label_np, dev)
            es.weight = (_to_device(ew, dev) if ew is not None
                         else torch.ones(ex.shape[0], dtype=torch.float32,
                                         device=dev))
            es.user_margin = self._user_margin(ebm, ex.shape[0])
            es.auc_scale = self._auc_scale(ew, ex.shape[0])
            self.evals.append(es)
        self._place_metrics()
        self.allreduce_bytes_per_round = 0
        self.hist_allreduce_bytes_per_round = 0
        self.sketch_seconds = 0.0

    def _features(self, x: np.ndarray) -> torch.Tensor:
        """Rows ``x`` [n, F] as feature-major [F, n] f32 on the device,
        NaN as 0 (the implicit zero of ``linear.py:345``)."""
        xt = np.ascontiguousarray(np.nan_to_num(
            np.asarray(x, np.float32), nan=0.0).T)
        return _to_device(xt, self.device)

    def _user_margin(self, base_margin: Optional[np.ndarray], n: int
                     ) -> Optional[torch.Tensor]:
        if base_margin is None:
            return None
        bm = np.zeros((n, self.n_outputs), np.float32)
        bm += np.asarray(base_margin, np.float32).reshape(n, -1)
        return _to_device(bm, self.device)

    def _weight_sum(self, weight: Optional[np.ndarray]) -> float:
        """The world's instance-weight sum as the reference takes it:
        ``np.sum`` of every row's weight in shard order (f32; rank order
        is shard order), all 1 without weights."""
        if weight is None:
            return float(np.sum(np.ones(self.n_global, np.float32)))
        if self.coll.world == 1:
            return float(np.sum(weight))
        counts = self.coll.row_counts(self.n_rows, self.device)
        allw = self.coll.all_gather(_to_device(weight, self.device), counts)
        return float(np.sum(allw.cpu().numpy()))

    @property
    def rounds_done(self) -> int:
        return self._rounds_done

    def gh_plane_bytes_per_shard(self) -> int:
        return 0

    def _margins(self, xt: torch.Tensor,
                 user_margin: Optional[torch.Tensor]) -> torch.Tensor:
        return linear_margins(xt, self.w, self.b, user_margin,
                              self.base_margin0)

    def step(self, iteration: int, gh_custom=None
             ) -> Dict[str, Dict[str, float]]:
        """One coordinate-descent round; {eval_name: {metric: value}} of the
        model after it."""
        if gh_custom is not None:
            raise NotImplementedError(
                "custom objectives with booster='gblinear' are not supported."
            )
        coll = self.coll
        coll.bytes.total = 0
        p = self.params
        k = self.n_outputs
        dev = self.device
        margins = self._margins(self.xt, self.user_margin)
        zeros = torch.zeros((k, self.n_rows), dtype=torch.float32, device=dev)
        gh = self._update(margins, zeros, self.label, self.weight)[0]
        self.w, self.b = linear_round(
            self.xt, gh.contiguous(), self.w, self.b, p.learning_rate,
            p.reg_lambda * self.sum_w, p.reg_alpha * self.sum_w,
            coll.sum if coll.world > 1 else None)
        self._rounds_done += 1
        self.margins = None
        if not self.evals:
            self.allreduce_bytes_per_round = coll.bytes.total
            return {}
        self.margins = self._margins(self.xt, self.user_margin)
        sums = self._update(self.margins, zeros, self.label, self.weight,
                            with_gh=False)[1]

        def held_out(es):
            es.margins = self._margins(es.xt, es.user_margin)
            zero = torch.zeros((k, es.margins.shape[0]), dtype=torch.float32,
                               device=dev)
            return self._update(es.margins, zero, es.label, es.weight,
                                with_gh=False)[1]

        return self._round_metrics(sums, None, held_out)

    def get_margins(self, es: Optional[_EvalSet] = None) -> np.ndarray:
        """This rank's margins [n, K] of the training set (or of ``es``)
        under the current model."""
        if es is None or es.is_train:
            if self.margins is None:
                self.margins = self._margins(self.xt, self.user_margin)
            return self.margins.cpu().numpy()
        if es.margins is None:
            es.margins = self._margins(es.xt, es.user_margin)
        return es.margins.cpu().numpy()

    def get_booster(self) -> RayLinearBooster:
        return RayLinearBooster(
            self.w.cpu().numpy(), self.b.cpu().numpy(), self.params,
            self.base_score, feature_names=self.feature_names,
            rounds=self._rounds_done)
