"""The trained-model object of the port.

Port of ``xgboost_ray_tpu/models/booster.py`` (``:760-930``): the forest in
padded-heap layout (host numpy arrays, ``[T, heap]`` per field of
``ops.grow.Tree``), the binning cuts and the parameters, with
``save_model``/``load_model``, ``save_raw``/``load_raw`` and ``get_dump``;
and prediction (``:145`` ``cat_features``, ``:156`` ``signature``, ``:204``
``_coerce_features``, ``:254`` ``slice_rounds``, ``:268``
``base_score_margin_np``, ``:277`` ``predict_margin_np``, ``:680``
``predict``, and ``:732`` ``_margin_to_prediction``, which B8 fuses)
through B8 (``ops/predict.py``), and SHAP contributions and interaction
values (``:578-678``: ``_finalize_contribs``, ``_assert_node_stats``,
``predict_contribs``, ``predict_interactions``) through B15
(``ops/shap.py``, its tables built once per device and kept with the
model), on the card unless ``device="cpu"``.
Rows go to the device in chunks of at most ``_CHUNK_BYTES`` of input,
output and kernel scratch, one launch a chunk, so a large ``pred_leaf``
(``[N, T]`` int32) or interactions output never has to fit the card at
once. ``get_dump`` writes text or xgboost's JSON dump (``:846-848``), and
``export_xgboost_json`` / ``import_xgboost_json`` (``:744-756``) xgboost's
model schema (``models/xgb_export.py``).
The host API the sklearn estimators read is the JAX module's too:
``get_score`` / ``get_fscore`` (``:968-996``), ``trees_to_dataframe``
(``:932``), ``attributes`` / ``attr`` / ``set_attr`` (``:189-202``), and
pickling through ``_to_dict`` (``:998-1004``), so a pickle holds host
arrays only and loads on a host without a card.
``coerce_model`` turns the model forms ``predict()`` and the serving
registry accept (booster, pickled bytes, saved-model path, JSON document
of either schema) into a booster.
The JSON is the JAX package's format (``"format":
"xgboost_ray_tpu.booster"``), so files cross-load both ways. The arrays
are written as an npz whose zip entries carry a fixed timestamp, so
``save_raw`` of a loaded model gives the same bytes.
"""

import base64
import dataclasses
import io
import json
import os
import pickle
import threading
import warnings
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from xgboost_ray_tpu_torch.device import resolve_device
from xgboost_ray_tpu_torch.ops import predict as predict_ops
from xgboost_ray_tpu_torch.ops import shap as shap_ops
from xgboost_ray_tpu_torch.ops.grow import Tree
from xgboost_ray_tpu_torch.ops.objectives import (
    QUANTILE,
    base_score_margin,
    transform_kind,
)
from xgboost_ray_tpu_torch.params import TrainParams, cat_feature_indices

FORMAT = "xgboost_ray_tpu.booster"

#: most bytes of one predict chunk on the device (rows in, results out)
_CHUNK_BYTES = 1 << 31

_TREE_DTYPES = {
    "feature": np.int32, "split_bin": np.int32, "threshold": np.float32,
    "default_left": np.bool_, "is_leaf": np.bool_, "value": np.float32,
    "gain": np.float32, "cover": np.float32, "base_weight": np.float32,
}


def forest_to_np(forest) -> Tree:
    """Any Tree-shaped container of arrays or tensors -> numpy Tree."""
    out = []
    for name, f in zip(Tree._fields, forest):
        if hasattr(f, "detach"):
            f = f.detach().cpu().numpy()
        out.append(np.asarray(f, dtype=_TREE_DTYPES[name]))
    return Tree(*out)


def stack_trees(trees: List[Tree]) -> Tree:
    """Stack per-round trees ([heap] or [k, heap] each) into [T, heap]."""
    if not trees:
        raise ValueError("empty forest")
    trees = [forest_to_np(t) for t in trees]
    return Tree(*[
        np.concatenate([np.atleast_2d(t[i]) for t in trees], axis=0)
        for i in range(len(Tree._fields))
    ])


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        for name, arr in arrays.items():
            info = zipfile.ZipInfo(f"{name}.npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            with zf.open(info, "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)
    return buf.getvalue()


class RayXGBoostBooster:
    """Trained GBDT ensemble (gbtree)."""

    def __init__(
        self,
        forest: Tree,
        cuts: np.ndarray,
        params: TrainParams,
        base_score: float,
        feature_names: Optional[List[str]] = None,
        feature_types: Optional[List[str]] = None,
        tree_weights: Optional[np.ndarray] = None,
    ):
        self.forest = forest_to_np(forest)
        self.cuts = np.asarray(cuts, dtype=np.float32)
        self.params = params
        self.base_score = float(base_score)
        self.tree_weights = (
            None if tree_weights is None else np.asarray(tree_weights, np.float32)
        )
        self.feature_names = feature_names
        self.feature_types = feature_types
        self.categories: Optional[Dict[int, tuple]] = None
        self.best_iteration: Optional[int] = None
        self.best_score: Optional[float] = None
        self._attributes: Dict[str, str] = {}
        self._has_node_stats: bool = True
        # device -> the forest's SHAP tables there (ops.shap.shap_forest)
        self._shap_forests: Dict[str, Any] = {}
        self._shap_lock = threading.Lock()

    # -- introspection -----------------------------------------------------

    @property
    def num_features(self) -> int:
        return int(self.cuts.shape[0])

    @property
    def num_outputs(self) -> int:
        if self.params.objective == QUANTILE:
            qa = self.params.quantile_alpha
            return len(qa) if isinstance(qa, (list, tuple)) else 1
        return max(self.params.num_class, 1)

    @property
    def max_depth(self) -> int:
        heap = self.forest.feature.shape[1]
        return int(np.log2(heap + 1)) - 1

    def num_boosted_rounds(self) -> int:
        per_round = self.num_outputs * self.params.num_parallel_tree
        return int(self.forest.feature.shape[0] // per_round)

    @property
    def num_trees(self) -> int:
        return int(self.forest.feature.shape[0])

    def attributes(self) -> Dict[str, str]:
        return dict(self._attributes)

    def attr(self, key: str) -> Optional[str]:
        return self._attributes.get(key)

    def set_attr(self, **kwargs) -> None:
        for k, v in kwargs.items():
            if v is None:
                self._attributes.pop(k, None)
            else:
                self._attributes[k] = str(v)

    @property
    def cat_features(self) -> tuple:
        """Indices of categorical features ('c' in feature_types)."""
        return cat_feature_indices(self.feature_types)

    def signature(self) -> tuple:
        """Structural identity of the model (the serve layer's key): the
        forest and feature shapes, the walk's static parameters and the
        objective envelope, not the array contents."""
        p = self.params
        return (
            "gbtree",
            int(self.forest.feature.shape[0]),
            int(self.forest.feature.shape[1]),
            self.num_features,
            self.num_outputs,
            self.max_depth,
            p.num_parallel_tree,
            self.tree_weights is not None,
            self.cat_features,
            p.objective,
            p.num_class,
            float(p.scale_pos_weight),
        )

    # -- prediction --------------------------------------------------------

    def _coerce_features(self, data) -> np.ndarray:
        """numpy or pandas rows -> [N, F] f32. A frame is put in the
        model's feature order; its category columns become the training
        category codes (unseen categories NaN, as xgboost)."""
        import pandas as pd

        if isinstance(data, pd.DataFrame):
            if self.feature_names and list(data.columns) != list(self.feature_names):
                cols = [c for c in self.feature_names if c in data.columns]
                if len(cols) == len(self.feature_names):
                    data = data[self.feature_names]
            non_numeric = [
                c for c in data.columns
                if not pd.api.types.is_numeric_dtype(data[c].dtype)
            ]
            if non_numeric:
                data = data.copy()
                col_pos = {c: i for i, c in enumerate(data.columns)}
                for c in non_numeric:
                    cats = (self.categories or {}).get(col_pos[c])
                    if cats is not None:
                        codes = pd.Categorical(
                            data[c], categories=list(cats)
                        ).codes.astype(np.float32)
                        codes = pd.Series(codes, index=data.index)
                    elif col_pos[c] in self.cat_features:
                        raise ValueError(
                            f"column {c!r} is categorical in the model but no "
                            f"category mapping was recorded (the model was "
                            f"trained on integer codes); pass codes encoded "
                            f"the same way as training."
                        )
                    else:
                        codes = data[c].astype("category").cat.codes.astype(
                            np.float32)
                    data[c] = codes.where(codes >= 0, np.nan)
            data = data.to_numpy()
        x = np.asarray(data, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[1] != self.num_features:
            raise ValueError(
                f"Feature shape mismatch: model expects {self.num_features}, "
                f"got {x.shape[1]}"
            )
        return x

    def slice_rounds(self, begin: int, end: int) -> "RayXGBoostBooster":
        """Sub-forest covering boosting rounds [begin, end)."""
        per_round = self.num_outputs * self.params.num_parallel_tree
        sl = slice(begin * per_round, end * per_round)
        out = RayXGBoostBooster(
            Tree(*[f[sl] for f in self.forest]), self.cuts, self.params,
            self.base_score, self.feature_names, self.feature_types,
            tree_weights=(None if self.tree_weights is None
                          else self.tree_weights[sl]),
        )
        out._has_node_stats = self._has_node_stats
        out.categories = self.categories
        return out

    def _rounds(self, iteration_range) -> "RayXGBoostBooster":
        if iteration_range is None or tuple(iteration_range) == (0, 0):
            return self
        return self.slice_rounds(iteration_range[0], iteration_range[1])

    def base_score_margin_np(self) -> float:
        """The margin-space offset implied by this booster's base_score."""
        return base_score_margin(self.params.objective, self.base_score)

    def device_forest(self, device, layout: str = "heap"):
        """The packed forest on ``device`` (``ops.predict.PredictForest``),
        its categorical flags from ``cat_features``."""
        return predict_ops.device_forest(
            self.forest, self.max_depth, layout, device,
            num_features=self.num_features, cat_features=self.cat_features)

    def device_tree_weights(self, device) -> Optional[torch.Tensor]:
        if self.tree_weights is None:
            return None
        return torch.from_numpy(self.tree_weights.copy()).to(device)

    def _chunks(self, n: int, row_bytes: int):
        step = max(1, _CHUNK_BYTES // max(row_bytes, 1))
        for lo in range(0, n, step):
            yield lo, min(lo + step, n)

    def predict_margin(
        self, x: np.ndarray, ntree_limit: int = 0,
        base_margin: Optional[np.ndarray] = None, device=None,
        transform: bool = False,
    ) -> np.ndarray:
        """[N, K] raw margins of f32 rows ``x`` (the reference's
        ``predict_margin_np``), or with ``transform`` the objective's
        predictions: [N] (the sigmoid, exp or hinge's 0/1 fused into B8;
        ``multi:softmax``'s classes) or [N, K] (``multi:softprob``'s
        probabilities, the softmax pass after B8; ``reg:quantileerror``'s K
        quantiles, the margins themselves), computed on ``device`` (the card
        by default)."""
        dev = resolve_device(device)
        n, num_features = x.shape
        k = self.num_outputs
        m0 = self.base_score_margin_np()
        objective = self.params.objective if transform else None
        width = k
        if transform:
            transform_kind(objective)  # raises outside the port
            width = predict_ops.value_width(objective, k)
        fo = self.device_forest(dev)
        tw = self.device_tree_weights(dev)
        out = np.empty((n, width) if width > 1 or not transform else (n,),
                       np.float32)
        row_bytes = 4 * (num_features + 2 * k)
        for lo, hi in self._chunks(n, row_bytes):
            xd = torch.from_numpy(np.ascontiguousarray(x[lo:hi])).to(dev)
            base = None
            if base_margin is not None:
                bm = np.full((hi - lo, k), m0, np.float32) + np.asarray(
                    base_margin[lo:hi], np.float32).reshape(hi - lo, -1)
                base = torch.from_numpy(bm).to(dev)
            margin = predict_ops.predict_margin(
                fo, xd, base, base0=m0, num_outputs=k,
                num_parallel_tree=self.params.num_parallel_tree,
                ntree_limit=int(ntree_limit), tree_weights=tw,
                transform=objective)
            out[lo:hi] = margin.reshape(out[lo:hi].shape).cpu().numpy()
        return out

    def predict_leaf(self, x: np.ndarray, device=None) -> np.ndarray:
        """[N, T] int32 heap index of the leaf each row reaches per tree."""
        dev = resolve_device(device)
        n, num_features = x.shape
        fo = self.device_forest(dev)
        out = np.empty((n, self.num_trees), np.int32)
        for lo, hi in self._chunks(n, 4 * (num_features + self.num_trees)):
            xd = torch.from_numpy(np.ascontiguousarray(x[lo:hi])).to(dev)
            out[lo:hi] = predict_ops.predict_leaf_index(fo, xd).cpu().numpy()
        return out

    def shap_forest(self, device) -> "shap_ops.ShapForest":
        """The forest's SHAP tables on ``device`` (``ops.shap.ShapForest``),
        built on the first call and kept with the model, so every later
        contributions call and every serve replica on that device reads the
        same tables."""
        dev = resolve_device(device)
        with self._shap_lock:
            sf = self._shap_forests.get(str(dev))
            if sf is None:
                sf = self._shap_forests[str(dev)] = shap_ops.shap_forest(
                    self.forest, self.max_depth, dev,
                    num_features=self.num_features,
                    cat_features=self.cat_features)
        return sf

    def tree_scales(self, sf, ntree_limit: int = 0):
        """``ops.shap.tree_scales`` of this model on ``sf``'s device."""
        return shap_ops.tree_scales(
            sf, self.num_outputs, self.params.num_parallel_tree,
            int(ntree_limit), self.tree_weights)

    def _assert_node_stats(self) -> None:
        if not self._has_node_stats:
            raise ValueError(
                "This model was saved by a version without per-node "
                "statistics (cover/base_weight); prediction contributions "
                "would be all-zero. Re-train or re-save the model with this "
                "version."
            )

    def _finalize_contribs(self, out: np.ndarray, kind: str,
                           base_margin: Optional[np.ndarray]) -> np.ndarray:
        """The base-score margin (and a user ``base_margin``) into the bias
        slot, and the class axis squeezed for one output (the reference's
        ``_finalize_contribs``; the serve predictor finalizes the same
        way)."""
        n = out.shape[0]
        k = out.shape[1]
        m0 = np.float32(self.base_score_margin_np())
        if kind == "interactions":
            out[:, :, -1, -1] += m0
            if base_margin is not None:
                out[:, :, -1, -1] += np.asarray(
                    base_margin, np.float32).reshape(n, -1)
            return out[:, 0] if k == 1 else out
        out[:, :, -1] += m0
        if base_margin is not None:
            out[:, :, -1] += np.asarray(base_margin, np.float32).reshape(n, -1)
        return out[:, 0, :] if k == 1 else out

    def _shap(self, x: np.ndarray, mode: str, ntree_limit: int,
              base_margin: Optional[np.ndarray], device) -> np.ndarray:
        self._assert_node_stats()
        dev = resolve_device(device)
        n, num_features = x.shape
        k = self.num_outputs
        sf = self.shap_forest(dev)
        sc = self.tree_scales(sf, ntree_limit)
        shape = shap_ops.out_shape(n, num_features, k, mode)
        width = int(np.prod(shape[1:]))
        # the scratch of the launch plan of all n rows: no chunk needs more
        sms = (shap_ops._sm_count(dev.index or 0) if dev.type == "cuda"
               else 132)
        words = shap_ops.scratch_floats(sf, num_features, k, mode, n, sms)
        out = np.empty(shape, np.float32)
        run = {"saabas": shap_ops.predict_contribs,
               "exact": shap_ops.predict_contribs_exact,
               "interactions": shap_ops.predict_interactions}[mode]
        for lo, hi in self._chunks(n, 4 * (num_features + width + words)):
            xd = torch.from_numpy(np.ascontiguousarray(x[lo:hi])).to(dev)
            out[lo:hi] = run(sf, xd, sc).cpu().numpy()
        return self._finalize_contribs(
            out, "interactions" if mode == "interactions" else "contribs",
            base_margin)

    def predict_contribs(self, x: np.ndarray, ntree_limit: int = 0,
                         base_margin: Optional[np.ndarray] = None,
                         approx: bool = False, device=None) -> np.ndarray:
        """Per-feature contributions [N, F+1] (one output) or [N, K, F+1],
        bias last, rows summing to the margin: exact TreeSHAP, or with
        ``approx`` the Saabas path attribution (xgboost
        ``approx_contribs=True``); one B15 launch per chunk of rows, on
        ``device`` (the card by default)."""
        return self._shap(x, "saabas" if approx else "exact", ntree_limit,
                          base_margin, device)

    def predict_interactions(self, x: np.ndarray, ntree_limit: int = 0,
                             base_margin: Optional[np.ndarray] = None,
                             device=None) -> np.ndarray:
        """SHAP interaction values [N, F+1, F+1] (or [N, K, F+1, F+1]):
        each feature row sums to that feature's contribution and the grand
        total equals the margin (xgboost ``pred_interactions``)."""
        return self._shap(x, "interactions", ntree_limit, base_margin,
                          device)

    def predict(
        self,
        data,
        output_margin: bool = False,
        pred_leaf: bool = False,
        pred_contribs: bool = False,
        pred_interactions: bool = False,
        ntree_limit: int = 0,
        iteration_range: Optional[Tuple[int, int]] = None,
        validate_features: bool = True,
        base_margin: Optional[np.ndarray] = None,
        approx_contribs: bool = False,
        device=None,
        **_ignored,
    ) -> np.ndarray:
        """Predict (API of ``xgboost_ray_tpu.RayXGBoostBooster.predict``):
        values, margins (``output_margin``), leaf indices (``pred_leaf``),
        SHAP contributions (``pred_contribs``, Saabas with
        ``approx_contribs``) or interaction values (``pred_interactions``),
        on the card unless ``device="cpu"``."""
        x = self._coerce_features(data)
        booster = self._rounds(iteration_range)
        if pred_interactions:
            if approx_contribs:
                warnings.warn(
                    "approx_contribs=True is ignored with pred_interactions: "
                    "only the exact interactions kernel is implemented."
                )
            return booster.predict_interactions(x, ntree_limit, base_margin,
                                                device)
        if pred_contribs:
            return booster.predict_contribs(x, ntree_limit, base_margin,
                                            approx_contribs, device)
        if pred_leaf:
            return booster.predict_leaf(x, device=device)
        if output_margin:
            margin = booster.predict_margin(x, ntree_limit, base_margin, device)
            return margin[:, 0] if self.num_outputs == 1 else margin
        return booster.predict_margin(x, ntree_limit, base_margin, device,
                                      transform=True)

    # -- serialization -----------------------------------------------------

    def _to_dict(self) -> Dict[str, Any]:
        arrays = {
            "cuts": self.cuts,
            "tree_weights": (
                self.tree_weights if self.tree_weights is not None
                else np.zeros((0,), np.float32)
            ),
        }
        arrays.update({name: getattr(self.forest, name) for name in Tree._fields})
        return {
            "format": FORMAT,
            "version": 1,
            "params": dataclasses.asdict(self.params),
            "base_score": self.base_score,
            "feature_names": self.feature_names,
            "feature_types": self.feature_types,
            "best_iteration": self.best_iteration,
            "best_score": self.best_score,
            "attributes": self._attributes,
            "has_node_stats": self._has_node_stats,
            "categories": (
                None if self.categories is None
                else {str(k): list(v) for k, v in self.categories.items()}
            ),
            "arrays_npz_b64": base64.b64encode(_npz_bytes(arrays)).decode("ascii"),
        }

    @classmethod
    def _from_dict(cls, d: Dict[str, Any]) -> "RayXGBoostBooster":
        if d.get("format") != FORMAT:
            raise ValueError(f"not a {FORMAT} model (format={d.get('format')!r})")
        raw = base64.b64decode(d["arrays_npz_b64"])
        with np.load(io.BytesIO(raw)) as z:
            has_stats = bool(d.get("has_node_stats", "base_weight" in z))
            forest = Tree(**{
                name: (z[name] if name in z else np.zeros_like(z["value"]))
                for name in Tree._fields
            })
            cuts = z["cuts"]
            tw = z["tree_weights"] if "tree_weights" in z else np.zeros((0,), np.float32)
        known = {f.name for f in dataclasses.fields(TrainParams)}
        params = TrainParams(**{k: v for k, v in d["params"].items() if k in known})
        out = cls(forest, cuts, params, d["base_score"], d.get("feature_names"),
                  d.get("feature_types"), tree_weights=tw if tw.size else None)
        out.best_iteration = d.get("best_iteration")
        out.best_score = d.get("best_score")
        out._attributes = dict(d.get("attributes") or {})
        out._has_node_stats = has_stats
        cats = d.get("categories")
        if cats is not None:
            out.categories = {int(k): tuple(v) for k, v in cats.items()}
        return out

    def save_model(self, fname: str) -> None:
        with open(fname, "w") as f:
            json.dump(self._to_dict(), f)

    @classmethod
    def load_model(cls, fname: str) -> "RayXGBoostBooster":
        with open(fname) as f:
            return cls._from_dict(json.load(f))

    def save_raw(self) -> bytes:
        return json.dumps(self._to_dict()).encode("utf-8")

    @classmethod
    def load_raw(cls, raw: bytes) -> "RayXGBoostBooster":
        return cls._from_dict(json.loads(raw.decode("utf-8")))

    def export_xgboost_json(self, fname: Optional[str] = None) -> str:
        """The model in xgboost's JSON model schema (``models/xgb_export``),
        loadable by any xgboost runtime; also written to ``fname``."""
        from xgboost_ray_tpu_torch.models.xgb_export import export_xgboost_json

        return export_xgboost_json(self, fname)

    @classmethod
    def import_xgboost_json(cls, data) -> "RayXGBoostBooster":
        """Load an xgboost JSON model (a path, JSON text or the parsed
        document), written by either package or by xgboost."""
        from xgboost_ray_tpu_torch.models.xgb_export import import_xgboost_json

        return import_xgboost_json(data)

    # -- model dump ----------------------------------------------------------

    def get_dump(self, with_stats: bool = False, dump_format: str = "text") -> List[str]:
        if dump_format == "json":
            return self._get_dump_json(with_stats)
        if dump_format != "text":
            raise ValueError(
                f"Unsupported dump_format {dump_format!r} (text or json).")
        dumps = []
        heap = self.forest.feature.shape[1]
        fo = self.forest
        for t in range(self.num_trees):
            lines = []

            def rec(idx: int, depth: int):
                if idx >= heap:
                    return
                indent = "\t" * depth
                if fo.is_leaf[t, idx]:
                    stats = f",cover={fo.cover[t, idx]:.6g}" if with_stats else ""
                    lines.append(f"{indent}{idx}:leaf={fo.value[t, idx]:.6g}{stats}")
                    return
                f = fo.feature[t, idx]
                if f < 0:
                    return  # unused slot
                thr = fo.threshold[t, idx]
                miss = 2 * idx + 1 if fo.default_left[t, idx] else 2 * idx + 2
                stats = (
                    f",gain={fo.gain[t, idx]:.6g},cover={fo.cover[t, idx]:.6g}"
                    if with_stats else ""
                )
                lines.append(
                    f"{indent}{idx}:[f{f}<{thr:.6g}] "
                    f"yes={2*idx+1},no={2*idx+2},missing={miss}{stats}"
                )
                rec(2 * idx + 1, depth + 1)
                rec(2 * idx + 2, depth + 1)

            rec(0, 0)
            dumps.append("\n".join(lines) + "\n")
        return dumps

    def _get_dump_json(self, with_stats: bool) -> List[str]:
        """xgboost ``dump_format="json"``: one nested node document per
        tree (``nodeid/depth/split/split_condition/yes/no/missing/
        children`` for a split, ``nodeid/leaf`` for a leaf)."""
        fo = self.forest
        dumps = []
        for t in range(self.num_trees):

            def rec(idx: int, depth: int):
                if bool(fo.is_leaf[t, idx]):
                    node = {"nodeid": idx, "leaf": float(fo.value[t, idx])}
                    if with_stats:
                        node["cover"] = float(fo.cover[t, idx])
                    return node
                f = int(fo.feature[t, idx])
                if f < 0:
                    return None  # unused slot
                miss = 2 * idx + 1 if bool(fo.default_left[t, idx]) else 2 * idx + 2
                node = {
                    "nodeid": idx,
                    "depth": depth,
                    "split": f"f{f}",
                    "split_condition": float(fo.threshold[t, idx]),
                    "yes": 2 * idx + 1,
                    "no": 2 * idx + 2,
                    "missing": miss,
                }
                if with_stats:
                    node["gain"] = float(fo.gain[t, idx])
                    node["cover"] = float(fo.cover[t, idx])
                children = [rec(2 * idx + 1, depth + 1),
                            rec(2 * idx + 2, depth + 1)]
                node["children"] = [c for c in children if c is not None]
                return node

            root = rec(0, 0)
            dumps.append(json.dumps(root if root is not None else {}))
        return dumps

    def trees_to_dataframe(self):
        """Flat per-node table of the forest (xgboost analog); columns:
        Tree, Node, ID, Feature, Split, Yes, No, Missing, Gain, IsLeaf,
        Value."""
        import pandas as pd

        rows = []
        fo = self.forest
        heap = fo.feature.shape[1]
        for t in range(self.num_trees):
            for idx in range(heap):
                is_leaf = bool(fo.is_leaf[t, idx])
                feat = int(fo.feature[t, idx])
                if not is_leaf and feat < 0:
                    continue  # unused slot
                yes, no = f"{t}-{2 * idx + 1}", f"{t}-{2 * idx + 2}"
                rows.append({
                    "Tree": t,
                    "Node": idx,
                    "ID": f"{t}-{idx}",
                    "Feature": "Leaf" if is_leaf else (
                        self.feature_names[feat] if self.feature_names
                        else f"f{feat}"),
                    "Split": None if is_leaf else float(fo.threshold[t, idx]),
                    "Yes": None if is_leaf else yes,
                    "No": None if is_leaf else no,
                    "Missing": None if is_leaf else (
                        yes if fo.default_left[t, idx] else no),
                    "Gain": float(fo.gain[t, idx]),
                    "IsLeaf": is_leaf,
                    "Value": float(fo.value[t, idx]),
                })
        return pd.DataFrame(rows)

    def get_score(self, importance_type: str = "weight") -> Dict[str, float]:
        """Per-feature importance (xgboost ``Booster.get_score``): weight
        (split counts), gain (mean split gain), total_gain."""
        feat = self.forest.feature
        internal = (feat >= 0) & (~self.forest.is_leaf)
        used = feat[internal]
        names = self.feature_names or [f"f{i}" for i in range(self.num_features)]
        counts = np.bincount(used, minlength=self.num_features).astype(np.float64)
        if importance_type == "weight":
            vals = counts
        elif importance_type in ("gain", "total_gain"):
            total = np.zeros(self.num_features, np.float64)
            np.add.at(total, used, self.forest.gain[internal])
            vals = total if importance_type == "total_gain" else np.divide(
                total, counts, out=np.zeros_like(total), where=counts > 0)
        else:
            raise ValueError(
                f"Unsupported importance_type: {importance_type!r} "
                f"(weight, gain, total_gain)"
            )
        return {names[i]: float(v) for i, v in enumerate(vals) if v > 0}

    def get_fscore(self) -> Dict[str, float]:
        """xgboost ``Booster.get_fscore``: split counts per feature."""
        return self.get_score(importance_type="weight")

    # -- pickling: the model document, so a pickle holds host arrays only
    # and loads where there is no card

    def __getstate__(self):
        return self._to_dict()

    def __setstate__(self, state):
        self.__dict__.update(self._from_dict(state).__dict__)


Booster = RayXGBoostBooster


def coerce_model(model: Any):
    """The booster that ``model`` names: a ``RayXGBoostBooster`` or a
    ``linear.RayLinearBooster``, pickled booster bytes, a saved-model path,
    or a JSON document (text or dict): the format both packages write, or
    xgboost's own model schema (``models/xgb_export.py``), a gblinear
    document giving a ``RayLinearBooster`` (``main.py:628-646``). Used by
    ``train(xgb_model=)``, ``predict()`` and the serving registry."""
    from xgboost_ray_tpu_torch.linear import RAW_FORMAT, RayLinearBooster

    if isinstance(model, (RayXGBoostBooster, RayLinearBooster)):
        return model
    if isinstance(model, bytes):
        # checkpoint bytes this program wrote (pickle runs code: load only
        # bytes of a trusted source)
        booster = pickle.loads(model)
        if not isinstance(booster, (RayXGBoostBooster, RayLinearBooster)):
            raise TypeError(
                f"checkpoint bytes hold a {type(booster).__name__}, not an "
                f"xgboost_ray_tpu_torch RayXGBoostBooster"
            )
        return booster
    if isinstance(model, dict):
        doc = model
    elif isinstance(model, str):
        if os.path.exists(model):
            with open(model) as f:
                doc = json.load(f)
        else:
            try:
                doc = json.loads(model)
            except ValueError as exc:
                raise ValueError(
                    f"model string is neither an existing file path "
                    f"nor valid JSON: {model[:80]!r}"
                ) from exc
    else:
        raise TypeError(
            f"cannot use a model of type {type(model).__name__}; pass a "
            f"RayXGBoostBooster, checkpoint bytes, a saved model path, or "
            f"its JSON document."
        )
    if doc.get("format") == FORMAT:
        return RayXGBoostBooster._from_dict(doc)
    if doc.get("format") == RAW_FORMAT:
        return RayLinearBooster._from_dict(doc)
    gb = doc.get("learner", {}).get("gradient_booster", {})
    if gb.get("name") == "gblinear":
        return RayLinearBooster.import_xgboost_json(doc)
    return RayXGBoostBooster.import_xgboost_json(doc)


def load_raw_model(raw: bytes):
    """The booster of ``save_raw`` bytes: a tree booster's document, or a
    gblinear model's (``linear.RAW_FORMAT``)."""
    return coerce_model(json.loads(raw.decode("utf-8")))
