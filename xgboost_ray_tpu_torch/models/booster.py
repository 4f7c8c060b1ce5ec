"""The trained-model object of the port.

Port of ``xgboost_ray_tpu/models/booster.py`` (``:760-930``): the forest in
padded-heap layout (host numpy arrays, ``[T, heap]`` per field of
``ops.grow.Tree``), the binning cuts and the parameters, with
``save_model``/``load_model``, ``save_raw``/``load_raw`` and ``get_dump``.
The JSON is the JAX package's format (``"format":
"xgboost_ray_tpu.booster"``), so files cross-load both ways. The arrays
are written as an npz whose zip entries carry a fixed timestamp, so
``save_raw`` of a loaded model gives the same bytes.
"""

import base64
import dataclasses
import io
import json
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np

from xgboost_ray_tpu_torch.ops.grow import Tree
from xgboost_ray_tpu_torch.params import TrainParams

FORMAT = "xgboost_ray_tpu.booster"

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

    # -- introspection -----------------------------------------------------

    @property
    def num_features(self) -> int:
        return int(self.cuts.shape[0])

    @property
    def num_outputs(self) -> int:
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

    # -- model dump ----------------------------------------------------------

    def get_dump(self, with_stats: bool = False, dump_format: str = "text") -> List[str]:
        if dump_format != "text":
            raise NotImplementedError(
                f"dump_format={dump_format!r} (the port dumps text only)")
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


Booster = RayXGBoostBooster
