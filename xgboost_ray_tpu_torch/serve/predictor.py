"""Padded-bucket predictor: the serve layer's front of kernels B8 and B15.

Port of ``xgboost_ray_tpu/serve/predictor.py``: ``KINDS``, ``LAYOUTS``,
``bucket_rows`` (``:69``) and ``CompiledPredictor`` (``:101``). Online
traffic has arbitrary batch sizes; every batch is padded up to a
power-of-two bucket, so the set of launch shapes a model sees is finite.
The forest goes to the device packed once per model (for ``node_array``,
in its order), and each bucket has preallocated device buffers for its
rows and its outputs: a batch is copied into its bucket's buffer, zero
rows pad it, B8 walks the bucket (for ``value`` with the objective's
transform fused into it: the sigmoid, the exp of the log-link objectives
and ``survival:aft``, hinge's 0/1; a ``reg:quantileerror`` model's
``value`` is its [rows, K] margins; a ``multi:softprob`` / ``multi:softmax``
model's ``value`` is B8's margins, then the softmax pass: [rows, K]
probabilities or [rows] classes), and the real rows are sliced back. The
walk is row-independent, so padding changes nothing in the real rows:
served results are bitwise the batch path's (``RayXGBoostBooster.predict``
on the same device).

The reference counts XLA compiles; here the counterpart is a kernel
build. ``compile_count()`` is the number of kernel builds (``nvcc`` runs:
the port has no JIT-compiled kernel) this process made: ``warmup`` builds
what the buckets need, and after it no request builds anything.
"""

import contextlib
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from xgboost_ray_tpu_torch.device import resolve_device
from xgboost_ray_tpu_torch.ops import _build
from xgboost_ray_tpu_torch.ops import predict as predict_ops
from xgboost_ray_tpu_torch.ops import shap as shap_ops

#: output kinds of the serve API
KINDS = ("value", "margin", "leaf", "contribs")

#: forest layouts the predictor can walk: the padded heap (the batch path's
#: layout) and the breadth-first node array (``ops/node_array.py``); both
#: serve bitwise-identical outputs
LAYOUTS = predict_ops.LAYOUTS


def compile_count() -> int:
    """Kernel builds (``nvcc`` runs) made by this process."""
    return _build.compile_count()


def bucket_rows(n: int, min_bucket: int, n_dev: int = 1) -> int:
    """Smallest bucket >= max(n, min_bucket) from the ladder of powers of
    two rounded up to a multiple of ``n_dev``. Idempotent
    (``bucket_rows(bucket_rows(n)) == bucket_rows(n)``), which is what lets
    the warmup enumerate exactly the buckets live requests hit."""
    n_dev = max(int(n_dev), 1)
    rows = max(int(n), int(min_bucket), n_dev, 1)
    # start one power of two below rows: its n_dev-rounded value may
    # already cover rows (e.g. rows=17, n_dev=3 -> 16 rounds to 18)
    p = 1 << max((rows - 1).bit_length() - 1, 0)
    while True:
        b = -(-p // n_dev) * n_dev
        if b >= rows:
            return b
        p *= 2


class CompiledPredictor:
    """Padded-bucket inference over one booster on one device."""

    def __init__(self, booster, device=None, min_bucket: int = 8,
                 layout: str = "heap"):
        if getattr(booster, "signature", None) is None:
            raise TypeError(
                f"serving requires a tree booster (RayXGBoostBooster); got "
                f"{type(booster).__name__}."
            )
        if layout not in LAYOUTS:
            raise ValueError(
                f"unknown forest layout {layout!r}; one of {LAYOUTS}"
            )
        self.device = resolve_device(device)
        self.booster = booster
        self.min_bucket = int(min_bucket)
        self.layout = layout
        self.signature = booster.signature()
        self.m0 = booster.base_score_margin_np()
        self.forest_dev = booster.device_forest(self.device, layout)
        #: columns of a ``value`` response: K for multi:softprob, else one
        self.value_width = predict_ops.value_width(booster.params.objective,
                                                   booster.num_outputs)
        self.tw_dev = booster.device_tree_weights(self.device)
        # contribs: the model's SHAP tables and tree scales, at first use
        self._shap = None
        # (bucket, kind) -> (rows buffer, output buffer, B15 scratch or None)
        self._buffers: Dict[Tuple[int, str], Tuple] = {}
        self._lock = threading.Lock()

    def _shap_tables(self):
        if self._shap is None:
            b = self.booster
            b._assert_node_stats()
            sf = b.shap_forest(self.device)
            self._shap = (sf, b.tree_scales(sf))
        return self._shap

    def _bucket_buffers(self, bucket: int, kind: str):
        b = self.booster
        key = (bucket, kind)
        bufs = self._buffers.get(key)
        if bufs is None:
            x = torch.zeros((bucket, b.num_features), dtype=torch.float32,
                            device=self.device)
            scratch = None
            if kind == "contribs":
                sf, _ = self._shap_tables()
                shape = shap_ops.out_shape(bucket, b.num_features,
                                           b.num_outputs, "exact")
                # what B15's launch plan for the bucket keeps off chip
                sms = (shap_ops._sm_count(self.device.index or 0)
                       if self.device.type == "cuda" else 132)
                words = shap_ops.scratch_floats(sf, b.num_features,
                                                b.num_outputs, "exact",
                                                bucket, sms)
                scratch = torch.empty((max(words, 1) * bucket,),
                                      dtype=torch.float32, device=self.device)
            else:
                shape = (bucket, {"leaf": b.num_trees,
                                  "margin": b.num_outputs,
                                  "value": self.value_width}[kind])
            out = torch.empty(shape, device=self.device,
                              dtype=torch.int32 if kind == "leaf"
                              else torch.float32)
            bufs = self._buffers[key] = (x, out, scratch)
        return bufs

    def predict(self, x: np.ndarray, kind: str = "value",
                stream: Optional[torch.cuda.Stream] = None) -> np.ndarray:
        """Serve one [N, F] float32 batch (see :meth:`predict_with_bucket`)."""
        out, _ = self.predict_with_bucket(x, kind, stream)
        return out

    def predict_with_bucket(
        self, x: np.ndarray, kind: str = "value",
        stream: Optional[torch.cuda.Stream] = None,
    ) -> Tuple[np.ndarray, int]:
        """Pad to the bucket, walk it on ``stream`` (the device's current
        stream by default), slice the N real rows back out and finalize
        them as the batch path does. Returns (result, bucket)."""
        if kind not in KINDS:
            raise ValueError(
                f"unknown serve output kind {kind!r}; one of {KINDS}"
            )
        b = self.booster
        if kind == "contribs":
            # as the batch path: no all-zero SHAP values from a model
            # without node statistics
            b._assert_node_stats()
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != b.num_features:
            raise ValueError(
                f"feature shape mismatch: model expects {b.num_features}, "
                f"got {x.shape[1] if x.ndim == 2 else x.shape}"
            )
        n = int(x.shape[0])
        bucket = bucket_rows(n, self.min_bucket)
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with self._lock, ctx:
            xb, ob, scratch = self._bucket_buffers(bucket, kind)
            xb[:n].copy_(torch.from_numpy(np.ascontiguousarray(x)))
            if n < bucket:
                xb[n:].zero_()
            if kind == "contribs":
                sf, sc = self._shap_tables()
                shap_ops.predict_contribs_exact(sf, xb, sc, out=ob,
                                                scratch=scratch,
                                                stream=stream)
            elif kind == "leaf":
                predict_ops.predict_leaf_index(self.forest_dev, xb, out=ob,
                                               stream=stream)
            else:
                predict_ops.predict_margin(
                    self.forest_dev, xb, None, base0=self.m0,
                    num_outputs=b.num_outputs,
                    num_parallel_tree=b.params.num_parallel_tree,
                    tree_weights=self.tw_dev, out=ob, stream=stream,
                    transform=b.params.objective if kind == "value" else None)
            res = ob[:n]
            if kind in ("margin", "value") and res.shape[1] == 1:
                res = res[:, 0]
            out = res.to("cpu", copy=True).numpy()
        if kind == "contribs":
            out = b._finalize_contribs(out, "contribs", None)
        return out, bucket

    def warmup(self, kinds=("value",), max_batch: int = 256) -> int:
        """Run every bucket in [min_bucket, bucket(max_batch)] for the given
        kinds once (kernel builds and buffers happen here); returns the
        number of kernel builds made now. After warmup, requests up to
        ``max_batch`` rows never build."""
        before = compile_count()
        top = bucket_rows(max_batch, self.min_bucket)
        n = 1
        while True:
            # bucket_rows is an idempotent monotone step function, so
            # bucket + 1 jumps to the next rung of the ladder
            bucket = bucket_rows(n, self.min_bucket)
            x = np.zeros((bucket, self.booster.num_features), np.float32)
            for kind in kinds:
                self.predict(x, kind)
            if bucket >= top:
                break
            n = bucket + 1
        return compile_count() - before
