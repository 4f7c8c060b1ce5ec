"""Build and load the hand-written CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), all sources at once in parallel. Libraries land in
``xgboost_ray_tpu_torch/_build/<hash>/`` keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is reused. The
wrappers in the op modules load them with ``ctypes`` and pass device
pointers, sizes and the current CUDA stream; every C entry point returns
``cudaGetLastError()``, which :func:`check` turns into an exception.

Nothing here runs at import time: the first wrapper call that launches a
kernel builds the libraries (this is also what ``chip_smoke.py`` times).
:func:`compile_count` counts the kernel builds this process made (``nvcc``
runs: the port has no Triton or other JIT-compiled kernel): the serve
layer's "no compiles after warmup" counter.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # K2's gain must round like the plain version: no a*b+c contraction
    "--fmad=false",
    # registers, shared memory and spills of every kernel, kept in the log
    "-Xptxas", "-v",
)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

#: C signatures: library stem -> {function: (argtypes, restype)}
SIGNATURES = {
    "histogram": {
        "xrt_hist_build": (
            [P, I, P, P, P, I, I, I, I, I, I, I, P, P, P, P], I),
        "xrt_hist_dequant": ([P, P, ctypes.c_longlong, P, I, P], I),
        "xrt_hist_ctas_per_sm": ([], I),
        "xrt_hist_build_int": (
            [P, I, P, I, P, P, I, I, I, I, I, I, I, P, P, P], I),
        "xrt_hist_form_dequant": (
            [P, I, P, I, P, I, I, I, P, P, I, P, P, I, P], I),
    },
    "quant": {
        "xrt_quantize_gh": (
            [P, P, ctypes.c_longlong, I, P, I, ctypes.c_uint, ctypes.c_uint,
             P], I),
        "xrt_wire_quant": (
            [P, ctypes.c_longlong, I, I, P, P, P, I, ctypes.c_longlong, P, I,
             F, P], I),
        "xrt_wire_acc": ([P, I, I, ctypes.c_longlong, I, I, P, P, P], I),
        "xrt_wire_deq": (
            [P, I, ctypes.c_longlong, ctypes.c_longlong, I, I, P, P, P], I),
    },
    "split": {
        "xrt_split_level": (
            [P, P, P, P, P, I, P, P, P, P, P, P, P, P, P, P, P, I, P, P, P,
             P, P, P], I),
        "xrt_leaf_records": ([P, P, P, I, P, P, P, P, P], I),
        "xrt_find_splits": (
            [P, I, I, I, F, F, F, F, P, P, P, P, P, P, P, P], I),
    },
    "predict": {
        "xrt_predict": ([P, P], I),
    },
    "partition": {
        "xrt_partition_route": (
            [P, P, I, I, P, I, I, P, P, P, P, I, P, P, P, P, P, P, I, P, P,
             P], I),
        "xrt_partition_scatter": (
            [P, P, I, I, P, P, I, P, P, P, P, P, P, P, P, P, P, P], I),
        "xrt_leaf_values": ([P, P, I, I, P, P, P, P], I),
        "xrt_partition_tile": ([], I),
    },
    "softmax": {
        "xrt_softmax": ([P, P], I),
        "xrt_softmax_ctas": ([P, P], I),
    },
    "walk": {
        "xrt_walk_binned": ([P, P], I),
        "xrt_walk_ctas": ([P, P], I),
        "xrt_walk_weighted": ([P, P], I),
    },
    "objective": {
        "xrt_k4": ([P, P], I),
    },
    "auc": {
        "xrt_auc_hist": ([P, P], I),
    },
    "ranking": {
        "xrt_rank_gh": ([P, P], I),
        "xrt_rank_metric": ([P, P], I),
    },
    "cox": {
        "xrt_cox_round": ([P, P], I),
    },
    "sampling": {
        "xrt_sample_rows": ([P, P], I),
        "xrt_sample_ctas": ([P], I),
        "xrt_feature_mask": ([P, P], I),
    },
    "lossguide": {
        "xrt_lossguide_step": ([P, P], I),
    },
    "linear": {
        "xrt_linear": ([P, P], I),
        "xrt_linear_ctas": ([P], I),
    },
    "shap": {
        "xrt_shap_saabas": ([P, P], I),
        "xrt_shap_exact": ([P, P], I),
        "xrt_shap_interactions": ([P, P], I),
    },
}


class TreeArgs(ctypes.Structure):
    """``XrtTreeArgs`` of ``csrc/split.cu``: what every level of one tree
    shares (the heap arrays it writes, cuts, feat_has_missing, sizes, split
    parameters, the constraints and the categorical flags), filled once per
    tree and passed by pointer."""

    _fields_ = ([(name, P) for name in (
        "feature", "split_bin", "threshold", "default_left", "is_leaf",
        "value", "gain", "cover", "base_weight", "cuts", "feat_has_missing")]
        + [("n_features", I), ("nbt", I)]
        + [(name, F) for name in (
            "reg_lambda", "reg_alpha", "gamma", "min_child_weight",
            "max_delta_step", "learning_rate")]
        + [("monotone", P), ("ic_bits", P), ("ic_words", I),
           ("categorical", P)])


class LossguideArgs(ctypes.Structure):
    """``XrtLossguideArgs`` of ``csrc/lossguide.cu``: one frontier step,
    passed by pointer (edit both together)."""

    _fields_ = ([(name, P) for name in (
        "feature", "split_bin", "threshold", "default_left", "is_leaf",
        "value", "gain", "cover", "base_weight", "cuts", "ent_slot",
        "ent_active", "ent_gain", "ent_feat", "ent_bin", "ent_dl",
        "ent_start", "ent_end", "last", "sp_gain", "sp_feat", "sp_bin",
        "sp_dl", "sp_valid", "sp_gh", "new_seg", "seg3", "feature3",
        "split_bin3", "dl3", "state3", "store", "parent", "leaf_seg",
        "leaf_state", "leaf_value")]
        + [("hist_pairs", ctypes.c_longlong)]
        + [(name, I) for name in (
            "n_ent", "heap", "n_features", "nbt", "t", "select", "finish")]
        + [(name, F) for name in (
            "reg_lambda", "reg_alpha", "max_delta_step", "learning_rate")])


class PredictArgs(ctypes.Structure):
    """``XrtPredictArgs`` of ``csrc/predict.cu``: one B8 launch's inputs,
    passed by pointer (edit both together)."""

    _fields_ = ([(name, P) for name in (
        "x", "nodes", "tree_weights", "base", "out_margin", "out_leaf")]
        + [("n_rows", ctypes.c_longlong)]
        + [(name, I) for name in (
            "n_features", "n_trees", "max_depth", "ntree_limit",
            "num_parallel_tree", "num_outputs", "layout", "mode", "mapping",
            "has_cat", "rows_per_block", "trees_per_tile", "staged",
            "shared_bytes", "front0", "padded", "top")]
        + [("m", I * 4), ("front", I * 4), ("base0", F), ("value_fn", I)])


class AucArgs(ctypes.Structure):
    """``XrtAucArgs`` of ``csrc/auc.cu``: one B9a launch, passed by pointer
    (edit both together)."""

    _fields_ = ([(name, P) for name in ("score", "label", "weight", "hist")]
                + [("n", ctypes.c_longlong), ("scale", ctypes.c_double)]
                + [(name, I) for name in ("stride", "grid")])


class WalkArgs(ctypes.Structure):
    """``XrtWalkArgs`` of ``csrc/walk.cu``: one B4 launch, passed by
    pointer (edit both together)."""

    _fields_ = ([(name, P) for name in (
        "feature", "split_bin", "default_left", "is_leaf", "value", "bins",
        "out")]
        + [("n_rows", ctypes.c_longlong)]
        + [(name, I) for name in (
            "n_features", "bin_bytes", "n_trees", "max_depth", "missing_bin",
            "mapping", "rows_per_tile", "trees_per_group", "shared_bytes",
            "grid")]
        + [("cat", P), ("categorical", I)])


class WalkWeightedArgs(ctypes.Structure):
    """``XrtWalkWeightedArgs`` of ``csrc/walk.cu``: one launch of B4's
    weighted-forest mode, passed by pointer (edit both together)."""

    _fields_ = ([(name, P) for name in (
        "feature", "split_bin", "default_left", "is_leaf", "value", "bins",
        "weights", "base", "out", "cat")]
        + [("n_rows", ctypes.c_longlong)]
        + [(name, I) for name in (
            "n_features", "bin_bytes", "n_trees", "heap", "max_depth",
            "missing_bin", "n_out", "fused", "staged", "grid")])


class LinearArgs(ctypes.Structure):
    """``XrtLinearArgs`` of ``csrc/linear.cu``: one B16 launch, passed by
    pointer (edit both together)."""

    _fields_ = ([(name, P) for name in (
        "x", "gh", "w", "b", "w_out", "b_out", "part", "sums", "bar")]
        + [("n", ctypes.c_longlong)]
        + [(name, I) for name in ("n_features", "k", "n_chunks")]
        + [(name, F) for name in ("eta", "lam", "alp")]
        + [(name, I) for name in ("mode", "coord", "grid")])


class SoftmaxArgs(ctypes.Structure):
    """``XrtSoftmaxArgs`` of ``csrc/softmax.cu``: one launch of the softmax
    pass, passed by pointer (edit both together)."""

    _fields_ = ([(name, P) for name in (
        "margin", "row_value", "label", "weight", "gh", "part", "out")]
        + [("n", ctypes.c_longlong)]
        + [(name, I) for name in (
            "k", "mode", "kmax", "pitch", "shared_bytes")]
        + [("kmagic", ctypes.c_uint)]
        + [("front0", I), ("top", I), ("front", I * 6), ("grid", I),
           ("logloss0", I), ("n_trees", I), ("inv_trees", F)])


class K4Args(ctypes.Structure):
    """``XrtK4Args`` of ``csrc/objective.cu``: one K4 launch, passed by
    pointer (edit both together)."""

    _fields_ = ([(name, P) for name in (
        "margin", "row_value", "label", "weight", "gh", "part", "ticket",
        "out")]
        + [("n", ctypes.c_longlong), ("grid", I), ("mode", I),
           ("scale_pos_weight", F)]
        + [(name, P) for name in ("lower", "upper", "alpha")]
        + [(name, I) for name in ("k", "metrics", "multi")]
        + [("c", F * 21), ("n_trees", I), ("inv_trees", F)])


class SampleArgs(ctypes.Structure):
    """``XrtSampleArgs`` of ``csrc/sampling.cu``: one B12r launch, passed by
    pointer (edit both together)."""

    _fields_ = ([(name, P) for name in (
        "gh", "taken", "rows", "gh_sel", "work")]
        + [(name, ctypes.c_longlong) for name in (
            "n_slots", "n_valid", "k", "row_offset")]
        + [("key0", ctypes.c_uint), ("key1", ctypes.c_uint),
           ("mode", I), ("grid", I)])


class MaskArgs(ctypes.Structure):
    """``XrtMaskArgs`` of ``csrc/sampling.cu``: one B12f launch, passed by
    pointer (edit both together)."""

    _fields_ = ([(name, P) for name in ("log_fw", "base", "out")]
                + [(name, I) for name in ("rows", "n_features", "k")]
                + [("rate", F), ("key0", ctypes.c_uint),
                   ("key1", ctypes.c_uint)])


class ShapArgs(ctypes.Structure):
    """``XrtShapArgs`` of ``csrc/shap.cu``: one B15 launch, passed by
    pointer (edit both together)."""

    _fields_ = ([(name, P) for name in (
        "x", "nodes", "base_weight", "steps", "elem_slot", "elem_z",
        "leaf_value", "leaf_m", "n_leaves", "tree_feats", "n_feats",
        "weights", "scale", "tree_class", "bias", "scratch", "out")]
        + [("n_rows", ctypes.c_longlong)]
        + [(name, I) for name in (
            "n_features", "n_trees", "max_depth", "max_leaves", "max_feats",
            "num_outputs", "has_cat", "weights_width")]
        + [("tree_tab", P)]
        + [(name, I) for name in (
            "tab_words", "feat_off", "node_off", "leaf_off", "route_words",
            "mapping", "threads", "grid", "shared_bytes", "off_tab",
            "off_route", "off_x", "off_sums", "off_stage", "off_acc",
            "acc_words", "sums_words", "scratch_words")]
        + [("saabas_tab", P)]
        + [(name, I) for name in (
            "sb_words", "sb_entry_off", "sb_half_off", "sb_pitch",
            "tile_trees", "cta_rows")])


_lock = threading.Lock()
_NVCC_BUILDS = 0


def compile_count() -> int:
    """Kernel builds made by this process: ``nvcc`` compiles of ``csrc/``
    sources (the port's only kernel builds)."""
    with _lock:
        return _NVCC_BUILDS


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin); the CUDA kernels of "
        "xgboost_ray_tpu_torch are compiled on first use."
    )


def _digest(stem: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith(".cuh") or name == f"{stem}.cu":
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(name.encode())
                h.update(f.read())
    return h.hexdigest()[:16]


def _lib_path(stem: str) -> str:
    return os.path.join(BUILD_DIR, _digest(stem), f"libxrt_{stem}.so")


def _log_path(lib_path: str) -> str:
    return lib_path[:-3] + ".log"


def build_log(stem: str) -> str:
    """nvcc's output (``-Xptxas -v``) from the build of ``csrc/<stem>.cu``."""
    with open(_log_path(build_all()[stem]), errors="replace") as f:
        return f.read()


def build_all() -> Dict[str, str]:
    """Compile every out-of-date ``csrc/*.cu`` (one ``nvcc`` per source, all
    started together); returns {stem: library path}."""
    global _NVCC_BUILDS
    stems = sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))
    paths = {s: _lib_path(s) for s in stems}
    todo = [s for s in stems if not os.path.exists(paths[s])]
    procs = []
    for s in todo:
        os.makedirs(os.path.dirname(paths[s]), exist_ok=True)
        tmp = f"{paths[s]}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
               os.path.join(CSRC_DIR, f"{s}.cu")]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for s, tmp, proc in procs:
        out, _ = proc.communicate()
        with _lock:
            _NVCC_BUILDS += 1
        if proc.returncode != 0:
            errors.append(f"--- {s}.cu ---\n{out.decode(errors='replace')}")
            continue
        with open(_log_path(paths[s]), "wb") as f:
            f.write(out)
        os.replace(tmp, paths[s])  # atomic: concurrent builders agree
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return paths


@functools.lru_cache(maxsize=None)
def _libraries() -> Dict[str, ctypes.CDLL]:
    libs = {}
    for stem, path in build_all().items():
        lib = ctypes.CDLL(path)
        for fn, (argtypes, restype) in SIGNATURES.get(stem, {}).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[stem] = lib
    return libs


_load_lock = threading.Lock()


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` (built on first use; one
    thread builds, others wait)."""
    with _load_lock:
        return _libraries()[stem]


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        import torch

        name = torch.cuda.get_device_name() if torch.cuda.is_available() else "?"
        raise RuntimeError(f"{what}: CUDA error {code} on {name}")


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor (``None`` passes a null pointer)."""
    return None if t is None else t.data_ptr()
