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
    },
    "split": {
        "xrt_split_level": (
            [P, P, P, P, P, I, P, P, P, P, P, P, P, P, P, P, P], I),
        "xrt_leaf_records": ([P, P, P, I, P, P, P], I),
        "xrt_find_splits": (
            [P, I, I, I, F, F, F, F, P, P, P, P, P, P, P], I),
    },
    "predict": {
        "xrt_predict": ([P, P], I),
    },
    "partition": {
        "xrt_partition_route": (
            [P, P, I, I, P, I, I, P, P, P, P, I, P, P, P, P, P, I, P, P, P],
            I),
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
    },
    "objective": {
        "xrt_k4": ([P, P], I),
    },
}


class TreeArgs(ctypes.Structure):
    """``XrtTreeArgs`` of ``csrc/split.cu``: what every level of one tree
    shares (the heap arrays it writes, cuts, feat_has_missing, sizes and
    split parameters), filled once per tree and passed by pointer."""

    _fields_ = ([(name, P) for name in (
        "feature", "split_bin", "threshold", "default_left", "is_leaf",
        "value", "gain", "cover", "base_weight", "cuts", "feat_has_missing")]
        + [("n_features", I), ("nbt", I)]
        + [(name, F) for name in (
            "reg_lambda", "reg_alpha", "gamma", "min_child_weight",
            "max_delta_step", "learning_rate")])


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
        + [("m", I * 4), ("front", I * 4), ("base0", F)])


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
            "grid")])


class SoftmaxArgs(ctypes.Structure):
    """``XrtSoftmaxArgs`` of ``csrc/softmax.cu``: one launch of the softmax
    pass, passed by pointer (edit both together)."""

    _fields_ = ([(name, P) for name in (
        "margin", "row_value", "label", "weight", "gh", "part", "out")]
        + [("n", ctypes.c_longlong)]
        + [(name, I) for name in (
            "k", "mode", "kmax", "pitch", "shared_bytes")]
        + [("kmagic", ctypes.c_uint)]
        + [("front0", I), ("top", I), ("front", I * 6), ("grid", I)])


class K4Args(ctypes.Structure):
    """``XrtK4Args`` of ``csrc/objective.cu``: one K4 launch, passed by
    pointer (edit both together)."""

    _fields_ = ([(name, P) for name in (
        "margin", "row_value", "label", "weight", "gh", "part", "ticket",
        "out")]
        + [("n", ctypes.c_longlong), ("grid", I), ("mode", I),
           ("scale_pos_weight", F)])


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
