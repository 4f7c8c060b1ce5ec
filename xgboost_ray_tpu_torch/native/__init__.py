"""Native (C++) host code of the port, bound with ``ctypes``.

``fast_csv.cpp`` (a copy of the JAX package's) is a multithreaded CSV ->
float32 parser, which the CSV data source reads headered numeric files
with. ``g++`` builds it at its first use into
``xgboost_ray_tpu_torch/_build/fastcsv-<hash>/`` (the hash of the source
and flags, so an edited source rebuilds), never beside the source; a
process that finds the library built loads it. A failed build is logged
with the compiler's error and the CSV source then reads with pandas, which
its per-parser counts show (``data_sources.csv.read_csv_file.reads``).
``RXGB_DISABLE_NATIVE_CSV`` set to a non-empty value makes every read take
pandas.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fast_csv.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_SRC)), "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None
_load_failed = False


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"fastcsv-{key.hexdigest()[:16]}",
                        "libfastcsv.so")


def _build(path: str) -> bool:
    """Compile into a temporary file beside ``path``, then rename it into
    place, so processes building at once never load a half-written one."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError) as exc:
        logger.error("fast_csv build failed (CSV files are read with "
                     "pandas): %s %s", exc, getattr(exc, "stderr", "") or "")
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as exc:
            logger.error("fast_csv load failed: %s", exc)
            _load_failed = True
            return None
        H = ctypes.c_int64
        for name, argtypes, restype in (
                ("fcsv_open", [ctypes.c_char_p, ctypes.c_int], H),
                ("fcsv_rows", [H], H),
                ("fcsv_cols", [H], H),
                ("fcsv_header", [H, ctypes.c_char_p, H], H),
                ("fcsv_parse", [H, ctypes.POINTER(ctypes.c_float),
                                ctypes.c_int], ctypes.c_int),
                ("fcsv_close", [H], None)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
        return _lib


def native_csv_available() -> bool:
    return not os.environ.get("RXGB_DISABLE_NATIVE_CSV") and _load() is not None


def read_csv_numpy(path: str, n_threads: int = 0
                   ) -> Optional[Tuple[np.ndarray, List[str]]]:
    """Parse a numeric, comma-separated CSV with a header row into float32:
    (matrix [rows, cols], column names), or None where the file is not
    one (gzip, no header row, a header as wide as no row, a parse error) or
    the native parser is unavailable; the caller then reads with pandas."""
    if path.endswith(".gz") or not native_csv_available():
        return None
    lib = _load()
    handle = lib.fcsv_open(path.encode(), 1)
    if handle == 0:
        return None
    try:
        rows = lib.fcsv_rows(handle)
        cols = lib.fcsv_cols(handle)
        if rows < 0 or cols <= 0:
            return None
        buf = ctypes.create_string_buffer(1 << 16)
        n = lib.fcsv_header(handle, buf, len(buf))
        if n < 0:
            return None
        names = buf.value.decode("utf-8", errors="replace").split("\n") if n else []
        if len(names) != cols:
            return None
        # a numeric header is a headerless file, which pandas reads otherwise
        for name in names:
            try:
                float(name)
                return None
            except ValueError:
                pass
        out = np.empty((rows, cols), dtype=np.float32)
        rc = lib.fcsv_parse(
            handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
        return (out, names) if rc == 0 else None
    finally:
        lib.fcsv_close(handle)
