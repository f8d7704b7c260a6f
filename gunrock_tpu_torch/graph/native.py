"""ctypes bindings to the native C++ host graph builder.

Counterpart of :mod:`gunrock_tpu.graph.native`. It compiles the repo's
``native/graph_builder.cpp`` with g++ on first use into the port's own
build directory (``build/gunrock_tpu_torch/``, beside the package), never
into ``native/``. Every entry point returns None when the toolchain or
the library is unavailable, and the callers then take their numpy path:
the native code only makes the host build faster, it never changes a
result.

An installed copy (``pip install .``) has no ``native/graph_builder.cpp``
beside it, so there every entry point returns None and ``from_coo``
takes its numpy path, as the JAX package does when installed. The build
directory is then ``<site-packages>/build/gunrock_tpu_torch``, where the
CUDA kernels and the C shim are built too: it must be writable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["build_dir", "get_lib", "native_available", "coo_to_csr_native",
           "parse_market_body_native"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "graph_builder.cpp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def build_dir() -> str:
    """The port's build directory (listed in ``.gitignore``)."""
    return os.path.join(_REPO, "build", "gunrock_tpu_torch")


def _build(so: str) -> bool:
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp, _SRC]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=300)
        if r.returncode != 0:
            return False
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable.
    Disable with GUNROCK_TPU_NO_NATIVE=1, as in the JAX package."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("GUNROCK_TPU_NO_NATIVE") or not os.path.exists(_SRC):
            return None
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(build_dir(), f"libgunrock_host_{tag}.so")
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        i64, i32p, i64p, f32p = (
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float))
        lib.gr_coo_to_csr.restype = i64
        lib.gr_coo_to_csr.argtypes = [i64, i64, i32p, i32p, f32p,
                                      ctypes.c_int, i64p, i32p, f32p]
        lib.gr_csr_dedup.restype = i64
        lib.gr_csr_dedup.argtypes = [i64, i64p, i32p, f32p]
        lib.gr_parse_market_body.restype = i64
        lib.gr_parse_market_body.argtypes = [ctypes.c_char_p, i64, i64,
                                             ctypes.c_int, i32p, i32p, f32p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _ptr(arr: Optional[np.ndarray], typ):
    if arr is None:
        return ctypes.cast(None, ctypes.POINTER(typ))
    return arr.ctypes.data_as(ctypes.POINTER(typ))


def coo_to_csr_native(num_nodes: int, src: np.ndarray, dst: np.ndarray,
                      values: Optional[np.ndarray], *,
                      remove_self_loops: bool, dedup: bool):
    """Sorted (optionally deduped) CSR from COO via the native builder.

    Returns ``(row_offsets int64, col_indices int32, values float32|None)``
    or ``None`` when the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    e = int(src.shape[0])
    src32 = np.ascontiguousarray(src, dtype=np.int32)
    dst32 = np.ascontiguousarray(dst, dtype=np.int32)
    vals = (np.ascontiguousarray(values, dtype=np.float32)
            if values is not None else None)
    row = np.zeros(num_nodes + 1, dtype=np.int64)
    col = np.empty(e, dtype=np.int32)
    val_out = np.empty(e, dtype=np.float32) if vals is not None else None

    n_out = lib.gr_coo_to_csr(
        num_nodes, e,
        _ptr(src32, ctypes.c_int32), _ptr(dst32, ctypes.c_int32),
        _ptr(vals, ctypes.c_float), int(remove_self_loops),
        _ptr(row, ctypes.c_int64), _ptr(col, ctypes.c_int32),
        _ptr(val_out, ctypes.c_float))
    if n_out < 0:
        return None
    if dedup:
        n_out = lib.gr_csr_dedup(num_nodes, _ptr(row, ctypes.c_int64),
                                 _ptr(col, ctypes.c_int32),
                                 _ptr(val_out, ctypes.c_float))
    col = col[:n_out].copy()
    if val_out is not None:
        val_out = val_out[:n_out].copy()
    return row, col, val_out


def parse_market_body_native(body: bytes, nnz_max: int, has_values: bool):
    """Parse the numeric body of a .mtx file (the lines after the size
    line) with the native parser. Returns ``(src, dst, vals|None)``
    (0-based int32, float32 values), or None when the library is
    unavailable or the body does not parse (more lines than
    ``nnz_max``, a malformed line)."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.empty(nnz_max, dtype=np.int32)
    dst = np.empty(nnz_max, dtype=np.int32)
    vals = np.empty(nnz_max, dtype=np.float32) if has_values else None
    n = lib.gr_parse_market_body(
        body, len(body), nnz_max, int(has_values),
        _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32),
        _ptr(vals, ctypes.c_float))
    if n < 0:
        return None
    src = src[:n].copy()
    dst = dst[:n].copy()
    if vals is not None:
        vals = vals[:n].copy()
    return src, dst, vals
