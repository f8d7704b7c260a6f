"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``gunrock_tpu_torch/csrc/*.cu`` for ``sm_90a``
(one compiler per source, all started together) and links the objects
into one shared library with a plain C interface, loaded with ctypes. The
library
is built at first use into ``build/gunrock_tpu_torch/`` beside the
package (listed in ``.gitignore``), named by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused. A
failed build raises: nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..graph.native import build_dir

__all__ = ["library_path", "build", "load"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_SOURCES = ("bfs_kernels.cu", "pull_kernels.cu", "sssp_kernels.cu")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
          "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{cuda_home}/bin): the CUDA kernels cannot be built")


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir(),
                        f"libgunrock_tpu_torch_{h.hexdigest()[:16]}.so")


def _run(cmd: list[str]) -> str:
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {r.returncode}:\n"
                           f"{' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
    return r.stdout + r.stderr


def build() -> str:
    """Compile the kernels unless already built; returns the library path.
    The compiler's register and spill report (``-Xptxas -v``) is kept
    beside it as ``<library>.log``."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in _SOURCES]
    cmds = [[nvcc, *_FLAGS, "-c", "-o", obj, os.path.join(_CSRC, src)]
            for src, obj in zip(_SOURCES, objs)]
    with ThreadPoolExecutor(len(cmds)) as pool:
        logs = list(pool.map(_run, cmds))
    logs.append(_run([nvcc, *_ARCH, "-shared", "-o", tmp, *objs]))
    for obj in objs:
        os.remove(obj)
    with open(path + ".log", "w") as f:
        f.write("".join(logs))
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            i32, f32 = ctypes.c_int, ctypes.c_float
            lib.gr_pull_reached_words.argtypes = [p, i64, p, p, i64, p, p]
            lib.gr_pull_reached_words.restype = ctypes.c_int
            lib.gr_bitmask_gather.argtypes = [p, i64, p, i64, p, p]
            lib.gr_bitmask_gather.restype = ctypes.c_int
            lib.gr_bitmask_gather_cumsum.argtypes = [p, i64, p, i64, p, i64,
                                                     p, p]
            lib.gr_bitmask_gather_cumsum.restype = ctypes.c_int
            lib.gr_pull_reduce.argtypes = [p, p, p, p, i64, i64, p, i32,
                                           i32, i32, p, i32, p, p, p, p, p,
                                           p]
            lib.gr_pull_reduce.restype = ctypes.c_int
            lib.gr_pull_power_iters.argtypes = [
                p, p, p, p, p, p, i64, i64, i64, p, i32, f32, f32, f32,
                i32, i32, p, p, p, p, p, p]
            lib.gr_pull_power_iters.restype = ctypes.c_int
            lib.gr_pull_min_sweeps.argtypes = [
                p, p, p, p, p, p, i64, i64, p, i32, i32, i32, i32, p, p, p,
                p, p, p]
            lib.gr_pull_min_sweeps.restype = ctypes.c_int
            lib.gr_brandes_levels.argtypes = [
                p, p, p, p, p, p, i64, i64, i32, i32, i32, i32, p, p, p, p, p,
                p]
            lib.gr_brandes_levels.restype = ctypes.c_int
            lib.gr_sample_sorted.argtypes = [p, p, i64, p, i32, i64, p, p, p]
            lib.gr_sample_sorted.restype = ctypes.c_int
            lib.gr_reduce_by_dst_sorted.argtypes = [
                p, p, p, i64, i32, i32, i64, p, p, p, p, p, p, p, p, p]
            lib.gr_reduce_by_dst_sorted.restype = ctypes.c_int
            lib.gr_scatter_sorted.argtypes = [p, i64, p, p, i64, p, i64, i32,
                                              i32, p]
            lib.gr_scatter_sorted.restype = ctypes.c_int
            _lib = lib
    return _lib
