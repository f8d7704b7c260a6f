"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``gunrock_tpu_torch/csrc/*.cu`` for ``sm_90a``
(one compiler per source, all started together; ``tiles.cuh`` is a
header they share) and links the objects
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
_HEADERS = ("tiles.cuh",)
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
          "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# The C entry points of csrc/*.cu and their parameters, one letter each:
# p a pointer (the last one the stream), q an int64_t, i an int, f a
# float. ctypes passes what it is told, so these must match the sources.
SIGNATURES = {
    "gr_pull_reached_words": "pqppqqpqpp",
    "gr_bitmask_gather": "pqpqpp",
    "gr_bitmask_gather_cumsum": "pqpqpqipp",
    "gr_pull_reduce": "pppqqqpiiipippppppp",
    "gr_pull_power_iters": "pppppqqqpifffiippppppp",
    "gr_pull_min_sweeps": "pppppqqpiiiippppppppp",
    "gr_brandes_levels": "pppppqqiiiippppppppp",
    "gr_sample_sorted": "ppqpiqppp",
    "gr_reduce_by_dst_sorted": "pppqiiqppppp",
    "gr_scatter_sorted": "pqppqpqiip",
}
_CTYPES = {"p": ctypes.c_void_p, "q": ctypes.c_int64, "i": ctypes.c_int,
           "f": ctypes.c_float}


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
    for name in _SOURCES + _HEADERS:
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
    """The loaded kernel library (built on first call). After the first
    call this is one global read: the wrappers call it on every launch."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, sig in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [_CTYPES[c] for c in sig]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
