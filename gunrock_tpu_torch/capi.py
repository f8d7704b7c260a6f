"""Python side of the port's C ABI (``csrc/c_api.cpp``).

Counterpart of :mod:`gunrock_tpu.capi`: each ``*_c`` function receives
raw pointer addresses and sizes as integers, wraps them as zero-copy
numpy views of the caller's buffers, runs the primitive on ``device``,
writes the results in place and returns the elapsed process time in ms,
as the reference's simplified C tier does (``gunrock.h:173-347``). The C
shim calls them with the default ``device="cuda"``, which raises where
there is no card (the shim then returns -1): nothing moves to the CPU
unasked. :func:`build_capi_lib` builds the shim.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import sysconfig

import numpy as np

from .graph.native import build_dir

__all__ = ["bfs_c", "bc_c", "cc_c", "sssp_c", "pagerank_c",
           "build_capi_lib", "CAPI_HEADER_DIR"]

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The directory of the shim's source and of its header,
# gunrock_tpu_torch.h, for C consumers (-I).
CAPI_HEADER_DIR = os.path.join(_REPO, "gunrock_tpu_torch", "csrc")
_CAPI_SRC = os.path.join(CAPI_HEADER_DIR, "c_api.cpp")


def _view(addr: int, n: int, dtype):
    """Zero-copy numpy view over a foreign buffer."""
    ct = {np.int32: ctypes.c_int32, np.float32: ctypes.c_float}[dtype]
    return np.ctypeslib.as_array((ct * n).from_address(addr))


def _graph(num_nodes, num_edges, row_addr, col_addr, val_addr=0):
    from .graph.csr import CsrGraph
    row = _view(row_addr, num_nodes + 1, np.int32).astype(np.int64)
    col = _view(col_addr, num_edges, np.int32).copy()
    vals = (_view(val_addr, num_edges, np.float32).copy()
            if val_addr else None)
    return CsrGraph(num_nodes=int(num_nodes), row_offsets=row,
                    col_indices=col, edge_values=vals)


def bfs_c(label_addr, pred_addr, num_nodes, num_edges, row_addr,
          col_addr, source, mark_preds, direction_optimized, *,
          device="cuda"):
    from .models.bfs import bfs
    g = _graph(num_nodes, num_edges, row_addr, col_addr)
    r = bfs(g, int(source), mark_preds=bool(mark_preds),
            direction_optimized=bool(direction_optimized), device=device)
    _view(label_addr, num_nodes, np.int32)[:] = r.labels
    if mark_preds and pred_addr:
        _view(pred_addr, num_nodes, np.int32)[:] = r.preds
    return float(r.info["process_ms"])


def bc_c(scores_addr, num_nodes, num_edges, row_addr, col_addr, source, *,
         device="cuda"):
    from .models.bc import bc
    g = _graph(num_nodes, num_edges, row_addr, col_addr)
    r = bc(g, int(source) if source >= 0 else None, device=device)
    _view(scores_addr, num_nodes, np.float32)[:] = r.bc_values
    return float(r.info["process_ms"])


def cc_c(comp_addr, count_addr, num_nodes, num_edges, row_addr, col_addr,
         *, device="cuda"):
    from .models.cc import cc
    g = _graph(num_nodes, num_edges, row_addr, col_addr)
    r = cc(g, device=device)
    _view(comp_addr, num_nodes, np.int32)[:] = r.components
    _view(count_addr, 1, np.int32)[0] = r.num_components
    return float(r.info["process_ms"])


def sssp_c(dist_addr, pred_addr, num_nodes, num_edges, row_addr, col_addr,
           val_addr, source, mark_preds, *, device="cuda"):
    from .models.sssp import sssp
    g = _graph(num_nodes, num_edges, row_addr, col_addr, val_addr)
    r = sssp(g, int(source), mark_preds=bool(mark_preds), device=device)
    _view(dist_addr, num_nodes, np.float32)[:] = r.distances
    if mark_preds and pred_addr:
        _view(pred_addr, num_nodes, np.int32)[:] = r.preds
    return float(r.info["process_ms"])


def pagerank_c(ids_addr, rank_addr, num_nodes, num_edges, row_addr,
               col_addr, normalized, *, device="cuda"):
    from .models.pr import pagerank
    g = _graph(num_nodes, num_edges, row_addr, col_addr)
    r = pagerank(g, normalized=bool(normalized), device=device)
    _view(ids_addr, num_nodes, np.int32)[:] = r.node_ids
    _view(rank_addr, num_nodes, np.float32)[:] = r.ranks[r.node_ids]
    return float(r.info["process_ms"])


def build_capi_lib() -> str:
    """Build the C shim (``csrc/c_api.cpp``, declared in
    ``csrc/gunrock_tpu_torch.h``) with g++ against this interpreter's
    headers and libpython, unless built already, into the port's build
    directory; returns the library's path. The repository's root and this
    interpreter's ``sys.path`` are baked in, so a plain C program can
    link it with no environment set up. A failed build raises."""
    ver = f"{sys.version_info.major}.{sys.version_info.minor}"
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR") or "/usr/local/lib"
    pypath = ":".join([_REPO] + [p for p in sys.path
                                 if p and os.path.isdir(p)])
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _CAPI_SRC,
           f"-I{inc}", f"-I{CAPI_HEADER_DIR}", f"-L{libdir}",
           f"-lpython{ver}", f"-Wl,-rpath,{libdir}",
           f"-DGRTT_PYPATH=\"{pypath}\""]
    h = hashlib.sha256(" ".join(cmd).encode())
    for name in ("c_api.cpp", "gunrock_tpu_torch.h"):
        with open(os.path.join(CAPI_HEADER_DIR, name), "rb") as f:
            h.update(f.read())
    so = os.path.join(build_dir(),
                      f"libgunrock_tpu_torch_capi_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    r = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed with code {r.returncode}:\n"
                           f"{' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, so)
    return so
