"""Sharded TopK degree centrality.

Counterpart of :mod:`gunrock_tpu.parallel.topk`: each shard takes the
top ``min(k, S)`` of its owned vertices by out- plus in-degree, the
candidates of every shard are pooled in shard order, and the global top
``k`` of the pool is the answer (communication O(p * k), not O(V)).
Both selections put the lower index first among ties, as the JAX
package's ``lax.top_k`` does (a stable descending sort), so the ids are
the JAX package's exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..enactor import Timer
from ..graph.csr import CsrGraph
from ..graph.device import sync
from ..utils.info import make_info
from .mesh import Mesh, info_graph, make_mesh
from .partition import partition

__all__ = ["topk_sharded", "ShardedTopkResult"]


@dataclasses.dataclass
class ShardedTopkResult:
    node_ids: np.ndarray      # (k,) int32, original vertex ids
    centralities: np.ndarray  # (k,) int32 (out_deg + in_deg)
    info: dict


def _top(vals: torch.Tensor, k: int):
    """``lax.top_k`` along the last dim: the ``k`` largest, the lower
    index first among ties."""
    srt = torch.sort(vals, dim=-1, descending=True, stable=True)
    return srt.values[..., :k], srt.indices[..., :k]


def topk_sharded(graph: CsrGraph, k: int = 10, *, num_shards: int = None,
                 partition_method: str = "random", seed: int = 0,
                 mesh: Optional[Mesh] = None,
                 device="cuda") -> ShardedTopkResult:
    timer = Timer()
    if mesh is None:
        mesh = make_mesh(num_shards, device=device)
    num_shards = mesh.num_shards
    k = min(k, graph.num_nodes)
    dev = mesh.device

    with timer.time("partition_ms"):
        pg, perm = partition(graph, num_shards, method=partition_method,
                             seed=seed, with_csc=True, device=dev)
        vmask_new = np.zeros(pg.v_global_pad, bool)
        vmask_new[perm] = True
        sync(dev)

    S, p = pg.shard_size, pg.num_shards
    kk = min(k, S)
    with timer.time("process_ms"):
        deg = torch.diff(pg.row_offsets, dim=1) + \
            torch.diff(pg.csc_offsets, dim=1)
        vmask = torch.from_numpy(vmask_new).to(dev).view(p, S)
        cent = torch.where(vmask, deg.to(torch.int32), -1)
        vals, ids = _top(cent, kk)                          # (p, kk)
        base = (torch.arange(p, device=dev) * S)[:, None]
        gids = torch.where(vals >= 0, ids + base, -1)
        gv, gpos = _top(vals.reshape(-1), k)
        ids_new = gids.reshape(-1)[gpos].cpu().numpy()
        gv = gv.cpu().numpy()

    # Stitch back to original ids (inverse of the relabeling perm).
    inv = np.full(pg.v_global_pad, -1, np.int64)
    inv[perm] = np.arange(graph.num_nodes)
    ids_orig = np.where(ids_new >= 0, inv[np.clip(ids_new, 0, None)], -1)
    info = make_info(
        primitive="topk_sharded", graph=info_graph(graph, mesh), timer=timer,
        edges_visited=graph.num_edges,
        extra={"num_shards": int(num_shards), "top_nodes": int(k),
               "partition_method": partition_method,
               "comm_bytes_per_superstep": int(p * kk * 8)},
    )
    return ShardedTopkResult(node_ids=ids_orig.astype(np.int32),
                             centralities=gv, info=info)
