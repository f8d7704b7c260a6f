"""Replicated ("duplicate") execution: the whole graph for every shard,
a batch of sources split across the mesh.

Counterpart of :mod:`gunrock_tpu.parallel.replicate` (the reference's
DuplicatePartitioner, ``app/dup/dup_partitioner.cuh``, whose use is
throughput on batched queries). The sources are padded to ``p * k`` and
shard ``i`` takes sources ``i * k .. (i + 1) * k - 1``; each runs the
port's single-card loop (``models.bfs.bfs_device``,
``models.bc.bc_device``) on the one uploaded graph, and the per-vertex
results combine with one sum over shards. On the stacked mesh the
shards share one device and run one after another; on a process-group
mesh each rank runs its own sources on its own upload.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..enactor import Timer
from ..graph.csr import CsrGraph
from ..graph.device import DeviceGraph, sync, to_device
from ..models.bc import bc_device
from ..models.bfs import bfs_device
from ..utils.info import make_info
from .mesh import Mesh, make_mesh, mesh_info

__all__ = ["bc_batch", "bfs_batch", "BatchBcResult", "BatchBfsResult"]


@dataclasses.dataclass
class BatchBcResult:
    bc_values: np.ndarray      # (V,) summed over the source batch
    info: dict


@dataclasses.dataclass
class BatchBfsResult:
    labels: np.ndarray         # (num_sources, V) int32 depths
    info: dict


def _prep(graph: Union[CsrGraph, DeviceGraph], sources, mesh, timer,
          device):
    """The uploaded graph, the padded ``(p, k)`` source table (-1 pads),
    the mesh."""
    if mesh is None:
        mesh = make_mesh(device=device)
    p = mesh.num_shards
    if isinstance(graph, CsrGraph):
        with timer.time("preprocess_ms"):
            dg = to_device(graph, device=mesh.device)
            sync(mesh.device)
    else:
        if graph.device != mesh.device:
            raise ValueError(f"graph is on {graph.device}, the mesh on "
                             f"{mesh.device}")
        dg = graph
    srcs = np.asarray(list(sources), dtype=np.int32)
    if srcs.size == 0:
        raise ValueError("empty source batch")
    if (srcs < 0).any() or (srcs >= dg.num_nodes).any():
        raise ValueError("source out of range")
    k = -(-srcs.size // p)
    padded = np.full(p * k, -1, np.int32)
    padded[: srcs.size] = srcs
    return dg, padded.reshape(p, k), mesh


def bc_batch(graph: Union[CsrGraph, DeviceGraph],
             sources: Sequence[int], *, mesh: Optional[Mesh] = None,
             queue_sizing: float = 1.0, device="cuda") -> BatchBcResult:
    """Multi-source Brandes BC, sources fanned across the mesh on a
    replicated graph; returns per-vertex centrality summed over the batch
    (x0.5 undirected scaling, matching ``models.bc``)."""
    timer = Timer()
    num_nodes = graph.num_nodes
    dg, table, mesh = _prep(graph, sources, mesh, timer, device)
    with timer.time("process_ms"):
        acc = torch.zeros((mesh.local_shards, dg.v_pad), dtype=torch.float32,
                          device=mesh.device)
        for i, shard_sources in enumerate(mesh.local(table).tolist()):
            for s in shard_sources:
                if s >= 0:
                    vals, _, _, _ = bc_device(dg, s,
                                              queue_sizing=queue_sizing)
                    acc[i] += vals
        vals = mesh.psum(acc)[:num_nodes].cpu().numpy()

    n_src = int((table >= 0).sum())
    info = make_info(
        primitive="bc_batch", graph=dg, timer=timer,
        edges_visited=2 * dg.num_edges * n_src,
        extra={"num_sources": n_src, "num_shards": mesh.num_shards,
               "replicated": True, "partition_method": "duplicate",
               **mesh_info(mesh)},
    )
    return BatchBcResult(bc_values=(vals * 0.5).astype(np.float32),
                         info=info)


def bfs_batch(graph: Union[CsrGraph, DeviceGraph],
              sources: Sequence[int], *, mesh: Optional[Mesh] = None,
              queue_sizing: float = 1.0, device="cuda") -> BatchBfsResult:
    """Batched multi-source BFS on a replicated graph: sources split
    across the mesh, each traversed by the single-card loop (non-DO);
    the label vectors are gathered back in source order."""
    timer = Timer()
    num_nodes = graph.num_nodes
    dg, table, mesh = _prep(graph, sources, mesh, timer, device)
    with timer.time("process_ms"):
        rows = []
        for shard_sources in mesh.local(table).tolist():
            for s in shard_sources:
                row = torch.full((num_nodes,), -1, dtype=torch.int32,
                                 device=mesh.device)
                if s >= 0:
                    row = bfs_device(dg, s, queue_sizing=queue_sizing)[0]
                rows.append(row[:num_nodes])
        # every shard's k rows, gathered in source order; pads dropped
        labels = mesh.all_gather(torch.stack(rows).view(
            mesh.local_shards, -1, num_nodes)).reshape(-1, num_nodes)
        labels = labels[torch.from_numpy(table.reshape(-1) >= 0).to(
            labels.device)].cpu().numpy()

    info = make_info(
        primitive="bfs_batch", graph=dg, timer=timer,
        edges_visited=dg.num_edges * int(labels.shape[0]),
        extra={"num_sources": int(labels.shape[0]),
               "num_shards": mesh.num_shards,
               "replicated": True, "partition_method": "duplicate",
               **mesh_info(mesh)},
    )
    return BatchBfsResult(labels=labels, info=info)
