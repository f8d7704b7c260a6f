"""Sharded PageRank: vertex-sharded pull SpMV over the shard mesh.

Counterpart of :mod:`gunrock_tpu.parallel.pr` (the reference's multi-GPU
PR exchanges rank associates every superstep, ``app/pr/pr_enactor.cuh:
1109``). Ranks are ``(p, S)``; each iteration ships only boundary values
(``comm.ghost_exchange`` into each shard's compact table) and sums each
shard's owned in-edges; convergence is the count of updated vertices
over every shard (reference Stop_Condition ``pr_enactor.cuh:864-884``).

With ``blocked`` (compact shard views carrying 1/outdeg(src) as per-edge
weights) the sum is kernel K3 (sum, ``mul``) once a shard over the
exchanged plain ranks, as the JAX package runs its blocked value kernel
per shard; without, one segmented sum over every shard's CSC of the
exchanged ``rank / outdeg``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..enactor import Timer
from ..graph.csr import CsrGraph
from ..graph.device import sync
from ..ops.pull2 import pull_reduce2
from ..utils.info import make_info
from .blocked import ShardedBlocked, blocked_from_partition
from .comm import ghost_exchange
from .mesh import Mesh, info_graph, make_mesh, mesh_of
from .partition import PartitionedGraph, flat_rows, partition

__all__ = ["pagerank_sharded", "pagerank_sharded_device",
           "ShardedPrResult"]


@dataclasses.dataclass
class ShardedPrResult:
    ranks: np.ndarray
    node_ids: np.ndarray
    info: dict


def shard_pull_sum(table: torch.Tensor, blocked: ShardedBlocked
                   ) -> torch.Tensor:
    """``(p, S)``: kernel K3 (sum, ``mul`` by the views' per-edge
    weights) over each shard's row of the compact ``table``."""
    return torch.stack([pull_reduce2(table[i], view, op="sum", wmode="mul")
                        for i, view in enumerate(blocked.views)])


def pagerank_sharded_device(pg: PartitionedGraph, *,
                            mesh: Optional[Mesh] = None,
                            out_degrees_new: torch.Tensor,
                            vmask_new: torch.Tensor, damping: float = 0.85,
                            threshold: float = 1e-6, max_iters: int = 50,
                            normalized: bool = True,
                            comm_latency: int = 0,
                            blocked: Optional[ShardedBlocked] = None):
    """Sharded PageRank in relabeled id space; returns ``(rank, iters)``,
    the ``(p*S,)`` float32 ranks on the partition's device and the
    iteration count. ``out_degrees_new`` and ``vmask_new`` are ``(p*S,)``
    (float32 out-degrees, real-vertex mask) in relabeled ids."""
    if not pg.has_ghosts:
        raise ValueError("sharded PageRank needs partition(with_ghosts=True)")
    mesh_of(pg, mesh)
    p, S, n = pg.num_shards, pg.shard_size, pg.num_nodes
    reset = (1.0 - damping) / n if normalized else (1.0 - damping)
    csc = flat_rows(pg.csc_offsets, pg.csc_local, S + p * pg.ghost_cap)
    out_deg = out_degrees_new.to(torch.float32).view(p, S)
    vmask = vmask_new.view(p, S)
    inv_deg = torch.where(out_deg > 0, 1.0 / out_deg.clamp(min=1.0), 0.0)
    rank = torch.where(vmask, (1.0 / n) if normalized else (1.0 - damping),
                       0.0).to(torch.float32)
    thresh = torch.tensor(threshold, dtype=torch.float32, device=pg.device)
    num_updated, it = 1, 0
    while num_updated > 0 and it < max_iters:
        if blocked is not None:
            # Plain ranks over the boundary; 1/outdeg(src) is in the
            # views' edge weights.
            table = ghost_exchange(rank, pg.ghost_send_idx,
                                   comm_latency=comm_latency)
            incoming = shard_pull_sum(table, blocked)
        else:
            table = ghost_exchange(rank * inv_deg, pg.ghost_send_idx,
                                   comm_latency=comm_latency)
            incoming = csc.reduce(table, "sum")
        new_rank = torch.where(vmask, reset + damping * incoming, 0.0)
        num_updated = int((vmask & ((new_rank - rank).abs() > thresh)).sum())
        rank = new_rank
        it += 1
    return rank.reshape(-1), it


def pagerank_sharded(graph: CsrGraph, *, num_shards: int = None,
                     partition_method: str = "random", seed: int = 0,
                     mesh: Optional[Mesh] = None, damping: float = 0.85,
                     threshold: float = 1e-6, max_iters: int = 50,
                     normalized: bool = True,
                     comm_latency: int = 0,
                     use_blocked: Optional[bool] = None,
                     device="cuda") -> ShardedPrResult:
    """Partition ``graph`` onto the mesh and run PageRank.
    ``use_blocked`` routes each shard's SpMV through kernel K3 (default:
    on a CUDA mesh; on the CPU the same views through K3's plain
    version); the exchange still ships only boundary ranks."""
    timer = Timer()
    if mesh is None:
        mesh = make_mesh(num_shards, device=device)
    num_shards = mesh.num_shards
    if use_blocked is None:
        use_blocked = mesh.device.type == "cuda"
    dev = mesh.device

    with timer.time("partition_ms"):
        pg, perm = partition(graph, num_shards, method=partition_method,
                             seed=seed, with_csc=True, with_ghosts=True,
                             device=dev)
        v_pad = pg.v_global_pad
        out_deg_new = np.zeros(v_pad, np.float32)
        out_deg_new[perm] = np.diff(graph.row_offsets).astype(np.float32)
        vmask_new = np.zeros(v_pad, bool)
        vmask_new[perm] = True
        out_deg_t = torch.from_numpy(out_deg_new).to(dev)
        blocked = None
        if use_blocked:
            inv_deg = torch.where(out_deg_t > 0,
                                  1.0 / out_deg_t.clamp(min=1.0), 0.0)
            # Compact views, edge weight 1/outdeg(global source).
            blocked = blocked_from_partition(
                pg, compact=True, edge_weight=lambda sg, dl, i: inv_deg[sg])
        sync(dev)

    with timer.time("process_ms"):
        rank, iters = pagerank_sharded_device(
            pg, mesh=mesh, out_degrees_new=out_deg_t,
            vmask_new=torch.from_numpy(vmask_new).to(dev), damping=damping,
            threshold=threshold, max_iters=max_iters, normalized=normalized,
            comm_latency=comm_latency, blocked=blocked)
        rank = rank.cpu().numpy()

    ranks_old = rank[perm]
    order = np.argsort(-ranks_old, kind="stable").astype(np.int32)
    # boundary-exchange volume: p*ghost_cap values a shard a superstep
    bytes_per_step = num_shards * (num_shards - 1) * pg.ghost_cap * 4
    info = make_info(
        primitive="pagerank_sharded", graph=info_graph(graph, mesh),
        timer=timer, edges_visited=graph.num_edges * int(iters),
        extra={"num_shards": int(num_shards), "damping": damping,
               "num_iterations": int(iters),
               "blocked_kernels": bool(use_blocked),
               "partition_method": partition_method,
               "ghost_cap": int(pg.ghost_cap),
               "comm_bytes_per_superstep": int(bytes_per_step),
               "comm_bytes": int(bytes_per_step) * int(iters),
               "comm_latency_rounds": comm_latency},
    )
    return ShardedPrResult(ranks=ranks_old, node_ids=order, info=info)
