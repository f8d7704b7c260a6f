"""Sharded Betweenness Centrality (single-source Brandes).

Counterpart of :mod:`gunrock_tpu.parallel.bc` (the reference's BC chains
a forward BFS-like loop accumulating sigma, ``bc_functor.cuh:70``, with a
backward loop replaying the levels, ``bc_functor.cuh:203-238``,
exchanging sigmas and deltas as value associates). Three level-
synchronous phases, every exchange boundary-only over the ghost tables:

  1. labels: sharded BFS depths (a label exchange a level over the
     in-edge tables, a pull over each shard's CSC rows);
  2. forward sweep d = 1..D: sigma[v] = sum of sigma[u] over in-neighbours
     u at depth d - 1 (a sigma exchange a level);
  3. backward sweep d = D-1..0: delta[u] = sigma[u] * sum over
     out-neighbours v at depth d + 1 of (1 + delta[v]) / sigma[v] (a
     delta exchange a level over the out-edge tables).

Segmented sums, no atomics: reproducible run to run. The JAX package
sums a float32 running total (``row_reduce_sorted``); here each row is
summed in float64, so the two agree to float32 rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..enactor import Timer
from ..graph.csr import CsrGraph
from ..graph.device import sync
from ..utils.info import make_info
from .comm import ghost_exchange
from .mesh import Mesh, info_graph, make_mesh, mesh_of
from .partition import PartitionedGraph, flat_rows, partition

__all__ = ["bc_sharded", "bc_sharded_device", "ShardedBcResult"]


@dataclasses.dataclass
class ShardedBcResult:
    bc_values: np.ndarray
    sigmas: np.ndarray
    labels: np.ndarray
    info: dict


def bc_sharded_device(pg: PartitionedGraph, src_new: int, *,
                      mesh: Optional[Mesh] = None, comm_latency: int = 0):
    """Sharded single-source Brandes in relabeled id space; returns
    ``(bc, sigma, labels, depth)``: ``(p*S,)`` tensors on the partition's
    device (the unscaled dependencies with the source's zero, the path
    counts, the int32 depths, -1 unreached) and the search depth as the
    JAX function counts it (one past the last level)."""
    if not pg.has_ghosts:
        raise ValueError("sharded BC needs partition(with_ghosts=True)")
    mesh_of(pg, mesh)
    p, S = pg.num_shards, pg.shard_size
    V, dev = p * S, pg.device
    fwd = flat_rows(pg.row_offsets, pg.col_local, S + p * pg.fwd_ghost_cap)
    bwd = flat_rows(pg.csc_offsets, pg.csc_local, S + p * pg.ghost_cap)

    def in_table(vals):
        return ghost_exchange(vals, pg.ghost_send_idx,
                              comm_latency=comm_latency)

    def out_table(vals):
        return ghost_exchange(vals, pg.fwd_ghost_send_idx,
                              comm_latency=comm_latency)

    labels = torch.full((V,), -1, dtype=torch.int32, device=dev)
    labels[int(src_new)] = 0
    labels = labels.view(p, S)

    # phase 1: BFS depths, a pull over in-edges a level
    changed, d = 1, 1
    while changed > 0:
        hit = (in_table(labels) == d - 1).to(torch.int32)
        new = (labels == -1) & (bwd.reduce(hit, "sum") > 0)
        labels = torch.where(new, d, labels)
        changed = int(new.sum())
        d += 1
    depth = d - 1  # one past the last level that discovered a vertex

    # labels are fixed from here on: one exchange a direction
    l_in = in_table(labels)
    l_out = out_table(labels)

    # phase 2: forward sigma sweep, a boundary exchange of sigma a level
    sigma = torch.where(labels == 0, 1.0, 0.0).to(torch.float32)
    for lvl in range(1, depth + 1):
        contrib = torch.where(l_in == lvl - 1, in_table(sigma), 0.0)
        sigma = torch.where(labels == lvl, bwd.reduce(contrib, "sum"), sigma)

    # phase 3: backward delta sweep over out-edges
    s_out = out_table(sigma).clamp(min=1e-30)
    delta = torch.zeros((p, S), dtype=torch.float32, device=dev)
    for lvl in range(depth - 1, -1, -1):
        ratio = torch.where(l_out == lvl + 1, (1.0 + out_table(delta)) / s_out,
                            0.0)
        delta = torch.where(labels == lvl, sigma * fwd.reduce(ratio, "sum"),
                            delta)
    bc = torch.where(labels > 0, delta, 0.0)
    return bc.reshape(-1), sigma.reshape(-1), labels.reshape(-1), depth


def bc_sharded(graph: CsrGraph, src: Union[int, str] = 0, *,
               num_shards: int = None, partition_method: str = "random",
               seed: int = 0, mesh: Optional[Mesh] = None,
               device="cuda") -> ShardedBcResult:
    """Partition ``graph`` onto the mesh and run single-source BC from
    ``src`` (an id or ``"largestdegree"``); values scaled by 0.5, as for
    undirected graphs in ``models.bc``."""
    timer = Timer()
    if mesh is None:
        mesh = make_mesh(num_shards, device=device)
    num_shards = mesh.num_shards
    if src == "largestdegree":
        src = graph.largest_degree_vertex()
    src = int(src)
    if not 0 <= src < graph.num_nodes:
        raise ValueError(f"src {src} out of range [0, {graph.num_nodes})")

    with timer.time("partition_ms"):
        pg, perm = partition(graph, num_shards, method=partition_method,
                             seed=seed, with_csc=True, with_ghosts=True,
                             device=mesh.device)
        sync(mesh.device)

    with timer.time("process_ms"):
        bc_new, sigma_new, labels_new, depth = bc_sharded_device(
            pg, int(perm[src]), mesh=mesh)
        bc_new, sigma_new, labels_new = (
            t.cpu().numpy() for t in (bc_new, sigma_new, labels_new))

    info = make_info(
        primitive="bc_sharded", graph=info_graph(graph, mesh), timer=timer,
        edges_visited=2 * graph.num_edges,
        extra={"src": src, "num_shards": int(num_shards),
               "search_depth": int(depth),
               "partition_method": partition_method,
               "ghost_cap": int(pg.ghost_cap),
               "comm_bytes_per_superstep":
                   num_shards * (num_shards - 1) * pg.ghost_cap * 4},
    )
    return ShardedBcResult(bc_values=(bc_new[perm] * 0.5).astype(np.float32),
                           sigmas=sigma_new[perm], labels=labels_new[perm],
                           info=info)
