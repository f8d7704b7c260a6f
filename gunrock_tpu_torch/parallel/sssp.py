"""Sharded SSSP: relaxation supersteps with distance associates,
near-far delta-stepping, and the kernel route's pull-relax.

Counterpart of :mod:`gunrock_tpu.parallel.sssp` (the reference's
multi-GPU SSSP exchanges distances as value associates with boundary
vertices each superstep, ``app/sssp/sssp_enactor.cuh:666``):

  push:  every shard's relax -> bucket (dst, cand) by owner ->
         all-to-all -> scatter-min merge
  pull:  boundary-only exchange of the frontier-masked distances ->
         kernel K3 (min, ``add``) over each shard's compact in-edges

Scheduling is the JAX package's: ``bellman`` relaxes every improved
vertex next round; ``nearfar`` keeps a near/far pile whose threshold
jumps past the global minimum active distance when the near bucket is
empty (one ``pmin`` there, a reduction over every shard here), computed
in float32 as there. A superstep pulls when the frontier's out-edges
over every shard pass ``num_edges // pull_frac`` and the shard views
(``blocked``) are given. The loop runs on the host, one read of its
scalars a superstep; the JAX package's chunked dispatch, which bounds a
TPU call's length, is not needed.
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
from .comm import (ShardAdvance, first_per_shard, ghost_exchange,
                   route_by_owner)
from .mesh import Mesh, info_graph, make_mesh, mesh_of
from .partition import PartitionedGraph, partition

__all__ = ["sssp_sharded", "sssp_sharded_device", "ShardedSsspResult"]

INF = float("inf")


@dataclasses.dataclass
class ShardedSsspResult:
    distances: np.ndarray
    info: dict


def sssp_sharded_device(pg: PartitionedGraph, src_new: int, *,
                        mesh: Optional[Mesh] = None,
                        queue_sizing: float = 1.0, in_sizing: float = 1.0,
                        max_iters: Optional[int] = None,
                        mode: str = "bellman", delta: float = 1.0,
                        blocked: Optional[ShardedBlocked] = None,
                        pull_frac: int = 16):
    """Sharded SSSP in relabeled id space; returns ``(dist, iters,
    overflow, comm_bytes)``: the ``(p*S,)`` float32 distances on the
    partition's device, the superstep count, the overflow flag and the
    float32 byte count, as the JAX function does.

    ``blocked``: compact shard views with the CSC's edge values
    (``blocked_from_partition(pg, compact=True, edge_weight="csc")``);
    supersteps whose frontier edges pass ``num_edges // pull_frac`` then
    pull through kernel K3 once a shard."""
    if pg.edge_values is None:
        raise ValueError("sharded SSSP needs partition(with_edge_values=True)")
    if mode not in ("bellman", "nearfar"):
        raise ValueError(f"unknown sssp mode {mode!r}")
    if blocked is not None and not pg.has_ghosts:
        raise ValueError("blocked pull-relax needs partition("
                         "with_ghosts=True)")
    mesh_of(pg, mesh)
    p, S = pg.num_shards, pg.shard_size
    V, dev = p * S, pg.device
    fcap = max(128, int(S * min(queue_sizing, 1.0)))
    out_cap = max(128, int(pg.e_shard_pad * min(queue_sizing, 1.0)))
    per_peer_cap = max(128, int(out_cap * min(in_sizing, 1.0)))
    if max_iters is None:
        max_iters = 4 * pg.num_nodes + 16
    nearfar = mode == "nearfar"
    pull_edges = pg.num_edges // max(pull_frac, 1)
    f32 = np.float32
    delta32 = f32(delta)

    adv = ShardAdvance(pg)
    deg = adv.deg
    weights = pg.edge_values.reshape(-1)

    def push_step(dist, frontier):
        """Every shard's relax -> owner-routed (dst, cand) -> scatter-min.
        Returns (dist, improved mask, overflow, bytes sent)."""
        src, dst, eid, sender, tot_l = adv.expand(frontier)
        cand = dist[src.long()] + weights[eid]
        ovf = max(tot_l, default=0) > out_cap
        if ovf:
            keep = first_per_shard(sender, p, out_cap)
            dst, cand, sender = dst[keep], cand[keep], sender[keep]
        counts, kept = route_by_owner(sender, dst // S, p, per_peer_cap)
        if kept is not None:
            ovf = True
            dst, cand = dst[kept], cand[kept]
        sent = int(counts.clamp(max=per_peer_cap).sum()) * 8
        new_dist = dist.clone().scatter_reduce_(0, dst, cand, "amin")
        return new_dist, new_dist < dist, ovf, sent

    def pull_step(dist, frontier):
        """Frontier-masked distances through the boundary exchange, K3
        min over each shard's compact in-edges."""
        fmask = torch.zeros(V, dtype=torch.bool, device=dev)
        fmask[frontier.long()] = True
        masked = torch.where(fmask, dist, INF).view(p, S)
        table = ghost_exchange(masked, pg.ghost_send_idx)
        cand = torch.stack([
            pull_reduce2(table[i], view, op="min", wmode="add")
            for i, view in enumerate(blocked.views)]).reshape(-1)
        new_dist = torch.minimum(dist, cand)
        return new_dist, new_dist < dist, False, \
            p * (p - 1) * pg.ghost_cap * 4

    src_new = int(src_new)
    dist = torch.full((V,), INF, dtype=torch.float32, device=dev)
    dist[src_new] = 0.0
    frontier = torch.tensor([src_new], dtype=torch.int32, device=dev)
    active = torch.zeros(V, dtype=torch.bool, device=dev)
    level = f32(delta if nearfar else np.inf)
    n_global, it, ovf, comm_bytes = 1, 0, False, f32(0)
    while n_global > 0 and it < max_iters and not ovf:
        use_pull = (blocked is not None and
                    int(deg[frontier.long()].sum()) > pull_edges)
        dist, imp, step_ovf, sent = (pull_step if use_pull else push_step)(
            dist, frontier)
        if nearfar:
            # Improved vertices enter the pile; near = below the level.
            # An empty near bucket moves the level just past the global
            # minimum active distance, strictly above it (near reads
            # dist < level), in float32 as the JAX package computes it.
            active = active | imp
            any_near = bool((active & (dist < float(level))).any())
            if not any_near:
                gmin = f32(float(torch.where(active, dist, INF).min()))
                new_level = f32(delta32 * f32(np.floor(gmin / delta32)
                                              + f32(1.0)))
                if not new_level > gmin:
                    new_level = np.nextafter(gmin, f32(np.inf))
                if np.isfinite(gmin):
                    level = new_level
            near = active & (dist < float(level))
            active = active & ~near
        else:
            near = imp
        frontier = torch.nonzero(near).flatten().to(torch.int32)
        shard = frontier.long() // S
        rebuild_ovf = int(torch.bincount(shard, minlength=p).max()) > fcap
        if rebuild_ovf:
            frontier = frontier[first_per_shard(shard, p, fcap)]
        n_global = frontier.shape[0]
        ovf = ovf or step_ovf or rebuild_ovf
        comm_bytes = f32(comm_bytes + f32(sent))
        it += 1
    return dist, it, ovf, comm_bytes


def sssp_sharded(graph: CsrGraph, src: int = 0, *, num_shards: int = None,
                 partition_method: str = "random", seed: int = 0,
                 mesh: Optional[Mesh] = None, queue_sizing: float = 1.0,
                 in_sizing: float = 1.0,
                 max_iters: Optional[int] = None,
                 mode: str = "bellman", delta_factor: int = 32,
                 use_blocked: Optional[bool] = None,
                 pull_frac: int = 16, device="cuda") -> ShardedSsspResult:
    """Partition ``graph`` onto the mesh and run SSSP.

    ``mode='nearfar'`` runs sharded delta-stepping with ``delta =
    delta_factor * mean(edge weight)`` (the C API knob,
    ``gunrock/gunrock.h:98``). ``use_blocked`` adds the pull-relax
    through kernel K3 for large frontiers (default: on a CUDA mesh)."""
    timer = Timer()
    if mesh is None:
        mesh = make_mesh(num_shards, device=device)
    num_shards = mesh.num_shards
    if not 0 <= int(src) < graph.num_nodes:
        raise ValueError(f"src {src} out of range [0, {graph.num_nodes})")
    if graph.edge_values is None:
        graph.random_edge_values()
    if use_blocked is None:
        use_blocked = mesh.device.type == "cuda"
    delta = float(delta_factor) * float(np.mean(graph.edge_values)) \
        if mode == "nearfar" else 1.0

    with timer.time("partition_ms"):
        pg, perm = partition(graph, num_shards, method=partition_method,
                             seed=seed, with_edge_values=True,
                             with_csc=use_blocked, with_ghosts=use_blocked,
                             device=mesh.device)
        blocked = (blocked_from_partition(pg, compact=True,
                                          edge_weight="csc")
                   if use_blocked else None)
        sync(mesh.device)
    with timer.time("process_ms"):
        # Overflow retry with doubled sizing (reference Check_Size
        # regrow, enactor_helper.cuh:103-138); sizing 1.0 cannot overflow.
        qs, ins = queue_sizing, in_sizing
        while True:
            dist, iters, ovf, comm_bytes = sssp_sharded_device(
                pg, int(perm[src]), mesh=mesh, queue_sizing=qs,
                in_sizing=ins, max_iters=max_iters, mode=mode, delta=delta,
                blocked=blocked, pull_frac=pull_frac)
            if not ovf or (qs >= 1.0 and ins >= 1.0):
                break
            qs = min(qs * 2.0, 1.0)
            ins = min(ins * 2.0, 1.0)
        dist = dist.cpu().numpy()

    dist_old = dist[perm]
    degs = np.diff(graph.row_offsets).astype(np.int64)
    info = make_info(
        primitive="sssp_sharded", graph=info_graph(graph, mesh), timer=timer,
        edges_visited=int(degs[np.isfinite(dist_old)].sum()),
        extra={"src": int(src), "num_shards": int(num_shards),
               "num_iterations": int(iters),
               "frontier_overflow": bool(ovf),
               "mode": mode, "delta": delta if mode == "nearfar" else None,
               "blocked_kernels": bool(use_blocked),
               "comm_bytes": float(comm_bytes),
               "partition_method": partition_method},
    )
    return ShardedSsspResult(distances=dist_old, info=info)
