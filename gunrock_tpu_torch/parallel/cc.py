"""Sharded Connected Components: min-label hooking and pointer jumping
over the shard mesh.

Counterpart of :mod:`gunrock_tpu.parallel.cc` (the reference's CC,
``gunrock/app/cc/cc_enactor.cuh``). A superstep, on every shard:

  1. boundary-only exchange of component ids over the forward ghost
     tables (``comm.ghost_exchange``; the reference ships boundary
     vertex associates, ``enactor_helper.cuh:297-405``);
  2. hook: comp[u] <- min(comp[u], min over out-neighbours comp[v]), one
     segmented min over every shard's CSR rows;
  3. pointer jumping through locally owned representatives until no
     shard changes, and every 8th superstep also through a snapshot of
     every shard's ids (the JAX package's global collapse rung).

It ends when no id changed on any shard. Each shard's jumping loop in the
JAX package stops when that shard is stable; a stable shard's jump
changes nothing, so running every shard until all are stable gives the
same ids. Needs the symmetrized graph, as the reference's CC does.
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
from .comm import ghost_exchange
from .mesh import Mesh, info_graph, make_mesh, mesh_info, mesh_of
from .partition import PartitionedGraph, flat_rows, for_mesh, partition

__all__ = ["cc_sharded", "cc_sharded_device", "ShardedCcResult"]

GLOBAL_EVERY = 8
_NONE = 0x7FFFFFFF


@dataclasses.dataclass
class ShardedCcResult:
    components: np.ndarray
    num_components: int
    info: dict


def _jump(comp: torch.Tensor, parent) -> torch.Tensor:
    """Repeat ``comp = min(comp, parent(comp))`` until nothing changes."""
    while True:
        j = torch.minimum(comp, parent(comp))
        if torch.equal(j, comp):
            return comp
        comp = j


def cc_sharded_device(pg: PartitionedGraph, *, mesh: Optional[Mesh] = None,
                      vmask_new: torch.Tensor,
                      max_iters: Optional[int] = None,
                      comm_latency: int = 0):
    """Sharded CC in relabeled id space; returns ``(comp, iters)``: the
    ``(p*S,)`` int32 representative of every vertex on the mesh's device
    (a relabeled id; every rank gets all of them on a process-group
    mesh) and the superstep count. ``vmask_new`` is ``(p*S,)``."""
    if not pg.has_ghosts:
        raise ValueError("sharded CC needs partition(with_ghosts=True)")
    mesh = mesh_of(pg, mesh)
    p, S = pg.num_shards, pg.shard_size
    L, V, dev = pg.local_shards, p * S, pg.device
    if max_iters is None:
        # min-label propagation crosses >= one boundary edge a superstep
        max_iters = pg.num_nodes + 16
    fwd = flat_rows(pg.row_offsets, pg.col_local, S + p * pg.fwd_ghost_cap)
    vid = torch.arange(V, dtype=torch.int32, device=dev)
    comp = mesh.local(torch.where(vmask_new, vid, _NONE).view(p, S))
    lbase = (torch.arange(L, device=dev) * S)[:, None]
    gbase = lbase + pg.shard_lo * S

    def local_parent(c):
        tgt = c.long() - gbase
        islocal = (tgt >= 0) & (tgt < S)
        got = c.reshape(-1)[(tgt.clamp(0, S - 1) + lbase).reshape(-1)]
        return torch.where(islocal, got.view(L, S), c)

    changed, it = 1, 0
    while changed > 0 and it < max_iters:
        table = ghost_exchange(comp, pg.fwd_ghost_send_idx,
                               comm_latency=comm_latency, mesh=mesh)
        hooked = torch.minimum(comp, fwd.reduce(table, "min"))
        jumped = _jump(hooked, local_parent)
        if it % GLOBAL_EVERY == GLOBAL_EVERY - 1:
            snap = mesh.all_gather(jumped).reshape(-1)
            jumped = _jump(jumped, lambda c: snap[c.long().clamp(0, V - 1)])
        moved = (jumped != comp).sum(dim=1)
        changed = sum(r[0] for r in mesh.read(moved[:, None]))
        comp = jumped
        it += 1
    return mesh.all_gather(comp).reshape(-1), it


def cc_sharded(graph: CsrGraph, *, num_shards: int = None,
               partition_method: str = "random", seed: int = 0,
               mesh: Optional[Mesh] = None, comm_latency: int = 0,
               device="cuda") -> ShardedCcResult:
    """Partition ``graph`` onto the mesh and run CC; components are
    labelled by the minimum original vertex id in each."""
    timer = Timer()
    if mesh is None:
        mesh = make_mesh(num_shards, device=device)
    num_shards = mesh.num_shards

    with timer.time("partition_ms"):
        pg, perm = partition(graph, num_shards, method=partition_method,
                             seed=seed, with_ghosts=True, device=mesh.device)
        pg = for_mesh(pg, mesh)
        vmask = np.zeros(pg.v_global_pad, bool)
        vmask[perm] = True
        sync(mesh.device)

    with timer.time("process_ms"):
        comp_new, iters = cc_sharded_device(
            pg, mesh=mesh, vmask_new=torch.from_numpy(vmask).to(mesh.device),
            comm_latency=comm_latency)
        comp_new = comp_new.cpu().numpy()

    # Back to original ids: representative = min ORIGINAL id.
    comp_old = comp_new[perm]
    inv = np.zeros(pg.v_global_pad, np.int64)
    inv[perm] = np.arange(graph.num_nodes)
    rep_old = inv[comp_old]
    mins = np.full(graph.num_nodes, np.iinfo(np.int64).max)
    np.minimum.at(mins, rep_old, np.arange(graph.num_nodes))
    comp = mins[rep_old].astype(np.int32)
    num_components = int(np.unique(comp).size)
    info = make_info(
        primitive="cc_sharded", graph=info_graph(graph, mesh), timer=timer,
        edges_visited=graph.num_edges * int(iters),
        extra={"num_shards": int(num_shards),
               "num_components": num_components,
               "num_iterations": int(iters),
               "partition_method": partition_method,
               "ghost_cap": int(pg.fwd_ghost_cap),
               "comm_bytes_per_superstep":
                   num_shards * (num_shards - 1) * pg.fwd_ghost_cap * 4,
               "comm_latency_rounds": comm_latency, **mesh_info(mesh)},
    )
    return ShardedCcResult(components=comp, num_components=num_components,
                           info=info)
