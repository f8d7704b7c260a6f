"""Sharded HITS and SALSA: dual-direction sweeps over the shard mesh.

Counterpart of :mod:`gunrock_tpu.parallel.hits`. Each iteration runs
both directions, each shipping only boundary values
(``comm.ghost_exchange`` with the direction's tables):

  * auth[v] = sum over in-edges  (u, v) of f(hub[u])   (CSC tables)
  * hub[u]  = sum over out-edges (u, v) of g(auth[v])  (forward tables)

HITS max-normalizes each vector by its largest entry over every shard
(the JAX package's ``pmax``, single-card parity with ``models/hits.py``);
SALSA's row-stochastic updates need no normalization.
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

__all__ = ["hits_sharded", "salsa_sharded", "ShardedLinkResult"]


@dataclasses.dataclass
class ShardedLinkResult:
    hubs: np.ndarray
    auths: np.ndarray
    info: dict


def link_sharded_device(pg: PartitionedGraph, kind: str, *,
                        vmask_new: torch.Tensor, max_iters: int,
                        mesh: Optional[Mesh] = None, comm_latency: int = 0):
    """``max_iters`` HITS (``kind="hits"``) or SALSA iterations on a
    partition made ``with_csc`` and ``with_ghosts``; returns ``(hub,
    auth)``, ``(p*S,)`` float32 on the mesh's device (all of them on
    every rank of a process-group mesh)."""
    if not pg.has_ghosts:
        raise ValueError(f"sharded {kind} needs partition(with_csc=True, "
                         "with_ghosts=True)")
    mesh = mesh_of(pg, mesh)
    p, S, n = pg.num_shards, pg.shard_size, pg.num_nodes
    bwd = flat_rows(pg.csc_offsets, pg.csc_local, S + p * pg.ghost_cap)
    fwd = flat_rows(pg.row_offsets, pg.col_local, S + p * pg.fwd_ghost_cap)
    vmask = mesh.local(vmask_new.view(p, S))
    out_deg = torch.diff(pg.row_offsets, dim=1).to(torch.float32)
    in_deg = torch.diff(pg.csc_offsets, dim=1).to(torch.float32)
    inv_out = torch.where(out_deg > 0, 1.0 / out_deg.clamp(min=1.0), 0.0)
    inv_in = torch.where(in_deg > 0, 1.0 / in_deg.clamp(min=1.0), 0.0)
    hub = torch.where(vmask, 1.0 if kind == "hits" else 1.0 / n,
                      0.0).to(torch.float32)
    auth = hub

    def normalize(x):
        # the largest entry over every shard (pmax)
        top = mesh.pmax(x.amax(dim=1))
        return x / torch.clamp(top, min=1e-12)

    for _ in range(max_iters):
        contrib = hub if kind == "hits" else hub * inv_out
        auth = bwd.reduce(ghost_exchange(contrib, pg.ghost_send_idx,
                                         comm_latency=comm_latency,
                                         mesh=mesh), "sum")
        auth = torch.where(vmask, auth, 0.0)
        if kind == "hits":
            auth = normalize(auth)
        fcontrib = auth if kind == "hits" else auth * inv_in
        hub = fwd.reduce(ghost_exchange(fcontrib, pg.fwd_ghost_send_idx,
                                        comm_latency=comm_latency,
                                        mesh=mesh), "sum")
        hub = torch.where(vmask, hub, 0.0)
        if kind == "hits":
            hub = normalize(hub)
    return (mesh.all_gather(hub).reshape(-1),
            mesh.all_gather(auth).reshape(-1))


def _link_sharded(kind: str, graph: CsrGraph, *, num_shards, max_iters,
                  partition_method, seed, mesh, comm_latency,
                  device) -> ShardedLinkResult:
    timer = Timer()
    if mesh is None:
        mesh = make_mesh(num_shards, device=device)
    num_shards = mesh.num_shards

    with timer.time("partition_ms"):
        pg, perm = partition(graph, num_shards, method=partition_method,
                             seed=seed, with_csc=True, with_ghosts=True,
                             device=mesh.device)
        pg = for_mesh(pg, mesh)
        vmask_new = np.zeros(pg.v_global_pad, bool)
        vmask_new[perm] = True
        sync(mesh.device)

    with timer.time("process_ms"):
        hub, auth = link_sharded_device(
            pg, kind, vmask_new=torch.from_numpy(vmask_new).to(mesh.device),
            max_iters=max_iters, mesh=mesh, comm_latency=comm_latency)
        hub, auth = hub.cpu().numpy(), auth.cpu().numpy()

    bytes_per_step = num_shards * (num_shards - 1) * \
        (pg.ghost_cap + pg.fwd_ghost_cap) * 4
    info = make_info(
        primitive=f"{kind}_sharded", graph=info_graph(graph, mesh),
        timer=timer, edges_visited=2 * graph.num_edges * max_iters,
        extra={"num_shards": int(num_shards),
               "max_iteration": int(max_iters),
               "partition_method": partition_method,
               "ghost_cap": int(pg.ghost_cap),
               "fwd_ghost_cap": int(pg.fwd_ghost_cap),
               "comm_bytes_per_superstep": int(bytes_per_step),
               "comm_bytes": int(bytes_per_step) * int(max_iters),
               "comm_latency_rounds": comm_latency, **mesh_info(mesh)},
    )
    return ShardedLinkResult(hubs=hub[perm], auths=auth[perm], info=info)


def hits_sharded(graph: CsrGraph, *, num_shards: int = None,
                 max_iters: int = 50, partition_method: str = "random",
                 seed: int = 0, mesh: Optional[Mesh] = None,
                 comm_latency: int = 0, device="cuda") -> ShardedLinkResult:
    """Sharded HITS; single-card semantics (``models/hits.py``) with
    boundary-only exchanges a direction and max normalization over every
    shard."""
    return _link_sharded("hits", graph, num_shards=num_shards,
                         max_iters=max_iters,
                         partition_method=partition_method, seed=seed,
                         mesh=mesh, comm_latency=comm_latency, device=device)


def salsa_sharded(graph: CsrGraph, *, num_shards: int = None,
                  max_iters: int = 50, partition_method: str = "random",
                  seed: int = 0, mesh: Optional[Mesh] = None,
                  comm_latency: int = 0, device="cuda") -> ShardedLinkResult:
    """Sharded SALSA (row-stochastic dual sweeps, ``models/salsa.py``)."""
    return _link_sharded("salsa", graph, num_shards=num_shards,
                         max_iters=max_iters,
                         partition_method=partition_method, seed=seed,
                         mesh=mesh, comm_latency=comm_latency, device=device)
