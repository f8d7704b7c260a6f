"""Sharded WTF ("Who To Follow"): the three-phase chain over the shard
mesh.

Counterpart of :mod:`gunrock_tpu.parallel.wtf` (the reference's WTF
chain, ``wtf_enactor.cuh:236-565``; single-card ``models/wtf.py``):

  1. personalized PageRank: a CSC-direction sweep an iteration with a
     boundary-only exchange, until the L1 change over every shard falls
     to ``threshold`` or ``max_iters``;
  2. circle of trust (CoT): the top ``min(1000, V)`` vertices by PPR,
     ties to the lower original id. The JAX package selects each
     shard's top candidates and then the global top of those; a global
     top-k vertex is always among its shard's top k, so selecting over
     every shard at once by the same two keys gives the same set;
  3. personalized SALSA over the CoT's out-edges: dual sweeps (CSC for
     the refscores, forward for the hub ranks), the CoT a mask on the
     edge sources, both directions boundary-only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..enactor import Timer
from ..graph.csr import CsrGraph
from ..graph.device import sync
from ..models.wtf import COT_SIZE
from ..utils.info import make_info
from .comm import ghost_exchange
from .mesh import Mesh, info_graph, make_mesh, mesh_info, mesh_of
from .partition import PartitionedGraph, flat_rows, for_mesh, partition

__all__ = ["wtf_sharded", "ShardedWtfResult"]


@dataclasses.dataclass
class ShardedWtfResult:
    node_ids: np.ndarray    # recommended vertices, best first
    scores: np.ndarray      # their refscores
    ppr_ranks: np.ndarray   # (V,) personalized PageRank from phase 1
    info: dict


def wtf_sharded_device(pg: PartitionedGraph, src_new: int, *,
                       vmask_new: torch.Tensor, orig_id: torch.Tensor,
                       delta: float, alpha: float, cot_cap: int,
                       max_iters: int, threshold: float,
                       mesh: Optional[Mesh] = None, comm_latency: int = 0):
    """The chain on a partition made ``with_csc`` and ``with_ghosts``;
    ``orig_id`` gives each relabeled vertex its original id (any value at
    pad slots). Returns ``(ppr, refscore, ppr_iters)``, ``(p*S,)``
    float32 on the mesh's device (all of them on every rank of a
    process-group mesh, which also selects the CoT from every shard's
    PPR, gathered)."""
    mesh = mesh_of(pg, mesh)
    p, S, n = pg.num_shards, pg.shard_size, pg.num_nodes
    L, dev = pg.local_shards, pg.device
    bwd = flat_rows(pg.csc_offsets, pg.csc_local, S + p * pg.ghost_cap)
    fwd = flat_rows(pg.row_offsets, pg.col_local, S + p * pg.fwd_ghost_cap)
    vmask_all = vmask_new.view(p, S)
    vmask = mesh.local(vmask_all)
    out_deg = torch.diff(pg.row_offsets, dim=1).to(torch.float32)
    inv_out = torch.where(out_deg > 0, 1.0 / out_deg.clamp(min=1.0), 0.0)
    is_src = torch.zeros(p * S, dtype=torch.float32, device=dev)
    is_src[int(src_new)] = 1.0
    is_src = mesh.local(is_src.view(p, S))

    def csc_sweep(contrib):
        return bwd.reduce(ghost_exchange(contrib, pg.ghost_send_idx,
                                         comm_latency=comm_latency,
                                         mesh=mesh), "sum")

    def fwd_sweep(contrib):
        return fwd.reduce(ghost_exchange(contrib, pg.fwd_ghost_send_idx,
                                         comm_latency=comm_latency,
                                         mesh=mesh), "sum")

    # phase 1: personalized PageRank (wtf_functor.cuh:91,118)
    rank = torch.where(vmask, 1.0 / n, 0.0).to(torch.float32)
    diff, it = float("inf"), 0
    thresh = np.float32(threshold)
    while diff > thresh and it < max_iters:
        new_rank = delta * csc_sweep(rank * inv_out) + (1.0 - delta) * is_src
        new_rank = torch.where(vmask, new_rank, 0.0)
        # the L1 change of each shard, summed over shards (a psum)
        diff = np.float32(float(mesh.psum((new_rank - rank).abs()
                                          .sum(dim=1)).sum()))
        rank = new_rank
        it += 1
    ppr = mesh.all_gather(rank)
    # phase 2: the CoT, by (-ppr, original id) over every real vertex
    key = torch.where(vmask_all, -ppr, 2.0).reshape(-1)
    oid = torch.where(vmask_all, orig_id.view(p, S), 2**30).reshape(-1)
    by_id = torch.sort(oid, stable=True).indices
    top = by_id[torch.sort(key[by_id], stable=True).indices][:cot_cap]
    top = top[key[top] < 2.0]
    cot_f = torch.zeros(p * S, dtype=torch.float32, device=dev)
    cot_f[top] = 1.0
    cot_f = mesh.local(cot_f.view(p, S))
    # CoT in-degrees (CotFunctor atomicAdd, wtf_functor.cuh:219)
    cot_indeg = csc_sweep(cot_f)
    inv_cot_in = torch.where(cot_indeg > 0,
                             1.0 / cot_indeg.clamp(min=1.0), 0.0)
    # phase 3: personalized SALSA over CoT out-edges
    # (wtf_enactor.cuh:350-365); cot_f masks the edge sources.
    rank = is_src
    refscore = torch.zeros((L, S), dtype=torch.float32, device=dev)
    for _ in range(int(1.0 / alpha)):  # reference wtf_enactor.cuh:464
        refscore = csc_sweep(rank * inv_out * cot_f)
        hub = fwd_sweep(refscore * inv_cot_in)
        rank = cot_f * (is_src * alpha * inv_out * out_deg
                        + (1.0 - alpha) * hub)
    refscore = torch.where(vmask, refscore, 0.0)
    return ppr.reshape(-1), mesh.all_gather(refscore).reshape(-1), it


def wtf_sharded(graph: CsrGraph, src: int = 0, *, delta: float = 0.85,
                alpha: float = 0.2, max_iters: int = 50,
                threshold: float = 1e-6, num_shards: int = None,
                partition_method: str = "random", seed: int = 0,
                mesh: Optional[Mesh] = None, comm_latency: int = 0,
                device="cuda") -> ShardedWtfResult:
    """Sharded WTF; single-card semantics (``models/wtf.py``) with
    boundary-only exchanges in every phase."""
    timer = Timer()
    if not 0 <= int(src) < graph.num_nodes:
        raise ValueError(f"src {src} out of range [0, {graph.num_nodes})")
    if mesh is None:
        mesh = make_mesh(num_shards, device=device)
    num_shards = mesh.num_shards
    cot_cap = min(COT_SIZE, graph.num_nodes)
    dev = mesh.device

    with timer.time("partition_ms"):
        pg, perm = partition(graph, num_shards, method=partition_method,
                             seed=seed, with_csc=True, with_ghosts=True,
                             device=dev)
        pg = for_mesh(pg, mesh)
        vmask_new = np.zeros(pg.v_global_pad, bool)
        vmask_new[perm] = True
        orig_id = np.full(pg.v_global_pad, 2**30, np.int32)
        orig_id[perm] = np.arange(graph.num_nodes, dtype=np.int32)
        sync(dev)

    with timer.time("process_ms"):
        ppr, refscore, ppr_iters = wtf_sharded_device(
            pg, int(perm[int(src)]),
            vmask_new=torch.from_numpy(vmask_new).to(dev),
            orig_id=torch.from_numpy(orig_id).to(dev), delta=float(delta),
            alpha=float(alpha), cot_cap=cot_cap, max_iters=max_iters,
            threshold=threshold, mesh=mesh, comm_latency=comm_latency)
        ppr, refscore = ppr.cpu().numpy(), refscore.cpu().numpy()

    ppr_out = ppr[perm]
    ref_out = refscore[perm]
    # Final ranking: score descending, original id ascending (the
    # single-card top-k's tie order).
    order = np.lexsort((np.arange(graph.num_nodes), -ref_out))[:cot_cap]
    bytes_per_step = num_shards * (num_shards - 1) * \
        (pg.ghost_cap + pg.fwd_ghost_cap) * 4
    info = make_info(
        primitive="wtf_sharded", graph=info_graph(graph, mesh), timer=timer,
        edges_visited=graph.num_edges * int(ppr_iters),
        extra={"src": int(src), "delta": delta, "alpha": alpha,
               "ppr_iterations": int(ppr_iters),
               "num_shards": int(num_shards),
               "partition_method": partition_method,
               "ghost_cap": int(pg.ghost_cap),
               "fwd_ghost_cap": int(pg.fwd_ghost_cap),
               "comm_bytes_per_superstep": int(bytes_per_step),
               "comm_latency_rounds": comm_latency, **mesh_info(mesh)},
    )
    return ShardedWtfResult(node_ids=order.astype(np.int32),
                            scores=ref_out[order], ppr_ranks=ppr_out,
                            info=info)
