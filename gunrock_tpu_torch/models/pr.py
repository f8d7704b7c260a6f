"""PageRank.

Counterpart of :mod:`gunrock_tpu.models.pr` (reference
``gunrock/app/pr/``): a pull over the CSC per iteration, converging when
no vertex's rank moved more than ``threshold``
(``pr_problem.cuh:83-93``), with the reference's ``normalized`` toggle::

    normalized:   rank' = (1-d)/V + d * sum rank[u]/deg[u]
    plain:        rank' = (1-d)   + d * sum rank[u]/deg[u]

and ``compensate=True`` to redistribute dangling-vertex mass.

Two routes, chosen by the JAX package's default rules; on CUDA tensors
both run the kernels, on CPU tensors their plain versions:

  * The power route, on graphs for which the JAX package holds its
    pull-v2 layout (``has_pull2``) unless ``compensate`` or
    ``instrument``: chunks of iterations in one call each of kernel K4
    (``ops.pull2.pull_power_iters``), one host read of the change counts
    per chunk. It is the faster route on the H100 (``PERF.md``), so no
    option turns it off.
  * The loop route: one iteration at a time, the pull through kernel K3
    (``ops.pull2.pull_reduce2``). The JAX package compiles this loop into
    a ``lax.while_loop``; here it runs on the host and reads the change
    count once an iteration.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from ..enactor import LoopStats, Timer, record_iteration
from ..graph.csr import CsrGraph
from ..graph.device import DeviceGraph, resolve_device, sync, to_device
from ..ops.pull2 import pull_power_iters, pull_reduce2
from ..utils.info import make_info

__all__ = ["pagerank", "PageRankResult", "pagerank_device"]

# Power-route rounds between host reads at threshold > 0: the JAX
# package's default GUNROCK_PR_CHUNK, so the iteration counts are its own.
POWER_CHUNK = 10


@dataclasses.dataclass
class PageRankResult:
    ranks: np.ndarray        # (V,) float32
    node_ids: np.ndarray     # (V,) int32 vertices sorted by descending rank
    info: dict


def _order(rank: torch.Tensor) -> torch.Tensor:
    """Vertices by descending rank, ties by ascending id (the JAX
    package's stable ``argsort(-rank)``)."""
    return torch.sort(-rank, stable=True).indices.to(torch.int32)


def _pr_loop(graph: DeviceGraph, *, damping: float, threshold: float,
             max_iters: int, normalized: bool, compensate: bool,
             instrument: Optional[list]):
    """The JAX package's ``_pr_loop`` (``models/pr.py:58-105``)."""
    dev = graph.device
    n = graph.num_nodes
    vmask = torch.arange(graph.v_pad, device=dev) < n
    deg = graph.out_degrees().float()
    inv_deg = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0), 0.0)
    rank = torch.where(vmask, (1.0 / n) if normalized else 1.0 - damping,
                       0.0).float()
    reset = torch.tensor((1.0 - damping) / n if normalized
                         else 1.0 - damping, dtype=torch.float32, device=dev)
    d32 = torch.tensor(damping, dtype=torch.float32, device=dev)
    stats = LoopStats()
    t0 = time.perf_counter()
    while stats.iteration < max_iters:
        incoming = pull_reduce2(rank * inv_deg, graph, op="sum")
        new_rank = reset + d32 * incoming
        if normalized and compensate:
            # Redistribute dangling-vertex mass uniformly.
            dangling = torch.where(vmask & (deg == 0), rank, 0.0).sum()
            new_rank = new_rank + d32 * dangling / n
        new_rank = torch.where(vmask, new_rank, 0.0)
        num_updated = int((vmask & ((new_rank - rank).abs() > threshold))
                          .sum())
        record_iteration(stats, frontier_len=num_updated,
                         edges=graph.num_edges)
        rank = new_rank
        if instrument is not None:
            t1 = time.perf_counter()
            instrument.append({"iteration": stats.iteration,
                               "ms": (t1 - t0) * 1e3,
                               "updated": num_updated})
            t0 = t1
        if num_updated == 0:
            break
    return rank, stats


def _pagerank_power(graph: DeviceGraph, *, damping: float, threshold: float,
                    max_iters: int, normalized: bool):
    """The JAX package's ``_pagerank_power`` (``models/pr.py:139-176``):
    all ``max_iters`` rounds in one K4 call at ``threshold <= 0``, else
    chunks of :data:`POWER_CHUNK` rounds, stopping after a chunk whose
    last round changed no vertex."""
    n = graph.num_nodes
    reset = (1.0 - damping) / n if normalized else 1.0 - damping
    init0 = (1.0 / n) if normalized else 1.0 - damping
    chunk = max_iters if threshold <= 0 else POWER_CHUNK
    vmask = torch.arange(graph.v_pad, device=graph.device) < n
    rank = torch.where(vmask, init0, 0.0).float()
    stats = LoopStats()
    while True:
        rank, changed = pull_power_iters(
            graph, rank, iters=min(chunk, max_iters - stats.iteration),
            damping=damping, reset=reset, threshold=threshold)
        for c in changed.tolist():
            record_iteration(stats, frontier_len=c, edges=graph.num_edges)
        if stats.frontier_trace[-1] == 0 or stats.iteration >= max_iters:
            break
    return rank, stats


def pagerank_device(graph: DeviceGraph, *, damping: float = 0.85,
                    threshold: float = 1e-6, max_iters: int = 50,
                    normalized: bool = True, compensate: bool = False,
                    instrument: Optional[list] = None):
    """Returns ``(rank, order, stats)``: (v_pad,) float32 ranks, the
    vertices (padding included) by descending rank, and the
    :class:`LoopStats` whose ``frontier_trace`` holds each iteration's
    count of moved vertices. ``instrument``: pass a list to collect
    per-iteration wall/updated records (reference ``--instrumented``);
    it forces the loop route, as in the JAX package."""
    if not graph.has_csc:
        raise ValueError("PageRank needs to_device(with_csc=True)")
    if max_iters < 1:
        raise ValueError("max_iters must be at least 1")
    if graph.has_pull2 and not compensate and instrument is None:
        rank, stats = _pagerank_power(graph, damping=damping,
                                      threshold=threshold,
                                      max_iters=max_iters,
                                      normalized=normalized)
    else:
        rank, stats = _pr_loop(graph, damping=damping, threshold=threshold,
                               max_iters=max_iters, normalized=normalized,
                               compensate=compensate,
                               instrument=instrument)
    return rank, _order(rank), stats


def pagerank(graph: Union[CsrGraph, DeviceGraph], *, damping: float = 0.85,
             threshold: float = 1e-6, max_iters: int = 50,
             normalized: bool = True, compensate: bool = False,
             instrumented: bool = False, device="cuda") -> PageRankResult:
    """C API parity: ``gunrock_pagerank`` (``gunrock.h:311``). A
    :class:`CsrGraph` is uploaded ``with_csc=True`` only, as the JAX
    package does, so it takes the loop route (K3 on CUDA); a
    :class:`DeviceGraph` built ``with_blocked_values=True`` takes the
    power route (K4) where ``has_pull2``. ``device`` applies to a
    :class:`CsrGraph`; a :class:`DeviceGraph` runs where it lies."""
    timer = Timer()
    per_iter: Optional[list] = [] if instrumented else None
    num_nodes = graph.num_nodes
    if isinstance(graph, CsrGraph):
        dev = resolve_device(device)
        with timer.time("preprocess_ms"):
            dgraph = to_device(graph, with_csc=True, device=dev)
            sync(dev)
    else:
        dgraph = graph
    with timer.time("process_ms"):
        rank, order, stats = pagerank_device(
            dgraph, damping=damping, threshold=threshold,
            max_iters=max_iters, normalized=normalized,
            compensate=compensate, instrument=per_iter)
        sync(dgraph.device)
    ranks_np = rank.cpu().numpy()[:num_nodes]
    order_np = order.cpu().numpy()
    order_np = order_np[order_np < num_nodes][:num_nodes]
    iters = stats.iteration
    info = make_info(
        primitive="pagerank", graph=dgraph, stats=stats, timer=timer,
        edges_visited=int(dgraph.num_edges) * iters,
        extra={"damping": damping, "threshold": threshold,
               "max_iteration": max_iters, "normalized": normalized,
               "instrumented": instrumented,
               "search_depth": iters,
               **({"per_iteration": per_iter} if instrumented else {})},
    )
    return PageRankResult(ranks=ranks_np, node_ids=order_np, info=info)
