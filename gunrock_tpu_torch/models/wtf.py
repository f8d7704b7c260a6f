"""WTF — "Who To Follow" (Twitter recommendation).

Counterpart of :mod:`gunrock_tpu.models.wtf` (reference
``gunrock/app/wtf/{wtf_problem,wtf_enactor,wtf_functor}.cuh``), three
phases as the reference chains them (``wtf_enactor.cuh:236-565``):

  1. **Personalized PageRank** from ``src``:
     ``rank' = delta * (sum rank[u]/outdeg(u)) + (1-delta)*[v == src]``,
     iterated while the float32 sum of ``|rank' - rank|`` exceeds
     ``threshold`` and fewer than ``max_iters`` iterations ran. The pull
     goes through kernel K3 (``ops.pull2.pull_reduce2``; its plain
     version on CPU tensors), once an iteration, on every graph: the JAX
     package's ``pull_vertex_reduce`` (blocked-values graphs) and
     ``row_reduce_sorted`` (the others) both compute this function. The
     JAX package runs the loop as a ``lax.while_loop``; here it runs on
     the host and reads the diff once an iteration.
  2. **Circle of trust** (CoT): the top ``min(1000, V)`` vertices by PPR
     rank, ties by ascending id (``jax.lax.top_k``'s order; see
     :func:`gunrock_tpu_torch.models.topk.top_k`).
  3. **Personalized SALSA** for ``int(1/alpha)`` iterations over the
     edges leaving the CoT (``wtf_enactor.cuh:464``)::

       refscore'[d] = sum rank[s]/outdeg(s)                   (AUTH, :365)
       rank'[s]     = sum [s==src]*alpha/outdeg(s)
                      + (1-alpha)*refscore[d]/cot_indeg(d)    (HUB, :350)

     The CoT's out-edges come from the exact-size ``expand`` in CoT
     order, so the JAX package's capacity ladder, and the host read of
     the CoT's degree that picks its rung, have no counterpart.

Output: the top ``min(1000, V)`` vertices by final refscore, best first,
ties by ascending id.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from ..enactor import Timer
from ..graph.csr import CsrGraph
from ..graph.device import DeviceGraph, resolve_device, sync, to_device
from ..ops.advance import expand
from ..ops.pull2 import pull_reduce2
from ..ops.segment import scatter_add
from ..utils.info import make_info
from .topk import top_k

__all__ = ["wtf", "WtfResult", "wtf_device", "COT_SIZE"]

COT_SIZE = 1000  # reference wtf_enactor.cuh:398


@dataclasses.dataclass
class WtfResult:
    node_ids: np.ndarray    # recommended vertices, best first
    scores: np.ndarray      # their refscores
    ppr_ranks: np.ndarray   # (V,) personalized PageRank from phase 1
    info: dict


def _ppr(graph: DeviceGraph, src: int, *, delta: float, max_iters: int,
         threshold: float):
    """Phase 1 (``models/wtf.py:54-84``). Returns (rank, iterations)."""
    dev = graph.device
    lane = torch.arange(graph.v_pad, device=dev)
    vmask = lane < graph.num_nodes
    inv_out = graph.inv_outdeg
    teleport = (lane == src).float() * (1.0 - delta)
    rank = torch.where(vmask, 1.0 / graph.num_nodes, 0.0).float()
    # The JAX package compares a float32 diff with a float32 threshold.
    threshold32 = float(np.float32(threshold))
    diff, it = float("inf"), 0
    while diff > threshold32 and it < max_iters:
        incoming = pull_reduce2(rank * inv_out, graph, op="sum")
        new_rank = torch.where(vmask, delta * incoming + teleport, 0.0)
        diff = float((new_rank - rank).abs().sum())
        rank, it = new_rank, it + 1
    return rank, it


def _salsa(graph: DeviceGraph, src: int, cot: torch.Tensor, *,
           alpha: float) -> torch.Tensor:
    """Phase 3 (``models/wtf.py:97-130``) over the out-edges of ``cot``.
    Returns the refscores, (v_pad,) float32."""
    v_pad, dev = graph.v_pad, graph.device
    inv_out = graph.inv_outdeg
    ex = expand(graph, cot)
    esrc, edst = ex.src, ex.dst
    zeros = torch.zeros(v_pad, dtype=torch.float32, device=dev)
    cot_indeg = scatter_add(zeros.clone(), edst, torch.ones(
        ex.total, dtype=torch.float32, device=dev))
    inv_cot_in = torch.where(cot_indeg > 0, 1.0 / cot_indeg.clamp(min=1.0),
                             0.0)
    from_src = torch.where(esrc == src, alpha * inv_out[esrc.long()], 0.0)
    rank = zeros.clone()
    rank[src] = 1.0
    ref = zeros
    for _ in range(int(1.0 / alpha)):
        ref = scatter_add(zeros.clone(), edst, (rank * inv_out)[esrc.long()])
        hub_val = from_src + (1.0 - alpha) * (ref * inv_cot_in)[edst.long()]
        rank = scatter_add(zeros.clone(), esrc, hub_val)
    return ref


def wtf_device(graph: DeviceGraph, src: int, *, delta: float = 0.85,
               alpha: float = 0.2, max_iters: int = 50,
               threshold: float = 1e-6):
    """Returns ``(node_ids, scores, ppr, ppr_iters)``: the top
    ``min(1000, V)`` vertices by refscore (int32) and their scores, the
    (v_pad,) float32 PPR ranks, and the PPR iteration count."""
    if not graph.has_csc:
        raise ValueError("WTF needs to_device(with_csc=True)")
    src = int(src)
    cot_cap = min(COT_SIZE, graph.num_nodes)
    vmask = torch.arange(graph.v_pad, device=graph.device) < graph.num_nodes
    ppr, ppr_iters = _ppr(graph, src, delta=delta, max_iters=max_iters,
                          threshold=threshold)
    _, cot = top_k(torch.where(vmask, ppr, -1.0), cot_cap)
    refscore = _salsa(graph, src, cot, alpha=alpha)
    scores, node_ids = top_k(torch.where(vmask, refscore, -1.0), cot_cap)
    return node_ids, scores, ppr, ppr_iters


def wtf(graph: Union[CsrGraph, DeviceGraph], src: int = 0, *,
        delta: float = 0.85, alpha: float = 0.2, max_iters: int = 50,
        threshold: float = 1e-6, device="cuda") -> WtfResult:
    """A :class:`CsrGraph` is uploaded ``with_csc=True`` to ``device``; a
    :class:`DeviceGraph` runs where it lies."""
    timer = Timer()
    if not 0 <= int(src) < graph.num_nodes:
        raise ValueError(f"src {src} out of range [0, {graph.num_nodes})")
    if isinstance(graph, CsrGraph):
        dev = resolve_device(device)
        with timer.time("preprocess_ms"):
            dgraph = to_device(graph, with_csc=True, device=dev)
            sync(dev)
    else:
        dgraph = graph
    with timer.time("process_ms"):
        node_ids, scores, ppr, ppr_iters = wtf_device(
            dgraph, src, delta=delta, alpha=alpha, max_iters=max_iters,
            threshold=threshold)
        sync(dgraph.device)
    info = make_info(
        primitive="wtf", graph=dgraph, timer=timer,
        edges_visited=dgraph.num_edges * ppr_iters,
        extra={"src": int(src), "delta": delta, "alpha": alpha,
               "ppr_iterations": ppr_iters},
    )
    return WtfResult(node_ids=node_ids.cpu().numpy(),
                     scores=scores.cpu().numpy(),
                     ppr_ranks=ppr.cpu().numpy()[:graph.num_nodes],
                     info=info)
