"""Connected components (Afforest-style sampling + Soman hooking).

Counterpart of :mod:`gunrock_tpu.models.cc` (reference
``gunrock/app/cc/``, whose Hook and PtrJump kernels run over the full edge
list, ``cc_functor.cuh:100-659``), with the JAX package's plan from
Afforest [Sutton/Orr/Pearce, IPDPS'18]:

  1. Neighbour-round linking: hook every vertex to its first
     ``NEIGHBOR_ROUNDS`` (2) CSR neighbours, one pointer-doubling step a
     round.
  2. Giant-component estimate: the modal component id ``c_hat`` of a
     strided sample of ``MODE_SAMPLES`` (2048) vertices, the first maximum.
  3. Remainder hooking: the vertices outside ``c_hat`` with edges hook
     over their own edges (expand) while their edge count fits a rung of
     ``capacity_ladder(e_pad)`` below the top; past it a round hooks over
     every edge (``edge_src`` / ``col_indices``), or, on CUDA graphs
     uploaded ``with_blocked_values`` or past 2^31 edges
     (``DeviceGraph.k3_pulls``), takes the min of the component ids
     over in-edges through kernel K3 (ids below 2^24 are exact in
     float32). One doubling step a round, until a round changes nothing.

Hooks are ``comp = scatter_min(comp, max(cu, cv), min(cu, cv))``; pointer
jumping runs to the fixpoint at the end, so component ids are the minimum
vertex id of each component. The opt-in sweeps route
(``GUNROCK_CC_SWEEPS=1`` on a graph with ``has_pull2``) propagates the
minimum id by min-pull sweeps (kernel K6) instead, in calls of
``GUNROCK_CC_SWEEP_CHUNK`` (6) sweeps. The input must carry symmetric
edges: :func:`cc` symmetrizes a directed :class:`CsrGraph`.

Routing follows the JAX package's, with "the graph's tensors lie on CUDA"
where it reads "the backend is a TPU". The loop runs on the host with two
small host reads a round; ``comp`` is updated in place by the hooks.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from ..enactor import LoopStats, Timer, capacity_ladder, record_iteration
from ..graph.csr import CsrGraph, from_coo
from ..graph.device import DeviceGraph, resolve_device, sync, to_device
from ..ops.advance import expand
from ..ops.pull2 import pull_min_sweeps, pull_vertex_reduce
from ..ops.segment import frontier_from_mask, scatter_min
from ..utils.info import make_info

__all__ = ["cc", "CcResult", "cc_device"]

NEIGHBOR_ROUNDS = 2     # Afforest's k: neighbour-sample linking rounds
MODE_SAMPLES = 2048


@dataclasses.dataclass
class CcResult:
    components: np.ndarray   # (V,) int32 component id (min vertex id)
    num_components: int
    info: dict


def _hook(comp: torch.Tensor, cu: torch.Tensor, cv: torch.Tensor,
          active: Optional[torch.Tensor]) -> torch.Tensor:
    """HookMin (``cc_functor.cuh:235``): attach the larger representative
    under the smaller, in place; the scatter-min is order-independent.
    Returns the lanes that differed."""
    differs = cu != cv if active is None else active & (cu != cv)
    scatter_min(comp, torch.maximum(cu, cv), torch.minimum(cu, cv),
                mask=differs)
    return differs


def _jump(comp: torch.Tensor) -> torch.Tensor:
    """One pointer-doubling step (PtrJump, ``cc_functor.cuh:503``)."""
    return comp[comp.long()]


def _cc_init(graph: DeviceGraph, stats: LoopStats):
    """Phases 1 and 2 (``models/cc.py:160-199``): neighbour-round linking
    and the modal component estimate. Returns ``(comp, c_hat)``."""
    dev = graph.device
    comp = torch.arange(graph.v_pad, dtype=torch.int32, device=dev)
    vmask = comp < graph.num_nodes
    starts = graph.row_offsets[:-1]
    degs = graph.out_degrees()
    for j in range(NEIGHBOR_ROUNDS):
        has = (j < degs) & vmask
        nb = graph.col_indices[(starts + j).clamp(max=graph.e_pad - 1).long()]
        differs = _hook(comp, comp, comp[torch.where(has, nb, 0).long()], has)
        comp = _jump(comp)
        record_iteration(stats, frontier_len=int(differs.sum()),
                         edges=min(graph.num_nodes, 2**31 - 1))
    # Trees are at most two deep after the link rounds: one more doubling
    # lands nearly all of the giant component on one value.
    comp = _jump(comp)
    stride = max(1, graph.num_nodes // MODE_SAMPLES)
    sample = comp[:stride * MODE_SAMPLES:stride]
    counts = (sample[None, :] == sample[:, None]).sum(dim=1)
    return comp, int(sample[torch.argmax(counts)])


def _expand_round(graph: DeviceGraph, comp: torch.Tensor,
                  fmask: torch.Tensor):
    """Remainder hooking over the frontier's own edges
    (``models/cc.py:128-157``). Returns ``(comp, changed, edges)``."""
    frontier, _ = frontier_from_mask(fmask)
    ex = expand(graph, frontier)
    differs = _hook(comp, comp[ex.src.long()], comp[ex.dst.long()], None)
    return _jump(comp), bool(differs.any()), ex.total


def _full_edge_round(graph: DeviceGraph, comp: torch.Tensor, pull: bool):
    """The classic hook over every edge (``models/cc.py:99-125``); with
    ``pull``, the minimum over in-edges through K3. Returns ``(comp,
    changed, edges)``."""
    if pull:
        m = pull_vertex_reduce(comp.float(), graph, op="min", wmode="none")
        m = torch.where(torch.isfinite(m), m, float(graph.v_pad))
        hooked = torch.minimum(comp, m.to(torch.int32))
        changed = bool((hooked != comp).any())
        comp = hooked
    else:
        e = graph.num_edges
        changed = bool(_hook(comp, comp[graph.edge_src[:e].long()],
                             comp[graph.col_indices[:e].long()], None).any())
    return _jump(comp), changed, min(graph.num_edges, 2**31 - 1)


def _cc_rounds(graph: DeviceGraph, comp: torch.Tensor, c_hat: int,
               stats: LoopStats, *, pull: bool, max_iters: int,
               instrument: Optional[list], t0: float) -> torch.Tensor:
    """Phase 3 (``models/cc.py:202-237``): remainder rounds until one
    changes nothing. The branch follows the remainder's edge count ``m_f``
    against ``capacity_ladder(e_pad)[:-1]``, as the JAX package's switch
    does. ``instrument`` gets ``{iteration, ms, frontier, phase}`` a round,
    phase ``expand`` or ``full_edge``."""
    bounds = capacity_ladder(graph.e_pad)[:-1]
    deg = graph.out_degrees()
    vmask = torch.arange(graph.v_pad, device=comp.device) < graph.num_nodes
    changed = True
    while changed and stats.iteration < max_iters:
        fmask = (comp != c_hat) & (deg > 0) & vmask
        n_f, m_f = torch.stack([fmask.sum(),
                                torch.where(fmask, deg, 0).sum()]).tolist()
        if sum(m_f > b for b in bounds) < len(bounds):
            phase = "expand"
            comp, changed, edges = _expand_round(graph, comp, fmask)
        else:
            phase = "full_edge"
            comp, changed, edges = _full_edge_round(graph, comp, pull)
        record_iteration(stats, frontier_len=n_f, edges=edges)
        if instrument is not None:
            sync(comp.device)
            t1 = time.perf_counter()
            instrument.append({"iteration": stats.iteration,
                               "ms": (t1 - t0) * 1e3, "frontier": n_f,
                               "phase": phase})
            t0 = t1
    return comp


def _finalize(graph: DeviceGraph, comp: torch.Tensor):
    """Pointer jumping to the fixpoint; ``(comp, num_components)``
    (``models/cc.py:240-245``)."""
    while True:
        nxt = _jump(comp)
        if torch.equal(nxt, comp):
            break
        comp = nxt
    ids = torch.arange(graph.v_pad, dtype=torch.int32, device=comp.device)
    return comp, int(((ids < graph.num_nodes) & (comp == ids)).sum())


def _cc_sweeps(graph: DeviceGraph):
    """The sweeps route (``models/cc.py:261-310``): min-label propagation
    by min-pull sweeps over the component ids as float32 (kernel K6,
    ``wmode="none"``), in calls of ``GUNROCK_CC_SWEEP_CHUNK`` sweeps, until
    an even sweep changes nothing or ``4V + 16`` sweeps ran."""
    rounds = int(os.environ.get("GUNROCK_CC_SWEEP_CHUNK", "6"))
    ids = torch.arange(graph.v_pad, dtype=torch.int32, device=graph.device)
    vmask = ids < graph.num_nodes
    comp_f = torch.where(vmask, ids.float(), float("inf"))
    changed, total = [], 0
    while True:
        comp_f, chg = pull_min_sweeps(graph, comp_f, sweeps=rounds,
                                      wmode="none")
        chg = chg.tolist()
        changed.extend(chg)
        total += rounds
        if any(c == 0 for c in chg[0::2]) or \
                total >= 4 * graph.num_nodes + 16:
            break
    comp = torch.where(vmask, torch.where(torch.isfinite(comp_f),
                                          comp_f.to(torch.int32), ids), 0)
    stats = LoopStats(iteration=total, nodes_queued=sum(changed),
                      edges_queued=graph.num_edges * total,
                      frontier_trace=changed, route="pull_sweeps")
    return comp, int((vmask & (comp == ids)).sum()), stats


def cc_device(graph: DeviceGraph, *, instrument: Optional[list] = None):
    """Connected components of an uploaded graph with symmetric edges;
    returns ``(comp, num_components, stats)``: the (v_pad,) int32
    component ids (the minimum vertex id of each component) on the
    graph's device, their count, and the
    :class:`~gunrock_tpu_torch.enactor.LoopStats` (``route``
    ``pull_sweeps`` on the sweeps route, ``hook`` otherwise).

    ``instrument``: pass a list to collect one record a remainder round,
    as the JAX package's instrumented mode (``models/cc.py:313-358``);
    it keeps the hooking route."""
    on_cuda = graph.device.type == "cuda"
    use_pallas = on_cuda and graph.k3_pulls
    if (graph.has_pull2 and instrument is None
            and os.environ.get("GUNROCK_CC_SWEEPS", "0") == "1"):
        return _cc_sweeps(graph)
    pull = use_pallas and graph.v_pad < (1 << 24)
    if graph.edge_src is None and not pull:
        raise ValueError("CC needs to_device(with_edge_src=True)")
    t0 = time.perf_counter()
    stats = LoopStats(route="hook")
    comp, c_hat = _cc_init(graph, stats)
    comp = _cc_rounds(graph, comp, c_hat, stats, pull=pull,
                      max_iters=4 * graph.num_nodes + 16,
                      instrument=instrument, t0=t0)
    comp, num_components = _finalize(graph, comp)
    return comp, num_components, stats


def _is_symmetric(graph: CsrGraph) -> bool:
    """Probabilistic exact symmetry check (``models/cc.py:361-383``):
    multiset hash of per-edge NONLINEAR mixes of (src, dst) vs (dst, src),
    O(E) vectorized. The mix (splitmix64-style finalizer) is essential — a
    linear keyed sum collapses to comparing sum(src) vs sum(dst), a
    systematic collision class any sum-balanced asymmetric graph falls
    into. Residual collision odds ~2^-64."""
    if graph.undirected or graph.num_edges == 0:
        return True

    def mix(x: np.ndarray) -> np.ndarray:
        # splitmix64 finalizer, vectorized (public-domain constants).
        x = (x + np.uint64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))

    a = graph.edge_sources().astype(np.uint64)
    b = graph.col_indices.astype(np.uint64)
    with np.errstate(over="ignore"):
        fwd = int(mix(a << np.uint64(32) | b).sum(dtype=np.uint64))
        rev = int(mix(b << np.uint64(32) | a).sum(dtype=np.uint64))
    return fwd == rev


def cc(graph: Union[CsrGraph, DeviceGraph], *, instrumented: bool = False,
       device="cuda") -> CcResult:
    """C API parity: ``gunrock_cc`` (``gunrock.h:227``). The input is
    treated as undirected connectivity: a directed :class:`CsrGraph` is
    symmetrized (components are then weakly connected) and uploaded to
    ``device`` ``with_edge_src``; a :class:`DeviceGraph` runs where it
    lies and must carry symmetric edges. ``instrumented`` collects
    per-round records into ``info["per_iteration"]``."""
    timer = Timer()
    per_iter: Optional[list] = [] if instrumented else None
    num_nodes = graph.num_nodes
    symmetrized = False
    if isinstance(graph, CsrGraph):
        dev = resolve_device(device)
        with timer.time("preprocess_ms"):
            if not _is_symmetric(graph):
                graph = from_coo(graph.num_nodes, graph.edge_sources(),
                                 graph.col_indices, undirected=True,
                                 remove_self_loops=False)
                symmetrized = True
            dgraph = to_device(graph, with_edge_src=True, device=dev)
            sync(dev)
    else:
        dgraph = graph
    with timer.time("process_ms"):
        comp, num_components, stats = cc_device(dgraph, instrument=per_iter)
        sync(dgraph.device)
    info = make_info(
        primitive="connected_components", graph=dgraph, stats=stats,
        timer=timer, edges_visited=int(dgraph.num_edges),
        extra={"num_components": num_components,
               "symmetrized": symmetrized,
               "search_depth": stats.iteration,
               "instrumented": instrumented,
               **({"per_iteration": per_iter} if instrumented else {})},
    )
    return CcResult(components=comp[:num_nodes].cpu().numpy(),
                    num_components=num_components, info=info)
