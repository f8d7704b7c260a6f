"""Triangle counting via segmented intersection.

Counterpart of :mod:`gunrock_tpu.models.tc` (the reference documents
segmented intersection as its fourth operator, for triangle counting,
``doc/programming_model.md``):

  1. orient the undirected graph into a DAG by (degree, id) order, the
     forward/node-iterator trick that bounds the oriented out-degree by
     O(sqrt(E)) (host numpy, as in the JAX package);
  2. cut the DAG's edges into chunks whose wedges fit the budget
     (``GUNROCK_TC_WEDGE_BUDGET``, default 2^26, the JAX package's
     non-TPU value), with the JAX package's bounds edge for edge;
  3. one :func:`~gunrock_tpu_torch.ops.intersection.intersect_counts`
     a chunk; the triangle total is the sum of the per-edge counts (each
     triangle is counted once in the DAG).

The JAX package copies each chunk's edges from the host and reads three
arrays back a chunk. Here the DAG is uploaded once, each chunk is a
slice of it on the device, and the counts stay there until the end. The
total and every count that crosses chunks are int64 (the flagship has
about 1.4e10 wedges).
"""

from __future__ import annotations

import dataclasses
import os
import types
from typing import Optional

import numpy as np
import torch

from ..enactor import Timer
from ..graph.csr import CsrGraph, from_coo
from ..graph.device import resolve_device, round_up, sizet64_rule
from ..ops.intersection import intersect_counts
from ..utils.info import make_info

__all__ = ["tc", "TcResult", "tc_device"]


@dataclasses.dataclass
class TcResult:
    total: int                    # number of triangles in the graph
    edge_counts: np.ndarray       # (dag edges,) int32 per oriented edge
    vertex_counts: np.ndarray     # (V,) int64 triangles at each vertex
    info: dict


def tc_device(row_offsets: torch.Tensor, col_indices: torch.Tensor,
              edge_src: torch.Tensor, chunk_src: torch.Tensor,
              chunk_dst: torch.Tensor):
    """Triangle counts for one edge chunk of an oriented CSR: ``(counts,
    vcounts, triangles, wedges)``, the chunk's per-edge and per-vertex
    counts, their sum (an int64 tensor) and its wedge count."""
    counts, vcounts, wedges = intersect_counts(
        row_offsets, col_indices, edge_src, chunk_src, chunk_dst)
    return counts, vcounts, counts.sum(dtype=torch.int64), wedges


def _orient(g: CsrGraph) -> CsrGraph:
    """Degree-order DAG orientation: keep (u, v) iff u precedes v in
    (degree, id) order. Assumes a symmetrized simple graph."""
    deg = g.out_degrees
    src = g.edge_sources()
    dst = g.col_indices
    lt = (deg[src] < deg[dst]) | ((deg[src] == deg[dst]) & (src < dst))
    return from_coo(g.num_nodes, src[lt], dst[lt],
                    remove_self_loops=False, dedup=False)


@dataclasses.dataclass
class _TcPrep:
    """Host-side oriented-DAG layout and wedge-budget chunking, the JAX
    package's, which its sharded TC (``parallel/tc.py``) also reads."""
    dag: CsrGraph
    row: np.ndarray          # (v_pad+1,) int32, int64 past 2^31 - 2 edges
    col: np.ndarray          # (e_pad,) int32, pad lanes = v_pad
    esrc_pad: np.ndarray     # (e_pad,) int32, pad lanes = v_pad
    esrc_full: np.ndarray    # (num_edges,) int32
    bounds: list             # chunk edge boundaries
    chunk_e: int
    wedge_cap: int
    wedge_total: int
    v_pad: int


def _default_wedge_budget() -> int:
    """Wedges a chunk: ``GUNROCK_TC_WEDGE_BUDGET``, else 2^26 (the JAX
    package's value off the TPU, whose serving path caps it at 2^23)."""
    env = os.environ.get("GUNROCK_TC_WEDGE_BUDGET")
    if env:
        return int(env)
    return 1 << 26


def _tc_prepare(g: CsrGraph, wedge_budget: Optional[int] = None) -> _TcPrep:
    if wedge_budget is None:
        wedge_budget = _default_wedge_budget()
    dag = _orient(g)
    deg = np.diff(dag.row_offsets).astype(np.int64)
    per_edge_wedges = deg[dag.col_indices]
    wedge_total = int(per_edge_wedges.sum())
    v_pad = round_up(max(dag.num_nodes, 1))
    e_pad = round_up(max(dag.num_edges, 1))
    # The DAG's offsets by the sizet64 rule (the JAX package holds them
    # in int32 at every size).
    off_t = np.int64 if sizet64_rule(e_pad, None) else np.int32
    row = np.full(v_pad + 1, dag.num_edges, off_t)
    row[: dag.num_nodes + 1] = dag.row_offsets.astype(off_t)
    col = np.full(e_pad, v_pad, np.int32)
    col[: dag.num_edges] = dag.col_indices
    esrc_full = dag.edge_sources().astype(np.int32)
    # Global per-edge sources for the sort-join probe set; pad lanes
    # pin to v_pad so they can never match a wedge.
    esrc_pad = np.full(e_pad, v_pad, np.int32)
    esrc_pad[: dag.num_edges] = esrc_full
    # Chunk edges so each chunk's wedge count fits the budget.
    wcum = np.concatenate([[0], np.cumsum(per_edge_wedges)])
    bounds = [0]
    while bounds[-1] < dag.num_edges:
        nxt = int(np.searchsorted(
            wcum, wcum[bounds[-1]] + wedge_budget, side="right")) - 1
        bounds.append(min(max(nxt, bounds[-1] + 1), dag.num_edges))
    chunk_e = round_up(max(max(b - a for a, b in
                               zip(bounds, bounds[1:])), 1))
    wedge_cap = round_up(int(max(
        (wcum[b] - wcum[a] for a, b in zip(bounds, bounds[1:])),
        default=1)) or 1)
    return _TcPrep(dag=dag, row=row, col=col, esrc_pad=esrc_pad,
                   esrc_full=esrc_full, bounds=bounds, chunk_e=chunk_e,
                   wedge_cap=wedge_cap, wedge_total=wedge_total,
                   v_pad=v_pad)


def _tc_run(prep: _TcPrep, device: torch.device):
    """Upload the DAG once and count every chunk on ``device``; returns
    ``(edge_counts, vertex_counts, total)`` as device tensors: int32 a
    DAG edge, int64 ``(v_pad,)`` and an int64 scalar."""
    n = prep.dag.num_edges
    row = torch.from_numpy(prep.row).to(device)
    col = torch.from_numpy(prep.col).to(device)
    esrc = torch.from_numpy(prep.esrc_full).to(device)
    edge_counts = torch.zeros(n, dtype=torch.int32, device=device)
    vcounts = torch.zeros(prep.v_pad, dtype=torch.int64, device=device)
    for a, b in zip(prep.bounds, prep.bounds[1:]):
        cc, vc, _, _ = tc_device(row, col, esrc, esrc[a:b], col[a:b])
        edge_counts[a:b] = cc
        vcounts += vc
    return edge_counts, vcounts, edge_counts.sum(dtype=torch.int64)


def tc(graph: CsrGraph, *, undirected_input: bool = True,
       device="cuda") -> TcResult:
    """Count triangles of a host graph on ``device``. Input must be a
    symmetric (undirected) graph: pass ``undirected_input=False`` to
    symmetrize a directed one first."""
    dev = resolve_device(device)
    timer = Timer()
    g = graph
    if not undirected_input:
        g = from_coo(g.num_nodes, g.edge_sources(), g.col_indices,
                     undirected=True)
    with timer.time("preprocess_ms"):
        prep = _tc_prepare(g)
    with timer.time("process_ms"):
        edge_counts, vcounts, total = _tc_run(prep, dev)
        total = int(total)
        edge_counts = edge_counts.cpu().numpy()
        vcounts = vcounts[:g.num_nodes].cpu().numpy()
    info = make_info(
        primitive="tc", timer=timer, edges_visited=prep.wedge_total,
        graph=types.SimpleNamespace(device=dev, num_nodes=g.num_nodes,
                                    num_edges=g.num_edges),
        extra={"num_triangles": total, "wedges_probed": prep.wedge_total,
               "num_chunks": len(prep.bounds) - 1})
    return TcResult(total=total, edge_counts=edge_counts,
                    vertex_counts=vcounts, info=info)
