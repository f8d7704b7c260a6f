"""Sample/template primitive: the skeleton for authoring new primitives.

Counterpart of :mod:`gunrock_tpu.models.sample`, which mirrors the
reference's ``app/sample`` skeleton and the "Creating a New Graph
Primitive" recipe (``doc/programming_model.md``): define per-vertex
state, express one superstep as advance -> functor -> filter, and drive
it with a loop. This example computes per-vertex hop distance (a minimal
BFS), annotated step by step. The JAX package drives the supersteps with
a ``lax.while_loop`` on the device; here the loop runs on the host and
reads the frontier's length once a superstep. Copy this file to start a
new primitive.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..graph.csr import CsrGraph
from ..graph.device import DeviceGraph, resolve_device, to_device
from ..ops.advance import expand
from ..ops.segment import compact, dedup_winners, scatter_set

__all__ = ["sample"]


def _sample_loop(graph: DeviceGraph, src: int) -> torch.Tensor:
    # 1. Problem state: one entry per vertex, padded to v_pad (the
    #    reference's DataSlice, app/sample/sample_problem.cuh), and the
    #    frontier, an exact-size int32 queue.
    labels = torch.full((graph.v_pad,), -1, dtype=torch.int32,
                        device=graph.device)
    labels[src] = 0
    frontier = torch.tensor([src], dtype=torch.int32, device=graph.device)
    iteration = 0
    while frontier.shape[0] > 0:
        # 2. Advance: expand the frontier's neighbors (one lane per edge).
        ex = expand(graph, frontier)
        # 3. Compute (the functor): CondEdge == "destination unvisited".
        cond_edge = labels[ex.dst.long()] == -1
        # 4. Filter: exact dedup so each vertex enters the frontier once.
        keep = dedup_winners(ex.dst, cond_edge, graph.v_pad)
        # 5. ApplyEdge: commit the new labels for surviving lanes.
        scatter_set(labels, ex.dst, iteration + 1, mask=keep)
        # 6. Compact the survivors into the next frontier.
        frontier, _ = compact(ex.dst, keep)
        iteration += 1
    return labels


def sample(graph: Union[CsrGraph, DeviceGraph], src: int = 0, *,
           device="cuda") -> np.ndarray:
    """Run the template primitive; returns hop distances (int32, -1
    where unreached). A :class:`CsrGraph` is uploaded to ``device``; a
    :class:`DeviceGraph` runs where it lies."""
    if isinstance(graph, CsrGraph):
        dgraph = to_device(graph, device=resolve_device(device))
    else:
        dgraph = graph
    if not 0 <= src < dgraph.num_nodes:
        raise ValueError(f"src {src} out of range [0, {dgraph.num_nodes})")
    labels = _sample_loop(dgraph, int(src))
    return labels[:dgraph.num_nodes].cpu().numpy()
