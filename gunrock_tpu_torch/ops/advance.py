"""Advance operator: frontier neighbor expansion over the forward CSR.

Counterpart of :func:`gunrock_tpu.ops.advance.expand` (reference LB
advance, ``oprtr/advance/kernel.cuh:76-182`` and
``oprtr/edge_map_partitioned/kernel.cuh:185``). The JAX package builds
a fixed-capacity lane array with masked tail lanes; here the output has
exactly ``total`` lanes, one per edge out of the frontier, so every lane
is valid. Lane order is the JAX package's: frontier order, then CSR order
within each frontier vertex's run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..graph.device import DeviceGraph

__all__ = ["ExpandedEdges", "expand"]


@dataclasses.dataclass(frozen=True)
class ExpandedEdges:
    """One (src -> dst) record per output lane of an advance.

    ``rank`` is the frontier slot that produced the lane (the reference's
    ``input_pos``, ``oprtr/advance_base.cuh:37``); ``total`` is the lane
    count (``output_length`` in ``ComputeOutputLength``).
    """

    src: torch.Tensor    # (total,) int32
    dst: Optional[torch.Tensor]  # (total,) int32; None without with_dst
    eid: torch.Tensor    # (total,) int64 edge id into col_indices
    rank: torch.Tensor   # (total,) int64 frontier slot
    total: int


def expand(graph: DeviceGraph, frontier: torch.Tensor, *,
           with_dst: bool = True) -> ExpandedEdges:
    """Push-mode advance (V2V over the forward CSR) of ``frontier``
    (int32 vertex ids). Callers wanting monotonic gathers pass the
    frontier sorted, as the DO-BFS push step does. ``with_dst=False``
    skips the destination gather, for callers that stream it with their
    payload (the SSSP push round, kernel K5)."""
    f = frontier.long()
    start = graph.row_offsets[f].long()
    deg = graph.row_offsets[f + 1].long() - start
    ends = torch.cumsum(deg, 0)
    total = int(ends[-1]) if ends.numel() else 0
    rank = torch.repeat_interleave(
        torch.arange(f.shape[0], device=f.device), deg, output_size=total)
    # eid[j] = start[rank] + (j - seg_start[rank])
    lane = torch.arange(total, device=f.device)
    eid = lane + (start - (ends - deg))[rank]
    return ExpandedEdges(src=frontier[rank],
                         dst=graph.col_indices[eid] if with_dst else None,
                         eid=eid, rank=rank, total=total)
