"""Advance operator: frontier neighbor expansion over the forward CSR or
the CSC, and the full-edge pull reduction.

Counterpart of :mod:`gunrock_tpu.ops.advance` (reference LB advance,
``oprtr/advance/kernel.cuh:76-182`` and
``oprtr/edge_map_partitioned/kernel.cuh:185``). The JAX package builds
a fixed-capacity lane array with masked tail lanes; here the output has
exactly ``total`` lanes, one per edge out of the frontier, so every lane
is valid. Lane order is the JAX package's: frontier order, then CSR order
within each frontier vertex's run.

The JAX signature ``expand(graph, frontier, n, out_cap, sorted_frontier,
with_src, with_dst)`` maps onto this one, so the port has no twin of it:

  * ``frontier[:n]`` is the frontier itself (exact size, no ``n``);
  * ``out_cap`` has nothing to bound: the output is ``total`` lanes, and
    a caller that caps them (the SSSP push rung) slices the lanes;
  * ``sorted_frontier`` selects gather fast paths on the TPU; a caller
    that wants monotonic gathers passes the frontier sorted;
  * ``with_src`` skips a cap-scale cumsum there; here ``src`` is one
    gather of the frontier by ``rank`` and always built;
  * ``with_dst`` is kept: it skips the destination gather for callers
    that stream it with their payload (kernel K5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..enactor import host_read
from ..graph.device import DeviceGraph
from .segment import row_reduce_sorted

__all__ = ["ExpandedEdges", "expand", "expand_inverse", "pull_reduce"]


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


def _expand_csr(offsets: torch.Tensor, indices: torch.Tensor,
                frontier: torch.Tensor, with_dst: bool) -> ExpandedEdges:
    f = frontier.long()
    start = offsets[f].long()
    deg = offsets[f + 1].long() - start
    ends = torch.cumsum(deg, 0)
    total = 0
    if ends.numel():
        total = int(ends[-1])
        host_read()
    rank = torch.repeat_interleave(
        torch.arange(f.shape[0], device=f.device), deg, output_size=total)
    # eid[j] = start[rank] + (j - seg_start[rank])
    lane = torch.arange(total, device=f.device)
    eid = lane + (start - (ends - deg))[rank]
    return ExpandedEdges(src=frontier[rank],
                         dst=indices[eid] if with_dst else None,
                         eid=eid, rank=rank, total=total)


def expand(graph: DeviceGraph, frontier: torch.Tensor, *,
           with_dst: bool = True) -> ExpandedEdges:
    """Push-mode advance (V2V over the forward CSR) of ``frontier``
    (int32 vertex ids). Callers wanting monotonic gathers pass the
    frontier sorted, as the DO-BFS push step does. ``with_dst=False``
    skips the destination gather, for callers that stream it with their
    payload (the SSSP push round, kernel K5)."""
    return _expand_csr(graph.row_offsets, graph.col_indices, frontier,
                       with_dst)


def expand_inverse(graph: DeviceGraph, frontier: torch.Tensor
                   ) -> ExpandedEdges:
    """Advance over the inverse CSR: expands the *in*-neighbors of the
    frontier (reference backward advance over
    ``column_offsets/row_indices``, ``oprtr/edge_map_backward/``). ``dst``
    lanes are in-neighbor sources, ``eid`` indexes the CSC's edge slots."""
    if not graph.has_csc:
        raise ValueError("expand_inverse needs to_device(with_csc=True)")
    return _expand_csr(graph.csc_offsets, graph.csc_indices, frontier, True)


def pull_reduce(graph: DeviceGraph, edge_vals: torch.Tensor, *,
                op: str = "sum") -> torch.Tensor:
    """Full-edge pull: reduce per-in-edge values into each destination.

    ``edge_vals`` is indexed by CSC edge slot (the order of
    ``graph.csc_indices``, ``e_pad`` long); returns a ``(v_pad,)``
    reduction with ``op`` ``sum``, ``max`` or ``min``. The segments are
    those of ``csc_edge_dst``, read here from ``csc_offsets`` (the same
    runs), so pad slots join no vertex. Empty segments hold the JAX
    package's identities (``jax.ops.segment_*``): 0 for ``sum``, -inf /
    +inf for float ``max`` / ``min`` and the integer type's bounds for
    ints. Sums accumulate in float64 (:func:`row_reduce_sorted`), so they
    agree with the JAX package's float32 sums to rounding."""
    if not graph.has_csc:
        raise ValueError("pull_reduce needs to_device(with_csc=True)")
    return row_reduce_sorted(edge_vals, graph.csc_offsets, op=op)
