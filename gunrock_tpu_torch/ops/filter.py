"""Filter operator: cull duplicates / invalid items, compact the frontier.

Counterpart of :mod:`gunrock_tpu.ops.filter` (the reference's filter
kernels, ``oprtr/filter/kernel.cuh:440``, dispatching CULL / SIMPLIFIED /
COMPACTED_CULL / BY_PASS) with two deterministic dataflows:

  * CULL    -> claim dedup (:func:`~.segment.dedup_winners`, the highest
    lane wins) + predicate + compaction;
  * BY_PASS -> predicate only, no compaction.

As the port's :func:`~.segment.compact`, :func:`cull_filter` returns an
exact-size frontier, so it takes neither the JAX package's ``cap`` nor
its ``fill``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .segment import compact, dedup_winners

__all__ = ["cull_filter", "bypass_filter"]


def cull_filter(
    items: torch.Tensor,
    mask: torch.Tensor,
    *,
    size: int,
    cond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    dedup: bool = True,
) -> tuple[torch.Tensor, int, torch.Tensor]:
    """Dedup + predicate + compact candidate vertices into a new frontier.

    ``items``: candidate vertex ids (one per advance output lane);
    ``mask``: active lanes; ``size``: vertex-space size for the claim
    table; ``cond``: a vectorized CondFilter taking the item vector and
    returning a keep mask. Returns ``(frontier, length, keep)``: the
    surviving items in lane order (exactly ``length`` of them), and
    ``keep``, the surviving lanes in advance-output order, for side
    updates on exactly those lanes."""
    keep = mask
    if cond is not None:
        keep = keep & cond(items)
    if dedup:
        keep = dedup_winners(items, keep, size)
    frontier, length = compact(items, keep)
    return frontier, length, keep


def bypass_filter(
    items: torch.Tensor,
    mask: torch.Tensor,
    *,
    cond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """BY_PASS filter (``oprtr/bypass_filter/``): apply the predicate,
    keep the frontier uncompacted; returns the updated mask."""
    if cond is None:
        return mask
    return mask & cond(items)
