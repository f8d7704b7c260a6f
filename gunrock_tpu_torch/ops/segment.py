"""Scatters, claim dedup and stream compaction on torch tensors.

Counterpart of :mod:`gunrock_tpu.ops.segment`. Two differences follow
from PyTorch's idiom:

  * The scatters update ``dest`` IN PLACE and return it: the traversal
    state (labels, preds) is V-scale, and a functional update would copy
    it on every level.
  * Outputs are exact-size, so :func:`compact` and
    :func:`frontier_from_mask` take no capacity and cannot overflow.

Winner rules are the JAX package's. :func:`dedup_winners` keeps the
HIGHEST lane per index (``ops/segment.py:66-79``) through an ``amax``
claim, which is order-independent and so deterministic on CUDA.
:func:`scatter_set` with duplicate indices is only deterministic when
every duplicate writes the same value; ``index_put_`` on CUDA gives no
order (the JAX package's scatter is last-wins).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..enactor import host_read

__all__ = ["scatter_min", "scatter_max", "scatter_add", "scatter_set",
           "dedup_winners", "compact", "frontier_from_mask",
           "mask_from_frontier", "row_reduce_sorted"]


def _select(idx: torch.Tensor, vals, mask: Optional[torch.Tensor]):
    if not torch.is_tensor(vals):
        vals = torch.full(idx.shape, vals, dtype=torch.int32,
                          device=idx.device)
    vals = vals.expand(idx.shape)
    if mask is not None:
        idx, vals = idx[mask], vals[mask]
        host_read(2)
    return idx.long(), vals


def _reduce(dest: torch.Tensor, idx, vals, mask, op: str) -> torch.Tensor:
    i, v = _select(idx, vals, mask)
    return dest.scatter_reduce_(0, i, v.to(dest.dtype), op)


def scatter_min(dest: torch.Tensor, idx: torch.Tensor, vals,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _reduce(dest, idx, vals, mask, "amin")


def scatter_max(dest: torch.Tensor, idx: torch.Tensor, vals,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _reduce(dest, idx, vals, mask, "amax")


def scatter_add(dest: torch.Tensor, idx: torch.Tensor, vals,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _reduce(dest, idx, vals, mask, "sum")


def scatter_set(dest: torch.Tensor, idx: torch.Tensor,
                vals: Union[torch.Tensor, int],
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dest[idx[mask]] = vals[mask]`` in place. Duplicate indices must
    carry equal values, or the winner is unspecified on CUDA: run
    :func:`dedup_winners` first when the winner matters."""
    i, v = _select(idx, vals, mask)
    dest[i] = v.to(dest.dtype)
    return dest


def dedup_winners(idx: torch.Tensor, mask: torch.Tensor,
                  size: int) -> torch.Tensor:
    """Pick one winner lane per distinct index; returns the winner mask.

    Every active lane claims its index with its lane id under ``amax``;
    a lane survives iff it reads its own id back, so the highest lane
    wins (the reference's CULL-filter duplicate culling,
    ``oprtr/cull_filter/cta.cuh:351-379``, made deterministic).
    """
    # Lane ids in int32 while they fit (every real push level), else int64.
    ltype = torch.int32 if idx.shape[0] < 2**31 - 1 else torch.int64
    lane = torch.arange(1, idx.shape[0] + 1, dtype=ltype, device=idx.device)
    claims = torch.zeros(size, dtype=ltype, device=idx.device)
    scatter_max(claims, idx, lane, mask)
    safe = torch.where(mask, idx, torch.zeros_like(idx)).long()
    return mask & (claims[safe] == lane)


def compact(vals: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor,
                                                              int]:
    """Stream-compact ``vals[mask]`` (the reference's CUB DeviceSelect,
    ``util/select_utils.cuh:47``); returns (values, count)."""
    out = vals[mask]
    host_read()
    return out, int(out.shape[0])


def frontier_from_mask(mask: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Dense vertex mask -> ascending int32 frontier + its length."""
    verts = torch.nonzero(mask).flatten().to(torch.int32)
    host_read()
    return verts, int(verts.shape[0])


def mask_from_frontier(frontier: torch.Tensor, size: int) -> torch.Tensor:
    """Frontier -> dense boolean mask of ``size`` vertices."""
    mask = torch.zeros(size, dtype=torch.bool, device=frontier.device)
    mask[frontier.long()] = True
    return mask


def row_reduce_sorted(vals: torch.Tensor, row_offsets: torch.Tensor, *,
                      op: str, identity=None) -> torch.Tensor:
    """Per-row reduction over CSR-ordered edge values (the JAX package's
    ``row_reduce_sorted``, ``ops/segment.py:100``): the plain reduction
    behind every value pull (``ops.pull2.pull_reduce2_plain``).

    ``row_offsets`` has V+1 entries over ``vals``'s edge order; entries
    of ``vals`` past ``row_offsets[-1]`` (padding) are ignored. Each row
    is reduced on its own, and ``sum`` accumulates in float64: the JAX
    package differences a float32 running sum over all edges instead,
    which loses small rows to the rounding of the large total. Empty rows
    get 0 for ``sum`` and ``identity`` for ``min``/``max`` (defaults:
    +inf / -inf, or the integer type's bounds). Integers up to 32 bits.
    """
    if op not in ("sum", "min", "max"):
        raise ValueError(f"unknown op {op!r}")
    if vals.dtype == torch.int64:
        raise ValueError("row_reduce_sorted takes up to 32-bit ints")
    # segment_reduce takes floats; float64 holds every int32 exactly.
    data = vals
    if op == "sum" or not vals.dtype.is_floating_point:
        data = vals.double()
    off = row_offsets.long()
    out = torch.segment_reduce(data, op, offsets=off)
    if op != "sum":
        if identity is None:
            if vals.dtype.is_floating_point:
                identity = float("inf") if op == "min" else float("-inf")
            else:
                info = torch.iinfo(vals.dtype)
                identity = info.max if op == "min" else info.min
        out = torch.where(off[1:] > off[:-1], out, identity)
    return out.to(vals.dtype)
