"""Per-shard views of a partitioned graph for kernels K1 and K3.

Counterpart of :mod:`gunrock_tpu.parallel.blocked`, which builds the
single-chip blocked Pallas layouts per shard so that every shard runs
the single-chip kernels over its local edges (the reference's multi-GPU
property, ``enactor_loop.cuh:748`` FullQueue_Core ->
``oprtr/advance/kernel.cuh``). The Hopper kernels read the plain CSC
(the port builds no blocked layout), so a shard's layout is a view:
row ``i`` of the stacked CSC tensors, which K1
(:func:`~gunrock_tpu_torch.ops.kernels.pull_reached_words`) and K3
(:func:`~gunrock_tpu_torch.ops.pull2.pull_reduce2`) take in place of a
``DeviceGraph``. Two source spaces, as in the JAX package:

  * global (``compact=False``): ids are global relabeled sources from
    ``csc_indices``, over a table of ``p * S`` entries (the DO-BFS pull's
    gathered frontier words);
  * compact (``compact=True``): ids from ``csc_local`` into ``[own 0..S
    | p * ghost_cap ghost slots]``, the table a boundary exchange fills
    (PageRank, SSSP's pull-relax).

A view's ``num_edges`` is the shard's real in-edge count,
``csc_offsets[i, -1]``, not the stacked width.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

__all__ = ["ShardView", "ShardedBlocked", "blocked_from_partition"]


@dataclasses.dataclass(frozen=True)
class ShardView:
    """One shard's CSC with the fields K1 and K3 read from a graph: rows
    are the shard's ``v_pad = S`` vertices, ``csc_indices`` index a value
    table of ``n_values`` entries, ``csc_edge_values`` are the per-edge
    weights (``weights="val"``), if any."""

    csc_offsets: torch.Tensor               # (S+1,) int32
    csc_indices: torch.Tensor               # (e_pad,) int32
    csc_edge_values: Optional[torch.Tensor]  # (e_pad,) float32
    num_edges: int
    v_pad: int
    e_pad: int
    n_values: int
    inv_outdeg: Optional[torch.Tensor] = None

    @property
    def has_csc(self) -> bool:
        return True

    @property
    def device(self) -> torch.device:
        return self.csc_indices.device


@dataclasses.dataclass(frozen=True)
class ShardedBlocked:
    """The views of every shard. ``src_pad`` is the table space
    (``p * S`` global, ``S + p * ghost_cap`` compact), ``dst_pad`` the
    rows, S."""

    views: tuple
    src_pad: int
    dst_pad: int

    @property
    def num_shards(self) -> int:
        return len(self.views)


def blocked_from_partition(pg, *, compact: bool = False,
                           edge_weight: Union[None, str, Callable] = None
                           ) -> ShardedBlocked:
    """The shard views of a ``PartitionedGraph``'s CSC, one a shard it
    holds (``pg.local_shards``).

    ``edge_weight``: None, ``"csc"`` (the partition's
    ``csc_edge_values``, SSSP's pull-relax weights), or a callable
    ``(src_global, dst_local, local shard) -> float32`` over a shard's
    edges
    (PageRank's 1/outdeg(src)), evaluated once here, as the JAX package
    folds it into its layout."""
    if pg.csc_offsets is None:
        raise ValueError("shard views need partition(with_csc=True)")
    if compact and not pg.has_ghosts:
        raise ValueError("compact views need partition(with_ghosts=True)")
    p, S = pg.num_shards, pg.shard_size
    L = pg.local_shards
    ids = pg.csc_local if compact else pg.csc_indices
    weights = None
    if edge_weight == "csc":
        if pg.csc_edge_values is None:
            raise ValueError("edge_weight='csc' needs "
                             "partition(with_edge_values=True, with_csc)")
        weights = pg.csc_edge_values
    elif edge_weight is not None:
        weights = torch.zeros(pg.csc_indices.shape, dtype=torch.float32,
                              device=pg.device)
    n_values = S + p * pg.ghost_cap if compact else p * S
    ends = pg.csc_offsets[:, -1].tolist()
    views = []
    for i in range(L):
        if callable(edge_weight):
            off = pg.csc_offsets[i].long()
            dst_local = torch.repeat_interleave(
                torch.arange(S, device=pg.device), torch.diff(off),
                output_size=ends[i])
            weights[i, :ends[i]] = torch.as_tensor(
                edge_weight(pg.csc_indices[i, :ends[i]].long(), dst_local,
                            i), dtype=torch.float32, device=pg.device)
        views.append(ShardView(
            csc_offsets=pg.csc_offsets[i], csc_indices=ids[i],
            csc_edge_values=None if weights is None else weights[i],
            num_edges=int(ends[i]), v_pad=S, e_pad=ids.shape[1],
            n_values=n_values))
    return ShardedBlocked(views=tuple(views), src_pad=n_values, dst_pad=S)
