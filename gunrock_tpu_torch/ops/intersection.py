"""Segmented intersection operator, the reference's documented fourth
operator (``doc/programming_model.md`` "Operators"), used by triangle
counting.

Counterpart of :mod:`gunrock_tpu.ops.intersection`. Wedge membership
probes are a sort-join, as in the JAX package:

    wedges = advance over the second endpoint's adjacency: a chunk edge
             (u, v) becomes one wedge (u, v, w) for each w in N(v)
             (the port's exact-size expansion, :mod:`.advance`)
    join   = one sort of [edges ++ wedges] by (u, w, tag): a wedge
             (u, v, w) is a triangle iff an edge (u, w) lands in its
             (u, w) run
    count  = scatter-adds of the hits into each chunk edge and corner

The JAX package's lanes are capped and masked; here every lane is live,
so the chunk's wedge count is the output size. Its four steps are the
functions :func:`wedges`, :func:`join`, :func:`hits` and :func:`count`,
which :func:`intersect_counts` runs in order; each takes the previous
one's outputs, so a profile can time them one by one.
"""

from __future__ import annotations

import torch

from .advance import _expand_csr

__all__ = ["row_probe", "intersect_counts", "wedges", "join", "hits",
           "count"]


def row_probe(row_offsets: torch.Tensor, col_indices: torch.Tensor,
              u: torch.Tensor, w: torch.Tensor, steps: int) -> torch.Tensor:
    """Lane-parallel membership test: is ``w`` in the sorted CSR row of
    ``u``? ``steps`` must be >= ceil(log2(max_degree + 1)). Kept for small
    probes; the TC path uses the sort-join."""
    e_pad = col_indices.shape[0]
    u = u.long()
    lo = row_offsets[u].long()
    hi = row_offsets[u + 1].long()
    end = hi
    for _ in range(steps):
        mid = (lo + hi) // 2
        go_right = col_indices[mid.clamp(max=e_pad - 1)] < w
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return (lo < end) & (col_indices[lo.clamp(max=e_pad - 1)] == w)


def wedges(row_offsets: torch.Tensor, col_indices: torch.Tensor,
           chunk_src: torch.Tensor, chunk_dst: torch.Tensor):
    """The wedge expansion: ``(u, w, rank, total)``, one lane per wedge
    (u, v, w), in chunk-edge order; ``rank`` is the chunk edge that made
    it."""
    ex = _expand_csr(row_offsets, col_indices, chunk_dst, True)
    return chunk_src[ex.rank], ex.dst, ex.rank, ex.total


def _join_radix(v_pad: int) -> int:
    # Pad lanes of the edge stream carry v_pad, so ids take v_pad + 1
    # values, and (u * radix + w) << 1 must stay below 2^63.
    if v_pad >= 2**31 - 1:
        raise ValueError(f"the join key holds vertex ids below 2^31 - 1, "
                         f"not {v_pad}")
    return v_pad + 1


def join(edge_src: torch.Tensor, edge_dst: torch.Tensor, u: torch.Tensor,
         w: torch.Tensor, v_pad: int):
    """The sort-join: the edge stream (tag 0) and the wedges (tag 1) as
    one int64 key ``((u * (v_pad + 1) + w) << 1) | tag``, sorted. Returns
    the sorted keys and the permutation (positions below ``len(edge_src)``
    are edges, the rest wedges in :func:`wedges`'s order)."""
    radix = _join_radix(v_pad)
    ekeys = (edge_src.long() * radix + edge_dst.long()) << 1
    wkeys = ((u.long() * radix + w.long()) << 1) | 1
    return torch.sort(torch.cat([ekeys, wkeys]))


def hits(keys: torch.Tensor, perm: torch.Tensor,
         num_stream_edges: int) -> torch.Tensor:
    """The wedges that close a triangle, as indices into :func:`wedges`'s
    lanes. The JAX package resolves them with a segmented-OR scan over
    the (u, w) runs. An edge sorts first in its run (tag 0), so a wedge's
    run holds an edge iff the last edge at or before the wedge in sorted
    order carries the wedge's (u, w): a cumsum of the edge flags names
    that edge, a gather from the sorted edge keys reads it, and no scan
    is needed."""
    is_edge = (keys & 1) == 0
    pair = keys >> 1
    edge_pairs = pair[is_edge]
    if not edge_pairs.numel():
        return perm[:0]
    # Positions in the sorted stream (the chunk's wedges and every edge),
    # int64 where they pass int32.
    ptype = torch.int32 if keys.shape[0] < 2**31 else torch.int64
    last = torch.cumsum(is_edge, 0, dtype=ptype) - 1
    hit = ~is_edge & (last >= 0) & \
        (edge_pairs[last.clamp(min=0).long()] == pair)
    return perm[hit] - num_stream_edges


def count(hit_idx: torch.Tensor, w: torch.Tensor, rank: torch.Tensor,
          chunk_src: torch.Tensor, chunk_dst: torch.Tensor, v_pad: int):
    """The count scatters: per chunk edge (int32) and per vertex (int64,
    ``(v_pad,)``), each triangle (u, v, w) credited to its three
    corners: w from the hit wedges (``hit_idx``, from :func:`hits`), u
    and v from the edge counts."""
    dev = w.device
    r = rank[hit_idx]
    counts = torch.zeros(chunk_src.shape[0], dtype=torch.int64,
                         device=dev).index_add_(0, r, torch.ones_like(r))
    vcounts = torch.zeros(v_pad, dtype=torch.int64, device=dev)
    vcounts.index_add_(0, w[hit_idx].long(), torch.ones_like(r))
    vcounts.index_add_(0, chunk_src.long(), counts)
    vcounts.index_add_(0, chunk_dst.long(), counts)
    return counts.to(torch.int32), vcounts


def intersect_counts(row_offsets: torch.Tensor, col_indices: torch.Tensor,
                     edge_src: torch.Tensor, chunk_src: torch.Tensor,
                     chunk_dst: torch.Tensor):
    """Per-edge |N(u) ∩ N(v)| for the edge chunk ``(chunk_src,
    chunk_dst)`` over one CSR (degree-oriented for TC).

    ``row_offsets`` has ``v_pad + 1`` entries; ``edge_src`` is the source
    of each edge of the join's edge stream, whose destinations are the
    first ``len(edge_src)`` entries of ``col_indices`` (pad lanes, with
    ``v_pad`` on both sides, never join a wedge). Returns
    ``(counts, vcounts, total_wedges)``: an int32 count a chunk edge, an
    int64 count a vertex (``(v_pad,)``) and the chunk's wedge count."""
    v_pad = row_offsets.shape[0] - 1
    u, w, rank, total = wedges(row_offsets, col_indices, chunk_src,
                               chunk_dst)
    keys, perm = join(edge_src, col_indices[:edge_src.shape[0]], u, w,
                      v_pad)
    hit_idx = hits(keys, perm, edge_src.shape[0])
    counts, vcounts = count(hit_idx, w, rank, chunk_src, chunk_dst, v_pad)
    return counts, vcounts, total
