"""The Graph500 Kronecker generator, on the device, from the seed.

The Graph500 reference code's ``kronecker_generator``: ``edge_factor *
2**scale`` edges, each built bit by bit over ``scale`` levels, where a
level picks one of the initiator's quadrants (A, B, C, D): the source
bit is set with probability C + D, and the target bit, given the source
bit, with B / (A + B) or D / (C + D). The vertex ids are then permuted
at random. The edge list's own shuffle is left out: the program and the
reference both sort the edges. Self-loops and duplicates are kept here;
the program's build removes them, as its users build graphs, and the
reference removes them on its own.

With ``"drop_isolated": true`` (LDBC Graphalytics' ``graph500-*``
datasets, which leave out the vertices without an edge) the vertices
that have an edge, self-loops not counted, are numbered ``0..n'-1`` in
id order after every draw, and the self-loops of the others go with
them; the graph is otherwise the one drawn without the key.
"""

from __future__ import annotations

import torch


def kronecker_edges(scale: int, num_edges: int, initiator, gen, device):
    """(src, dst) int64 of ``num_edges`` edges on ``device``, before the
    vertices are permuted: bit ``b`` of an id is level ``b``'s choice."""
    a, b, c = (float(v) for v in initiator[:3])
    ab = a + b
    c_norm, a_norm = c / (1.0 - ab), a / ab
    src = torch.zeros(num_edges, dtype=torch.int64, device=device)
    dst = torch.zeros_like(src)
    for level in range(scale):
        ii = torch.rand(num_edges, generator=gen, device=device) > ab
        thresh = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(num_edges, generator=gen, device=device) > thresh
        src |= ii.long() << level
        dst |= jj.long() << level
    return src, dst


def drop_isolated(n: int, src: torch.Tensor, dst: torch.Tensor):
    """(n', src, dst): the vertices that have an edge other than a
    self-loop, renumbered in id order, and the edges between them."""
    has = torch.zeros(n, dtype=torch.bool, device=src.device)
    loop = src == dst
    has[src[~loop]] = True
    has[dst[~loop]] = True
    new_id = torch.cumsum(has, 0) - 1
    keep = has[src]
    return int(has.sum()), new_id[src[keep]], new_id[dst[keep]]


def generate(cfg: dict, seed: int, device: torch.device) -> dict:
    """The configuration's graph as a host COO: ``num_nodes``, ``src``
    and ``dst`` (int32 numpy arrays)."""
    scale = int(cfg["scale"])
    n = 1 << scale
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**64)
    src, dst = kronecker_edges(scale, int(cfg["edge_factor"]) * n,
                               cfg["initiator"], gen, device)
    perm = torch.randperm(n, generator=gen, device=device)
    src, dst = perm[src], perm[dst]
    if cfg.get("drop_isolated", False):
        n, src, dst = drop_isolated(n, src, dst)
    return {"num_nodes": n,
            "src": src.to(torch.int32).cpu().numpy(),
            "dst": dst.to(torch.int32).cpu().numpy()}

