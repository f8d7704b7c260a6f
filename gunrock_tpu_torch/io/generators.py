"""Synthetic graph generators: R-MAT, RGG, small-world.

Counterpart of :mod:`gunrock_tpu.io.generators` (reference
``graphio/rmat.cuh:177``, ``graphio/rgg.cuh``, ``graphio/small_world.cuh``).
The numpy RNG calls are the same, in the same order, so the same
arguments give a byte-identical CSR. :func:`rmat_device` draws on the
device with a ``torch.Generator``: the JAX package's distribution, not
its bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.csr import CsrGraph, from_coo
from ..graph.device import resolve_device

__all__ = ["rmat", "rgg", "small_world", "rmat_coo", "rmat_device"]


def rmat_coo(
    scale: int,
    edge_factor: float = 48.0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    *,
    seed: int = 0,
    noise: float = 0.0,
):
    """Generate R-MAT COO edges (vectorized Kronecker recursion).

    Defaults match the reference (a=0.57 b=0.19 c=0.19 d=0.05,
    ``graphio/rmat.cuh:186-190``). Returns (num_nodes, src, dst).
    """
    num_nodes = 1 << scale
    num_edges = int(num_nodes * edge_factor)
    rng = np.random.default_rng(seed)

    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    for bit in range(scale):
        aa, bb, cc = a, b, c
        if noise:
            # Per-level parameter jitter (reference grmat-style smoothing).
            aa = a * (1 + noise * (rng.random() - 0.5))
            bb = b * (1 + noise * (rng.random() - 0.5))
            cc = c * (1 + noise * (rng.random() - 0.5))
        u = rng.random(num_edges)
        # Quadrant choice per edge per level (vectorized ChoosePartition,
        # reference rmat.cuh:70-101).
        go_right_src = u >= aa + bb                     # c or d quadrant
        go_right_dst = np.where(go_right_src, u >= aa + bb + cc, u >= aa)
        src |= go_right_src.astype(np.int64) << bit
        dst |= go_right_dst.astype(np.int64) << bit
    return num_nodes, src, dst


def rmat(
    scale: int,
    edge_factor: float = 48.0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    *,
    seed: int = 0,
    undirected: bool = True,
    random_edge_values: bool = False,
) -> CsrGraph:
    num_nodes, src, dst = rmat_coo(scale, edge_factor, a, b, c, seed=seed)
    g = from_coo(num_nodes, src, dst, undirected=undirected)
    if random_edge_values:
        g.random_edge_values(seed=seed)
    return g


def rmat_device(scale: int, edge_factor: float = 48.0,
                a: float = 0.57, b: float = 0.19, c: float = 0.19,
                *, seed: int = 0, device="cuda"):
    """R-MAT COO edges drawn on ``device`` (reference GRMAT,
    ``graphio/grmat.cuh:105``; the JAX package's ``rmat_device``):
    returns ``(num_nodes, src, dst)``, the ids int32 tensors there.

    Each level draws one float32 uniform an edge from an explicit
    ``torch.Generator`` seeded with ``seed`` and picks the quadrant as
    the JAX package does: source bit set above ``a + b``, destination
    bit set above ``a + b + c`` in the lower half and above ``a`` in the
    upper. So the edges follow the JAX package's distribution (quadrants
    a, b, c and 1 - a - b - c, independent across levels and edges), not
    its bits: ``jax.random`` and torch's generator give other numbers
    from one seed. One level at a time, so the draws take one float an
    edge where the JAX package holds all the levels'."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    num_nodes = 1 << scale
    num_edges = int(num_nodes * edge_factor)
    src = torch.zeros(num_edges, dtype=torch.int32, device=dev)
    dst = torch.zeros(num_edges, dtype=torch.int32, device=dev)
    for bit in range(scale):
        u = torch.rand(num_edges, generator=gen, device=dev)
        right_src = u >= a + b
        right_dst = torch.where(right_src, u >= a + b + c, u >= a)
        src |= right_src.to(torch.int32) << bit
        dst |= right_dst.to(torch.int32) << bit
    return num_nodes, src, dst


def rgg(
    num_nodes: int,
    threshold: float | None = None,
    *,
    seed: int = 0,
    undirected: bool = True,
) -> CsrGraph:
    """Random geometric graph on the unit square (reference
    ``graphio/rgg.cuh``: default threshold ~ sqrt(ln(n)/n)).

    Grid-bucketed neighbor search keeps this O(n) for the default radius.
    """
    if threshold is None:
        threshold = np.sqrt(np.log(num_nodes) / num_nodes)
    rng = np.random.default_rng(seed)
    pts = rng.random((num_nodes, 2))

    cell = threshold
    grid_n = max(1, int(1.0 / cell))
    cx = np.minimum((pts[:, 0] / cell).astype(np.int64), grid_n - 1)
    cy = np.minimum((pts[:, 1] / cell).astype(np.int64), grid_n - 1)
    cell_id = cx * grid_n + cy
    order = np.argsort(cell_id, kind="stable")

    srcs, dsts = [], []
    sorted_cells = cell_id[order]
    starts = np.searchsorted(sorted_cells, np.arange(grid_n * grid_n))
    ends = np.searchsorted(sorted_cells, np.arange(grid_n * grid_n), side="right")
    t2 = threshold * threshold
    for gx in range(grid_n):
        for gy in range(grid_n):
            mine = order[starts[gx * grid_n + gy]:ends[gx * grid_n + gy]]
            if mine.size == 0:
                continue
            neigh = []
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    nx, ny = gx + dx, gy + dy
                    if 0 <= nx < grid_n and 0 <= ny < grid_n:
                        cid = nx * grid_n + ny
                        neigh.append(order[starts[cid]:ends[cid]])
            cand = np.concatenate(neigh)
            d2 = ((pts[mine, None, :] - pts[None, cand, :]) ** 2).sum(-1)
            ii, jj = np.nonzero(d2 <= t2)
            s, d = mine[ii], cand[jj]
            keep = s < d  # each pair once; symmetrize in from_coo
            srcs.append(s[keep])
            dsts.append(d[keep])
    src = np.concatenate(srcs) if srcs else np.empty(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.empty(0, np.int64)
    return from_coo(num_nodes, src, dst, undirected=undirected)


def small_world(
    num_nodes: int,
    k: int = 6,
    p: float = 0.1,
    *,
    seed: int = 0,
    undirected: bool = True,
) -> CsrGraph:
    """Watts–Strogatz small-world graph (reference
    ``graphio/small_world.cuh``): ring lattice with k/2 neighbors each
    side, each edge rewired with probability p."""
    rng = np.random.default_rng(seed)
    half = max(1, k // 2)
    base = np.arange(num_nodes, dtype=np.int64)
    src = np.repeat(base, half)
    shift = np.tile(np.arange(1, half + 1, dtype=np.int64), num_nodes)
    dst = (src + shift) % num_nodes
    rewire = rng.random(src.size) < p
    dst = np.where(rewire, rng.integers(0, num_nodes, src.size), dst)
    return from_coo(num_nodes, src, dst, undirected=undirected)
