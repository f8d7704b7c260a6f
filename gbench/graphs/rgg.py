"""Random geometric graphs, on the device, from the seed.

The 10th DIMACS Implementation Challenge's ``rgg_n_2_<scale>_s0``
recipe: ``2**scale`` points uniform in the unit square, and an edge
between two points closer than ``radius_factor * sqrt(ln n / n)``. The
points are binned into square cells of side at least the radius and
numbered in cell order (column of cells, then row), so the vertex ids
follow the points' places, as in the DIMACS matrices, whose nonzeros lie
in a band. Each pair is tested once, against the points of its own cell
and of four neighbouring ones, and listed once; the graph is undirected.
"""

from __future__ import annotations

import math

import torch

# The neighbouring cells that a cell tests: itself (pairs i < j) and
# half of its eight neighbours, so that each pair is tested once.
_OFFSETS = ((0, 0), (1, -1), (1, 0), (1, 1), (0, 1))
_CHUNK = 1 << 20


def radius(cfg: dict) -> float:
    n = 1 << int(cfg["scale"])
    return float(cfg["radius_factor"]) * math.sqrt(math.log(n) / n)


def rgg_edges(pts: torch.Tensor, r: float):
    """(pts sorted by cell, src, dst): every pair of points closer than
    ``r``, listed once, by the points' places in cell order."""
    n, dev = pts.shape[0], pts.device
    k = max(1, int(math.floor(1.0 / r)))
    cx = (pts[:, 0] * k).long().clamp_(max=k - 1)
    cy = (pts[:, 1] * k).long().clamp_(max=k - 1)
    order = torch.argsort(cx * k + cy, stable=True)
    pts, cx, cy = pts[order], cx[order], cy[order]
    counts = torch.bincount(cx * k + cy, minlength=k * k)
    start = torch.zeros(k * k + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=start[1:])
    r2 = r * r
    srcs, dsts = [], []
    for dx, dy in _OFFSETS:
        nx, ny = cx + dx, cy + dy
        valid = (nx >= 0) & (nx < k) & (ny >= 0) & (ny < k)
        cell = torch.where(valid, nx * k + ny, 0)
        cnt = torch.where(valid, counts[cell], 0)
        first = start[cell]
        for lo in range(0, n, _CHUNK):
            hi = min(n, lo + _CHUNK)
            c = cnt[lo:hi]
            total = int(c.sum())
            if total == 0:
                continue
            i = torch.repeat_interleave(
                torch.arange(lo, hi, device=dev), c)
            ends = torch.cumsum(c, 0)
            pos = torch.arange(total, device=dev) - (ends - c)[i - lo]
            j = first[i] + pos
            if (dx, dy) == (0, 0):
                keep = j > i
                i, j = i[keep], j[keep]
            d = pts[i] - pts[j]
            near = (d * d).sum(1) < r2
            srcs.append(i[near])
            dsts.append(j[near])
    return pts, torch.cat(srcs), torch.cat(dsts)


def generate(cfg: dict, seed: int, device: torch.device) -> dict:
    """The configuration's graph as a host COO: ``num_nodes``, int32
    ``src`` and ``dst``, each pair once."""
    n = 1 << int(cfg["scale"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**64)
    pts = torch.rand(n, 2, generator=gen, device=device, dtype=torch.float64)
    _, src, dst = rgg_edges(pts, radius(cfg))
    return {"num_nodes": n,
            "src": src.to(torch.int32).cpu().numpy(),
            "dst": dst.to(torch.int32).cpu().numpy()}
