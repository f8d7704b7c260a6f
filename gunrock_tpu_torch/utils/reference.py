"""CPU reference implementation (oracle) for BFS validation.

Counterpart of :func:`gunrock_tpu.utils.reference.cpu_bfs` (reference
``ReferenceBFS``, ``tests/bfs/test_bfs.cu:186-257``): a plain,
obviously-correct host BFS that the CLI validates against.
"""

from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["cpu_bfs"]


def cpu_bfs(g, src: int) -> np.ndarray:
    """Plain queue BFS; labels[v] = depth, -1 unreachable."""
    labels = np.full(g.num_nodes, -1, dtype=np.int32)
    labels[src] = 0
    q = deque([src])
    row, col = g.row_offsets, g.col_indices
    while q:
        u = q.popleft()
        for e in range(row[u], row[u + 1]):
            v = col[e]
            if labels[v] == -1:
                labels[v] = labels[u] + 1
                q.append(v)
    return labels
