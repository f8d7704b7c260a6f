"""Community modularity metric.

Counterpart of :mod:`gunrock_tpu.utils.modularity` (the reference's
experimental "global indicator",
``gunrock/global_indicator/modularity.cuh``):

Q = (1/2m) * sum_{(u,v) in E, c(u)=c(v)} [1 - k_u * k_v / (2m)]

computed as the intra-community edge fraction minus the degree-based
expectation, over the host CSR, in float64 as the JAX package computes
it there.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["modularity"]


def modularity(g, communities) -> float:
    """Newman modularity of a vertex->community assignment (a numpy
    array or a tensor on any device) over an undirected host graph
    (edges counted once a direction, 2m = num_edges for a symmetrized
    CSR)."""
    if torch.is_tensor(communities):
        communities = communities.cpu().numpy()
    comm = np.asarray(communities)
    m2 = float(g.num_edges)          # = 2m for symmetrized input
    if m2 == 0:
        return 0.0
    intra = float((comm[g.edge_sources()] == comm[g.col_indices]).sum()) / m2
    deg_per_comm = np.bincount(comm, weights=g.out_degrees.astype(np.float64))
    expected = float((deg_per_comm ** 2).sum()) / (m2 * m2)
    return intra - expected
