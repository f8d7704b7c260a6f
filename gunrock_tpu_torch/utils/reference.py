"""CPU reference implementations (oracles) the CLI validates against.

Counterparts of :mod:`gunrock_tpu.utils.reference` (numpy, float64):
``cpu_bfs`` (reference ``ReferenceBFS``, ``tests/bfs/test_bfs.cu:186-257``),
``cpu_sssp``, ``cpu_pagerank``, ``cpu_hits``, ``cpu_salsa``, ``cpu_wtf``,
``cpu_cc``, ``cpu_tc`` and ``cpu_bc`` (with ``cpu_brandes``, its
single-source pass). The BC oracle is level-synchronous and vectorised
over each level's edges, where the JAX package's loops over edges in
Python, so it runs at the flagship's 60.7 M edges.
"""

from __future__ import annotations

import heapq
from collections import deque

import numpy as np

__all__ = ["cpu_bfs", "cpu_sssp", "cpu_pagerank", "cpu_hits", "cpu_salsa",
           "cpu_wtf", "cpu_cc", "cpu_tc", "cpu_bc", "cpu_brandes"]


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


def cpu_sssp(g, src: int) -> np.ndarray:
    """Dijkstra; dist[v] = shortest distance, +inf unreachable."""
    dist = np.full(g.num_nodes, np.inf, dtype=np.float64)
    dist[src] = 0.0
    row, col, w = g.row_offsets, g.col_indices, g.edge_values
    pq = [(0.0, src)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        for e in range(row[u], row[u + 1]):
            v, nd = col[e], d + w[e]
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(pq, (nd, v))
    return dist


def cpu_pagerank(g, damping: float = 0.85, max_iters: int = 100,
                 tol: float = 1e-6, normalized: bool = True) -> np.ndarray:
    """Power-iteration PageRank matching the reference semantics
    (``tests/pr/test_pr.cu`` SimpleReferencePr); stops once the L1 change
    of an iteration is below ``tol`` (``tol=0`` runs ``max_iters``)."""
    n = g.num_nodes
    outdeg = np.diff(g.row_offsets)
    deg = outdeg.astype(np.float64)
    dst = g.col_indices.astype(np.intp)
    rank = np.full(n, 1.0 / n, dtype=np.float64)
    for _ in range(max_iters):
        contrib = np.divide(rank, deg, out=np.zeros(n), where=deg > 0)
        incoming = np.bincount(dst, weights=np.repeat(contrib, outdeg),
                               minlength=n)
        new_rank = (1.0 - damping) / n + damping * incoming
        if not normalized:
            new_rank = (1.0 - damping) + damping * incoming
        if np.abs(new_rank - rank).sum() < tol:
            rank = new_rank
            break
        rank = new_rank
    return rank


def cpu_hits(g, max_iters: int = 50):
    """HITS hub/authority scores (reference ``tests/hits``), each
    max-normalized per iteration."""
    n = g.num_nodes
    outdeg = np.diff(g.row_offsets)
    src_of_edge = g.edge_sources().astype(np.intp)
    dst = g.col_indices.astype(np.intp)
    hub = np.ones(n)
    auth = np.ones(n)
    for _ in range(max_iters):
        auth = np.bincount(dst, weights=np.repeat(hub, outdeg), minlength=n)
        hub = np.bincount(src_of_edge, weights=auth[dst], minlength=n)
        auth /= max(auth.max(), 1e-12)
        hub /= max(hub.max(), 1e-12)
    return hub, auth


def cpu_salsa(g, max_iters: int = 50):
    """SALSA hub/authority scores, the numpy formulation of the
    documented recurrence (the reference's ReferenceSALSA,
    ``tests/salsa/test_salsa.cu:188``, is an empty stub)::

        auth[v] = sum over (u,v) of hub[u]  / outdeg(u)
        hub[u]  = sum over (u,v) of auth[v] / indeg(v)
    """
    n = g.num_nodes
    degs = np.diff(g.row_offsets)
    src = g.edge_sources().astype(np.intp)
    dst = g.col_indices.astype(np.intp)
    outdeg = degs.astype(np.float64)
    indeg = np.bincount(dst, minlength=n).astype(np.float64)
    inv_out = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1.0), 0.0)
    inv_in = np.where(indeg > 0, 1.0 / np.maximum(indeg, 1.0), 0.0)
    hub = np.full(n, 1.0 / n)
    auth = hub.copy()
    for _ in range(max_iters):
        auth = np.bincount(dst, weights=np.repeat(hub * inv_out, degs),
                           minlength=n)
        hub = np.bincount(src, weights=(auth * inv_in)[dst], minlength=n)
    return hub, auth


def cpu_wtf(g, src: int, *, delta: float = 0.85, alpha: float = 0.2,
            max_iters: int = 50, threshold: float = 1e-6,
            cot_size: int = 1000):
    """Who-To-Follow oracle: PPR -> circle of trust -> personalized SALSA
    (reference ``wtf_enactor.cuh:236-565`` phase semantics; see
    models/wtf.py for the per-phase recurrences this mirrors).
    Returns (refscore, ppr)."""
    n = g.num_nodes
    esrc = g.edge_sources()
    edst = g.col_indices
    degs = np.diff(g.row_offsets)
    outdeg = degs.astype(np.float64)
    inv_out = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1.0), 0.0)

    # phase 1: personalized PageRank
    rank = np.full(n, 1.0 / n)
    e_src_vec = np.zeros(n)
    e_src_vec[src] = 1.0
    dst = edst.astype(np.intp)
    for _ in range(max_iters):
        incoming = np.bincount(dst, weights=np.repeat(rank * inv_out, degs),
                               minlength=n)
        new_rank = delta * incoming + (1.0 - delta) * e_src_vec
        diff = np.abs(new_rank - rank).sum()
        rank = new_rank
        if diff <= threshold:
            break

    # phase 2: circle of trust = top-k by PPR (ties -> lowest id), then
    # in-degree restricted to CoT out-edges
    k = min(cot_size, n)
    cot = np.argsort(-rank, kind="stable")[:k]
    in_cot = np.zeros(n, bool)
    in_cot[cot] = True
    sel = in_cot[esrc]
    s, d = esrc[sel], edst[sel]
    cot_indeg = np.bincount(d, minlength=n).astype(np.float64)
    inv_cot_in = np.where(cot_indeg > 0,
                          1.0 / np.maximum(cot_indeg, 1.0), 0.0)

    # phase 3: personalized SALSA over the CoT's out-edges
    salsa_iters = int(1.0 / alpha)
    r = np.zeros(n)
    r[src] = 1.0
    ref = np.zeros(n)
    for _ in range(salsa_iters):
        ref = np.bincount(d, weights=(r * inv_out)[s], minlength=n)
        hub_val = np.where(s == src, alpha * inv_out[s], 0.0) + \
            (1.0 - alpha) * (ref * inv_cot_in)[d]
        r = np.bincount(s, weights=hub_val, minlength=n)
    return ref, rank


def cpu_cc(g) -> np.ndarray:
    """Weakly connected components (scipy's), each labelled with the
    minimum vertex id in it, the JAX package's normal form."""
    import scipy.sparse
    from scipy.sparse.csgraph import connected_components
    n = g.num_nodes
    a = scipy.sparse.csr_matrix(
        (np.ones(g.num_edges, np.int8), g.col_indices, g.row_offsets),
        shape=(n, n))
    _, comp = connected_components(a, directed=True, connection="weak")
    # Labels are numbered by first appearance, so each label's first
    # index is its smallest vertex.
    _, first = np.unique(comp, return_index=True)
    return first[comp].astype(np.int32)


def cpu_tc(g) -> int:
    """Triangle count via per-edge sorted-adjacency intersection
    (node-iterator; independent of the device's oriented sort-join). In an
    undirected simple graph each triangle has three edges with u < v, and
    each of them finds the triangle's third corner once, so the sum over
    those edges is three times the count."""
    row, col = g.row_offsets, g.col_indices
    adj = [np.sort(col[row[v]:row[v + 1]]) for v in range(g.num_nodes)]
    total = 0
    for u, v in zip(g.edge_sources(), col):
        if u < v:
            total += np.intersect1d(adj[u], adj[v],
                                    assume_unique=True).size
    return total // 3


def _out_edges(row: np.ndarray, col: np.ndarray, verts: np.ndarray):
    """(u, v) of every out-edge of ``verts``, in CSR order."""
    start = row[verts]
    deg = row[verts + 1] - start
    base = np.repeat(start - (np.cumsum(deg) - deg), deg)
    eid = np.arange(base.shape[0], dtype=np.int64) + base
    return np.repeat(verts, deg), col[eid]


def _add_at(out: np.ndarray, idx: np.ndarray, w: np.ndarray) -> None:
    """out[idx] += w with repeated indices summed, in time that grows with
    len(idx), not len(out) (a level of a deep graph is small)."""
    uniq, inv = np.unique(idx, return_inverse=True)
    out[uniq] += np.bincount(inv, weights=w, minlength=uniq.shape[0])


def cpu_brandes(g, src: int):
    """One source of Brandes' algorithm (reference ``RefCPUBC``,
    ``tests/bc/test_bc.cu``), one BFS level at a time in float64: returns
    ``(labels, sigma, delta)``, the depths (-1 unreachable), the
    shortest-path counts and the dependencies."""
    n = g.num_nodes
    row = np.asarray(g.row_offsets, np.int64)
    col = np.asarray(g.col_indices, np.int64)
    dist = np.full(n, -1, np.int64)
    dist[src] = 0
    sigma = np.zeros(n)
    sigma[src] = 1.0
    levels = [np.array([src], np.int64)]
    while True:
        d = len(levels)
        u, v = _out_edges(row, col, levels[-1])
        fresh = np.unique(v[dist[v] == -1])
        dist[fresh] = d
        on = dist[v] == d
        _add_at(sigma, v[on], sigma[u[on]])
        if not fresh.size:
            break
        levels.append(fresh)
    delta = np.zeros(n)
    for d in range(len(levels) - 1, -1, -1):
        u, v = _out_edges(row, col, levels[d])
        down = dist[v] == d + 1
        u, v = u[down], v[down]
        _add_at(delta, u, sigma[u] / sigma[v] * (1.0 + delta[v]))
    return dist.astype(np.int32), sigma, delta


def cpu_bc(g, src: int = -1) -> np.ndarray:
    """Brandes betweenness centrality: the dependencies of ``src``, or
    summed over all sources for ``src=-1``, without each source's own, and
    scaled by 0.5 for the undirected double count."""
    bc = np.zeros(g.num_nodes)
    for s in (range(g.num_nodes) if src < 0 else [src]):
        _, _, delta = cpu_brandes(g, s)
        delta[s] = 0.0
        bc += delta
    return bc * 0.5
