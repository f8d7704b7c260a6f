"""Sharded triangle counting: wedge chunks fanned across the shard mesh.

Counterpart of :mod:`gunrock_tpu.parallel.tc`. TC's working set is its
wedges, not the graph, so the shards split the wedge-budget chunks of
one replicated oriented DAG (the reference's "duplicate" mode applied to
the segmented intersection): shard ``i`` counts chunks ``i * cps ..
(i + 1) * cps - 1`` with the single-card step
(``models.tc.tc_device``, the sort-join of ``ops/intersection.py``), and
one sum over shards combines the totals and per-vertex counts, in int64.
The DAG and its chunk bounds are the single-card ``_tc_prepare``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..enactor import Timer
from ..graph.csr import CsrGraph, from_coo
from ..graph.device import sync
from ..models.tc import _tc_prepare, tc_device
from ..utils.info import make_info
from .mesh import Mesh, info_graph, make_mesh, mesh_info

__all__ = ["tc_sharded", "ShardedTcResult"]


@dataclasses.dataclass
class ShardedTcResult:
    total: int
    vertex_counts: np.ndarray
    info: dict


def tc_sharded(graph: CsrGraph, *, num_shards: int = None,
               mesh: Optional[Mesh] = None, undirected_input: bool = True,
               device="cuda") -> ShardedTcResult:
    timer = Timer()
    g = graph
    if not undirected_input:
        g = from_coo(g.num_nodes, g.edge_sources(), g.col_indices,
                     undirected=True)
    if mesh is None:
        mesh = make_mesh(num_shards, device=device)
    p, dev = mesh.num_shards, mesh.device

    with timer.time("preprocess_ms"):
        prep = _tc_prepare(g)
        nchunks = len(prep.bounds) - 1
        cps = max(1, -(-nchunks // p))        # chunks per shard

    with timer.time("process_ms"):
        row = torch.from_numpy(prep.row).to(dev)
        col = torch.from_numpy(prep.col).to(dev)
        esrc = torch.from_numpy(prep.esrc_full).to(dev)
        L = mesh.local_shards
        vcounts = torch.zeros((L, prep.v_pad), dtype=torch.int64, device=dev)
        totals = torch.zeros((L, 1), dtype=torch.int64, device=dev)
        chunks = list(zip(prep.bounds, prep.bounds[1:]))
        for li, i in enumerate(mesh.axis_index().tolist()):
            for a, b in chunks[i * cps:(i + 1) * cps]:
                _, vc, tri, _ = tc_device(row, col, esrc, esrc[a:b],
                                          col[a:b])
                vcounts[li] += vc
                totals[li] += tri
        tot = int(mesh.psum(totals))
        vc = mesh.psum(vcounts)[:g.num_nodes].cpu().numpy()
        sync(dev)

    info = make_info(
        primitive="tc_sharded", graph=info_graph(g, mesh), timer=timer,
        edges_visited=prep.wedge_total,
        extra={"num_shards": int(p), "num_triangles": tot,
               "wedges_probed": prep.wedge_total,
               "num_chunks": nchunks,
               "chunks_per_shard": int(cps), **mesh_info(mesh)},
    )
    return ShardedTcResult(total=tot, vertex_counts=vc, info=info)
