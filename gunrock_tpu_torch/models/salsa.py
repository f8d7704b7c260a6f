"""SALSA (stochastic approach for link-structure analysis).

Counterpart of :mod:`gunrock_tpu.models.salsa` (reference
``gunrock/app/salsa/``): random-walk-normalized hub/authority
propagation, ping-ponged per iteration::

    auth[v] = sum over (u,v) in E of hub[u]  / outdeg(u)
    hub[u]  = sum over (u,v) in E of auth[v] / indeg(v)

Each update is a pull through kernel K3 (its plain version on CPU
tensors), the hub update over the reverse graph, as in
:mod:`gunrock_tpu_torch.models.hits`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..enactor import Timer
from ..graph.csr import CsrGraph
from ..graph.device import DeviceGraph, resolve_device, sync, to_device
from ..ops.pull2 import pull_reduce2
from ..utils.info import make_info

__all__ = ["salsa", "SalsaResult", "salsa_device"]


@dataclasses.dataclass
class SalsaResult:
    hubs: np.ndarray
    auths: np.ndarray
    info: dict


def salsa_device(graph: DeviceGraph, max_iters: int = 50,
                 rev: Optional[DeviceGraph] = None):
    """``rev``: the reverse graph, by default ``graph.reverse()``.
    Returns ``(hub, auth)``, (v_pad,) float32 each."""
    if not graph.has_csc or graph.edge_src is None:
        raise ValueError("SALSA needs to_device(with_csc=True, "
                         "with_edge_src=True)")
    rev = graph.reverse() if rev is None else rev
    n = graph.num_nodes
    vmask = torch.arange(graph.v_pad, device=graph.device) < n
    out_deg = graph.out_degrees().float()
    in_deg = (graph.csc_offsets[1:] - graph.csc_offsets[:-1]).float()
    inv_out = torch.where(out_deg > 0, 1.0 / out_deg.clamp(min=1.0), 0.0)
    inv_in = torch.where(in_deg > 0, 1.0 / in_deg.clamp(min=1.0), 0.0)
    hub = torch.where(vmask, 1.0 / n, 0.0).float()
    auth = hub
    for _ in range(max_iters):
        auth = pull_reduce2(hub * inv_out, graph, op="sum")
        hub = pull_reduce2(auth * inv_in, rev, op="sum")
    return hub, auth


def salsa(graph: Union[CsrGraph, DeviceGraph], max_iters: int = 50, *,
          device="cuda") -> SalsaResult:
    """As :func:`gunrock_tpu_torch.models.hits.hits`: on CUDA both updates
    run through kernel K3."""
    timer = Timer()
    num_nodes = graph.num_nodes
    if isinstance(graph, CsrGraph):
        dev = resolve_device(device)
        with timer.time("preprocess_ms"):
            dgraph = to_device(graph, with_csc=True, with_edge_src=True,
                               device=dev)
            sync(dev)
    else:
        dgraph = graph
    with timer.time("process_ms"):
        hub, auth = salsa_device(dgraph, max_iters)
        sync(dgraph.device)
    info = make_info(
        primitive="salsa", graph=dgraph, timer=timer,
        edges_visited=2 * dgraph.num_edges * max_iters,
        extra={"max_iteration": max_iters},
    )
    return SalsaResult(hubs=hub.cpu().numpy()[:num_nodes],
                       auths=auth.cpu().numpy()[:num_nodes], info=info)
