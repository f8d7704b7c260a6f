"""HITS (hubs & authorities).

Counterpart of :mod:`gunrock_tpu.models.hits` (reference
``gunrock/app/hits/hits_enactor.cuh:158-311``): per iteration, authority
scores from hubs over in-edges and hub scores from authorities over
out-edges, each max-normalized (``mode="norm"``, the JAX package's
default: the reference's raw sums grow as ``lambda_max^k``), or the
reference's raw degree-normalized recurrence (``mode="raw"``).

Every update is a pull through kernel K3 (``ops.pull2.pull_reduce2``;
its plain version on CPU tensors): the authority update over the graph's
CSC, the hub update over the CSC of the reverse graph
(:meth:`DeviceGraph.reverse`, the same tensors with CSR and CSC
swapped).
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

__all__ = ["hits", "HitsResult", "hits_device"]


@dataclasses.dataclass
class HitsResult:
    hubs: np.ndarray    # (V,) float32
    auths: np.ndarray   # (V,) float32
    info: dict


def _max_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(x.max(), min=1e-12)


def _hits_loop(graph: DeviceGraph, rev: DeviceGraph, max_iters: int):
    vmask = torch.arange(graph.v_pad, device=graph.device) < graph.num_nodes
    hub = vmask.float()
    auth = hub
    for _ in range(max_iters):
        auth = _max_normalize(pull_reduce2(hub, graph, op="sum"))
        hub = _max_normalize(pull_reduce2(auth, rev, op="sum"))
    return hub, auth


def _hits_raw_loop(graph: DeviceGraph, rev: DeviceGraph, src: int,
                   delta: float, max_iters: int):
    """The reference's raw ping-pong recurrence (JAX package
    ``_hits_raw_loop``, ``models/hits.py:79-120``), both advances over
    the forward CSR, that is pulls over the reverse graph::

        auth'[u] = sum over (u,v) of hub[v] / max(outdeg v, 1)
        hub'[u]  = delta*[u == src]
                   + (1-delta) * sum over (u,v) of auth'[v] / indeg(v)
    """
    dev = graph.device
    ids = torch.arange(graph.v_pad, device=dev)
    vmask = ids < graph.num_nodes
    out_deg = graph.out_degrees().float()
    in_deg = (graph.csc_offsets[1:] - graph.csc_offsets[:-1]).float()
    inv_out = 1.0 / out_deg.clamp(min=1.0)
    inv_in = torch.where(in_deg > 0, 1.0 / in_deg.clamp(min=1.0), 0.0)
    d32 = torch.tensor(delta, dtype=torch.float32, device=dev)
    personal = d32 * (ids == src).float()
    hub = vmask.float()
    auth = hub
    for _ in range(max_iters):
        auth = pull_reduce2(hub * inv_out, rev, op="sum")
        hub = personal + (1.0 - d32) * pull_reduce2(auth * inv_in, rev,
                                                    op="sum")
    return hub, auth


def hits_device(graph: DeviceGraph, max_iters: int = 50,
                rev: Optional[DeviceGraph] = None, mode: str = "norm",
                src: int = 0, delta: float = 0.2):
    """``mode="norm"`` (default): max-normalized sums. ``mode="raw"``:
    the reference's exact raw recurrence (``src``/``delta`` are its
    personalization knobs, ``hits_problem.cuh:282-349``). ``rev``: the
    reverse graph, by default ``graph.reverse()``. Returns ``(hub,
    auth)``, (v_pad,) float32 each."""
    if not graph.has_csc or graph.edge_src is None:
        raise ValueError("HITS needs to_device(with_csc=True, "
                         "with_edge_src=True)")
    if mode not in ("norm", "raw"):
        raise ValueError(f"unknown HITS mode {mode!r}")
    rev = graph.reverse() if rev is None else rev
    if mode == "raw":
        return _hits_raw_loop(graph, rev, src, delta, max_iters)
    return _hits_loop(graph, rev, max_iters)


def hits(graph: Union[CsrGraph, DeviceGraph], max_iters: int = 50, *,
         device="cuda") -> HitsResult:
    """A :class:`CsrGraph` is uploaded to ``device`` (``with_csc``,
    ``with_edge_src``); a :class:`DeviceGraph` runs where it lies. On
    CUDA both updates run through kernel K3."""
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
        hub, auth = hits_device(dgraph, max_iters)
        sync(dgraph.device)
    info = make_info(
        primitive="hits", graph=dgraph, timer=timer,
        edges_visited=2 * dgraph.num_edges * max_iters,
        extra={"max_iteration": max_iters},
    )
    return HitsResult(hubs=hub.cpu().numpy()[:num_nodes],
                      auths=auth.cpu().numpy()[:num_nodes], info=info)
