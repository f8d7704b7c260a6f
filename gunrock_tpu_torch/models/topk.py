"""TopK degree centrality.

Counterpart of :mod:`gunrock_tpu.models.topk` (reference
``gunrock/app/topk/topk_enactor.cuh:133-161``): per-vertex centrality =
out-degree + in-degree, then a top-k selection. The JAX package selects
with ``jax.lax.top_k``, which puts the lower index first among equal
values; ``torch.topk`` promises no order among ties, so the port selects
with a stable descending sort (:func:`top_k`), which keeps that order.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from ..enactor import Timer
from ..graph.csr import CsrGraph
from ..graph.device import DeviceGraph, resolve_device, sync, to_device
from ..utils.info import make_info

__all__ = ["topk", "TopkResult", "topk_device", "top_k"]


@dataclasses.dataclass
class TopkResult:
    node_ids: np.ndarray      # (k,) int32
    centralities: np.ndarray  # (k,) int32 (out_deg + in_deg)
    info: dict


def top_k(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values, ids)`` of the ``k`` largest entries, by value descending
    and, among equal values, id ascending (``jax.lax.top_k``'s order);
    ids are int32."""
    vals, ids = torch.sort(values, descending=True, stable=True)
    return vals[:k], ids[:k].to(torch.int32)


def topk_device(graph: DeviceGraph, k: int):
    """Returns ``(ids, centralities)``, ``min(k, V)`` of each, int32."""
    if not graph.has_csc:
        raise ValueError("TopK needs to_device(with_csc=True)")
    out_deg = graph.out_degrees()
    in_deg = graph.csc_offsets[1:] - graph.csc_offsets[:-1]
    vmask = torch.arange(graph.v_pad, device=graph.device) < graph.num_nodes
    cent = torch.where(vmask, out_deg + in_deg, -1).to(torch.int32)
    vals, ids = top_k(cent, min(k, graph.num_nodes))
    return ids, vals


def topk(graph: Union[CsrGraph, DeviceGraph], k: int = 10, *,
         device="cuda") -> TopkResult:
    """A :class:`CsrGraph` is uploaded ``with_csc=True`` to ``device``; a
    :class:`DeviceGraph` runs where it lies."""
    timer = Timer()
    if isinstance(graph, CsrGraph):
        dev = resolve_device(device)
        with timer.time("preprocess_ms"):
            dgraph = to_device(graph, with_csc=True, device=dev)
            sync(dev)
    else:
        dgraph = graph
    with timer.time("process_ms"):
        ids, vals = topk_device(dgraph, k)
        sync(dgraph.device)
    info = make_info(primitive="topk", graph=dgraph, timer=timer,
                     extra={"top_nodes": int(k)})
    return TopkResult(node_ids=ids.cpu().numpy(),
                      centralities=vals.cpu().numpy(), info=info)
