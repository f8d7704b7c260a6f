"""Device-resident graph: padded int32 CSR (+ CSC) as torch tensors.

Counterpart of :mod:`gunrock_tpu.graph.device` (``DeviceGraph`` and
``to_device``), holding the forward CSR and optionally the inverse CSR
(CSC) for the pull step, as the reference's ``GraphSlice`` does
(``gunrock/app/problem_base.cuh:85-342``).

The padding rule is the JAX package's own (``_pad``), so every array here
equals its JAX counterpart element for element:

  * ``row_offsets`` has ``v_pad + 1`` entries; entries past ``num_nodes``
    repeat ``num_edges`` so padded vertices have degree 0.
  * ``col_indices`` / ``csc_indices`` are padded to ``e_pad`` with 0;
    padded edges are never reachable via offsets.
  * ``csc_edge_dst`` (destination of each CSC edge) uses ``v_pad`` as
    the fill.

The blocked-CSC and pull-v2 layouts of the JAX package are not built:
the Hopper pull kernel reads the plain CSC.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .csr import CsrGraph

__all__ = ["DeviceGraph", "to_device", "from_numpy", "round_up",
           "resolve_device"]

LANE = 128

_FIELDS = ("row_offsets", "col_indices", "csc_offsets", "csc_indices",
           "csc_edge_dst")


def round_up(x: int, m: int = LANE) -> int:
    return ((x + m - 1) // m) * m


def _pad(sz: int) -> int:
    """The JAX package's padding rule (``graph/device.py:419-420``)."""
    return round_up(max(sz, 1), 8192 if sz >= 8192 else LANE)


def resolve_device(device) -> torch.device:
    """``torch.device`` for a public call's ``device`` argument. Raises
    when CUDA is asked for and absent: nothing moves to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Padded int32 CSR (+ optional CSC) on one torch device.

    ``num_nodes``/``num_edges`` are the exact counts; ``v_pad``/``e_pad``
    the padded lengths (see the module docstring).
    """

    num_nodes: int
    num_edges: int
    v_pad: int
    e_pad: int
    row_offsets: torch.Tensor                   # (v_pad+1,) int32
    col_indices: torch.Tensor                   # (e_pad,)   int32
    # Inverse CSR: csc row v lists the in-neighbors (sources) of v.
    csc_offsets: Optional[torch.Tensor] = None  # (v_pad+1,) int32
    csc_indices: Optional[torch.Tensor] = None  # (e_pad,)   int32
    csc_edge_dst: Optional[torch.Tensor] = None  # (e_pad,)  int32, fill v_pad
    undirected: bool = False

    @property
    def device(self) -> torch.device:
        return self.row_offsets.device

    @property
    def has_csc(self) -> bool:
        return self.csc_offsets is not None

    def out_degrees(self) -> torch.Tensor:
        """(v_pad,) int32 out-degree of every (padded) vertex."""
        return self.row_offsets[1:] - self.row_offsets[:-1]


def _pad_offsets(row_offsets: np.ndarray, v_pad: int,
                 num_edges: int) -> np.ndarray:
    out = np.full(v_pad + 1, num_edges, dtype=np.int32)
    out[: row_offsets.shape[0]] = row_offsets.astype(np.int32)
    return out


def _pad_edges(arr: np.ndarray, e_pad: int, fill) -> np.ndarray:
    out = np.full(e_pad, fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def to_device(g: CsrGraph, *, with_csc: bool = False,
              device="cuda") -> DeviceGraph:
    """Upload a host CSR (and its CSC with ``with_csc``) to ``device``.

    The kernels index with int32, so graphs whose padded edge count
    reaches 2^31 - 2 (the JAX package's ``sizet64`` rule) are refused.
    """
    dev = resolve_device(device)
    v_pad = _pad(g.num_nodes)
    e_pad = _pad(g.num_edges)
    fields = {
        "row_offsets": _pad_offsets(g.row_offsets, v_pad, g.num_edges),
        "col_indices": _pad_edges(g.col_indices.astype(np.int32), e_pad, 0),
    }
    if with_csc:
        t = g.csc()
        fields["csc_offsets"] = _pad_offsets(t.row_offsets, v_pad,
                                             t.num_edges)
        fields["csc_indices"] = _pad_edges(t.col_indices.astype(np.int32),
                                           e_pad, 0)
        fields["csc_edge_dst"] = _pad_edges(
            np.repeat(np.arange(t.num_nodes, dtype=np.int32),
                      np.diff(t.row_offsets)), e_pad, v_pad)
    return from_numpy(fields, num_nodes=g.num_nodes, num_edges=g.num_edges,
                      v_pad=v_pad, e_pad=e_pad, device=dev,
                      undirected=bool(g.undirected))


def from_numpy(fields: dict, *, num_nodes: int, num_edges: int, v_pad: int,
               e_pad: int, device="cuda",
               undirected: bool = False) -> DeviceGraph:
    """Build a :class:`DeviceGraph` from padded numpy arrays, keyed by
    field name (``row_offsets``, ``col_indices`` and optionally the three
    ``csc_*`` arrays), such as ``np.asarray`` of a JAX ``DeviceGraph``'s
    fields. The padding is kept as given; shapes and offsets are checked
    here, on the host, because the kernels trust them."""
    dev = resolve_device(device)
    if e_pad >= 2**31 - 2:
        raise ValueError("graphs past 2^31 edges need 64-bit offsets, "
                         "which the int32 kernels do not take yet")
    unknown = set(fields) - set(_FIELDS)
    if unknown:
        raise ValueError(f"unknown DeviceGraph fields {sorted(unknown)}")
    shapes = {"row_offsets": v_pad + 1, "col_indices": e_pad,
              "csc_offsets": v_pad + 1, "csc_indices": e_pad,
              "csc_edge_dst": e_pad}
    tensors = {}
    for name, arr in fields.items():
        arr = np.asarray(arr)
        if arr.shape != (shapes[name],):
            raise ValueError(f"{name} has shape {arr.shape}, "
                             f"expected ({shapes[name]},)")
        if name.endswith("offsets"):
            d = np.diff(arr.astype(np.int64))
            if arr[0] != 0 or arr[-1] != num_edges or (d < 0).any():
                raise ValueError(f"{name} is not a nondecreasing offset "
                                 f"array from 0 to num_edges={num_edges}")
        elif name != "csc_edge_dst" and arr.size and (
                arr.min() < 0 or arr.max() >= max(num_nodes, 1)):
            raise ValueError(f"{name} holds vertex ids outside "
                             f"[0, {num_nodes})")
        tensors[name] = torch.from_numpy(
            np.array(arr, dtype=np.int32)).to(dev)
    if "row_offsets" not in tensors or "col_indices" not in tensors:
        raise ValueError("row_offsets and col_indices are required")
    csc = [n for n in _FIELDS[2:] if n in tensors]
    if csc and len(csc) != 3:
        raise ValueError("csc_offsets, csc_indices and csc_edge_dst go "
                         "together")
    if csc:
        # The pull kernel reads csc_edge_dst where its plain version reads
        # csc_offsets: the two must describe the same rows.
        off = np.asarray(fields["csc_offsets"]).astype(np.int64)
        rows = np.repeat(np.arange(v_pad, dtype=np.int32), np.diff(off))
        if not np.array_equal(
                np.asarray(fields["csc_edge_dst"])[:num_edges], rows):
            raise ValueError("csc_edge_dst does not match csc_offsets")
    return DeviceGraph(num_nodes=int(num_nodes), num_edges=int(num_edges),
                       v_pad=int(v_pad), e_pad=int(e_pad),
                       undirected=undirected, **tensors)
