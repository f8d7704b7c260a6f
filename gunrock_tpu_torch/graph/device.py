"""Device-resident graph: padded CSR (+ CSC) as torch tensors.

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
  * ``edge_src`` (source of each CSR edge) and ``csc_edge_dst``
    (destination of each CSC edge) use ``v_pad`` as the fill.
  * ``edge_values`` / ``csc_edge_values`` are padded with 0.0.

Offsets are int32, or int64 on a ``sizet64`` graph (the reference's
``--64bit-SizeT``), by the JAX package's rule: ``sizet64=None`` turns
them wide once ``e_pad >= 2**31 - 2``. Vertex ids and the per-edge id
arrays stay int32 either way. The kernels that read CSC row bounds (K1,
K3, K4, K6, K9) take them as int32: on a sizet64 graph below 2^31 edges
their wrappers narrow the (v_pad + 1) offsets exactly, and past it they
refuse the graph; the kernels that run over edge streams (K2, K5, K10)
take 64-bit lengths and positions.

The blocked-CSC and pull-v2 layouts of the JAX package are not built:
the Hopper pull kernels read the plain CSC, so every graph with a CSC
takes them, with ``inv_outdeg``, the per-vertex weight behind the JAX
package's ``pv2_wpr`` edge stream. Where the JAX package builds its own
in-edge layout for ``with_blocked_values`` (and no CSC unless asked),
the port builds the CSC in its place, so a graph uploaded
``with_blocked_values`` runs every pull the JAX package runs on it. The
flag also marks the graph as the JAX package marks it; with
``has_pull2`` it picks the routes of PageRank (power or loop), SSSP and
non-DO BFS (min-pull sweeps) by the JAX package's rules, so that the
routes and the iteration counts are the JAX package's.
``with_blocked_csc`` likewise builds the CSC and sets
``has_blocked_csc`` as the JAX package would: DO-BFS pulls with it
through kernel K1 and without it through K10, as the JAX package pulls
through its blocked kernels or ``bitmask_gather_cumsum``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from .csr import CsrGraph

__all__ = ["DeviceGraph", "to_device", "from_numpy", "round_up",
           "resolve_device", "sync", "sizet64_rule", "SIZET64_EDGES"]

LANE = 128

# Per-edge int32 arrays, the offsets (int32, or int64 on a sizet64
# graph), and the float32 edge values that from_numpy takes, with the
# expected length of each ("v" = v_pad + 1, "e" = e_pad).
_INT_FIELDS = {"row_offsets": "v", "col_indices": "e", "edge_src": "e",
               "csc_offsets": "v", "csc_indices": "e", "csc_edge_dst": "e"}
_FLOAT_FIELDS = {"edge_values": "e", "csc_edge_values": "e"}
_CSC = ("csc_offsets", "csc_indices", "csc_edge_dst")
# The JAX package's blocked layouts, which from_numpy drops.
_TPU_LAYOUT_PREFIXES = ("pv2_", "bcsc_")


def round_up(x: int, m: int = LANE) -> int:
    return ((x + m - 1) // m) * m


# Edges checked at a time by from_numpy's per-edge row-id check, so that
# its temporaries stay small at 2^31 edges.
_CHECK_EDGES = 1 << 26
# The padded edge count from which the JAX package holds 64-bit offsets
# unasked (``graph/device.py:424-425``).
SIZET64_EDGES = 2**31 - 2


def _pad(sz: int) -> int:
    """The JAX package's padding rule (``graph/device.py:419-420``)."""
    return round_up(max(sz, 1), 8192 if sz >= 8192 else LANE)


def sizet64_rule(e_pad: int, sizet64: Optional[bool], *,
                 blocked: bool = False) -> bool:
    """Whether a graph of ``e_pad`` padded edges holds int64 offsets: the
    JAX package's rule (``graph/device.py:424-428``). ``None`` means
    ``e_pad >= 2**31 - 2``; ``blocked`` (``with_blocked_csc`` or
    ``with_blocked_values``) with 64-bit offsets raises ``ValueError``,
    as there."""
    if sizet64 is None:
        sizet64 = e_pad >= SIZET64_EDGES
    if sizet64 and blocked:
        raise ValueError("with_blocked_csc and with_blocked_values need "
                         "32-bit offsets, as the JAX package's blocked "
                         "layouts do: a sizet64 graph (past 2^31 - 2 "
                         "padded edges, or asked) takes neither")
    return bool(sizet64)


def pull2_ok(v_pad: int) -> bool:
    """Whether the JAX package builds its pull-v2 layout for a graph of
    ``v_pad`` padded vertices asked ``with_blocked_values``
    (``graph/device.py:464-467``): that decides PageRank's power route."""
    return (32 <= v_pad // LANE <= 16384 and v_pad % 1024 == 0
            and os.environ.get("GUNROCK_PULL2", "1") != "0")


def resolve_device(device) -> torch.device:
    """``torch.device`` for a public call's ``device`` argument. Raises
    when CUDA is asked for and absent: nothing moves to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Padded CSR (+ optional CSC) on one torch device: int32 vertex ids
    and per-edge arrays, offsets int32 or, on a sizet64 graph, int64.

    ``num_nodes``/``num_edges`` are the exact counts; ``v_pad``/``e_pad``
    the padded lengths (see the module docstring).
    """

    num_nodes: int
    num_edges: int
    v_pad: int
    e_pad: int
    row_offsets: torch.Tensor                   # (v_pad+1,) int32/int64
    col_indices: torch.Tensor                   # (e_pad,)   int32
    edge_values: Optional[torch.Tensor] = None  # (e_pad,)   float32
    edge_src: Optional[torch.Tensor] = None     # (e_pad,)   int32, fill v_pad
    # Inverse CSR: csc row v lists the in-neighbors (sources) of v.
    csc_offsets: Optional[torch.Tensor] = None  # (v_pad+1,) like row_offsets
    csc_indices: Optional[torch.Tensor] = None  # (e_pad,)   int32
    csc_edge_values: Optional[torch.Tensor] = None  # (e_pad,) float32
    csc_edge_dst: Optional[torch.Tensor] = None  # (e_pad,)  int32, fill v_pad
    # 1/out-degree per vertex (0 where the degree is 0), float64 division
    # cast to float32 as the JAX package's build_pull2 computes it
    # (graph/pull2.py:93-98); set with the CSC.
    inv_outdeg: Optional[torch.Tensor] = None   # (v_pad,) float32
    undirected: bool = False
    # Built with_blocked_values, as the JAX package marks its graphs.
    has_blocked_values: bool = False
    # The JAX package would hold its pull-v2 layout for this graph
    # (pull2_ok): PageRank takes the power route.
    has_pull2: bool = False
    # The JAX package would hold its blocked CSC for this graph (asked
    # with_blocked_csc, or with_blocked_values without pull2_ok): DO-BFS
    # pulls through kernel K1; without it, through K10.
    has_blocked_csc: bool = False

    @property
    def device(self) -> torch.device:
        return self.row_offsets.device

    @property
    def has_csc(self) -> bool:
        return self.csc_offsets is not None

    @property
    def sizet64(self) -> bool:
        """The offsets are int64."""
        return self.row_offsets.dtype == torch.int64

    @property
    def n_values(self) -> int:
        """Entries of the value table a pull gathers from (kernel K3):
        one a vertex, ``v_pad``. A shard's view of a partitioned graph
        has more (``parallel.blocked.ShardView``)."""
        return self.v_pad

    def out_degrees(self) -> torch.Tensor:
        """(v_pad,) out-degree of every (padded) vertex, in the offsets'
        dtype."""
        return self.row_offsets[1:] - self.row_offsets[:-1]

    def reverse(self) -> "DeviceGraph":
        """The transpose, on the same tensors: its CSR is this graph's CSC
        and its CSC this graph's CSR, so a reduction over out-edges here
        is a pull over in-edges there (kernel K3). Needs the CSC and
        ``edge_src``, which becomes the reverse CSC's ``csc_edge_dst``."""
        if not self.has_csc or self.edge_src is None:
            raise ValueError("reverse() needs to_device(with_csc=True, "
                             "with_edge_src=True)")
        return dataclasses.replace(
            self, row_offsets=self.csc_offsets, col_indices=self.csc_indices,
            edge_values=self.csc_edge_values, edge_src=self.csc_edge_dst,
            csc_offsets=self.row_offsets, csc_indices=self.col_indices,
            csc_edge_values=self.edge_values, csc_edge_dst=self.edge_src,
            inv_outdeg=_inv_degree(self.csc_offsets))


def _inv_degree(offsets: torch.Tensor) -> torch.Tensor:
    """(v_pad,) float32 1/degree of each row of an offset array, 0 where
    the degree is 0: float64 division cast to float32, as the JAX
    package's ``build_pull2`` computes it (``graph/pull2.py:93-98``)."""
    deg = (offsets[1:] - offsets[:-1]).double()
    return torch.where(deg > 0, 1.0 / deg, 0.0).float()


def _pad_offsets(row_offsets: np.ndarray, v_pad: int, num_edges: int,
                 dtype=np.int32) -> np.ndarray:
    out = np.full(v_pad + 1, num_edges, dtype=dtype)
    out[: row_offsets.shape[0]] = row_offsets.astype(dtype)
    return out


def _pad_edges(arr: np.ndarray, e_pad: int, fill) -> np.ndarray:
    out = np.full(e_pad, fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _seg_ids(offsets: np.ndarray) -> np.ndarray:
    """Row id of every edge of an offset array (COO rows)."""
    off = np.asarray(offsets).astype(np.int64)
    return np.repeat(np.arange(off.shape[0] - 1, dtype=np.int32),
                     np.diff(off))


def _host_fields(g: CsrGraph, t: Optional[CsrGraph], v_pad: int,
                 e_pad: int, *, with_edge_values: bool,
                 with_edge_src: bool, off_dtype=np.int32) -> dict:
    """Padded numpy arrays of ``g`` and, when ``t`` (the transpose of
    ``g``) is given, of its CSC, the offsets in ``off_dtype``."""
    def values(h: CsrGraph) -> np.ndarray:
        v = h.edge_values
        if v is None:
            v = np.ones(h.num_edges, dtype=np.float32)
        return _pad_edges(v.astype(np.float32), e_pad, np.float32(0.0))

    fields = {
        "row_offsets": _pad_offsets(g.row_offsets, v_pad, g.num_edges,
                                    off_dtype),
        "col_indices": _pad_edges(g.col_indices.astype(np.int32), e_pad, 0),
    }
    if with_edge_values:
        fields["edge_values"] = values(g)
    if with_edge_src:
        fields["edge_src"] = _pad_edges(_seg_ids(g.row_offsets), e_pad,
                                        v_pad)
    if t is not None:
        fields["csc_offsets"] = _pad_offsets(t.row_offsets, v_pad,
                                             t.num_edges, off_dtype)
        fields["csc_indices"] = _pad_edges(t.col_indices.astype(np.int32),
                                           e_pad, 0)
        fields["csc_edge_dst"] = _pad_edges(_seg_ids(t.row_offsets), e_pad,
                                            v_pad)
        if with_edge_values:
            fields["csc_edge_values"] = values(t)
    return fields


def _csc_from_csr(arrays: dict, num_nodes: int, num_edges: int, v_pad: int,
                  e_pad: int) -> dict:
    """The padded CSC fields (with ``csc_edge_values`` when the arrays
    hold ``edge_values``) of padded CSR arrays, built on the host as
    :func:`to_device` builds them."""
    ev = arrays.get("edge_values")
    g = CsrGraph(num_nodes=num_nodes,
                 row_offsets=arrays["row_offsets"][:num_nodes + 1]
                 .astype(np.int64),
                 col_indices=arrays["col_indices"][:num_edges],
                 edge_values=None if ev is None else ev[:num_edges])
    fields = _host_fields(g, g.csc(), v_pad, e_pad,
                          with_edge_values=ev is not None,
                          with_edge_src=False)
    return {k: v for k, v in fields.items() if k.startswith("csc_")}


def to_device(g: CsrGraph, *, with_csc: bool = False,
              with_edge_values: bool = False, with_edge_src: bool = False,
              with_blocked_csc: bool = False,
              with_blocked_values: bool = False,
              sizet64: Optional[bool] = None,
              device="cuda") -> DeviceGraph:
    """Upload a host CSR (and its CSC with ``with_csc``) to ``device``.

    ``with_edge_values`` uploads the edge values (ones when the graph has
    none), on the CSC too; ``with_edge_src`` the per-edge source ids;
    ``with_blocked_csc`` and ``with_blocked_values`` build the CSC (the
    port's kernels read it in place of the JAX package's blocked layouts)
    and mark the graph as the JAX package marks it, for the routes of
    BFS, PageRank, SSSP, BC and CC (see the module docstring).

    ``sizet64`` holds the offsets as int64 (the reference's
    ``--64bit-SizeT``); ``None`` turns it on once ``e_pad >= 2**31 - 2``,
    and with either blocked flag it raises ``ValueError``, as in the JAX
    package (:func:`sizet64_rule`). The JAX package also refuses sizet64
    outside its x64 mode; PyTorch holds int64 tensors in any mode, so the
    port has no such switch and no such error.
    """
    dev = resolve_device(device)
    v_pad = _pad(g.num_nodes)
    e_pad = _pad(g.num_edges)
    wide = sizet64_rule(e_pad, sizet64,
                        blocked=with_blocked_csc or with_blocked_values)
    with_csc = with_csc or with_blocked_csc or with_blocked_values
    fields = _host_fields(g, g.csc() if with_csc else None, v_pad, e_pad,
                          with_edge_values=with_edge_values,
                          with_edge_src=with_edge_src,
                          off_dtype=np.int64 if wide else np.int32)
    return from_numpy(fields, num_nodes=g.num_nodes, num_edges=g.num_edges,
                      v_pad=v_pad, e_pad=e_pad, device=dev,
                      undirected=bool(g.undirected),
                      with_blocked_csc=with_blocked_csc,
                      with_blocked_values=with_blocked_values,
                      sizet64=wide)


def _check_seg_ids(name: str, arr: np.ndarray, offsets: np.ndarray,
                   num_edges: int) -> None:
    """``arr[:num_edges]`` must be the row id of every edge of
    ``offsets``; compared a group of rows at a time, about
    ``_CHECK_EDGES`` edges a group, so no edge-scale temporary is made."""
    off = np.asarray(offsets).astype(np.int64)
    rows = off.shape[0] - 1
    starts = np.searchsorted(off, np.arange(0, num_edges, _CHECK_EDGES),
                             side="right") - 1
    bounds = np.unique(np.append(starts.clip(0, rows), rows))
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        want = np.repeat(np.arange(r0, r1, dtype=np.int32),
                         np.diff(off[r0:r1 + 1]))
        if not np.array_equal(arr[off[r0]:off[r1]], want):
            raise ValueError(f"{name} does not match its offsets")


def from_numpy(fields: dict, *, num_nodes: int, num_edges: int, v_pad: int,
               e_pad: int, device="cuda", undirected: bool = False,
               with_blocked_csc: bool = False,
               with_blocked_values: bool = False,
               sizet64: Optional[bool] = None,
               timings: Optional[dict] = None) -> DeviceGraph:
    """Build a :class:`DeviceGraph` from padded numpy arrays keyed by
    field name, such as ``np.asarray`` of a JAX ``DeviceGraph``'s fields:
    ``row_offsets`` and ``col_indices`` (required), ``edge_values``,
    ``edge_src``, and the CSC's ``csc_offsets``, ``csc_indices``,
    ``csc_edge_dst`` (these three together) and ``csc_edge_values``.

    The JAX package's TPU layouts (keys starting ``pv2_`` or ``bcsc_``)
    are ignored: the Hopper kernels read the plain CSC. Pass
    ``with_blocked_csc`` and ``with_blocked_values`` as the JAX graph was
    built (``has_blocked_csc``, ``has_blocked_values``); without the
    CSC's keys the CSC is then built here from the CSR (with
    ``csc_edge_values`` from ``edge_values``), as :func:`to_device`
    builds it. With the CSC,
    ``inv_outdeg`` is computed here from ``row_offsets``. Any other key
    is refused.

    Offsets are held as int64 with ``sizet64``; ``None`` keeps int64
    offsets given as int64 (so a JAX sizet64 graph loads unchanged) and
    turns them wide once ``e_pad >= 2**31 - 2``, by :func:`sizet64_rule`
    (which also refuses the blocked flags with them). Offsets that cannot
    hold ``num_edges`` in int32 are refused.

    The padding is kept as given; shapes, offsets and per-edge row ids
    are checked here, on the host, because the kernels trust them: the
    checks make no edge-scale temporary, and arrays already of their
    dtype are not copied on the host before the upload. ``timings``: pass
    a dict to receive the seconds of the host checks (``check_s``) and of
    the upload (``upload_s``)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    fields = {k: v for k, v in fields.items()
              if not k.startswith(_TPU_LAYOUT_PREFIXES) and v is not None}
    unknown = set(fields) - set(_INT_FIELDS) - set(_FLOAT_FIELDS)
    if unknown:
        raise ValueError(f"unknown DeviceGraph fields {sorted(unknown)}")
    if "row_offsets" not in fields or "col_indices" not in fields:
        raise ValueError("row_offsets and col_indices are required")
    csc = [n for n in _CSC if n in fields]
    if csc and len(csc) != 3:
        raise ValueError("csc_offsets, csc_indices and csc_edge_dst go "
                         "together")
    if "csc_edge_values" in fields and not csc:
        raise ValueError("csc_edge_values needs the CSC")
    if sizet64 is None and any(
            np.asarray(v).dtype == np.int64 for k, v in fields.items()
            if k.endswith("offsets")):
        sizet64 = True
    wide = sizet64_rule(e_pad, sizet64,
                        blocked=with_blocked_csc or with_blocked_values)
    if not wide and num_edges > 2**31 - 1:
        raise ValueError(f"int32 offsets cannot hold num_edges={num_edges}:"
                         " pass sizet64=True or None")
    lengths = {"v": v_pad + 1, "e": e_pad}
    arrays = {}
    for name, arr in fields.items():
        arr = np.asarray(arr)
        want = lengths[{**_INT_FIELDS, **_FLOAT_FIELDS}[name]]
        if arr.shape != (want,):
            raise ValueError(f"{name} has shape {arr.shape}, "
                             f"expected ({want},)")
        if name.endswith("offsets"):
            d = np.diff(arr.astype(np.int64))
            if arr[0] != 0 or arr[-1] != num_edges or (d < 0).any():
                raise ValueError(f"{name} is not a nondecreasing offset "
                                 f"array from 0 to num_edges={num_edges}")
            dtype = np.int64 if wide else np.int32
        elif name in _INT_FIELDS:
            if name in ("col_indices", "csc_indices") and arr.size and (
                    arr.min() < 0 or arr.max() >= max(num_nodes, 1)):
                raise ValueError(f"{name} holds vertex ids outside "
                                 f"[0, {num_nodes})")
            dtype = np.int32
        else:
            dtype = np.float32
        arrays[name] = np.asarray(arr, dtype=dtype)
    if (with_blocked_csc or with_blocked_values) and not csc:
        arrays.update(_csc_from_csr(arrays, int(num_nodes), int(num_edges),
                                    v_pad, e_pad))
        csc = list(_CSC)
    # The pull kernels read per-edge row ids where their plain versions
    # read offsets: the two must describe the same rows.
    if "edge_src" in arrays:
        _check_seg_ids("edge_src", arrays["edge_src"],
                       arrays["row_offsets"], num_edges)
    if csc:
        _check_seg_ids("csc_edge_dst", arrays["csc_edge_dst"],
                       arrays["csc_offsets"], num_edges)
    t1 = time.perf_counter()
    tensors = {k: _upload(v, dev) for k, v in arrays.items()}
    if csc:
        tensors["inv_outdeg"] = _inv_degree(tensors["row_offsets"])
    if timings is not None:
        sync(dev)
        timings.update(check_s=t1 - t0, upload_s=time.perf_counter() - t1)
    return DeviceGraph(num_nodes=int(num_nodes), num_edges=int(num_edges),
                       v_pad=int(v_pad), e_pad=int(e_pad),
                       undirected=undirected,
                       has_blocked_values=bool(with_blocked_values),
                       has_pull2=bool(with_blocked_values) and pull2_ok(v_pad),
                       has_blocked_csc=bool(with_blocked_csc) or (
                           bool(with_blocked_values) and not pull2_ok(v_pad)),
                       **tensors)


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One copy of a host array on ``dev``, never a view of the caller's
    array (a read-only one, such as ``np.asarray`` of a JAX array, is
    copied on the host first, as torch shares no read-only memory)."""
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        return torch.from_numpy(np.array(arr)).to(dev)
    return torch.from_numpy(arr).to(dev, copy=True)
