"""Value pulls over the CSC: kernels K3 (``pull_reduce2``), K4
(``pull_power_iters``), K6 (``pull_min_sweeps``) and K9
(``brandes_fwd_levels``, ``brandes_bwd_levels``).

Counterpart of :mod:`gunrock_tpu.ops.pull2` (``pull_reduce2``,
``pull_power_iters``, ``pull_min_sweeps``, ``brandes_fwd_levels``,
``brandes_bwd_levels``) and of ``pull_vertex_reduce`` in
:mod:`gunrock_tpu.ops.pallas_kernels`. Every value primitive reads one
operation::

    out[v] = init[v] (+) ((+) over in-edges (u, v) of f(values[u], w_uv))

with (+) ``sum`` or ``min`` and f ``none`` (values[u]), ``add``
(values[u] + w), ``mul`` (values[u] * w) or ``incr`` (values[u] + 1). The
weight stream is ``val`` (the CSC's edge values) or ``wpr`` (1/out-degree
of the source, ``graph.inv_outdeg``). The JAX package computes it on its
TPU pull-v2 layout; here the kernels read the plain CSC (``csc_indices``
and ``csc_offsets``) of any graph uploaded ``with_csc``.

K3 also reads one shard of a partitioned graph
(:class:`gunrock_tpu_torch.parallel.blocked.ShardView`): its rows are
the shard's S vertices, and ``values`` is the shard's value table of
``graph.n_values`` entries, longer than the rows where it holds the
ghost slots of the shard's remote in-neighbours. A graph's table is its
``v_pad`` vertices.

As in :mod:`gunrock_tpu_torch.ops.kernels`, each kernel has a plain
PyTorch version (``*_plain``), a wrapper that launches the CUDA kernel in
``csrc/pull_kernels.cu`` for CUDA tensors (or raises), and a launch count
in :data:`~gunrock_tpu_torch.ops.kernels.LAUNCHES`. The wrappers take the
plain versions only for tensors that lie on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .kernels import LAUNCHES, _check, _launch, _route, row_bounds32
from .segment import row_reduce_sorted

__all__ = ["pull_reduce2", "pull_reduce2_plain", "pull_power_iters",
           "pull_power_iters_plain", "pull_min_sweeps",
           "pull_min_sweeps_plain", "pull_vertex_reduce",
           "brandes_fwd_levels", "brandes_fwd_levels_plain",
           "brandes_bwd_levels", "brandes_bwd_levels_plain", "PULL_TILE"]

# CSC edges a block reduces in the pass shared by K3, K4, K6 and K9
# (kTile in csrc/pull_kernels.cu, which refuses any other value). It fixes
# the order of every sum, so two launches on the same input agree bit for
# bit.
PULL_TILE = 2048

# The activity gate of K6 and K9 (kGroupWords in csrc/pull_kernels.cu): a
# round marks which groups of source vertices are active in this many
# 32-bit words, one bit a group of group_size(v_pad) consecutive vertices.
GROUP_WORDS = 32


def group_size(v_pad: int) -> int:
    """Vertices in one source group of the K6/K9 gate: the least power of
    two that puts every vertex of ``v_pad`` in one of 32 * GROUP_WORDS
    groups."""
    size = 1
    while (v_pad - 1) // size >= 32 * GROUP_WORDS:
        size *= 2
    return size


_OPS = {"sum": 0, "min": 1}
_FNS = {"none": 0, "add": 1, "mul": 2, "incr": 3}
_NO_WEIGHTS, _PER_EDGE, _PER_SOURCE = 0, 1, 2


def _weights(graph, wmode: str, weights: str):
    """(tensor, kind) of the weight stream ``wmode`` reads, or
    (None, no weights)."""
    if wmode not in _FNS:
        raise ValueError(f"unknown wmode {wmode!r}")
    if wmode not in ("add", "mul"):
        return None, _NO_WEIGHTS
    if weights == "val":
        if graph.csc_edge_values is None:
            raise ValueError("the val weights need to_device("
                             "with_csc=True, with_edge_values=True)")
        return graph.csc_edge_values, _PER_EDGE
    if weights == "wpr":
        if graph.inv_outdeg is None:
            raise ValueError("the wpr weights need graph.inv_outdeg, which "
                             "to_device(with_csc=True) computes")
        return graph.inv_outdeg, _PER_SOURCE
    raise ValueError(f"unknown weights {weights!r}")


def _validate(graph, op: str, values: torch.Tensor,
              n: Optional[int] = None) -> None:
    """Check ``op``, the CSC and that ``values`` has ``n`` entries
    (default ``v_pad``; K3's value table has ``graph.n_values``)."""
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}")
    if not graph.has_csc:
        raise ValueError("value pulls need to_device(with_csc=True)")
    n = graph.v_pad if n is None else n
    if values.shape != (n,):
        raise ValueError(f"values have shape {tuple(values.shape)}, "
                         f"expected ({n},)")


def pull_reduce2_plain(values: torch.Tensor, graph, *, op: str = "sum",
                       wmode: str = "none",
                       init: Optional[torch.Tensor] = None,
                       weights: str = "val") -> torch.Tensor:
    """Gather, f in float32, :func:`row_reduce_sorted` over the CSC rows
    (sums in float64, so this version is the accurate reference the
    kernel is held to; ``min`` is exact either way), then (+) ``init``."""
    _validate(graph, op, values, graph.n_values)
    w, kind = _weights(graph, wmode, weights)
    src = graph.csc_indices.long()
    x = values.float()[src]
    if w is not None:
        wx = w if kind == _PER_EDGE else w[src]
        x = x + wx if wmode == "add" else x * wx
    elif wmode == "incr":
        x = x + 1.0
    out = row_reduce_sorted(x, graph.csc_offsets, op=op)
    if init is None:
        return out
    init = init.float()
    return init + out if op == "sum" else torch.minimum(init, out)


def _scratch(graph, device, *, gated: bool = False
             ) -> tuple[torch.Tensor, list[int]]:
    """K3/K4/K6/K9 scratch as one buffer of 4-byte slots, and the
    addresses the kernels take, in their order: the first row of each
    tile and one past the last (int32), per-row totals, per-tile head and
    tail partials, and a value table of ``graph.n_values`` (the
    per-source values folded with the ``wpr`` weights; K9's gated
    values), all float32;
    ``gated`` (K6, K9) adds a mark a tile (int32) and two rounds' source
    group bits (``GROUP_WORDS`` words each). One allocation a call, never
    cleared (the kernels read no slot they did not write in the same
    call); the caller holds the buffer until the launch is enqueued."""
    ntiles = -(-graph.num_edges // PULL_TILE)
    sizes = (ntiles + 1, graph.v_pad, ntiles, ntiles, graph.n_values)
    if gated:
        sizes += (ntiles, 2 * GROUP_WORDS)
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=device)
    ptrs, at = [], buf.data_ptr()
    for n in sizes:
        ptrs.append(at)
        at += 4 * n
    return buf, ptrs


def _check_float(name: str, t: torch.Tensor, n: int,
                 device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32 or \
            not t.is_contiguous() or t.shape != (n,):
        raise ValueError(f"{name} must be a contiguous ({n},) float32 "
                         f"tensor on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_graph(graph, w: Optional[torch.Tensor], kind: int,
                 device: torch.device) -> torch.Tensor:
    """Check the CSC and the weights; returns the int32 row bounds the
    kernels read (:func:`~gunrock_tpu_torch.ops.kernels.row_bounds32`)."""
    offsets = row_bounds32(graph)
    _check("csc_indices", graph.csc_indices, device)
    _check("csc_offsets", offsets, device)
    if w is not None:
        _check_float("weights", w,
                     graph.e_pad if kind == _PER_EDGE else graph.n_values,
                     device)
    return offsets


def pull_reduce2(values: torch.Tensor, graph, *, op: str = "sum",
                 wmode: str = "none", init: Optional[torch.Tensor] = None,
                 weights: str = "val") -> torch.Tensor:
    """(v_pad,) float32 ``out[v] = init[v] (+) ((+) over CSC row v of
    f(values[u], w))``; rows without in-edges get ``init``, or the
    identity (0 for ``sum``, +inf for ``min``).

    Kernel K3 (replaces the Pallas ``pull_reduce2``,
    ``gunrock_tpu/ops/pull2.py:268``, and ``pull_vertex_reduce`` over the
    sharded layouts of ``gunrock_tpu/parallel/blocked.py``). ``values``
    is the (graph.n_values,) table, ``init`` (v_pad,); both are cast to
    float32. Two launches on the same input give bitwise equal output."""
    tensors = [values, graph.csc_indices] + ([] if init is None else [init])
    if not _route(*tensors):
        return pull_reduce2_plain(values, graph, op=op, wmode=wmode,
                                  init=init, weights=weights)
    _validate(graph, op, values, graph.n_values)
    w, kind = _weights(graph, wmode, weights)
    dev = graph.csc_indices.device
    values = values.to(torch.float32).contiguous()
    _check_float("values", values, graph.n_values, dev)
    if init is not None:
        init = init.to(torch.float32).contiguous()
        _check_float("init", init, graph.v_pad, dev)
    offsets = _check_graph(graph, w, kind, dev)
    buf, scratch = _scratch(graph, dev)
    out = torch.empty(graph.v_pad, dtype=torch.float32, device=dev)
    _launch(_build.load().gr_pull_reduce, values.data_ptr(),
            graph.csc_indices.data_ptr(), offsets.data_ptr(),
            graph.num_edges, graph.v_pad, graph.n_values,
            0 if w is None else w.data_ptr(), kind, _OPS[op], _FNS[wmode],
            0 if init is None else init.data_ptr(), PULL_TILE, *scratch,
            out.data_ptr(), device=dev)
    LAUNCHES["pull_reduce2"] += 1
    return out


def pull_vertex_reduce(values: torch.Tensor, graph, *, op: str = "sum",
                       wmode: str = "none") -> torch.Tensor:
    """(v_pad,) per-vertex reduce over in-edges with the ``val`` weights:
    the JAX package's ``pull_vertex_reduce``
    (``gunrock_tpu/ops/pallas_kernels.py:540``), which dispatches to
    ``pull_reduce2`` on its pull-v2 graphs and runs its v1 blocked kernel
    on the others. Both compute this function, so both go to K3 here."""
    return pull_reduce2(values, graph, op=op, wmode=wmode)


def pull_power_iters_plain(graph, init: torch.Tensor, *, iters: int,
                           damping: float, reset: float,
                           threshold: float = 0.0,
                           weights: str = "wpr"):
    """``iters`` rounds of the plain sum pull with the epilogue
    ``rank' = v < num_nodes ? reset + damping * acc : 0`` in float32, and
    the count of ``|rank' - rank| > threshold`` over all v_pad slots."""
    if iters < 1:
        raise ValueError("iters must be at least 1")
    vmask = torch.arange(graph.v_pad, device=init.device) < graph.num_nodes
    d32 = torch.tensor(damping, dtype=torch.float32, device=init.device)
    r32 = torch.tensor(reset, dtype=torch.float32, device=init.device)
    rank = init.float()
    changed = []
    for _ in range(iters):
        acc = pull_reduce2_plain(rank, graph, op="sum", wmode="mul",
                                 weights=weights)
        fresh = torch.where(vmask, r32 + d32 * acc, 0.0)
        changed.append(((fresh - rank).abs() > threshold).sum())
        rank = fresh
    return rank, torch.stack(changed).to(torch.int32)


def pull_power_iters(graph, init: torch.Tensor, *, iters: int,
                     damping: float, reset: float, threshold: float = 0.0,
                     weights: str = "wpr"):
    """Run ``iters`` PageRank rounds ``rank' = mask * (reset + damping *
    sum over in-edges of rank[u] * w_uv)`` from one host call; returns
    ``(rank, changed)`` with ``changed`` the (iters,) int32 count of
    ``|rank' - rank| > threshold`` per round.

    Kernel K4 (replaces the Pallas ``pull_power_iters``,
    ``gunrock_tpu/ops/pull2.py:842``): each round is K3's pass 1 (sum,
    the ``wpr`` weights folded into the rank once a vertex first) and a
    finish of K4's own, the epilogue, the change count and the next
    round's fold fused, enqueued on the current stream with no host read;
    each round equals :func:`pull_reduce2` (sum, ``mul``) followed by the
    epilogue bit for bit. Two rank buffers ping-pong, and the last
    round's is returned."""
    if not _route(init, graph.csc_indices):
        return pull_power_iters_plain(graph, init, iters=iters,
                                      damping=damping, reset=reset,
                                      threshold=threshold, weights=weights)
    if iters < 1:
        raise ValueError("iters must be at least 1")
    _validate(graph, "sum", init)
    w, kind = _weights(graph, "mul", weights)
    dev = graph.csc_indices.device
    init = init.to(torch.float32).contiguous()
    _check_float("init", init, graph.v_pad, dev)
    offsets = _check_graph(graph, w, kind, dev)
    buf, scratch = _scratch(graph, dev)
    ping = torch.empty(graph.v_pad, dtype=torch.float32, device=dev)
    pong = torch.empty_like(ping)
    changed = torch.zeros(iters, dtype=torch.int32, device=dev)
    _launch(_build.load().gr_pull_power_iters, init.data_ptr(),
            ping.data_ptr(), pong.data_ptr(), graph.csc_indices.data_ptr(),
            offsets.data_ptr(), graph.num_edges, graph.v_pad,
            graph.num_nodes, w.data_ptr(), kind, float(damping),
            float(reset), float(threshold), iters, PULL_TILE, *scratch,
            changed.data_ptr(), device=dev)
    LAUNCHES["pull_power_iters"] += 1
    return (ping if iters % 2 else pong), changed


def _check_sweeps(sweeps: int, wmode: str) -> None:
    if sweeps < 1:
        raise ValueError("sweeps must be at least 1")
    if wmode not in ("none", "add", "incr"):
        raise ValueError(f"min sweeps take wmode none, add or incr, not "
                         f"{wmode!r}")


def pull_min_sweeps_plain(graph, init: torch.Tensor, *, sweeps: int,
                          wmode: str = "add", weights: str = "val"):
    """``sweeps`` rounds of :func:`pull_reduce2_plain` with ``op="min"``
    and ``init`` the current distances (Jacobi: each sweep reads the
    previous one's result), and the count of ``d'[v] < d[v]`` a sweep."""
    _check_sweeps(sweeps, wmode)
    d = init.float()
    changed = []
    for _ in range(sweeps):
        fresh = pull_reduce2_plain(d, graph, op="min", wmode=wmode, init=d,
                                   weights=weights)
        changed.append((fresh < d).sum())
        d = fresh
    return d, torch.stack(changed).to(torch.int32)


def pull_min_sweeps(graph, init: torch.Tensor, *, sweeps: int,
                    wmode: str = "add", weights: str = "val"):
    """Run ``sweeps`` min-pull sweeps ``d'[v] = min(d[v], min over CSC row
    v of f(d[u], w))`` from ``init`` ((v_pad,), +inf for unreached) in one
    host call; returns ``(dist, changed)`` with ``changed`` the (sweeps,)
    int32 count of improved vertices a sweep.

    Kernel K6 (replaces the Pallas ``pull_min_sweeps``,
    ``gunrock_tpu/ops/pull2.py:554``). The TPU kernel sweeps Gauss-Seidel,
    odd sweeps backward, and only a zero on an even sweep certifies the
    fixpoint. Here every sweep is Jacobi (two buffers ping-pong), so its
    result and count equal the plain version's and a zero count on any
    sweep is a fixpoint; callers that test even sweeps stay sound. The
    fixpoint is the one the TPU kernel reaches: the least distances over
    walks, each step rounded as float32 ``d[u] + w``.

    As the TPU kernel skips the groups whose sources did not change, a
    sweep gathers only from the active groups of ``group_size(v_pad)``
    consecutive sources: those holding a vertex not +inf in ``init`` on
    the call's first sweep, then one the previous sweep lowered; a tile
    of edges with none costs its index loads. This is exact: an inactive
    source u last entered the min for each of its out-neighbours v when
    it last changed (or is +inf, and f(+inf, w) = +inf for ``none``,
    ``add`` and ``incr``, the only modes taken), and d[v] only fell
    since, so f(d[u], w) >= d[v] (the proof is in
    ``csrc/pull_kernels.cu``); reading more sources than the active ones
    adds only terms the plain version takes too. So the first sweep from
    one seed gathers little, and a sweep in which most groups changed
    costs about a full pull."""
    _check_sweeps(sweeps, wmode)
    if not _route(init, graph.csc_indices):
        return pull_min_sweeps_plain(graph, init, sweeps=sweeps,
                                     wmode=wmode, weights=weights)
    _validate(graph, "min", init)
    w, kind = _weights(graph, wmode, weights)
    dev = graph.csc_indices.device
    init = init.to(torch.float32).contiguous()
    _check_float("init", init, graph.v_pad, dev)
    offsets = _check_graph(graph, w, kind, dev)
    buf, scratch = _scratch(graph, dev, gated=True)
    ping = torch.empty(graph.v_pad, dtype=torch.float32, device=dev)
    pong = torch.empty_like(ping)
    changed = torch.zeros(sweeps, dtype=torch.int32, device=dev)
    _launch(_build.load().gr_pull_min_sweeps, init.data_ptr(),
            ping.data_ptr(), pong.data_ptr(), graph.csc_indices.data_ptr(),
            offsets.data_ptr(), graph.num_edges, graph.v_pad,
            0 if w is None else w.data_ptr(), kind, _FNS[wmode], sweeps,
            PULL_TILE, *scratch, changed.data_ptr(), device=dev)
    LAUNCHES["pull_min_sweeps"] += 1
    return (ping if sweeps % 2 else pong), changed


def _check_levels(graph, levels: int, *arrays: torch.Tensor) -> None:
    if levels < 1:
        raise ValueError("levels must be at least 1")
    for t in arrays:
        _validate(graph, "sum", t)


def brandes_fwd_levels_plain(graph, lab: torch.Tensor, sig: torch.Tensor, *,
                             d0: int, levels: int):
    """``levels`` forward Brandes levels, each a :func:`pull_reduce2_plain`
    sum of the gated path counts (sums in float64, the accurate reference
    the kernel is held to) and the epilogue in float32."""
    _check_levels(graph, levels, lab, sig)
    lab, sig = lab.float(), sig.float()
    counts = []
    for d in range(d0, d0 + levels):
        gated = torch.where(lab == float(d - 1), sig, 0.0)
        acc = pull_reduce2_plain(gated, graph, op="sum")
        open_ = lab == float("inf")
        sig = torch.where(open_, sig + acc, sig)
        new = open_ & (sig > 0)
        lab = torch.where(new, float(d), lab)
        counts.append(new.sum())
    return lab, sig, torch.stack(counts).to(torch.int32)


def brandes_bwd_levels_plain(graph, lab: torch.Tensor, sig: torch.Tensor,
                             delta: torch.Tensor, *, t0: int, levels: int):
    """``levels`` backward Brandes rings, as
    :func:`brandes_fwd_levels_plain`."""
    _check_levels(graph, levels, lab, sig, delta)
    lab, sig, delta = lab.float(), sig.float(), delta.float()
    counts = []
    for t in range(t0, t0 - levels, -1):
        gated = torch.where(lab == float(t + 1),
                            (1.0 + delta) / sig.clamp(min=1e-30), 0.0)
        acc = pull_reduce2_plain(gated, graph, op="sum")
        ring = lab == float(t)
        delta = torch.where(ring, sig * (delta + acc), delta)
        counts.append(ring.sum())
    return delta, torch.stack(counts).to(torch.int32)


def _brandes(graph, lab, sig, delta, *, fwd: bool, level0: int,
             levels: int):
    """Launch K9 on copies of the state; returns them and the counts."""
    dev = graph.csc_indices.device
    state = []
    for name, t in (("lab", lab), ("sig", sig), ("delta", delta)):
        if t is None:
            state.append(None)
            continue
        t = t.to(torch.float32).clone(memory_format=torch.contiguous_format)
        _check_float(name, t, graph.v_pad, dev)
        state.append(t)
    offsets = _check_graph(graph, None, _NO_WEIGHTS, dev)
    buf, (tile_rows, rowval, head, tail, gated, tmark,
          active) = _scratch(graph, dev, gated=True)
    counts = torch.zeros(levels, dtype=torch.int32, device=dev)
    lab, sig, delta = state
    _launch(_build.load().gr_brandes_levels, lab.data_ptr(), sig.data_ptr(),
            0 if delta is None else delta.data_ptr(),
            graph.csc_indices.data_ptr(), offsets.data_ptr(),
            graph.num_edges, graph.v_pad, int(fwd), int(level0), levels,
            PULL_TILE, tile_rows, gated, rowval, head, tail, tmark, active,
            counts.data_ptr(), device=dev)
    LAUNCHES["brandes_levels"] += 1
    return lab, sig, delta, counts


def brandes_fwd_levels(graph, lab: torch.Tensor, sig: torch.Tensor, *,
                       d0: int, levels: int):
    """Run ``levels`` forward Brandes levels (depths ``d0`` .. ``d0 +
    levels - 1``) over the CSC. ``lab`` is the (v_pad,) float32 depth
    (+inf unreached), ``sig`` the running path counts. Level d sums, over
    the in-edges of each undiscovered vertex, ``sig`` of the sources at
    depth d - 1, and labels d the vertices whose count becomes positive.
    Returns ``(lab', sig', discovered)``, ``discovered`` the (levels,)
    int32 count of vertices a level labelled; the inputs are not changed.

    Kernel K9 (replaces the Pallas ``_brandes_kernel``,
    ``gunrock_tpu/ops/pull2.py:895``): every level is enqueued from one
    host call with no host read. Two launches on the same input agree
    bit for bit, and with K3's sum over the gated values followed by the
    epilogue (:func:`pull_reduce2` then torch).

    As the TPU kernel skips quiet groups, a level reads only what can
    change its result: the tiles of edges into the rows that read a
    total (forward the undiscovered rows, backward the ring), and in
    them the values of the source groups that hold a gated source
    (depth d - 1). Both are exact: every other source's gated value is
    +0.0, and adding +0.0 to a non-negative partial leaves its bits as
    they are. So the levels past the frontier, and the deep and shallow
    rings, cost their V-wide passes and little else."""
    if not _route(lab, sig, graph.csc_indices):
        return brandes_fwd_levels_plain(graph, lab, sig, d0=d0,
                                        levels=levels)
    _check_levels(graph, levels, lab, sig)
    lab, sig, _, counts = _brandes(graph, lab, sig, None, fwd=True,
                                   level0=d0, levels=levels)
    return lab, sig, counts


def brandes_bwd_levels(graph, lab: torch.Tensor, sig: torch.Tensor,
                       delta: torch.Tensor, *, t0: int, levels: int):
    """Run ``levels`` backward Brandes rings (``t0`` down to ``t0 - levels
    + 1``): ring t sets ``delta[u] = sig[u] * (delta[u] + sum over
    in-neighbours v at depth t + 1 of (1 + delta[v]) / sig[v])`` for the
    vertices at depth t. The pull reduces over in-edges while the
    recurrence runs over out-edges, so the edge set must be symmetric.
    Returns ``(delta', ring_size)``, the (levels,) int32 count of vertices
    a ring updated; the inputs are not changed.

    Kernel K9 (replaces the Pallas ``_brandes_kernel``,
    ``gunrock_tpu/ops/pull2.py:895``), as :func:`brandes_fwd_levels`:
    ring t reads only the tiles of edges into the ring's rows, and in
    them the sources at depth t + 1."""
    if not _route(lab, sig, delta, graph.csc_indices):
        return brandes_bwd_levels_plain(graph, lab, sig, delta, t0=t0,
                                        levels=levels)
    _check_levels(graph, levels, lab, sig, delta)
    _, _, delta, counts = _brandes(graph, lab, sig, delta, fwd=False,
                                   level0=t0, levels=levels)
    return delta, counts
