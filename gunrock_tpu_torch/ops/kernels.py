"""Packed bitmasks, the CUDA kernels of the DO-BFS path and those of
the SSSP push round.

Counterpart of :mod:`gunrock_tpu.ops.pallas_kernels` for the functions
the ported paths call: ``words_for``, ``pack_bitmask``,
``unpack_bitmask``, ``bitmask_gather``, ``pull_reached_words`` and
``bitmask_gather_cumsum`` (K2, K1, K10; ``csrc/bfs_kernels.cu``),
``last_hit_rows`` (K14, the predecessor fills' kernel, which has no
Pallas counterpart; the same file),
``sample_sorted`` and ``sample_sorted2``
(K5), ``reduce_by_dst_sorted`` (K7) and ``scatter_sorted`` (K8; all
three in ``csrc/sssp_kernels.cu``).

A packed mask is a flat ``(nwords,)`` int32 tensor: bit v is bit
``v & 31`` of word ``v >> 5``, bit 31 included, the same words as the
JAX package's ``(R, 128)`` array read in row-major order. The JAX package
pads the word count to whole 8x128 tiles for the TPU; here a mask holds
``ceil(bits / 32)`` words.

Each kernel has three parts: its plain PyTorch version
(``*_plain``), a wrapper that launches the hand-written CUDA kernel for
CUDA tensors, and a launch count in
:data:`LAUNCHES`. The wrapper takes the plain version only for tensors
that lie on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

__all__ = ["LAUNCHES", "reset_launch_counts", "words_for", "pack_bitmask",
           "unpack_bitmask", "bitmask_gather", "bitmask_gather_plain",
           "bitmask_gather_cumsum", "bitmask_gather_cumsum_plain",
           "pull_reached_words", "pull_reached_words_plain",
           "sample_sorted", "sample_sorted_plain", "sample_sorted2",
           "sample_sorted2_plain", "reduce_by_dst_sorted",
           "reduce_by_dst_sorted_plain", "scatter_sorted",
           "scatter_sorted_plain", "last_hit_rows", "last_hit_rows_plain",
           "row_bounds32", "REDUCE_TILE", "WARP_TILE",
           "GATHER_CUMSUM_TILE", "SHARED_MASK_WORDS", "HIT_CHUNK"]

# Kernel launches per wrapper since the last reset_launch_counts(), for
# every CUDA kernel of the port: K1, K2, K10, K5 (both wrappers), K7, K8
# and K14 here, K3, K4, K6 and K9 (both phases) in ops/pull2.py.
LAUNCHES = {"pull_reached_words": 0, "bitmask_gather": 0,
            "bitmask_gather_cumsum": 0,
            "pull_reduce2": 0, "pull_power_iters": 0, "pull_min_sweeps": 0,
            "sample_sorted": 0, "sample_sorted2": 0,
            "reduce_by_dst_sorted": 0, "scatter_sorted": 0,
            "brandes_levels": 0, "last_hit_rows": 0}

# Stream lanes a block of K7 reduces (kReduceTile in
# csrc/sssp_kernels.cu, which refuses any other). It fixes the order of
# every sum, so two launches on the same input agree bit for bit.
REDUCE_TILE = 2048

# Edges a warp tile of K1 (kWarpTile in csrc/bfs_kernels.cu) and ids a
# block tile of K10 (kCumsumTile): K1's wrapper allocates a tile-rows
# slot for each tile and one past the last, K10's a 64-bit tile state for
# each and the tile counter; the kernels refuse fewer.
WARP_TILE = 256
GATHER_CUMSUM_TILE = 16384

# K10's size rule: a frontier mask of at most this many words (1,851,392
# bits) is read from shared memory, copied there once a block by a grid
# of one block an SM; a larger one is read through L1, the variant for
# masks above the 227 KB a block may hold (kCumsumMaskWords in
# csrc/bfs_kernels.cu, which refuses larger masks in shared memory). K1
# reads its mask through L1 at every size.
SHARED_MASK_WORDS = 57856

# Edges :func:`last_hit_rows_plain` takes at a time: its temporaries
# (about 30 bytes an edge) stay near 512 MiB whatever the graph's size.
HIT_CHUNK = 1 << 24


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def words_for(num_bits: int) -> int:
    """Packed int32 words needed for ``num_bits`` bits."""
    return -(-num_bits // 32)


def pack_bitmask(mask: torch.Tensor,
                 nwords: Optional[int] = None) -> torch.Tensor:
    """(V,) bool -> (nwords,) int32 packed words; ``nwords`` defaults to
    :func:`words_for` (V), extra words are zero."""
    v = mask.shape[0]
    nwords = words_for(v) if nwords is None else nwords
    if nwords * 32 < v:
        raise ValueError(f"{nwords} words cannot hold {v} bits")
    bits = torch.zeros(nwords * 32, dtype=torch.int64, device=mask.device)
    bits[:v] = mask
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (bits.view(nwords, 32) << shifts).sum(dim=1)
    # Words are unsigned 32-bit values; store them as int32 two's
    # complement, as the JAX package does.
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bitmask(words: torch.Tensor, v_pad: int) -> torch.Tensor:
    """(nwords,) int32 -> (v_pad,) bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, None] >> shifts[None, :]) & 1
    return bits.reshape(-1)[:v_pad].bool()


def _check(name: str, t: torch.Tensor, device: torch.device,
           dtypes: tuple = (torch.int32,)) -> None:
    if t.device != device or t.dtype not in dtypes or \
            not t.is_contiguous() or t.dim() != 1:
        kinds = "/".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"{name} must be a contiguous 1-D {kinds} tensor "
                         f"on {device}; got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def row_bounds32(graph) -> torch.Tensor:
    """The CSC offsets as the int32 row bounds that K1, K4, K6 and K9
    read: as they are on an int32 graph, narrowed (v_pad + 1 entries,
    exactly) on a sizet64 graph below 2^31 edges, and refused past it,
    where no int32 bound can name an edge. These kernels run on the
    blocked routes, which a sizet64 graph never takes; K3 reads int64
    offsets as they are."""
    off = graph.csc_offsets
    if off.dtype != torch.int64:
        return off
    if graph.num_edges > 2**31 - 1:
        raise ValueError(f"the CSC-tile kernels take int32 row bounds, and "
                         f"this sizet64 graph has {graph.num_edges} edges, "
                         "past 2^31 - 1")
    return off.to(torch.int32)


def _launch(fn, *args, device: torch.device) -> None:
    """Call a kernel's C entry point with ``device``'s current stream and
    raise on the CUDA error it returns. A launch goes to the current
    device, so ``device`` is made current for the call unless it is
    already."""
    # The raw handle of the current stream, without building a Stream
    # object (which enters the device's context) on every launch. CUDA
    # builds of torch only, so it is looked up here, not at import.
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {rc}")


def _route(*tensors: torch.Tensor) -> bool:
    """True to run the CUDA kernel, False for the plain version. Only
    tensors that all lie on the CPU take the plain version."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"}:
        return True
    raise ValueError(f"tensors on {sorted(types)}: the kernels take CUDA "
                     "tensors, the plain versions CPU tensors")


def bitmask_gather_plain(words: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """out[i] = bit ``idx[i]`` of the packed mask (0/1 int32); ids
    outside the mask read 0."""
    i = idx.long()
    ok = (i >= 0) & (i < words.shape[0] * 32)
    i = torch.where(ok, i, 0)
    bits = (words[i >> 5].long() >> (i & 31)) & 1
    return torch.where(ok, bits, 0).to(torch.int32)


def bitmask_gather(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = bit ``idx[i]`` of the packed mask (0/1 int32); ids
    outside the mask read 0.

    Kernel K2 (replaces the Pallas ``bitmask_gather``,
    ``gunrock_tpu/ops/pallas_kernels.py:116``): one launch with 16-byte
    id loads and stores, the mask read through L1. ``idx`` is int32 of
    any length, and may be a view at any offset: the output is placed at
    the same offset mod 16 bytes, so that the kernel's one scalar head
    lines both up for 16-byte accesses."""
    if not _route(words, idx):
        return bitmask_gather_plain(words, idx)
    _check("words", words, idx.device)
    _check("idx", idx, idx.device)
    n = idx.shape[0]
    buf = torch.empty(n + 3, dtype=torch.int32, device=idx.device)
    off = (idx.data_ptr() - buf.data_ptr()) % 16 // 4
    out = buf[off:off + n]
    if n == 0:
        return out
    _launch(_build.load().gr_bitmask_gather, words.data_ptr(),
            words.shape[0] * 32, idx.data_ptr(), n, out.data_ptr(),
            device=idx.device)
    LAUNCHES["bitmask_gather"] += 1
    return out


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as the int32 two's complement of their low 32 bits."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def bitmask_gather_cumsum_plain(words: torch.Tensor, idx: torch.Tensor,
                                start: int = 0) -> torch.Tensor:
    """Inclusive running sum of :func:`bitmask_gather_plain`, from
    ``start``, wrapped to int32 modulo 2^32 as K10's sums are. ``start``
    lets a caller continue a sum across chunks of one id stream (the
    card's check over 2^31 ids) or start it near 2^31 (the tests of the
    wrap)."""
    run = torch.cumsum(bitmask_gather_plain(words, idx), 0,
                       dtype=torch.int64)
    return _wrap32(run + start)


def bitmask_gather_cumsum(words: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """(n,) int32 inclusive running sum of the bits of the packed mask
    that ``idx`` selects: out[i] = bit idx[0] + ... + bit idx[i]. Ids
    outside the mask read 0.

    Kernel K10 (replaces the Pallas ``bitmask_gather_cumsum``,
    ``gunrock_tpu/ops/pallas_kernels.py:880``): a memset of the tile
    states and one pass over the ids with a decoupled look-back between
    tiles, the mask in shared memory up to ``SHARED_MASK_WORDS`` words,
    else through L1. ``idx`` is int32 of any length (the Pallas version
    takes multiples of 128).

    The output stays int32, as in the JAX package ("inclusive, int32"):
    past 2^31 hits (a sizet64 graph's pull) the sums wrap modulo 2^32,
    the kernel adding in ``uint32_t`` and storing the bits, as
    :func:`bitmask_gather_cumsum_plain` wraps them. A difference of two
    sums taken modulo 2^32 stays exact while fewer than 2^32 hits lie
    between them, which is what BFS's pull reads. An int64 output would
    cost 16 GiB at 2^31 ids, beside a graph of 24 GiB."""
    return _gather_cumsum(words, idx, words.shape[0] <= SHARED_MASK_WORDS)


def _gather_cumsum(words: torch.Tensor, idx: torch.Tensor,
                   shared: bool) -> torch.Tensor:
    """:func:`bitmask_gather_cumsum` with K10's mask in shared memory
    (``shared``) or through L1, whatever its size, so that the card's
    tests and tools can hold both variants against the plain version on
    one input."""
    if not _route(words, idx):
        return bitmask_gather_cumsum_plain(words, idx)
    _check("words", words, idx.device)
    _check("idx", idx, idx.device)
    n = idx.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=idx.device)
    if n == 0:
        return out
    # The tile counter, then a count a tile; the entry point zeroes them.
    state = torch.empty(1 + -(-n // GATHER_CUMSUM_TILE), dtype=torch.int64,
                        device=idx.device)
    _launch(_build.load().gr_bitmask_gather_cumsum, words.data_ptr(),
            words.shape[0] * 32, idx.data_ptr(), n, state.data_ptr(),
            state.shape[0], int(shared), out.data_ptr(), device=idx.device)
    LAUNCHES["bitmask_gather_cumsum"] += 1
    return out


def pull_reached_words_plain(words: torch.Tensor, graph) -> torch.Tensor:
    """Bit gather over every CSC edge, segment-any by cumsum boundary
    difference, then pack (the JAX package's XLA pull,
    ``models/bfs.py:355-361``)."""
    hit = bitmask_gather_plain(words, graph.csc_indices)
    run0 = torch.zeros(hit.shape[0] + 1, dtype=torch.int64,
                       device=hit.device)
    torch.cumsum(hit, 0, out=run0[1:])
    samples = run0[graph.csc_offsets.long()]
    return pack_bitmask((samples[1:] - samples[:-1]) > 0)


def pull_reached_words(words: torch.Tensor, graph) -> torch.Tensor:
    """(words_for(graph.v_pad),) int32 reach words: bit v is set iff some
    in-neighbour of v (CSC row v of the DeviceGraph ``graph``) has its
    bit set in ``words``.

    Kernel K1 (replaces the Pallas ``pull_reached_words``,
    ``gunrock_tpu/ops/pallas_kernels.py:348``, and its blocked and cells
    kernels): a memset of the output, the tile-rows prologue and one
    launch. Like its plain version it reads ``csc_indices`` and
    ``csc_offsets``."""
    if not graph.has_csc:
        raise ValueError("pull_reached_words needs to_device(with_csc=True)")
    if not _route(words, graph.csc_indices):
        return pull_reached_words_plain(words, graph)
    dev = graph.csc_indices.device
    offsets = row_bounds32(graph)
    for name, t in (("words", words), ("csc_indices", graph.csc_indices),
                    ("csc_offsets", offsets)):
        _check(name, t, dev)
    if graph.num_edges == 0:
        return torch.zeros(words_for(graph.v_pad), dtype=torch.int32,
                           device=dev)
    # The entry point zeroes the output, which the kernel ORs into.
    out = torch.empty(words_for(graph.v_pad), dtype=torch.int32, device=dev)
    tile_rows = torch.empty(-(-graph.num_edges // WARP_TILE) + 1,
                            dtype=torch.int32, device=dev)
    _launch(_build.load().gr_pull_reached_words, words.data_ptr(),
            words.shape[0] * 32, graph.csc_indices.data_ptr(),
            offsets.data_ptr(), graph.v_pad, graph.num_edges,
            tile_rows.data_ptr(), tile_rows.shape[0], out.data_ptr(),
            device=dev)
    LAUNCHES["pull_reached_words"] += 1
    return out


_GATHER_TYPES = (torch.int32, torch.float32)


def sample_sorted_plain(arr: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``arr[pos]``; positions outside ``arr`` read 0."""
    p = pos.long()
    ok = (p >= 0) & (p < arr.shape[0])
    out = arr[torch.where(ok, p, 0)] if arr.shape[0] else \
        torch.zeros(p.shape, dtype=arr.dtype, device=arr.device)
    return torch.where(ok, out, torch.zeros((), dtype=arr.dtype,
                                            device=arr.device))


def sample_sorted2_plain(arr_a: torch.Tensor, arr_b: torch.Tensor,
                         pos: torch.Tensor):
    """``(arr_a[pos], arr_b[pos])``; positions outside read 0."""
    return sample_sorted_plain(arr_a, pos), sample_sorted_plain(arr_b, pos)


def _sample(a: torch.Tensor, b: Optional[torch.Tensor], pos: torch.Tensor,
            name: str):
    dev = pos.device
    for label, t in (("arr", a), ("arr_b", b)):
        if t is None:
            continue
        if t.device != dev or t.dtype not in _GATHER_TYPES or \
                not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"{label} must be a contiguous 1-D int32 or "
                             f"float32 tensor on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if pos.dtype not in (torch.int32, torch.int64) or \
            not pos.is_contiguous() or pos.dim() != 1:
        raise ValueError(f"pos must be a contiguous 1-D int32 or int64 "
                         f"tensor; got {pos.dtype} {tuple(pos.shape)}")
    if b is not None and b.shape != a.shape:
        raise ValueError("sample_sorted2 takes two arrays of one length")
    out_a = torch.empty(pos.shape[0], dtype=a.dtype, device=dev)
    out_b = None if b is None else torch.empty(pos.shape[0], dtype=b.dtype,
                                               device=dev)
    if pos.shape[0] == 0:
        return out_a, out_b
    _launch(_build.load().gr_sample_sorted, a.data_ptr(),
            0 if b is None else b.data_ptr(), a.shape[0], pos.data_ptr(),
            int(pos.dtype == torch.int64), pos.shape[0], out_a.data_ptr(),
            0 if b is None else out_b.data_ptr(), device=dev)
    LAUNCHES[name] += 1
    return out_a, out_b


def sample_sorted(arr: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``arr[pos]`` for int32 or float32 ``arr`` and int32 or int64
    ``pos``; positions outside ``arr`` read 0.

    Kernel K5 (replaces the Pallas ``sample_sorted``,
    ``gunrock_tpu/ops/pallas_kernels.py:665``). Any order of ``pos`` is
    right; sorted positions make the kernel's reads coalesce. ``arr`` may
    have any length (the JAX package's multiple-of-8192 padding is a TPU
    means)."""
    if not _route(arr, pos):
        return sample_sorted_plain(arr, pos)
    return _sample(arr, None, pos, "sample_sorted")[0]


def sample_sorted2(arr_a: torch.Tensor, arr_b: torch.Tensor,
                   pos: torch.Tensor):
    """``(arr_a[pos], arr_b[pos])`` in one pass, as :func:`sample_sorted`.

    Kernel K5 in its two-array mode (replaces the Pallas
    ``sample_sorted2``, ``gunrock_tpu/ops/pallas_kernels.py:783``)."""
    if not _route(arr_a, arr_b, pos):
        return sample_sorted2_plain(arr_a, arr_b, pos)
    return _sample(arr_a, arr_b, pos, "sample_sorted2")


_REDUCE_OPS = {"min": 0, "sum": 1}
_SCATTER_OPS = {"min": 0, "add": 1, "max": 2, "set": 3}


def _check_reduce(sd, vals, op, out_lanes, aux) -> None:
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown op {op!r}")
    if out_lanes < 0:
        raise ValueError("out_lanes must be at least 0")
    if vals.shape != sd.shape or (aux is not None and aux.shape != sd.shape):
        raise ValueError("sd, vals and aux must have one shape")


def reduce_by_dst_sorted_plain(sd: torch.Tensor, vals: torch.Tensor, *,
                               op: str = "min", out_lanes: int,
                               aux: Optional[torch.Tensor] = None):
    """Runs of ``sd`` by their boundaries, :func:`row_reduce_sorted` over
    them (sums in float64, so this version is the accurate reference the
    kernel is held to), the aux filter, then the first ``out_lanes``
    runs. Lanes at or past the count hold 0."""
    from .segment import row_reduce_sorted
    _check_reduce(sd, vals, op, out_lanes, aux)
    dev = sd.device
    ids = torch.zeros(out_lanes, dtype=torch.int32, device=dev)
    rvals = torch.zeros(out_lanes, dtype=torch.float32, device=dev)
    tail = torch.ones(sd.shape[0], dtype=torch.bool, device=dev)
    tail[:-1] = sd[1:] != sd[:-1]
    ends = torch.nonzero(tail).flatten() + 1
    offsets = torch.cat([ends.new_zeros(1), ends])
    runs = sd[tail].to(torch.int32)
    red = row_reduce_sorted(vals.float(), offsets, op=op)
    if aux is not None:
        keep = red < aux.float()[tail]
        runs, red = runs[keep], red[keep]
    k = min(runs.shape[0], out_lanes)
    ids[:k] = runs[:k]
    rvals[:k] = red[:k]
    return ids, rvals, torch.tensor(runs.shape[0], dtype=torch.int32,
                                    device=dev)


def _reduce_state(m: int, device: torch.device) -> torch.Tensor:
    """K7's tile states for ``m`` lanes: the tile counter, then a head
    partial, a tail partial and a count a tile, 64-bit words that the
    entry point zeroes before its launch."""
    return torch.empty(1 + 3 * -(-m // REDUCE_TILE), dtype=torch.int64,
                       device=device)


def reduce_by_dst_sorted(sd: torch.Tensor, vals: torch.Tensor, *,
                         op: str = "min", out_lanes: int,
                         aux: Optional[torch.Tensor] = None):
    """Reduce ``vals`` by runs of equal, nondecreasing int32 ``sd``.

    Returns ``(ids, rvals, count)``: one lane per run, its id and the min
    or sum of its values, in ascending id order in the first
    ``min(count, out_lanes)`` of ``out_lanes`` lanes, and ``count`` as a
    0-d int32 tensor on the device. A count past ``out_lanes`` signals an
    overflow: the runs past ``out_lanes`` were dropped, the count is
    true. ``aux`` (float32, constant within each run, such as
    ``dist[sd]``) turns on the strictly-improving filter: a run is kept
    iff its value is below its aux. Lanes at or past the count are left
    undefined.

    Kernel K7 (replaces the Pallas ``reduce_by_dst_sorted``,
    ``gunrock_tpu/ops/pallas_kernels.py:1320``). ``min`` is exact; two
    launches on the same input agree bit for bit."""
    tensors = [sd, vals] + ([] if aux is None else [aux])
    if not _route(*tensors):
        return reduce_by_dst_sorted_plain(sd, vals, op=op,
                                          out_lanes=out_lanes, aux=aux)
    _check_reduce(sd, vals, op, out_lanes, aux)
    if sd.shape[0] > 2**31 - 1:
        raise ValueError(f"reduce_by_dst_sorted counts runs in int32: "
                         f"{sd.shape[0]} lanes are past 2^31 - 1")
    dev = sd.device
    _check("sd", sd, dev)
    for name, t in (("vals", vals), ("aux", aux)):
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"on {dev}; got {t.dtype} on {t.device}")
    m = sd.shape[0]
    state = _reduce_state(m, dev)
    ids = torch.empty(out_lanes, dtype=torch.int32, device=dev)
    rvals = torch.empty(out_lanes, dtype=torch.float32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    _launch(_build.load().gr_reduce_by_dst_sorted, sd.data_ptr(),
            vals.data_ptr(), 0 if aux is None else aux.data_ptr(), m,
            _REDUCE_OPS[op], REDUCE_TILE, out_lanes, state.data_ptr(),
            ids.data_ptr(), rvals.data_ptr(), count.data_ptr(), device=dev)
    LAUNCHES["reduce_by_dst_sorted"] += 1
    return ids, rvals, count


def _check_scatter(dense, ids, vals, op) -> None:
    if op not in _SCATTER_OPS:
        raise ValueError(f"unknown op {op!r}")
    if dense.dtype not in _GATHER_TYPES or vals.dtype != dense.dtype:
        raise ValueError(f"dense and vals must both be int32 or float32; "
                         f"got {dense.dtype} and {vals.dtype}")
    if vals.shape != ids.shape:
        raise ValueError("ids and vals must have one shape")


def scatter_sorted_plain(dense: torch.Tensor, ids: torch.Tensor,
                         vals: torch.Tensor, *, count=None,
                         op: str = "min") -> torch.Tensor:
    """Plain indexing of the lanes below ``count`` whose ids lie in
    ``dense``; updates ``dense`` in place and returns it."""
    _check_scatter(dense, ids, vals, op)
    c = ids.shape[0] if count is None else min(int(count), ids.shape[0])
    i = ids[:c].long()
    ok = (i >= 0) & (i < dense.shape[0])
    i, v = i[ok], vals[:c][ok]
    if op == "min":
        v = torch.minimum(dense[i], v)
    elif op == "max":
        v = torch.maximum(dense[i], v)
    elif op == "add":
        v = dense[i] + v
    dense[i] = v
    return dense


def scatter_sorted(dense: torch.Tensor, ids: torch.Tensor,
                   vals: torch.Tensor, *, count=None,
                   op: str = "min") -> torch.Tensor:
    """``dense[ids[i]] = op(dense[ids[i]], vals[i])`` for ``i < count``
    (all lanes when None), op ``min``, ``max``, ``set`` or ``add``, on
    int32 or float32. ``ids`` (int32) must be unique among those lanes
    (a compacted winner stream, ascending for coalesced access); ids
    outside ``dense`` are dropped. Updates ``dense`` IN PLACE, where the
    JAX package returns a new array, and returns it. ``count`` may be an
    int or a one-element int32 tensor on the device, such as the count
    :func:`reduce_by_dst_sorted` returns, which the kernel reads there.

    Kernel K8 (replaces the Pallas ``scatter_sorted``,
    ``gunrock_tpu/ops/pallas_kernels.py:1289``)."""
    tensors = [dense, ids, vals] + ([count] if torch.is_tensor(count)
                                    else [])
    if not _route(*tensors):
        return scatter_sorted_plain(dense, ids, vals, count=count, op=op)
    _check_scatter(dense, ids, vals, op)
    if ids.shape[0] > 2**31 - 1:
        raise ValueError(f"scatter_sorted reads its count as int32: "
                         f"{ids.shape[0]} lanes are past 2^31 - 1")
    dev = dense.device
    _check("ids", ids, dev)
    if not dense.is_contiguous() or not vals.is_contiguous() or \
            vals.device != dev:
        raise ValueError(f"dense and vals must be contiguous on {dev}")
    count_ptr, count_host = 0, ids.shape[0]
    if torch.is_tensor(count):
        if count.device != dev or count.dtype != torch.int32 or \
                count.numel() != 1:
            raise ValueError(f"count must be one int32 on {dev}")
        count_ptr = count.data_ptr()
    elif count is not None:
        count_host = int(count)
    if ids.shape[0] == 0:
        return dense
    _launch(_build.load().gr_scatter_sorted, dense.data_ptr(),
            dense.shape[0], ids.data_ptr(), vals.data_ptr(), ids.shape[0],
            count_ptr, count_host, int(dense.dtype == torch.float32),
            _SCATTER_OPS[op], device=dev)
    LAUNCHES["scatter_sorted"] += 1
    return dense


def _check_hit(graph, vals: torch.Tensor,
               weights: Optional[torch.Tensor]) -> None:
    if not graph.has_csc:
        raise ValueError("last_hit_rows needs to_device(with_csc=True)")
    _check("vals", vals, vals.device,
           (torch.int32 if weights is None else torch.float32,))
    if vals.shape[0] < graph.v_pad:
        raise ValueError(f"vals holds {vals.shape[0]} entries, fewer than "
                         f"the graph's {graph.v_pad} rows")
    if weights is not None:
        _check("weights", weights, weights.device, (torch.float32,))
        if weights.shape[0] < graph.num_edges:
            raise ValueError(f"weights holds {weights.shape[0]} entries, "
                             f"fewer than the graph's {graph.num_edges} "
                             "edges")


def last_hit_rows_plain(graph, vals: torch.Tensor,
                        weights: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """:func:`last_hit_rows` in PyTorch, each edge's row from
    ``csc_edge_dst``.

    The JAX package takes a ``cummax`` of the hit positions over every
    edge and samples it at the row ends; here each chunk of
    :data:`HIT_CHUNK` edges takes a segmented max of its hit positions
    over the rows clipped to the chunk (``torch.segment_reduce``, in
    float64, exact for positions below 2^53), folded into the rows'
    running max. So the walk makes no edge-scale temporary, and its
    positions are 64-bit whatever the offsets' dtype. (A chunked
    ``cummax`` with a carry took 6.4 s over 2^31 edges on an H100, this
    about 0.09 s: ``PERF.md``, section 6.)"""
    src, dst = graph.csc_indices, graph.csc_edge_dst
    off = graph.csc_offsets.long()
    dev = off.device
    last = torch.full((off.shape[0] - 1,), -1.0, dtype=torch.float64,
                      device=dev)
    for lo in range(0, graph.num_edges, HIT_CHUNK):
        hi = min(lo + HIT_CHUNK, graph.num_edges)
        du = vals.index_select(0, src[lo:hi])
        dv = vals.index_select(0, dst[lo:hi])
        if weights is None:
            hit = du + 1 == dv
        else:
            hit = (du < dv) & (du + weights[lo:hi] == dv)
        pos = torch.where(hit, torch.arange(lo, hi, dtype=torch.float64,
                                            device=dev), -1.0)
        best = torch.segment_reduce(pos, "max", offsets=off.clamp(lo, hi) - lo,
                                    initial=-1.0)
        last = torch.maximum(last, best)
    return last.long()


def last_hit_rows(graph, vals: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(v_pad,) int64: for each CSC row v of the DeviceGraph ``graph``,
    the last position p in CSC order whose in-neighbour
    u = ``csc_indices[p]`` passes the predecessor fills' test, or -1.
    Without ``weights`` (BFS, int32 labels): ``vals[u] + 1 ==
    vals[v]``. With them (SSSP, float32 distances and the CSC's float32
    weights): ``vals[u] < vals[v]`` and ``vals[u] + weights[p] ==
    vals[v]``, one float32 add. Positions are 64-bit whatever the
    offsets' type.

    Kernel K14 (no Pallas counterpart: the JAX package's fills take
    XLA's ``cummax``, ``gunrock_tpu/models/bfs.py:373-386``): a fill of
    the output with -1 and one pass over the CSC's edges in balanced
    warp tiles, rows from ``csc_offsets`` (int32 or int64, as uploaded);
    ``csc_edge_dst`` is not read. It raises on a ``vals`` or ``weights``
    of another type, shape or layout, on either route."""
    _check_hit(graph, vals, weights)
    tensors = [vals, graph.csc_indices, graph.csc_offsets]
    if weights is not None:
        tensors.append(weights)
    if not _route(*tensors):
        return last_hit_rows_plain(graph, vals, weights)
    dev = graph.csc_indices.device
    _check("csc_indices", graph.csc_indices, dev)
    _check("csc_offsets", graph.csc_offsets, dev, (torch.int32, torch.int64))
    out = torch.empty(graph.v_pad, dtype=torch.int64, device=dev)
    _launch(_build.load().gr_last_hit_rows, graph.csc_offsets.data_ptr(),
            int(graph.csc_offsets.dtype == torch.int64),
            graph.csc_indices.data_ptr(), vals.data_ptr(),
            0 if weights is None else weights.data_ptr(), graph.v_pad,
            graph.num_edges, out.data_ptr(), device=dev)
    LAUNCHES["last_hit_rows"] += 1
    return out
