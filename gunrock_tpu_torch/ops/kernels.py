"""Packed bitmasks and the two CUDA kernels of the DO-BFS path.

Counterpart of :mod:`gunrock_tpu.ops.pallas_kernels` for the functions
the DO-BFS path calls: ``words_for``, ``pack_bitmask``,
``unpack_bitmask``, ``bitmask_gather`` and ``pull_reached_words``.

A packed mask is a flat ``(nwords,)`` int32 tensor: bit v is bit
``v & 31`` of word ``v >> 5``, bit 31 included, the same words as the
JAX package's ``(R, 128)`` array read in row-major order. The JAX package
pads the word count to whole 8x128 tiles for the TPU; here a mask holds
``ceil(bits / 32)`` words.

Each kernel has three parts: its plain PyTorch version
(``*_plain``), a wrapper that launches the hand-written CUDA kernel in
``csrc/bfs_kernels.cu`` for CUDA tensors, and a launch count in
:data:`LAUNCHES`. The wrapper takes the plain version only for tensors
that lie on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["LAUNCHES", "reset_launch_counts", "words_for", "pack_bitmask",
           "unpack_bitmask", "bitmask_gather", "bitmask_gather_plain",
           "pull_reached_words", "pull_reached_words_plain"]

# Kernel launches per wrapper since the last reset_launch_counts(), for
# every CUDA kernel of the port: K1 and K2 here, K3 and K4 in
# ops/pull2.py.
LAUNCHES = {"pull_reached_words": 0, "bitmask_gather": 0,
            "pull_reduce2": 0, "pull_power_iters": 0}


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


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.int32 or \
            not t.is_contiguous() or t.dim() != 1:
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor on "
                         f"{device}; got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _launch(fn, *args, device: torch.device) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
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
    """out[i] = bit ``idx[i]`` of the packed mask (0/1 int32).

    Kernel K2 (replaces the Pallas ``bitmask_gather``,
    ``gunrock_tpu/ops/pallas_kernels.py:116``). ``idx`` is int32 of any
    length."""
    if not _route(words, idx):
        return bitmask_gather_plain(words, idx)
    _check("words", words, idx.device)
    _check("idx", idx, idx.device)
    out = torch.empty(idx.shape[0], dtype=torch.int32, device=idx.device)
    if idx.shape[0] == 0:
        return out
    from . import _build
    _launch(_build.load().gr_bitmask_gather, words.data_ptr(),
            words.shape[0] * 32, idx.data_ptr(), idx.shape[0],
            out.data_ptr(), device=idx.device)
    LAUNCHES["bitmask_gather"] += 1
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
    kernels). It reads ``csc_indices`` and ``csc_edge_dst``; the plain
    version reads ``csc_indices`` and ``csc_offsets``."""
    if not graph.has_csc:
        raise ValueError("pull_reached_words needs to_device(with_csc=True)")
    if not _route(words, graph.csc_indices):
        return pull_reached_words_plain(words, graph)
    dev = graph.csc_indices.device
    for name, t in (("words", words), ("csc_indices", graph.csc_indices),
                    ("csc_edge_dst", graph.csc_edge_dst)):
        _check(name, t, dev)
    # The kernel ORs its bits into the output, so it starts zeroed.
    out = torch.zeros(words_for(graph.v_pad), dtype=torch.int32, device=dev)
    if graph.num_edges == 0:
        return out
    from . import _build
    _launch(_build.load().gr_pull_reached_words, words.data_ptr(),
            words.shape[0] * 32, graph.csc_indices.data_ptr(),
            graph.csc_edge_dst.data_ptr(), graph.num_edges, out.data_ptr(),
            device=dev)
    LAUNCHES["pull_reached_words"] += 1
    return out
