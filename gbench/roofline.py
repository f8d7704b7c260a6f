"""Peaks of one NVIDIA H100 SXM and the least time of a kernel.

Copied from ``chip_smoke.py`` (``HBM_RATE``, ``FP32_RATE``, ``bound``,
``pull_bytes``), where the port's kernel table was built with them, and
frozen here so that later changes to the program cannot move the
yardstick.
"""

from __future__ import annotations

# Published H100 SXM rates (NVIDIA data sheet, at 700 W): HBM bytes/s
# and float32 operations/s outside the tensor cores.
HBM_RATE, FP32_RATE = 3.35e12, 67e12


def bound(nbytes: float, flops: float = 0.0) -> dict:
    """``bound_ms`` and ``bound_by`` of a kernel: the larger of its bytes
    (each input read once, each output written once) over the memory rate
    and its float32 operations over the peak rate."""
    b_ms = nbytes / HBM_RATE * 1e3
    o_ms = flops / FP32_RATE * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}


def pull_bytes(num_edges: int, num_rows: int, vectors: int,
               edge_streams: int = 1) -> int:
    """Bytes of one pull over the CSC: ``edge_streams`` 4-byte arrays of
    one entry an edge (csc_indices, and the weights where read; the row
    of each edge follows from csc_offsets) and ``vectors`` 4-byte arrays
    of one entry a row (the offsets, the values, the output, ...)."""
    return 4 * edge_streams * num_edges + 4 * vectors * num_rows


def bitmask_bytes(num_bits: int) -> int:
    """Bytes of a packed bit mask of ``num_bits`` bits in 32-bit words."""
    return 4 * -(-num_bits // 32)


def k1_level_bytes(num_nodes: int, num_edges: int) -> int:
    """Bytes one BFS pull level needs from kernel K1 (reach words from
    the frontier's bits over the CSC): ``csc_indices`` once, the
    ``num_nodes + 1`` row offsets, the frontier's words read and the
    reach words written. Counted over the vertices, not the program's
    padding: what the inputs need, not what a layout adds."""
    return (pull_bytes(num_edges, num_nodes + 1, 1)
            + 2 * bitmask_bytes(num_nodes))
