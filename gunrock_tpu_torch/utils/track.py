"""Debug and forensics utilities.

Counterpart of :mod:`gunrock_tpu.utils.track` (the reference's vertex
watchlists, ``util/track_utils.cuh:22-110``, and its latency injection,
``util/latency_utils.cuh:20-80``):

  * :func:`track_values` prints the tracked vertices' values from the
    host loop, in the JAX package's line format. The JAX package prints
    from inside ``jit`` through ``jax.debug.print``; the port's loops run
    on the host, so a plain ``print`` at the call does the same.
  * :func:`inject_latency` burns dependent passes over a small tensor on
    ``x``'s device, the JAX package's LCG chain, and returns ``x``
    unchanged, to emulate a slower stage or interconnect. Work queued
    after the call on the same stream waits for the burn, as the JAX
    package's ``optimization_barrier`` ties ``x`` to it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["track_values", "inject_latency"]


def track_values(name: str, values: torch.Tensor,
                 vertices: Sequence[int], iteration=None) -> None:
    """Print the tracked vertices' current values, one line:
    ``<name> [iter=<i> ]verts=[...] values=[...]`` (numpy's array
    format, as ``jax.debug.print`` writes it). Nothing is read or printed
    when the watchlist is empty, so production runs pay nothing."""
    if not vertices:
        return
    verts = torch.as_tensor(list(vertices), dtype=torch.int32)
    vals = values[verts.to(values.device).long()].cpu().numpy()
    v = verts.numpy()
    if iteration is None:
        print(f"{name} verts={v} values={vals}")
    else:
        if torch.is_tensor(iteration):
            iteration = iteration.cpu().numpy()
        print(f"{name} iter={np.asarray(iteration)} verts={v} values={vals}")


def _burn(rounds: int, device) -> torch.Tensor:
    """The JAX package's chain: ``rounds`` dependent passes of
    ``v = (v * 1664525 + 1013904223) ^ (v >> 1)`` over an (8, 128) int32
    tensor of 12345, wrapping modulo 2^32 as int32 arithmetic does there
    (computed in int64 here, where torch's int32 overflow is not
    defined)."""
    v = torch.full((8, 128), 12345, dtype=torch.int32, device=device)
    for _ in range(rounds):
        lcg = (v.long() * 1664525 + 1013904223 + 2**31) % 2**32 - 2**31
        v = lcg.to(torch.int32) ^ (v >> 1)
    return v


def inject_latency(x: torch.Tensor, rounds: int) -> torch.Tensor:
    """Burn ``rounds`` dependent passes on ``x``'s device and return ``x``
    itself, bit-exact. ``rounds <= 0`` is a no-op with no cost."""
    if rounds > 0:
        _burn(rounds, x.device)
    return x
