"""The shard mesh: ``num_shards`` graph shards on one torch device.

Counterpart of :mod:`gunrock_tpu.parallel.mesh`. The JAX package runs a
sharded primitive as one ``shard_map`` over a 1-D mesh of devices, its
arrays stacked on a leading shard axis. An H100 host has one card, and
NCCL refuses two ranks on one device, so the port keeps the stacked
layout and puts every shard on the one device: a shard's arrays are row
``i`` of ``(p, ...)`` tensors, and each collective of the JAX package is
a tensor operation over the leading axis (``parallel/comm.py``). That is
the reference's ``--device=0,0`` trick (two logical GPUs on one card,
``CMakeLists.txt:389-421``), which the JAX package's tests play with 8
virtual CPU devices.

``pvary`` and the ``check_vma`` switch of the JAX package have no
counterpart: there is no ``shard_map`` to annotate. A mesh over several
distinct devices (multi-card, over ``torch.distributed`` and NCCL) is not
built yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Optional, Sequence, Union

import torch

from ..graph.device import resolve_device

__all__ = ["Mesh", "make_mesh", "mesh_of", "info_graph", "AXIS"]

AXIS = "shard"  # graph-parallel axis name, as in the JAX package


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``num_shards`` shards on ``device``; ``axis`` names the shard axis,
    the leading dimension of every stacked tensor."""

    device: torch.device
    num_shards: int
    axis: str = AXIS


def make_mesh(num_shards: Optional[int] = None, axis: str = AXIS,
              device: Union[str, torch.device, Sequence] = "cuda") -> Mesh:
    """A mesh of ``num_shards`` shards (default 1) on ``device``.

    ``device`` may also list a device per shard, as the reference's
    ``--device=0,0``: every entry must name the same device, and
    ``num_shards`` defaults to the list's length. Raises when CUDA is
    asked for and absent, and ``NotImplementedError`` for several
    distinct devices."""
    if isinstance(device, (list, tuple)):
        devs = {resolve_device(d) for d in device}
        if len(devs) > 1:
            raise NotImplementedError(
                f"a mesh over {len(devs)} distinct devices is not built: "
                "the port runs every shard on one device")
        if num_shards is None:
            num_shards = len(device)
        dev = devs.pop()
    else:
        dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if num_shards is None:
        num_shards = 1
    if num_shards < 1:
        raise ValueError(f"num_shards must be at least 1, not {num_shards}")
    return Mesh(device=dev, num_shards=int(num_shards), axis=axis)


def mesh_of(pg, mesh: Optional[Mesh]) -> Mesh:
    """The mesh a ``*_sharded_device`` call runs on: ``mesh``, or one of
    ``pg.num_shards`` shards on the partition's device; raises when they
    disagree."""
    if mesh is None:
        return Mesh(device=pg.device, num_shards=pg.num_shards)
    if mesh.num_shards != pg.num_shards or mesh.device != pg.device:
        raise ValueError(f"a partition of {pg.num_shards} shards on "
                         f"{pg.device} cannot run on a mesh of "
                         f"{mesh.num_shards} on {mesh.device}")
    return mesh


def info_graph(graph, mesh: Mesh):
    """What ``utils.info.make_info`` reads of a host graph run on
    ``mesh``: its counts and the mesh's device."""
    return types.SimpleNamespace(num_nodes=graph.num_nodes,
                                 num_edges=graph.num_edges,
                                 device=mesh.device)
