"""The shard mesh: ``num_shards`` graph shards, stacked on one torch
device or one a process of a ``torch.distributed`` group.

Counterpart of :mod:`gunrock_tpu.parallel.mesh`. The JAX package runs a
sharded primitive as one ``shard_map`` over a 1-D mesh of devices, its
arrays stacked on a leading shard axis, and its collectives are
``lax.all_to_all``, ``all_gather``, ``psum``, ``pmax``, ``pmin`` and
``axis_index`` over that axis. Here a :class:`Mesh` carries those
collectives as methods, so each primitive's body is written once over
the shards it holds, the *local* shards: a stacked tensor has a leading
axis of ``mesh.local_shards`` rows, shards ``shard_lo ..`` of the mesh.

  * The stacked mesh (``make_mesh(p, device=...)``): every shard on one
    device, ``local_shards == p``. A collective is a tensor operation
    over the leading axis: ``all_to_all`` a transpose, ``all_gather``
    the tensor itself, ``psum``/``pmax``/``pmin`` reductions over dim 0.
    That is the reference's ``--device=0,0`` trick (two logical GPUs on
    one card, ``CMakeLists.txt:389-421``), which the JAX package's tests
    play with 8 virtual CPU devices.
  * The process-group mesh (``make_mesh(process_group=...)``, or
    ``make_mesh`` once ``torch.distributed`` is initialized): one shard a
    rank, ``local_shards == 1``, ``shard_lo`` the rank; the collectives
    are ``dist.all_to_all_single`` (ragged pushes exchange their counts
    first), ``dist.all_gather_into_tensor`` and ``dist.all_reduce``.
    Under NCCL a rank's device is ``cuda:<LOCAL_RANK>``; under Gloo it is
    the device the caller names, the CPU or a card the ranks may share
    (Gloo takes CUDA tensors in all three collectives: nothing is staged
    through host buffers).
    A float ``psum`` is an ``all_gather`` and a local sum over the shard
    axis, the order the stacked mesh sums in, so both meshes give the
    same bits; integer sums and max/min take ``all_reduce``.

Every host superstep loop decides on values read from every shard
(:meth:`Mesh.read`), so all ranks take the same branch, as the JAX
package's ``lax.while_loop`` does on its ``psum``'d condition.

``pvary`` and the ``check_vma`` switch of the JAX package have no
counterpart: there is no ``shard_map`` to annotate.
"""

from __future__ import annotations

import dataclasses
import os
import types
from typing import Optional, Sequence, Union

import torch

from ..graph.device import resolve_device

__all__ = ["Mesh", "make_mesh", "mesh_of", "info_graph", "mesh_info",
           "AXIS"]

AXIS = "shard"  # graph-parallel axis name, as in the JAX package

@dataclasses.dataclass(frozen=True)
class Mesh:
    """``num_shards`` shards; ``axis`` names the shard axis, the leading
    dimension of every stacked tensor. ``group`` is the process group of
    a mesh with one shard a rank (None: every shard stacked on
    ``device``), ``shard_lo`` the first shard held here, ``backend`` the
    group's backend and ``devices`` every rank's device."""

    device: torch.device
    num_shards: int
    axis: str = AXIS
    group: Optional[object] = None
    shard_lo: int = 0
    backend: Optional[str] = None
    devices: tuple = ()

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def local_shards(self) -> int:
        return 1 if self.distributed else self.num_shards

    # ---- the JAX package's collectives over the shard axis ----------

    def axis_index(self) -> torch.Tensor:
        """(local_shards,) int64: the index of each local shard."""
        return torch.arange(self.shard_lo, self.shard_lo + self.local_shards,
                            device=self.device)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """The local rows of a tensor stacked over all ``num_shards``."""
        if not self.distributed:
            return x
        return x[self.shard_lo:self.shard_lo + 1]

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_to_all(tiled)`` of per-peer buffers: ``x`` is
        ``(local_shards, p, ...)`` with ``[i, j]`` what local shard i
        sends shard j; returns the same shape with ``[j, i]`` what shard
        i sent local shard j."""
        if not self.distributed:
            return x.transpose(0, 1)
        send = x[0].contiguous()
        recv = torch.empty_like(send)
        self._dist().all_to_all_single(recv, send, group=self.group)
        return recv[None]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_gather``: local ``(local_shards, ...)`` rows ->
        ``(num_shards, ...)``, in shard order."""
        if not self.distributed:
            return x
        send = x.contiguous()
        out = send.new_empty((self.num_shards,) + tuple(send.shape[1:]))
        self._dist().all_gather_into_tensor(out, send, group=self.group)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.psum`` over the shard axis: ``(local_shards, ...)`` ->
        ``(...)``. Floats gather and sum in shard order, as the stacked
        mesh sums, so both give the same bits."""
        if not self.distributed or x.is_floating_point():
            return self.all_gather(x).sum(dim=0)
        return self._reduce(x, "SUM")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.pmax`` over the shard axis (exact in any order)."""
        if not self.distributed:
            return x.amax(dim=0)
        return self._reduce(x, "MAX")

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.pmin`` over the shard axis (exact in any order)."""
        if not self.distributed:
            return x.amin(dim=0)
        return self._reduce(x, "MIN")

    def read(self, rows) -> list:
        """The host read of a superstep's scalars: ``rows`` holds one row
        of numbers a local shard (a tensor or nested lists); returns one
        row a shard of the mesh, ``num_shards`` rows, the same on every
        rank. On the stacked mesh a host list comes back as it is, and a
        tensor is read once."""
        if not self.distributed:
            return rows.tolist() if torch.is_tensor(rows) else \
                [list(r) for r in rows]
        if not torch.is_tensor(rows):
            rows = torch.tensor(rows, dtype=torch.float64
                                if any(isinstance(v, float) for r in rows
                                       for v in r) else torch.int64)
        elif rows.dtype == torch.bool:
            rows = rows.to(torch.uint8)
        return self.all_gather(rows.to(self.device)).tolist()

    def push(self, owner: torch.Tensor, payloads: Sequence[torch.Tensor]
             ) -> list:
        """Send each lane to the shard ``owner`` names: ``payloads`` are
        the local shards' lanes, in sender order and each sender's in
        lane order. Returns every payload as its receivers read it:
        sender by sender, each sender's lanes in their order (the JAX
        package's all-to-all). On the stacked mesh every lane is already
        here in that order restricted to each receiver, so the payloads
        come back as they are; a process-group mesh packs each peer's
        chunk in lane order (a stable sort by owner), exchanges the
        counts, then the lanes."""
        if not self.distributed:
            return list(payloads)
        p = self.num_shards
        order = torch.sort(owner.long(), stable=True).indices
        counts = torch.bincount(owner.long(), minlength=p)
        recv = self.all_to_all(counts.view(1, p, 1)).view(p)
        send_splits, recv_splits = counts.tolist(), recv.tolist()
        out = []
        for payload in payloads:
            send = payload[order].contiguous()
            got = send.new_empty(sum(recv_splits))
            self._dist().all_to_all_single(got, send, recv_splits,
                                           send_splits, group=self.group)
            out.append(got)
        return out

    # ---- plumbing ----------------------------------------------------

    @staticmethod
    def _dist():
        import torch.distributed as dist
        return dist

    def _reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        dist = self._dist()
        y = x[0].clone()
        dist.all_reduce(y, getattr(dist.ReduceOp, op), group=self.group)
        return y


def make_mesh(num_shards: Optional[int] = None, axis: str = AXIS,
              device: Union[str, torch.device, Sequence] = "cuda", *,
              process_group=None) -> Mesh:
    """A mesh of ``num_shards`` shards (default 1) on ``device``.

    ``device`` may also list a device per shard, as the reference's
    ``--device=0,0``: every entry must name the same device, and
    ``num_shards`` defaults to the list's length; distinct devices in
    one process raise ``NotImplementedError`` (one shard a card is the
    process-group route). Raises when CUDA is asked for and absent.

    ``process_group`` (or, when it is None, an initialized default group
    of ``torch.distributed``): one shard a rank; ``num_shards`` must be
    None or the group's size. Under NCCL the rank's device is
    ``cuda:<LOCAL_RANK>`` (the rank when the variable is unset); under
    Gloo, ``device``. The backend is the group's, never switched: NCCL
    with two ranks on one card raises, as NCCL does."""
    if isinstance(device, (list, tuple)):
        devs = {resolve_device(d) for d in device}
        if len(devs) > 1:
            raise NotImplementedError(
                f"a mesh over {len(devs)} distinct devices in one process "
                "is not built: one shard a card runs one process a shard "
                "(make_mesh(process_group=...) under torch.distributed)")
        if num_shards is None:
            num_shards = len(device)
        device = devs.pop()
    if process_group is None:
        dist = Mesh._dist()
        if dist.is_available() and dist.is_initialized():
            process_group = dist.group.WORLD
    if process_group is not None:
        return _group_mesh(num_shards, axis, device, process_group)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if num_shards is None:
        num_shards = 1
    if num_shards < 1:
        raise ValueError(f"num_shards must be at least 1, not {num_shards}")
    return Mesh(device=dev, num_shards=int(num_shards), axis=axis)


def _group_mesh(num_shards, axis, device, group) -> Mesh:
    dist = Mesh._dist()
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if num_shards is not None and int(num_shards) != world:
        raise ValueError(f"a process-group mesh holds one shard a rank: "
                         f"{world} ranks cannot hold {num_shards} shards")
    backend = str(dist.get_backend(group))
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        if not torch.cuda.is_available() or \
                local >= torch.cuda.device_count():
            raise ValueError(f"NCCL takes one card a rank: local rank "
                             f"{local} has no card of its own")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda" and rank == 0:
        # One build of the kernel library (a no-op where the launching
        # process built it); the gather below holds the other ranks
        # until it is there, so they only load it.
        from ..ops import _build
        _build.build()
    names = [None] * world
    dist.all_gather_object(names, str(dev), group=group)
    return Mesh(device=dev, num_shards=world, axis=axis, group=group,
                shard_lo=rank, backend=backend, devices=tuple(names))


def mesh_of(pg, mesh: Optional[Mesh]) -> Mesh:
    """The mesh a ``*_sharded_device`` call runs on: ``mesh``, or one of
    ``pg.num_shards`` shards stacked on the partition's device; raises
    when they disagree (a partition holding one shard runs on its
    process-group mesh)."""
    if mesh is None:
        if pg.local_shards != pg.num_shards:
            raise ValueError(f"shard {pg.shard_lo} of a partition of "
                             f"{pg.num_shards} runs on a process-group "
                             "mesh: pass mesh=")
        return Mesh(device=pg.device, num_shards=pg.num_shards)
    if mesh.num_shards != pg.num_shards or mesh.device != pg.device or \
            mesh.shard_lo != pg.shard_lo or \
            mesh.local_shards != pg.local_shards:
        last = pg.shard_lo + pg.local_shards - 1
        raise ValueError(f"shards {pg.shard_lo}..{last} of "
                         f"{pg.num_shards} on {pg.device} cannot run on a "
                         f"mesh holding {mesh.local_shards} of "
                         f"{mesh.num_shards} on {mesh.device}")
    return mesh


def info_graph(graph, mesh: Mesh):
    """What ``utils.info.make_info`` reads of a host graph run on
    ``mesh``: its counts and the mesh's device."""
    return types.SimpleNamespace(num_nodes=graph.num_nodes,
                                 num_edges=graph.num_edges,
                                 device=mesh.device)


def mesh_info(mesh: Mesh) -> dict:
    """The ``info`` fields of a process-group mesh: its backend, world
    size and every rank's device; nothing for the stacked mesh."""
    if not mesh.distributed:
        return {}
    return {"backend": mesh.backend, "world_size": mesh.num_shards,
            "rank_devices": list(mesh.devices)}
