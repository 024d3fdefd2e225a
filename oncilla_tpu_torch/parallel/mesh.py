"""Mesh helpers: the fabric's ordered row devices, and the named-axis
meshes the sharded train steps run on.

The control plane addresses devices as (rank, device_index); the fabric
addresses them by position in the mesh, ``global = rank * devices_per_rank +
index`` (``oncilla_tpu.parallel.mesh``, the analogue of EXTOLL's flat
(node, vpid) space). The fabric keeps one row tensor per mesh entry, so its
mesh (:func:`node_mesh`) is just the list of those rows' devices.

The training meshes are :class:`Mesh`: named axes laid row-major over the
processes of a ``torch.distributed`` world, one process a card (the JAX
package lays a ``jax.sharding.Mesh`` over the devices of one process). Each
process keeps its own shard of every leaf as a plain tensor: a
:class:`PartitionSpec` names, for each dimension, the mesh axes it is split
over, as the JAX ``PartitionSpec`` does, :func:`shard` takes this process's
slice of a full leaf and :func:`gather` puts a full leaf back together. The
mesh builds a process group for every set of its axes whose size exceeds 1,
so a collective over ``("dp", "sp")`` is one call; on a mesh of one it
builds none and needs no process group at all.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import torch

from oncilla_tpu_torch.core.errors import OcmDeviceError
from oncilla_tpu_torch.utils.platform import resolve_device

NODE_AXIS = "node"
# The training meshes' axes: batch data parallel, tensor parallel over heads
# and ffn, sequence parallel (ring attention), expert parallel, pipeline.
DP, TP, SP, EP, PP = "dp", "tp", "sp", "ep", "pp"


def node_mesh(devices=None) -> list[torch.device]:
    """The mesh: one entry per fabric row, in order. The default is every
    CUDA device; without CUDA that raises :class:`OcmDeviceError`. A device
    may repeat, which is how one card (or the CPU, when named) hosts several
    rows."""
    if devices is None:
        if not torch.cuda.is_available():
            raise OcmDeviceError(
                "CUDA is not available; pass devices (e.g. ['cpu'] * 8) to "
                "build the mesh on the CPU"
            )
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


def global_index(rank: int, device_index: int, devices_per_rank: int) -> int:
    return rank * devices_per_rank + device_index


# -- named-axis meshes for the sharded train steps ---------------------------


class PartitionSpec(tuple):
    """One entry a dimension: None (not split), an axis name, or a tuple of
    axis names (split over their product, the first the slowest); missing
    trailing entries are None. The JAX ``PartitionSpec``'s meaning."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"

    def axes(self, dim: int) -> tuple:
        e = self[dim] if dim < len(self) else None
        if e is None:
            return ()
        return (e,) if isinstance(e, str) else tuple(e)


P = PartitionSpec


class Mesh:
    """Named axes over the processes of a ``torch.distributed`` world.

    ``shape`` maps axis names to sizes in order; ranks are laid row-major
    over it (the last axis the fastest), as ``np.reshape`` lays the JAX
    package's devices. ``rank`` is this process's rank (the world's when a
    process group is initialised, else 0) and ``device`` the device its
    shards live on. With a process group whose world equals the mesh's
    size, a group is built for every set of axes of size > 1 (all ranks
    build them in the same order, as ``new_group`` needs); a mesh of one
    needs no process group. A mesh of more than one process made without
    one is a layout: its shape and coordinates answer, its collectives
    raise."""

    def __init__(self, shape: dict, device=None, rank: int | None = None):
        import torch.distributed as dist

        from oncilla_tpu_torch.parallel.collectives import name_group

        self.shape = {str(k): int(v) for k, v in shape.items()}
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.device = resolve_device(device)
        live = dist.is_available() and dist.is_initialized()
        if rank is None:
            rank = dist.get_rank() if live else 0
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords = dict(zip(self.axis_names, _unravel(rank, self.shape)))
        self._groups: dict = {}
        self.layout_only = self.size > 1 and not live
        if self.layout_only:
            return
        if self.size > 1 and dist.get_world_size() != self.size:
            raise ValueError(f"a mesh of {self.size} over a world of "
                             f"{dist.get_world_size()} processes")
        wide = [a for a in self.axis_names if self.shape[a] > 1]
        for n in range(1, len(wide) + 1):
            for axes in itertools.combinations(wide, n):
                lists = self._rank_lists(axes)
                mine, _ = dist.new_subgroups_by_enumeration(lists)
                self._groups[axes] = mine
                name_group(mine, axes)
        if self.device.type == "cuda":
            # NCCL makes a communicator at a group's first collective, which
            # every member must join: join them all now, so a point-to-point
            # exchange between a few members is never a group's first call.
            probe = torch.zeros(1, device=self.device)
            for g in self._groups.values():
                dist.all_reduce(probe, group=g)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"

    def axis_size(self, *axes) -> int:
        """The product of the sizes of ``axes`` (1 for an axis the mesh
        lacks)."""
        return math.prod(self.shape.get(a, 1) for a in axes)

    def axis_index(self, *axes) -> int:
        """This process's index along ``axes`` taken together (row-major, 0
        for an axis the mesh lacks)."""
        i = 0
        for a in axes:
            i = i * self.shape.get(a, 1) + self.coords.get(a, 0)
        return i

    def _rank_lists(self, axes) -> list[list[int]]:
        """Every group of ranks that differ only along ``axes``, each in
        the order of its index along them."""
        rest = [a for a in self.axis_names if a not in axes]
        lists = []
        for fixed in itertools.product(*(range(self.shape[a]) for a in rest)):
            at = dict(zip(rest, fixed))
            lists.append([self.rank_at({**at, **dict(zip(axes, idx))})
                          for idx in itertools.product(
                              *(range(self.shape[a]) for a in axes))])
        return lists

    def rank_at(self, coords: dict) -> int:
        """The rank at ``coords`` (axes left out: this process's)."""
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + int(coords.get(a, self.coords[a]))
        return r

    def ranks(self, *axes) -> list[int]:
        """The ranks of this process's group along ``axes``, by index."""
        axes = tuple(a for a in self.axis_names if a in axes)
        return [self.rank_at(dict(zip(axes, idx))) for idx in itertools.product(
            *(range(self.shape[a]) for a in axes))]

    def group(self, *axes):
        """The process group along ``axes`` (those of size 1 left out), or
        None when their size is 1: every collective over it is then the
        identity."""
        axes = tuple(a for a in self.axis_names if a in axes and self.shape[a] > 1)
        if not axes:
            return None
        if self.layout_only:
            raise RuntimeError(f"{self!r} is a layout: no process group is "
                               "initialised")
        return self._groups[axes]


def _unravel(rank: int, shape: dict) -> tuple:
    idx = []
    for n in reversed(list(shape.values())):
        idx.append(rank % n)
        rank //= n
    return tuple(reversed(idx))


@dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: its :class:`PartitionSpec` over a :class:`Mesh`
    (the JAX ``NamedSharding``)."""

    mesh: Mesh
    spec: PartitionSpec


def full_shape(shape, mesh: Mesh, spec: PartitionSpec) -> tuple:
    """The full shape of a leaf whose shard here has ``shape``."""
    return tuple(n * mesh.axis_size(*spec.axes(d)) for d, n in enumerate(shape))


def shard(full: torch.Tensor, mesh: Mesh, spec: PartitionSpec,
          device=None) -> torch.Tensor:
    """This process's slice of ``full`` under ``spec``, a tensor of its own
    on ``device`` (the mesh's by default)."""
    out = full
    for d in range(full.ndim):
        axes = spec.axes(d)
        k = mesh.axis_size(*axes)
        if k == 1:
            continue
        if full.shape[d] % k:
            raise ValueError(f"dimension {d} of {tuple(full.shape)} does not "
                             f"split {k} ways under {spec!r}")
        out = out.chunk(k, dim=d)[mesh.axis_index(*axes)]
    dev = mesh.device if device is None else resolve_device(device)
    return out.to(dev).clone() if out.device == dev else out.to(dev)


def gather(local: torch.Tensor, mesh: Mesh, spec: PartitionSpec) -> torch.Tensor:
    """The full leaf from every process's shard (a collective: every
    process of the mesh calls it), a tensor of its own. No gradient."""
    out = local.detach().clone()
    for d in reversed(range(local.ndim)):
        axes = spec.axes(d)
        g = mesh.group(*axes)
        if g is None:
            continue
        k = mesh.axis_size(*axes)
        moved = out.movedim(d, 0).contiguous()
        buf = torch.empty((k * moved.shape[0], *moved.shape[1:]),
                          dtype=moved.dtype, device=moved.device)
        _all_gather_into(buf, moved, g)
        out = buf.movedim(0, d)
    return out.contiguous()


def _all_gather_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    import torch.distributed as dist

    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def arena_sharding(mesh) -> NamedSharding:
    """The placement of a (rows, arena_bytes) global arena: one row a mesh
    entry along the ``node`` axis (``mesh`` a :class:`Mesh` with that axis,
    or :func:`node_mesh`'s list, taken as its layout)."""
    if not isinstance(mesh, Mesh):
        mesh = Mesh({NODE_AXIS: len(mesh)}, device="cpu", rank=0)
    return NamedSharding(mesh, P(NODE_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    """Every process holds the whole leaf."""
    return NamedSharding(mesh, P())
