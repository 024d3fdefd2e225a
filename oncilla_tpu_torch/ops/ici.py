"""The device data plane: REMOTE_DEVICE put/get/copy between GPUs' memory.

The counterpart of ``oncilla_tpu.ops.ici``. The reference's device data
plane is one-sided RDMA into a remote daemon's registered buffer (reference
src/rdma.c:241-263). Here, as in the JAX package, it comes in two forms,
both implementing the data half of a :class:`RemoteBackend` for
REMOTE_DEVICE handles:

- :class:`IciDataPlane`: one :class:`DeviceArena` per mesh entry; the
  controlling process moves chunks between them with ``Tensor.to`` (the
  JAX package's ``jax.device_put``; no kernel of its own there either).
- :class:`SpmdIciPlane`: handles resolve onto the rows of one fabric
  (:mod:`oncilla_tpu_torch.parallel.spmd_arena`), and a handle-to-handle
  copy is the one-sided kernel K4 (:mod:`oncilla_tpu_torch.ops.fabric`), as
  ``ocm_copy_onesided`` on an RDMA handle goes straight to ``ib_write``
  (reference src/lib.c:670-700).

Addressing is connectionless: (rank, device_index, offset), with
``global = rank * devices_per_rank + device_index`` picking the mesh entry.
"""

from __future__ import annotations

import math
import threading

import torch

from oncilla_tpu_torch.core.arena import check_bounds
from oncilla_tpu_torch.core.errors import OcmBoundsError, OcmError, OcmInvalidHandle
from oncilla_tpu_torch.core.handle import OcmAlloc
from oncilla_tpu_torch.core.hbm import DeviceArena, from_bytes
from oncilla_tpu_torch.core.hostmem import as_byte_tensor
from oncilla_tpu_torch.parallel import spmd_arena as sa
from oncilla_tpu_torch.parallel.mesh import global_index, node_mesh
from oncilla_tpu_torch.utils.config import OcmConfig
from oncilla_tpu_torch.utils.debug import GLOBAL_TRACER


def resolve_global_device(handle: OcmAlloc, devices_per_rank: int,
                          ndevices: int) -> int:
    """(rank, device_index) -> mesh position, range-checked; shared by both
    planes."""
    if not 0 <= handle.device_index < devices_per_rank:
        raise OcmInvalidHandle(
            f"device_index {handle.device_index} out of range for "
            f"{devices_per_rank} devices per rank"
        )
    g = global_index(handle.rank, handle.device_index, devices_per_rank)
    if not 0 <= g < ndevices:
        raise OcmInvalidHandle(
            f"handle addresses device {g} but only {ndevices} devices "
            "are attached"
        )
    return g


class IciDataPlane:
    """Per-device arenas addressable by (rank, device_index).

    The arena capacities must match what the bookkeeping allocators assume
    (``OcmConfig.device_arena_bytes``): the control plane hands out offsets
    into these arenas without touching the bytes."""

    def __init__(self, config: OcmConfig | None = None, devices=None,
                 devices_per_rank: int | None = None):
        self.config = config or OcmConfig()
        self.devices = node_mesh(devices)
        self.devices_per_rank = devices_per_rank or len(self.devices)
        self.arenas = [
            DeviceArena(self.config.device_arena_bytes, d, self.config.alignment)
            for d in self.devices
        ]
        self.tracer = GLOBAL_TRACER

    def _arena(self, handle: OcmAlloc) -> DeviceArena:
        g = resolve_global_device(handle, self.devices_per_rank, len(self.arenas))
        return self.arenas[g]

    def device_of(self, handle: OcmAlloc) -> torch.device:
        """The device of the arena ``handle`` addresses (where the plane
        server runs a relayed op)."""
        return self._arena(handle).device

    def put(self, handle: OcmAlloc, data, offset: int = 0) -> None:
        """One-sided write: bytes from any device into the owner's arena."""
        arena = self._arena(handle)
        raw = as_byte_tensor(data)
        with self.tracer.span("ici_put", nbytes=raw.numel()):
            arena.write(handle.extent, raw, offset)

    def get(self, handle: OcmAlloc, nbytes: int, offset: int = 0) -> torch.Tensor:
        """One-sided read from the owner's arena, on its device."""
        arena = self._arena(handle)
        with self.tracer.span("ici_get", nbytes=nbytes):
            return arena.read(handle.extent, nbytes, offset)

    def copy(self, dst: OcmAlloc, src: OcmAlloc, nbytes: int,
             dst_offset: int = 0, src_offset: int = 0) -> None:
        """Extent copy between arenas. Within one arena it is one on-device
        move; across arenas it sends chunks of ``chunk_bytes``, with at most
        ``inflight_ops`` chunks staged at once (the reference's
        2-posted-commands limit, extoll.c:44-51). Each chunk goes as an
        asynchronous ``Tensor.to`` of the destination's device, then a write;
        the host never waits on the data."""
        a_src, a_dst = self._arena(src), self._arena(dst)
        with self.tracer.span("ici_copy", nbytes=nbytes):
            if a_src is a_dst:
                a_src.move(src.extent, dst.extent, nbytes, src_offset, dst_offset)
                return
            check_bounds(src.extent, src_offset, nbytes)
            check_bounds(dst.extent, dst_offset, nbytes)
            chunk = self.config.chunk_bytes
            inflight: list[tuple[torch.Tensor, int]] = []
            pos = 0
            while pos < nbytes or inflight:
                while pos < nbytes and len(inflight) < self.config.inflight_ops:
                    n = min(chunk, nbytes - pos)
                    piece = a_src.read(src.extent, n, src_offset + pos)
                    inflight.append(
                        (piece.to(a_dst.device, non_blocking=True), pos))
                    pos += n
                moved, at = inflight.pop(0)
                a_dst.write(dst.extent, moved, dst_offset + at)

    def scrub(self, handle: OcmAlloc) -> None:
        """Zero a freshly issued handle's extent (scrub-at-alloc, calloc
        parity, reference src/alloc.c:171)."""
        self._arena(handle).fill_zero(handle.extent)

    def get_as(self, handle: OcmAlloc, shape, dtype: torch.dtype,
               offset: int = 0) -> torch.Tensor:
        return self._arena(handle).read_as(handle.extent, shape, dtype, offset)


class SpmdIciPlane:
    """The one-sided flavour of the device data plane: handles resolve onto
    the rows of one fabric (one row per mesh entry), and handle-to-handle
    copies are the one-sided kernel K4 on CUDA rows. Implements the same
    data interface as :class:`IciDataPlane`; a :class:`RemoteBackend`
    carries it as ``ici_plane`` for ``Ocm.copy``.

    Rows stay below 2 GiB, as the JAX plane's int32-addressed rows must
    (ici.py:186-191), so the two planes accept the same configurations."""

    def __init__(self, config: OcmConfig | None = None, mesh=None,
                 devices_per_rank: int | None = None):
        self.config = config or OcmConfig()
        if self.config.device_arena_bytes > 2**31 - 1:
            raise OcmError(
                "SpmdIciPlane rows must stay below 2 GiB, as the JAX "
                "package's int32-addressed rows must; device_arena_bytes "
                f"must be < 2 GiB (got {self.config.device_arena_bytes}). "
                "Use more rows, or DeviceArena."
            )
        self.mesh = node_mesh() if mesh is None else node_mesh(mesh)
        self.devices_per_rank = devices_per_rank or len(self.mesh)
        self.arena = sa.make_arena(self.mesh, self.config.device_arena_bytes)
        self.tracer = GLOBAL_TRACER
        self.stats = {"ici_copies": 0, "puts": 0, "gets": 0}
        # Serialises operations on the rows and the fabric's sequence
        # numbers (the JAX plane's lock guards its donated-arena rebind).
        self._mu = threading.Lock()

    def _gdev(self, handle: OcmAlloc) -> int:
        g = resolve_global_device(handle, self.devices_per_rank, len(self.mesh))
        # A daemon-issued extent sized for a bigger arena would land past
        # the row's end.
        end = handle.extent.offset + handle.extent.nbytes
        if end > self.config.device_arena_bytes:
            raise OcmBoundsError(
                f"extent [{handle.extent.offset}, {end}) exceeds the plane's "
                f"{self.config.device_arena_bytes} B arena rows (plane and "
                "daemon device_arena_bytes must match)"
            )
        return g

    def device_of(self, handle: OcmAlloc) -> torch.device:
        """The device of the row ``handle`` addresses."""
        return self.arena.rows[self._gdev(handle)].device

    def put(self, handle: OcmAlloc, data, offset: int = 0) -> None:
        raw = as_byte_tensor(data)
        check_bounds(handle.extent, offset, raw.numel())
        g = self._gdev(handle)
        with self.tracer.span("spmd_ici_put", nbytes=raw.numel()), self._mu:
            sa.host_put(self.arena, g, raw, handle.extent.offset + offset)
            self.stats["puts"] += 1

    def get(self, handle: OcmAlloc, nbytes: int, offset: int = 0) -> torch.Tensor:
        check_bounds(handle.extent, offset, nbytes)
        g = self._gdev(handle)
        with self.tracer.span("spmd_ici_get", nbytes=nbytes), self._mu:
            out = sa.host_get(self.arena, g, nbytes, handle.extent.offset + offset)
            self.stats["gets"] += 1
        return out

    def copy(self, dst: OcmAlloc, src: OcmAlloc, nbytes: int,
             dst_offset: int = 0, src_offset: int = 0,
             use_kernel: bool | None = None) -> None:
        """One-sided device-to-device copy: the source row's device stores
        into the destination row (no host hop)."""
        check_bounds(src.extent, src_offset, nbytes)
        check_bounds(dst.extent, dst_offset, nbytes)
        g_src, g_dst = self._gdev(src), self._gdev(dst)
        with self.tracer.span("spmd_ici_copy", nbytes=nbytes), self._mu:
            sa.ici_copy(
                self.arena, g_src, g_dst,
                src.extent.offset + src_offset, dst.extent.offset + dst_offset,
                nbytes, use_kernel=use_kernel,
            )
            self.stats["ici_copies"] += 1

    def update(self, fn) -> None:
        """``self.arena = fn(self.arena)`` under the plane lock, for code
        that works on the rows directly."""
        with self._mu:
            self.arena = fn(self.arena)

    def scrub(self, handle: OcmAlloc) -> None:
        """Zero the handle's extent (scrub-at-alloc: the daemon only books
        device extents, the bytes live here; calloc parity,
        reference src/alloc.c:171)."""
        g = self._gdev(handle)
        with self.tracer.span("spmd_ici_scrub", nbytes=handle.extent.nbytes):
            self.update(lambda a: sa.fill_zero(
                a, g, handle.extent.offset, handle.extent.nbytes))

    def get_as(self, handle: OcmAlloc, shape, dtype: torch.dtype,
               offset: int = 0) -> torch.Tensor:
        nbytes = math.prod(shape) * dtype.itemsize
        return from_bytes(self.get(handle, nbytes, offset), shape, dtype)
