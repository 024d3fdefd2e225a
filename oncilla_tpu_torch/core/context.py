"""The application-side context: alloc / free / put / get / copy.

Analogue of libocm (reference src/lib.c + inc/oncillamem.h) and of
``oncilla_tpu.core.context``, for the local arms: ``ocm_init`` returns an
:class:`Ocm`; handles are :class:`OcmAlloc`; ``copy`` composes the
kind x kind matrix with a same-device fast path. LOCAL_HOST lives in a host
arena (pinned when the device is CUDA), LOCAL_DEVICE in the device arena.
Remote arms go to the :class:`RemoteBackend` the context was given (the
daemon client, or a stand-in that books extents itself); without one they
raise ``OcmConnectError``, as the JAX package does in single-node mode. A
copy between two REMOTE_DEVICE handles rides the backend's ``ici_plane``
(the one-sided fabric) when it has one, never the host.

Device arms take and return torch tensors on the context's device; host
arms return CPU tensors.
"""

from __future__ import annotations

import itertools
import math
import threading
from typing import Protocol

import torch

from oncilla_tpu_torch.core.errors import OcmConnectError, OcmInvalidHandle
from oncilla_tpu_torch.core.handle import OcmAlloc
from oncilla_tpu_torch.core.hbm import DeviceArena, from_bytes
from oncilla_tpu_torch.core.hostmem import HostArena, as_byte_tensor
from oncilla_tpu_torch.core.kinds import Fabric, OcmKind
from oncilla_tpu_torch.utils.config import OcmConfig
from oncilla_tpu_torch.utils.debug import GLOBAL_TRACER, printd
from oncilla_tpu_torch.utils.platform import resolve_device

_LOCAL_KINDS = (OcmKind.LOCAL_HOST, OcmKind.LOCAL_DEVICE)


class RemoteBackend(Protocol):
    """What serves the remote arms. One-sided semantics: after ``alloc``
    returns, ``put``/``get`` involve no remote application code (the
    reference's data plane bypasses the daemon per transfer). A backend
    whose handles live on a device fabric also carries it as
    ``ici_plane``."""

    def alloc(self, nbytes: int, kind: OcmKind) -> OcmAlloc: ...
    def free(self, handle: OcmAlloc) -> None: ...
    def put(self, handle: OcmAlloc, data, offset: int) -> None: ...
    def get(self, handle: OcmAlloc, nbytes: int, offset: int): ...


class Ocm:
    """Per-process oncilla context (``ocm_init``/``ocm_tini``,
    reference src/lib.c:98,160). ``device`` is a CUDA device by
    default; ``device="cpu"`` runs the device arm on the CPU. ``remote``
    serves the remote kinds."""

    def __init__(self, config: OcmConfig | None = None,
                 remote: RemoteBackend | None = None, device=None):
        self.config = config or OcmConfig()
        self._remote = remote
        if self.config.nodefile or self.config.rank is not None:
            raise OcmConnectError(
                "a nodefile/rank names a control plane, which this package "
                "does not have yet (single-node local arms only)"
            )
        self.device = resolve_device(device)
        self.host_arena = HostArena(
            self.config.host_arena_bytes, self.config.alignment,
            pinned=self.device.type == "cuda",
        )
        self.device_arenas = [
            DeviceArena(self.config.device_arena_bytes, self.device,
                        self.config.alignment)
        ]
        # Odd local ids, as in the JAX package (daemon ids are even).
        self._next_id = itertools.count(1, 2)
        self._allocs: dict[int, OcmAlloc] = {}
        self._lock = threading.Lock()
        self.tracer = GLOBAL_TRACER

    # -- lifecycle -------------------------------------------------------

    def __enter__(self) -> "Ocm":
        return self

    def __exit__(self, *exc) -> None:
        self.tini()

    def tini(self) -> None:
        """Free every live handle (``ocm_tini``, lib.c:160)."""
        with self._lock:
            handles = list(self._allocs.values())
        for h in handles:
            try:
                self.free(h)
            except OcmInvalidHandle:
                pass

    # -- alloc / free ----------------------------------------------------

    def _local_arena(self, kind: OcmKind, device_index: int):
        if kind == OcmKind.LOCAL_HOST:
            return self.host_arena
        if not 0 <= device_index < len(self.device_arenas):
            raise OcmInvalidHandle(
                f"device_index {device_index} out of range "
                f"(host has {len(self.device_arenas)} arena(s))"
            )
        return self.device_arenas[device_index]

    def _remote_or_raise(self, kind) -> RemoteBackend:
        if self._remote is None:
            raise OcmConnectError(
                f"kind {kind} needs a control plane; this context has none "
                "(single-node mode)"
            )
        return self._remote

    def alloc(self, nbytes: int, kind: OcmKind = OcmKind.LOCAL_HOST,
              device_index: int = 0) -> OcmAlloc:
        """``ocm_alloc`` (reference src/lib.c:175)."""
        with self.tracer.span("alloc"):
            if kind in _LOCAL_KINDS:
                di = 0 if kind == OcmKind.LOCAL_HOST else device_index
                ext = self._local_arena(kind, di).alloc(nbytes)
                h = OcmAlloc(
                    alloc_id=next(self._next_id), kind=kind,
                    fabric=Fabric.LOCAL, nbytes=nbytes, rank=0,
                    device_index=di, extent=ext, origin_rank=0,
                )
            else:
                h = self._remote_or_raise(kind).alloc(nbytes, kind)
            with self._lock:
                self._allocs[h.alloc_id] = h
            printd("alloc id=%d kind=%s nbytes=%d", h.alloc_id, kind, nbytes)
            return h

    def free(self, handle: OcmAlloc) -> None:
        """``ocm_free`` (reference src/lib.c:347)."""
        if handle is None:
            raise OcmInvalidHandle("free(None)")
        with self._lock:
            if handle.freed or handle.alloc_id not in self._allocs:
                raise OcmInvalidHandle(f"double free of alloc {handle.alloc_id}")
            del self._allocs[handle.alloc_id]
        if handle.kind in _LOCAL_KINDS:
            self._local_arena(handle.kind, handle.device_index).free(
                handle.extent)
        else:
            self._remote_or_raise(handle.kind).free(handle)
        handle.freed = True

    # -- one-sided ops ---------------------------------------------------

    def _check_live(self, handle: OcmAlloc) -> None:
        if handle.freed:
            raise OcmInvalidHandle(f"use of freed alloc {handle.alloc_id}")

    def put(self, handle: OcmAlloc, data, offset: int = 0) -> None:
        """One-sided write (``ocm_copy_onesided`` op_flag=1, lib.c:670)."""
        self._check_live(handle)
        raw = as_byte_tensor(data)
        with self.tracer.span("put", nbytes=raw.numel()):
            if handle.kind in _LOCAL_KINDS:
                self._local_arena(handle.kind, handle.device_index).write(
                    handle.extent, raw, offset
                )
            else:
                self._remote_or_raise(handle.kind).put(handle, raw, offset)

    def get(self, handle: OcmAlloc, nbytes: int | None = None, offset: int = 0,
            out: torch.Tensor | None = None) -> torch.Tensor:
        """One-sided read (``ocm_copy_onesided`` op_flag=0): fresh uint8
        bytes, on the card for device arms, on the CPU for host arms.

        ``out`` (a contiguous uint8 tensor, or numpy array, sized to the
        read) is the registered-receive-buffer idiom: the bytes land in the
        caller's buffer, which is returned. A pinned ``out`` reused across
        gets saves a fresh destination (and its page faults) per read."""
        self._check_live(handle)
        if out is not None:
            dst = as_byte_tensor(out)
            nbytes = dst.numel()
        elif nbytes is None:
            nbytes = handle.nbytes - offset
        with self.tracer.span("get", nbytes=nbytes):
            if handle.kind not in _LOCAL_KINDS:
                got = self._remote_or_raise(handle.kind).get(
                    handle, nbytes, offset)
                if out is None:
                    return got
                dst.copy_(got)
                return out
            arena = self._local_arena(handle.kind, handle.device_index)
            if out is None:
                return arena.read(handle.extent, nbytes, offset)
            arena.read_into(handle.extent, dst, offset)
            return out

    def get_as(self, handle: OcmAlloc, shape, dtype: torch.dtype,
               offset: int = 0) -> torch.Tensor:
        """Typed one-sided read."""
        nbytes = math.prod(shape) * dtype.itemsize
        return from_bytes(self.get(handle, nbytes, offset), shape, dtype)

    def localbuf(self, handle: OcmAlloc) -> torch.Tensor:
        """``ocm_localbuf`` (reference src/lib.c:425-460): a zero-copy
        view for LOCAL_HOST, a materialised copy for LOCAL_DEVICE. Remote
        kinds' staging windows are not ported."""
        self._check_live(handle)
        if handle.kind not in _LOCAL_KINDS:
            self._remote_or_raise(handle.kind)
            raise OcmInvalidHandle(
                f"ocm_localbuf of a {handle.kind} handle: staging windows "
                "are not ported; use get")
        if handle.kind == OcmKind.LOCAL_HOST:
            return self.host_arena.view(handle.extent)
        return self.device_arenas[handle.device_index].read(
            handle.extent, handle.nbytes
        )

    # -- two-sided copy matrix ------------------------------------------

    def copy(self, dst: OcmAlloc, src: OcmAlloc, nbytes: int | None = None,
             dst_offset: int = 0, src_offset: int = 0) -> None:
        """``ocm_copy`` (reference src/lib.c:502-665): every pair
        composes get -> put, with a same-device fast path, and
        REMOTE_DEVICE -> REMOTE_DEVICE on the backend's ``ici_plane``
        (the RDMA x RDMA arm going straight to ``ib_write``,
        lib.c:670-700)."""
        self._check_live(dst)
        self._check_live(src)
        if nbytes is None:
            nbytes = min(src.nbytes - src_offset, dst.nbytes - dst_offset)
        with self.tracer.span("copy", nbytes=nbytes):
            if (
                src.kind == OcmKind.LOCAL_DEVICE
                and dst.kind == OcmKind.LOCAL_DEVICE
                and src.device_index == dst.device_index
            ):
                self.device_arenas[src.device_index].move(
                    src.extent, dst.extent, nbytes, src_offset, dst_offset
                )
                return
            if (
                src.kind == OcmKind.REMOTE_DEVICE
                and dst.kind == OcmKind.REMOTE_DEVICE
                and self._remote is not None
            ):
                plane = getattr(self._remote, "ici_plane", None)
                if plane is not None:
                    plane.copy(dst, src, nbytes, dst_offset, src_offset)
                    return
            data = self.get(src, nbytes, src_offset)
            self.put(dst, data, dst_offset)

    @staticmethod
    def is_remote(handle: OcmAlloc) -> bool:
        return handle.is_remote

    @staticmethod
    def alloc_kind(handle: OcmAlloc) -> OcmKind:
        return handle.kind

    @staticmethod
    def remote_sz(handle: OcmAlloc) -> int:
        return handle.remote_sz

    def block_until_ready(self) -> None:
        for a in self.device_arenas:
            a.block_until_ready()


# ---------------------------------------------------------------------------
# Module-level functional API, name-for-name with inc/oncillamem.h:69-89.
# ---------------------------------------------------------------------------

def ocm_init(config: OcmConfig | None = None, device=None) -> Ocm:
    """``ocm_init`` (reference src/lib.c:98-132). Runs on CUDA unless
    ``device="cpu"``; raises ``OcmDeviceError`` when CUDA is absent and no
    CPU was asked for. It has no wire client yet, so it serves the local
    kinds only (``Ocm(config, remote=...)`` takes a backend directly)."""
    return Ocm(config=config, device=device)


def ocm_tini(ctx: Ocm) -> None:
    ctx.tini()


def ocm_alloc(ctx: Ocm, nbytes: int, kind: OcmKind = OcmKind.LOCAL_HOST, **kw):
    return ctx.alloc(nbytes, kind, **kw)


def ocm_free(ctx: Ocm, handle: OcmAlloc) -> None:
    ctx.free(handle)


def ocm_localbuf(ctx: Ocm, handle: OcmAlloc):
    return ctx.localbuf(handle)


def ocm_is_remote(handle: OcmAlloc) -> bool:
    return handle.is_remote


def ocm_alloc_kind(handle: OcmAlloc) -> OcmKind:
    return handle.kind


def ocm_remote_sz(handle: OcmAlloc) -> int:
    return handle.remote_sz


def ocm_copy(ctx: Ocm, dst: OcmAlloc, src: OcmAlloc, **kw) -> None:
    ctx.copy(dst, src, **kw)


def ocm_copy_onesided(ctx: Ocm, handle: OcmAlloc, local=None,
                      op: str = "write", offset: int = 0):
    """``ocm_copy_onesided`` (reference src/lib.c:670): "write" puts
    ``local`` into the allocation; "read" returns ``len(local)`` bytes (the
    rest of the allocation when ``local`` is None)."""
    if op == "write":
        ctx.put(handle, local, offset)
        return None
    if op == "read":
        n = as_byte_tensor(local).numel() if local is not None else None
        return ctx.get(handle, n, offset)
    raise ValueError(f"op must be 'read' or 'write', got {op!r}")


def ocm_copy_out(ctx: Ocm, src: OcmAlloc, nbytes: int | None = None,
                 offset: int = 0):
    """``ocm_copy_out`` (oncillamem.h:84): drain an allocation into a fresh
    buffer."""
    return ctx.get(src, nbytes, offset)


def ocm_copy_in(ctx: Ocm, dst: OcmAlloc, src, offset: int = 0) -> None:
    """``ocm_copy_in`` (oncillamem.h:85): fill an allocation from a buffer."""
    ctx.put(dst, src, offset)
