"""The application-side context: alloc / free / put / get / copy.

Analogue of libocm (reference src/lib.c + inc/oncillamem.h) and of
``oncilla_tpu.core.context``, for the local arms: ``ocm_init`` returns an
:class:`Ocm`; handles are :class:`OcmAlloc`; ``copy`` composes the
kind x kind matrix with a same-device fast path. LOCAL_HOST lives in a host
arena (pinned when the device is CUDA), LOCAL_DEVICE in the device arena.
Remote arms go to the :class:`RemoteBackend` the context was given, or that
``ocm_init`` attached through a nodefile (the daemon client,
:class:`~oncilla_tpu_torch.runtime.client.ControlPlaneClient`); without one
they raise ``OcmConnectError``, as the JAX package does in single-node mode.
Handles a daemon placed (``daemon_owned``, single-node demotions to a
LOCAL kind included) route every op to the backend, never to the context's
own arenas. A copy between two REMOTE_DEVICE handles rides the backend's
``ici_plane`` (the one-sided fabric) when it has one, never the host.

Device arms take and return torch tensors on the context's device; host
arms return CPU tensors.
"""

from __future__ import annotations

import itertools
import math
import threading
from typing import Protocol

import torch

from oncilla_tpu_torch.analysis import alloctrace
from oncilla_tpu_torch.core.arena import Extent, check_bounds
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
    ``ici_plane``. ``get_into`` lands a host-kind handle's bytes in the
    caller's buffer (the registered-receive idiom) and returns it."""

    def alloc(self, nbytes: int, kind: OcmKind) -> OcmAlloc: ...
    def free(self, handle: OcmAlloc) -> None: ...
    def put(self, handle: OcmAlloc, data, offset: int) -> None: ...
    def get(self, handle: OcmAlloc, nbytes: int, offset: int): ...
    def get_into(self, handle: OcmAlloc, out, offset: int): ...

    # A backend that bounds an op's time also takes ``deadline_ms=`` on
    # alloc, put, get and get_into; the context passes it only when set.


class Ocm:
    """Per-process oncilla context (``ocm_init``/``ocm_tini``,
    reference src/lib.c:98,160). ``device`` is a CUDA device by
    default; ``device="cpu"`` runs the device arm on the CPU. ``remote``
    serves the remote kinds."""

    def __init__(self, config: OcmConfig | None = None,
                 remote: RemoteBackend | None = None, device=None):
        self.config = config or OcmConfig()
        self._remote = remote
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
        # App-side staging windows of remote handles (the reference's
        # malloc'd local arm, lib.c:255), made on first request and
        # released by free.
        self._stagebufs: dict[int, torch.Tensor] = {}
        # True only when ocm_init created the backend (tini then closes
        # it); an injected backend stays the caller's.
        self._owns_remote = False
        self._lock = threading.Lock()
        self.tracer = GLOBAL_TRACER
        # Scope key for the OCM_ALLOCTRACE=1 allocation ledger (id-based:
        # contexts sharing a backend must not share a ledger scope).
        self._trace_scope = f"ctx:{id(self):#x}"

    # -- lifecycle -------------------------------------------------------

    def __enter__(self) -> "Ocm":
        return self

    def __exit__(self, *exc) -> None:
        self.tini()

    def tini(self) -> None:
        """Free every live handle and, when ``ocm_init`` attached the
        backend, detach from the daemon (``ocm_tini``, lib.c:160)."""
        if alloctrace.enabled():
            # Still-live handles here were leaked by the app (tini is the
            # reclaim-of-last-resort): report each with its allocation
            # site before the frees below erase the evidence.
            report = alloctrace.note_tini(self._trace_scope)
            if report["count"]:
                printd(
                    "tini: %d leaked alloc(s) totalling %d B reclaimed",
                    report["count"], report["bytes"],
                )
                for entry in report["live"]:
                    printd(
                        "tini leak: alloc %d (%d B, %s) from %s [%s]",
                        entry["alloc_id"], entry["nbytes"], entry["kind"],
                        entry["site"], entry["thread"],
                    )
        with self._lock:
            handles = list(self._allocs.values())
        for h in handles:
            try:
                self.free(h)
            except OcmInvalidHandle:
                pass
        if self._owns_remote:
            self._owns_remote = False
            self._remote.close()

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
              device_index: int = 0,
              local_nbytes: int | None = None,
              deadline_ms: int | None = None) -> OcmAlloc:
        """``ocm_alloc`` (reference src/lib.c:175). ``local_nbytes``
        (remote kinds only) sizes the app-side staging window smaller than
        the remote region, the reference's ``local_alloc_bytes`` idiom
        (reference test/ocm_test.c:35-47): ``push``/``pull`` then move
        window-sized pieces at explicit remote offsets. ``deadline_ms``
        bounds a remote alloc's time (see :meth:`put`)."""
        if local_nbytes is not None:
            if kind in _LOCAL_KINDS:
                raise OcmInvalidHandle(
                    "local_nbytes applies to remote kinds (local arms have "
                    "no staging window)")
            if not 0 < local_nbytes <= nbytes:
                raise OcmInvalidHandle(
                    f"local_nbytes {local_nbytes} must be in (0, {nbytes}]")
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
                kw = ({} if deadline_ms is None
                      else {"deadline_ms": deadline_ms})
                h = self._remote_or_raise(kind).alloc(nbytes, kind, **kw)
                h.local_nbytes = local_nbytes
            with self._lock:
                self._allocs[h.alloc_id] = h
            alloctrace.note_alloc(
                self._trace_scope, h.alloc_id, nbytes, h.kind.name
            )
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
            self._stagebufs.pop(handle.alloc_id, None)
        if self._on_backend(handle):
            # Demoted handles too: the daemon registered the extent.
            self._remote_or_raise(handle.kind).free(handle)
        else:
            self._local_arena(handle.kind, handle.device_index).free(
                handle.extent)
        handle.freed = True
        alloctrace.note_free(self._trace_scope, handle.alloc_id)

    # -- one-sided ops ---------------------------------------------------

    def _check_live(self, handle: OcmAlloc) -> None:
        if handle.freed:
            raise OcmInvalidHandle(f"use of freed alloc {handle.alloc_id}")

    @staticmethod
    def _on_backend(handle: OcmAlloc) -> bool:
        """Whether the handle's bytes are the backend's: every remote kind,
        and a daemon-placed handle demoted to a local kind (its offset is
        an address in the daemon's arena, not in this context's)."""
        return handle.daemon_owned or handle.kind not in _LOCAL_KINDS

    def put(self, handle: OcmAlloc, data, offset: int = 0,
            deadline_ms: int | None = None) -> None:
        """One-sided write (``ocm_copy_onesided`` op_flag=1, lib.c:670).
        ``deadline_ms`` bounds the op's total time: retry and failover
        ladders clamp to it and an exhausted budget surfaces as typed
        :class:`OcmDeadlineExceeded`. Local arms are a copy and ignore
        it."""
        self._check_live(handle)
        raw = as_byte_tensor(data)
        # Pass the deadline only when set: a minimal RemoteBackend keeps
        # its plain signature.
        kw = {} if deadline_ms is None else {"deadline_ms": deadline_ms}
        with self.tracer.span("put", nbytes=raw.numel()):
            if self._on_backend(handle):
                self._remote_or_raise(handle.kind).put(handle, raw, offset,
                                                       **kw)
            else:
                self._local_arena(handle.kind, handle.device_index).write(
                    handle.extent, raw, offset
                )

    def get(self, handle: OcmAlloc, nbytes: int | None = None, offset: int = 0,
            out: torch.Tensor | None = None,
            deadline_ms: int | None = None) -> torch.Tensor:
        """One-sided read (``ocm_copy_onesided`` op_flag=0): fresh uint8
        bytes, on the card for device arms, on the CPU for host arms.

        ``out`` (a contiguous uint8 tensor, or numpy array, sized to the
        read) is the registered-receive-buffer idiom: the bytes land in the
        caller's buffer, which is returned. A pinned ``out`` reused across
        gets saves a fresh destination (and its page faults) per read; on a
        REMOTE_HOST handle ``out`` goes to the backend's ``get_into``, and a
        host ``out`` is where the wire's stripes land.

        ``deadline_ms`` bounds the op's total time (see :meth:`put`);
        reads on a replicated handle under an armed ``OCM_HEDGE_MS`` may
        be hedged against the replica chain."""
        self._check_live(handle)
        if out is not None:
            dst = as_byte_tensor(out)
            nbytes = dst.numel()
        elif nbytes is None:
            nbytes = handle.nbytes - offset
        kw = {} if deadline_ms is None else {"deadline_ms": deadline_ms}
        with self.tracer.span("get", nbytes=nbytes):
            if self._on_backend(handle):
                backend = self._remote_or_raise(handle.kind)
                if out is not None and handle.kind in (OcmKind.REMOTE_HOST,
                                                       OcmKind.LOCAL_HOST):
                    backend.get_into(handle, dst, offset, **kw)
                    return out
                got = as_byte_tensor(backend.get(handle, nbytes, offset,
                                                 **kw))
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

    def localbuf(self, handle: OcmAlloc,
                 nbytes: int | None = None) -> torch.Tensor:
        """``ocm_localbuf`` (reference src/lib.c:425-460): the app-side
        window onto an allocation. A zero-copy view for LOCAL_HOST, a
        materialised copy for LOCAL_DEVICE. For a remote (or daemon-owned)
        handle, a host staging tensor made on first request, kept per
        handle and released by ``free``: mutate it in place, then
        ``push``/``pull`` (or ``ocm_copy_onesided`` with ``local=None``).

        ``nbytes`` sizes the window smaller than the remote region while
        the window does not exist yet (the ``alloc(local_nbytes=)``
        idiom)."""
        self._check_live(handle)
        if nbytes is not None:
            if not self._on_backend(handle):
                raise OcmInvalidHandle(
                    "a sized staging window applies to remote kinds only")
            if not 0 < nbytes <= handle.nbytes:
                raise OcmInvalidHandle(
                    f"window {nbytes} must be in (0, {handle.nbytes}]")
            with self._lock:
                existing = self._stagebufs.get(handle.alloc_id)
                if existing is not None and existing.numel() != nbytes:
                    raise OcmInvalidHandle(
                        f"staging window already created at "
                        f"{existing.numel()} B; cannot resize to {nbytes}")
                handle.local_nbytes = nbytes
        if not self._on_backend(handle):
            if handle.kind == OcmKind.LOCAL_HOST:
                return self.host_arena.view(handle.extent)
            return self.device_arenas[handle.device_index].read(
                handle.extent, handle.nbytes)
        self._remote_or_raise(handle.kind)  # a window onto no backend
        with self._lock:
            # Re-checked under the lock: a free racing in between must not
            # leave a window cached for a dead id.
            if handle.alloc_id not in self._allocs:
                raise OcmInvalidHandle(
                    f"alloc {handle.alloc_id} freed during localbuf")
            buf = self._stagebufs.get(handle.alloc_id)
            if buf is None:
                window = handle.local_nbytes or handle.nbytes
                buf = torch.zeros(window, dtype=torch.uint8)
                self._stagebufs[handle.alloc_id] = buf
        return buf

    def _staging_range(self, handle: OcmAlloc, nbytes: int | None,
                       offset: int, local_offset: int | None) -> tuple:
        """(n, local_offset) of a push/pull, bounds-checked against both
        the staging window and the remote region. A full-size window
        mirrors the region (local_offset = offset); a smaller one defaults
        to local_offset 0."""
        if not self._on_backend(handle):
            raise OcmInvalidHandle("push/pull is for remote-kind handles")
        window = handle.local_nbytes or handle.nbytes
        if local_offset is None:
            local_offset = offset if window == handle.nbytes else 0
        if nbytes is None:
            n = min(window - local_offset, handle.nbytes - offset)
        else:
            n = nbytes
        check_bounds(Extent(0, window), local_offset, n)
        check_bounds(Extent(0, handle.nbytes), offset, n)
        return n, local_offset

    def push(self, handle: OcmAlloc, nbytes: int | None = None,
             offset: int = 0, local_offset: int | None = None) -> None:
        """One-sided write of the staging window into a remote allocation
        (``offset`` addresses the region, ``local_offset`` the window)."""
        n, lo = self._staging_range(handle, nbytes, offset, local_offset)
        buf = self.localbuf(handle)
        self.put(handle, buf[lo:lo + n], offset)

    def pull(self, handle: OcmAlloc, nbytes: int | None = None,
             offset: int = 0, local_offset: int | None = None) -> None:
        """One-sided read of a remote allocation into the staging window."""
        n, lo = self._staging_range(handle, nbytes, offset, local_offset)
        buf = self.localbuf(handle)
        buf[lo:lo + n].copy_(self.get(handle, n, offset))

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
                and not (src.daemon_owned or dst.daemon_owned)
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

    def status(self, rank: int | None = None) -> dict:
        """A daemon's live STATUS (rank, nnodes, live_allocs, bytes live).
        On rank 0 ``nnodes`` is the joined count: poll it before relying
        on remote placement (a still-joining cluster demotes remote
        requests, reference src/alloc.c:82-83)."""
        return self._remote_or_raise("status").status(rank)

    def fetch_prom(self, rank: int | None = None) -> str:
        """A rank's Prometheus text exposition (STATUS_PROM), fetched
        over the ordinary in-band control path."""
        return self._remote_or_raise("fetch_prom").fetch_prom(rank)

    def start_slo(self, interval_s: float | None = None):
        """Arm the in-process SLO watcher (obs/slo.py) over this
        context's control plane: background STATUS_PROM scrapes feed the
        metrics history, the burn-rate engine evaluates the ``OCM_SLO``
        objectives, and verdicts surface in ``status()["slo"]``.
        Returns the runner, or None when ``OCM_SLO`` disables it."""
        return self._remote_or_raise("start_slo").start_slo(interval_s)

    def stop_slo(self) -> None:
        backend = self._remote
        if backend is not None:
            backend.stop_slo()

    def export_trace(self, path: str, cluster: bool = True) -> dict:
        """Write a Perfetto/Chrome-trace JSON merging this process's
        event journal (``OCM_EVENTS=1``) with — when ``cluster`` and a
        control plane is attached — every reachable daemon's journal
        (STATUS_EVENTS), trace_ids stitched as flows across pid tracks.
        Returns the exporter summary ({events, spans, tracks, flows})."""
        from oncilla_tpu_torch.obs import export, journal

        streams = [journal.events()]
        backend = self._remote
        fetch = getattr(backend, "fetch_events", None)
        if cluster and fetch is not None:
            nnodes = len(getattr(backend, "entries", []) or [])
            for rank in range(nnodes):
                try:
                    streams.append(fetch(rank))
                except Exception as e:  # noqa: BLE001 — merge survivors;
                    # a down daemon must not void the local journal
                    printd("export_trace: rank %d journal unavailable: %s",
                           rank, e)
        return export.write_chrome_trace(export.merge(*streams), path)

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

def ocm_init(config: OcmConfig | None = None, device=None, *,
             ici_plane=None) -> Ocm:
    """``ocm_init`` (reference src/lib.c:98-132). Runs on CUDA unless
    ``device="cpu"``; raises ``OcmDeviceError`` when CUDA is absent and no
    CPU was asked for. When the config names a nodefile (or
    ``OCM_NODEFILE`` is set) it attaches to the app's daemon, the
    reference's CONNECT handshake: the rank comes from ``config.rank`` or
    is detected from the nodefile. ``ici_plane`` (an ``SpmdIciPlane``)
    serves the REMOTE_DEVICE arm. A daemon that does not answer raises
    ``OcmConnectError``; nothing falls back to a single-node context, and a
    ``rank`` without a nodefile raises it too. (``Ocm(config, remote=...)``
    takes a backend the caller made and keeps.)
    """
    config = config or OcmConfig()
    dev = resolve_device(device)
    if not config.nodefile:
        if config.rank is not None:
            # A rank names a place in a cluster that nothing here locates.
            raise OcmConnectError(
                f"rank {config.rank} given without a nodefile (set "
                "OcmConfig.nodefile or OCM_NODEFILE)")
        return Ocm(config=config, device=dev)
    from oncilla_tpu_torch.runtime.client import ControlPlaneClient
    from oncilla_tpu_torch.runtime.membership import detect_rank, parse_nodefile

    entries = parse_nodefile(config.nodefile)
    rank = config.rank if config.rank is not None else detect_rank(entries)
    if not 0 <= rank < len(entries):
        raise OcmConnectError(
            f"rank {rank} out of range for the {len(entries)}-node nodefile")
    remote = ControlPlaneClient(entries, rank, config=config,
                                ici_plane=ici_plane)
    try:
        ctx = Ocm(config=config, remote=remote, device=dev)
    except BaseException:
        remote.close()
        raise
    ctx._owns_remote = True
    return ctx


def ocm_tini(ctx: Ocm) -> None:
    ctx.tini()


def ocm_alloc(ctx: Ocm, nbytes: int, kind: OcmKind = OcmKind.LOCAL_HOST, **kw):
    return ctx.alloc(nbytes, kind, **kw)


def ocm_free(ctx: Ocm, handle: OcmAlloc) -> None:
    ctx.free(handle)


def ocm_localbuf(ctx: Ocm, handle: OcmAlloc, nbytes: int | None = None):
    return ctx.localbuf(handle, nbytes)


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
    rest of the allocation when ``local`` is None). With ``local=None`` on
    a remote (or daemon-owned) handle, the op moves the handle's staging
    window (``ctx.localbuf``), as the reference's one-sided ops use the
    handle's own local arm."""
    staged = local is None and (handle.is_remote or handle.daemon_owned)
    if op == "write":
        if staged:
            ctx.push(handle, offset=offset)
        else:
            ctx.put(handle, local, offset)
        return None
    if op == "read":
        if staged:
            ctx.pull(handle, offset=offset)
            # Element 0 is the byte at ``offset``; a smaller window took the
            # pull at its position 0, so the whole window is that view.
            buf = ctx.localbuf(handle)
            return buf[offset:] if buf.numel() == handle.nbytes else buf
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
