"""The app-side control-plane client: the :class:`RemoteBackend` an
:class:`~oncilla_tpu_torch.core.context.Ocm` attached to a cluster uses.

The port's subset of ``oncilla_tpu/runtime/client.py`` (the app half of
libocm, reference src/lib.c): it registers with its local daemon (the
CONNECT handshake, lib.c:98-132), drives alloc/free through it, keeps its
leases alive with heartbeats, and talks directly to the owner daemon for
REMOTE_HOST bytes (the one-sided data plane bypasses the local daemon per
transfer). Large transfers are striped over pooled connections and
pipelined within a stripe (:mod:`oncilla_tpu_torch.fabric.tcp`).

Device arms (REMOTE_DEVICE, and the LOCAL_DEVICE handles of single-node
demotion) hold their bytes in an :class:`~oncilla_tpu_torch.ops.ici.
SpmdIciPlane`: the daemons only book the extents. A client given the plane
uses it directly and serves it to the cluster (:class:`_PlaneServer`); a
plane-less client reaches device bytes through the owner daemon, which
relays to the registered plane.

Thread safety: one lock serialises the control socket; data sockets are
leased from the pool per transfer, so prefetch workers may run transfers
from their own threads.

Not ported (each waits for a later slice): the async mux runtime, data
fabrics (FLAG_CAP_FABRIC), replication, failover, hedged reads and circuit
breakers, the adaptive window tuner and ACK coalescing, trace and deadline
propagation, and the SLO surface.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import socket
import threading
import time

import numpy as np
import torch

from oncilla_tpu_torch.core.arena import Extent
from oncilla_tpu_torch.core.errors import (
    OcmBoundsError,
    OcmConnectError,
    OcmError,
    OcmInvalidHandle,
    OcmProtocolError,
    OcmRemoteError,
)
from oncilla_tpu_torch.core.handle import OcmAlloc
from oncilla_tpu_torch.core.hostmem import as_byte_tensor
from oncilla_tpu_torch.core.kinds import Fabric, OcmKind
from oncilla_tpu_torch.fabric import tcp as tcp_fabric
from oncilla_tpu_torch.qos.policy import pack_profile
from oncilla_tpu_torch.runtime.membership import NodeEntry
from oncilla_tpu_torch.runtime.pool import PeerPool
from oncilla_tpu_torch.runtime.protocol import (
    FLAG_CAP_QOS,
    FLAG_QOS_TAIL,
    WIRE_KIND,
    WIRE_KIND_INV,
    ErrCode,
    Message,
    MsgType,
    recv_msg,
    request,
    send_msg,
)
from oncilla_tpu_torch.utils.config import OcmConfig
from oncilla_tpu_torch.utils.debug import GLOBAL_TRACER, printd

_DEVICE_KINDS = (OcmKind.REMOTE_DEVICE, OcmKind.LOCAL_DEVICE)


def backoff_sleep(step_s: float) -> None:
    """One back-off pause with jitter (uniform in [0.5, 1.0] of the step),
    so a herd of clients never re-dials a daemon in lockstep."""
    time.sleep(step_s * random.uniform(0.5, 1.0))


def _advertised_host() -> str:
    return os.environ.get("OCM_ADVERTISE_HOST", "127.0.0.1")


def _host_bytes(data) -> np.ndarray:
    """``data`` (a tensor on any device, an array, a bytes-like) as flat
    uint8 host bytes for the wire: a card tensor is copied down once."""
    raw = as_byte_tensor(data)
    if raw.device.type != "cpu":
        raw = raw.cpu()
    return raw.numpy()


class _PlaneServer:
    """Serves an ``SpmdIciPlane`` to the cluster: a loopback TCP endpoint
    speaking PLANE_PUT / PLANE_GET / PLANE_SCRUB, registered with the
    daemons by PLANE_SERVE. This is what lets a process without the plane
    (a second process, a C app) do one-sided device-kind ops: its
    DATA_PUT/DATA_GET reach the owner daemon, which relays them here.

    Each connection is served on its own thread. The plane's own lock
    serialises those threads against the controller's use; every plane
    call addresses its row's device explicitly, and a put or scrub on a
    card row is synchronised before the reply says it landed."""

    def __init__(self, plane):
        self.plane = plane
        host = os.environ.get("OCM_BIND_HOST") or (
            "0.0.0.0" if os.environ.get("OCM_ADVERTISE_HOST") else "127.0.0.1")
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, 0))
        self._srv.listen(32)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._conns: set[socket.socket] = set()
        self._mu = threading.Lock()
        #: Relayed ops served, by message type name.
        self.served = {"PLANE_PUT": 0, "PLANE_GET": 0, "PLANE_SCRUB": 0}
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="ocm-plane-srv")
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._mu:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="ocm-plane-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    msg = recv_msg(conn)
                except (OSError, OcmProtocolError):
                    return
                try:
                    reply = self._handle(msg)
                except Exception as e:  # noqa: BLE001 — typed wire error
                    # The relay must keep serving: every failure goes back
                    # as an ERROR reply the daemon forwards to the caller.
                    printd("plane server: %s: %s", type(e).__name__, e)
                    if isinstance(e, OcmBoundsError):
                        code = ErrCode.BOUNDS
                    elif isinstance(e, OcmInvalidHandle):
                        code = ErrCode.BAD_ALLOC_ID
                    else:
                        code = ErrCode.UNKNOWN
                    reply = Message(MsgType.ERROR, {
                        "code": int(code),
                        "detail": f"plane: {type(e).__name__}: {e}"})
                try:
                    send_msg(conn, reply)
                except OSError:
                    return
        finally:
            with self._mu:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, msg: Message) -> Message:
        f = msg.fields
        if msg.type not in (MsgType.PLANE_PUT, MsgType.PLANE_GET,
                            MsgType.PLANE_SCRUB):
            raise OcmProtocolError(f"plane server got {msg.type.name}")
        handle = OcmAlloc(
            alloc_id=f["alloc_id"], kind=OcmKind.REMOTE_DEVICE,
            fabric=Fabric.ICI, nbytes=f["ext_nbytes"], rank=f["rank"],
            device_index=f["device_index"],
            extent=Extent(offset=f["ext_offset"], nbytes=f["ext_nbytes"]),
            origin_rank=f["rank"],
        )
        with self._mu:
            self.served[msg.type.name] += 1
        dev = self.plane.device_of(handle)
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            if msg.type == MsgType.PLANE_SCRUB:
                # Owner-daemon free-time scrub of a recycled device extent.
                self.plane.scrub(handle)
                _settle(dev)
                return Message(MsgType.DATA_PUT_OK, {"nbytes": f["ext_nbytes"]})
            if msg.type == MsgType.PLANE_PUT:
                if len(msg.data) != f["nbytes"]:
                    raise OcmProtocolError("PLANE_PUT length mismatch")
                self.plane.put(handle, np.frombuffer(msg.data, dtype=np.uint8),
                               f["offset"])
                _settle(dev)
                return Message(MsgType.DATA_PUT_OK, {"nbytes": f["nbytes"]})
            got = self.plane.get(handle, f["nbytes"], f["offset"])
            return Message(MsgType.DATA_GET_OK, {"nbytes": f["nbytes"]},
                           _host_bytes(got))

    def close(self) -> None:
        self._stop.set()
        try:
            # shutdown wakes the accept() blocked in the accept thread;
            # close alone does not.
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        with self._mu:
            conns, self._conns = list(self._conns), set()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
                c.close()
            except OSError:
                pass
        self._accept_thread.join(timeout=5.0)


def _settle(dev: torch.device) -> None:
    """Wait until the work queued on ``dev``'s current stream has run, so
    a relay reply never runs ahead of the bytes it acknowledges."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


class ControlPlaneClient:
    """Connects an app process to its local daemon, and to owner daemons
    for data. Implements the ``RemoteBackend`` protocol of
    :class:`~oncilla_tpu_torch.core.context.Ocm`.

    With an ``ici_plane`` the client serves that plane to the cluster.
    ``app_id`` (default: the OS pid) is
    the app identity on the wire; leases and DISCONNECT reclamation are per
    (app_id, rank), so clients sharing a process and a rank share them
    unless given their own ``app_id``."""

    def __init__(self, entries: list[NodeEntry], rank: int,
                 config: OcmConfig | None = None, ici_plane=None,
                 heartbeat: bool = True, app_id: int | None = None):
        self.entries = list(entries)
        self.rank = rank
        self.config = config or OcmConfig()
        self.pid = os.getpid() if app_id is None else int(app_id)
        self.ici_plane = ici_plane
        self.tracer = GLOBAL_TRACER
        self._pool = PeerPool()
        self._ctrl, self.rank = self._connect_ladder(self.entries, rank)
        self._ctrl.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._ctrl_lock = threading.Lock()
        # Which ranks own this app's live remote allocations (rank ->
        # count), reported on HEARTBEAT/DISCONNECT so daemons relay and
        # reclaim with O(owners) fan-out.
        self._owner_ranks: dict[int, int] = {}
        self._owner_lock = threading.Lock()
        #: Wire transfers this client made (one per put/get, whatever its
        #: stripes and chunks), and their bytes.
        self.transfers = {"put": 0, "get": 0, "put_bytes": 0, "get_bytes": 0}
        self._stats_lock = threading.Lock()
        # Host staging for card tensors (pinned when CUDA is there): a card
        # put is copied down into it and sent from it, a get into a card
        # tensor lands in it and is copied up. Grown to the largest
        # transfer, reused; held under its lock for the whole transfer.
        self._stage: torch.Tensor | None = None
        self._stage_lock = threading.Lock()
        self._plane_server: _PlaneServer | None = None
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        try:
            self._handshake()
            if ici_plane is not None:
                self._plane_server = _PlaneServer(ici_plane)
                r = self._request(Message(MsgType.PLANE_SERVE, {
                    "host": _advertised_host(),
                    "port": self._plane_server.port, "relay": 0}))
                if r.type != MsgType.PLANE_SERVE_OK:
                    raise OcmConnectError(
                        f"plane registration failed: {r.type.name}")
        except BaseException:
            self._teardown()
            raise
        if heartbeat:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name=f"ocm-hb-{self.rank}")
            self._hb_thread.start()

    def _handshake(self) -> None:
        """CONNECT / CONNECT_CONFIRM (lib.c:128-132). The port offers a
        capability only for what it implements: the QoS profile, declared
        when the config's profile is not the default (the serving
        harness's cold client declares PRIO_LOW); otherwise the frame is
        the plain CONNECT."""
        connect = Message(MsgType.CONNECT, {"pid": self.pid, "rank": self.rank})
        if self.config.qos_offer:
            connect.flags |= FLAG_CAP_QOS | FLAG_QOS_TAIL
            connect.data = pack_profile(self.config.priority,
                                        self.config.quota_bytes,
                                        self.config.quota_handles)
        r = self._request(connect)
        if r.type != MsgType.CONNECT_CONFIRM:
            raise OcmConnectError(f"bad handshake reply {r.type.name}")
        self._ctrl_caps = r.flags & FLAG_CAP_QOS
        self.nnodes = r.fields["nnodes"]

    # -- plumbing --------------------------------------------------------

    def _connect_ctrl(self, host: str, port: int,
                      retries: int | None = None) -> socket.socket:
        """Dial one daemon with capped exponential back-off + jitter: a
        restarting daemon refuses connections for a beat."""
        cfg = self.config
        retries = cfg.connect_retries if retries is None else retries
        delay = max(cfg.connect_backoff_s, 1e-3)
        last: OSError | None = None
        for attempt in range(retries + 1):
            try:
                return socket.create_connection((host, port), timeout=30.0)
            except OSError as e:
                last = e
                if attempt == retries:
                    break
                backoff_sleep(min(delay, cfg.connect_backoff_cap_s))
                delay *= 2
        raise OcmConnectError(
            f"local daemon unreachable at {host}:{port} after "
            f"{retries + 1} attempts: {last}") from last

    def _connect_ladder(self, entries, rank: int) -> tuple[socket.socket, int]:
        """The app's own rank first with the full retry budget, then every
        other seed once with one quick retry. Returns (socket, rank of the
        daemon reached): boot survives any single seed being down."""
        me = entries[rank]
        try:
            return self._connect_ctrl(me.connect_host, me.port), rank
        except OcmConnectError as e:
            last: OcmConnectError = e
        for e in entries:
            if e.rank == rank or not e.port:
                continue
            try:
                sock = self._connect_ctrl(e.connect_host, e.port, retries=1)
            except OcmConnectError as err:
                last = err
                continue
            printd("client: seed rank %d unreachable, attached to rank %d at "
                   "%s:%d instead", rank, e.rank, e.connect_host, e.port)
            return sock, e.rank
        raise OcmConnectError(
            f"no seed daemon reachable (own rank {rank} and every other "
            f"nodefile address refused): {last}") from last

    def _request(self, msg: Message) -> Message:
        # The control socket is one framed request/reply stream; the lock
        # is held across the round trip and nothing else is taken under it.
        with self._ctrl_lock:
            return request(self._ctrl, msg)

    def _owners_field(self) -> str:
        with self._owner_lock:
            return ",".join(str(r) for r in sorted(self._owner_ranks))

    def _note_owner(self, rank: int, delta: int) -> None:
        if rank == self.rank:
            return
        with self._owner_lock:
            n = self._owner_ranks.get(rank, 0) + delta
            if n > 0:
                self._owner_ranks[rank] = n
            else:
                self._owner_ranks.pop(rank, None)

    def _heartbeat_loop(self) -> None:
        beats = 0
        while not self._hb_stop.wait(self.config.heartbeat_s):
            try:
                self._request(Message(MsgType.HEARTBEAT, {
                    "rank": self.rank, "pid": self.pid,
                    "owners": self._owners_field()}))
                beats += 1
                if self._plane_server is not None and beats % 15 == 0:
                    # Periodic re-registration heals daemons that dropped
                    # the endpoint; an unchanged one is a no-op there.
                    self._request(Message(MsgType.PLANE_SERVE, {
                        "host": _advertised_host(),
                        "port": self._plane_server.port, "relay": 0}))
            except (OSError, OcmProtocolError):
                printd("client rank %d: heartbeat failed", self.rank)

    def close(self) -> None:
        """Stop heartbeating, deregister the plane and send DISCONNECT, on
        which the daemons reclaim this app's allocations at once."""
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=10.0)
        if self._plane_server is not None:
            try:
                self._request(Message(MsgType.PLANE_SERVE,
                                      {"host": "", "port": 0, "relay": 0}))
            except (OSError, OcmError):
                pass
        # Bounded lock: a beat inside _request holds it mid send/recv, and
        # an unlocked send would interleave frames. If the daemon is wedged
        # the courtesy message is skipped; the lease reaper covers it.
        if self._ctrl_lock.acquire(timeout=2.0):
            try:
                send_msg(self._ctrl, Message(MsgType.DISCONNECT, {
                    "pid": self.pid, "owners": self._owners_field()}))
            except OSError:
                pass
            finally:
                self._ctrl_lock.release()
        self._teardown()

    def _teardown(self) -> None:
        self._pool.close()
        if self._plane_server is not None:
            self._plane_server.close()
        try:
            self._ctrl.close()
        except OSError:
            pass

    # -- RemoteBackend: alloc / free ------------------------------------

    def alloc(self, nbytes: int, kind: OcmKind) -> OcmAlloc:
        req = Message(MsgType.REQ_ALLOC, {
            "orig_rank": self.rank, "pid": self.pid,
            "kind": WIRE_KIND[kind.value], "nbytes": nbytes})
        f = self._alloc_request(req).fields
        placed = OcmKind(WIRE_KIND_INV[f["kind"]])
        fabric = (Fabric.LOCAL if not placed.is_remote else
                  Fabric.ICI if placed == OcmKind.REMOTE_DEVICE else Fabric.DCN)
        h = OcmAlloc(
            alloc_id=f["alloc_id"], kind=placed, fabric=fabric, nbytes=nbytes,
            rank=f["rank"], device_index=f["device_index"],
            extent=Extent(offset=f["offset"], nbytes=nbytes),
            origin_rank=self.rank,
        )
        h.owner_addr = (f["owner_host"], f["owner_port"])
        h.daemon_owned = True  # even when demoted: the daemon holds the bytes
        self._note_owner(h.rank, +1)
        # Device-arm scrub (calloc parity, reference src/alloc.c:171): the
        # daemon only books device extents. Its free-time PLANE_SCRUB is
        # the authoritative scrub; a plane-owning client also zeroes at
        # alloc, for setups where no endpoint was registered.
        if placed in _DEVICE_KINDS and self.ici_plane is not None:
            self.ici_plane.scrub(h)
        return h

    def _alloc_request(self, req: Message) -> Message:
        """REQ_ALLOC with back-pressure compliance: a BUSY rejection is
        retried with capped jittered back-off, seeded by the daemon's
        suggested delay; every other error, and BUSY once the retries are
        spent, propagates."""
        cfg = self.config
        delay = max(cfg.busy_backoff_ms, 1) / 1e3
        for attempt in range(cfg.busy_retries + 1):
            try:
                return self._request(req)
            except OcmRemoteError as e:
                if e.code != int(ErrCode.BUSY) or attempt == cfg.busy_retries:
                    raise
                hint = getattr(e, "retry_after_ms", 0) / 1e3
                step = min(max(delay, hint),
                           cfg.connect_backoff_cap_s)
                printd("client rank %d: BUSY, backing off %.0f ms (attempt "
                       "%d)", self.rank, step * 1e3, attempt + 1)
                backoff_sleep(step)
                delay *= 2
        raise AssertionError("unreachable")  # the loop returns or raises

    def free(self, handle: OcmAlloc) -> None:
        # Leave the owner set before the round trip (restored on failure):
        # a heartbeat racing the free must not relay for a dying extent.
        self._note_owner(handle.rank, -1)
        try:
            self._request(Message(MsgType.REQ_FREE, {
                "alloc_id": handle.alloc_id, "rank": handle.rank}))
        except BaseException:
            self._note_owner(handle.rank, +1)
            raise

    # -- RemoteBackend: one-sided data ----------------------------------

    def put(self, handle: OcmAlloc, data, offset: int = 0) -> None:
        if handle.kind in _DEVICE_KINDS and self.ici_plane is not None:
            self.ici_plane.put(handle, data, offset)
            return
        raw = as_byte_tensor(data)
        if raw.device.type == "cpu":
            self._put_host(handle, raw.numpy(), offset)
            return
        with self._stage_lock:
            stage = self._staging(raw.numel())
            stage.copy_(raw)
            self._put_host(handle, stage.numpy(), offset)

    def _put_host(self, handle: OcmAlloc, raw: np.ndarray, offset: int) -> None:
        with self.tracer.span("dcn_put", nbytes=raw.nbytes):
            self._transfer(handle, raw.nbytes, offset, put_mv=memoryview(raw))
        self._note("put", raw.nbytes)

    def _staging(self, n: int) -> torch.Tensor:
        """``n`` bytes of the staging buffer; hold ``_stage_lock``."""
        if self._stage is None or self._stage.numel() < n:
            self._stage = None  # release the smaller one first
            self._stage = torch.empty(n, dtype=torch.uint8,
                                      pin_memory=torch.cuda.is_available())
        return self._stage[:n]

    def get(self, handle: OcmAlloc, nbytes: int, offset: int = 0):
        """The bytes: on the plane's device for device arms the client's
        plane holds, else a fresh CPU tensor off the wire."""
        if handle.kind in _DEVICE_KINDS and self.ici_plane is not None:
            return self.ici_plane.get(handle, nbytes, offset)
        out = np.empty(nbytes, dtype=np.uint8)
        self._get_into(handle, out, offset)
        return torch.from_numpy(out)

    def get_into(self, handle: OcmAlloc, out, offset: int = 0):
        """One-sided get into a caller-owned buffer: a writable C-contiguous
        uint8 numpy array, or a contiguous uint8 tensor. The
        registered-receive-buffer idiom: the stripes land in disjoint views
        of a host ``out`` (a pinned staging buffer, say); a card ``out`` is
        filled from the client's pinned staging. Returns ``out``."""
        if handle.kind in _DEVICE_KINDS:
            raise OcmError("get_into serves host-kind handles only")
        if isinstance(out, torch.Tensor):
            if out.dtype != torch.uint8 or not out.is_contiguous():
                raise ValueError("out must be a contiguous uint8 tensor")
            if out.device.type != "cpu":
                with self._stage_lock:
                    stage = self._staging(out.numel())
                    self._get_into(handle, stage.numpy(), offset)
                    out.view(-1).copy_(stage)
                return out
            arr = out.numpy()
        else:
            arr = out
            if (arr.dtype != np.uint8 or not arr.flags.c_contiguous
                    or not arr.flags.writeable):
                raise ValueError("out must be a writable C-contiguous uint8 array")
        self._get_into(handle, arr.reshape(-1), offset)
        return out

    def _get_into(self, handle: OcmAlloc, arr: np.ndarray, offset: int) -> None:
        with self.tracer.span("dcn_get", nbytes=arr.nbytes):
            self._transfer(handle, arr.nbytes, offset, get_arr=arr)
        self._note("get", arr.nbytes)

    def _note(self, op: str, nbytes: int) -> None:
        with self._stats_lock:
            self.transfers[op] += 1
            self.transfers[f"{op}_bytes"] += nbytes

    def _owner_addr(self, handle: OcmAlloc) -> tuple[str, int]:
        if handle.owner_addr is not None:
            return tuple(handle.owner_addr)
        e = self.entries[handle.rank]
        return (e.connect_host, e.port)

    def _transfer(self, handle: OcmAlloc, total: int, offset: int,
                  put_mv: memoryview | None = None,
                  get_arr: np.ndarray | None = None) -> None:
        """Move ``total`` bytes at handle-relative ``offset`` straight to or
        from the owner daemon: split into contiguous stripes, each on its
        own leased connection and thread, each a pipelined window."""
        addr = self._owner_addr(handle)
        nstripes = tcp_fabric.plan_stripes(self.config, total)
        if nstripes == 1:
            self._stripe(handle, 0, total, offset, put_mv, get_arr, addr, None)
            return
        # Contention may shrink the set: re-split over what was leased.
        entries = self._pool.lease_set(addr[0], addr[1], nstripes)
        nstripes = len(entries)
        base, rem = divmod(total, nstripes)
        ranges, start = [], 0
        for i in range(nstripes):
            length = base + (1 if i < rem else 0)
            ranges.append((start, length))
            start += length
        errors: list[BaseException | None] = [None] * nstripes

        def worker(i: int) -> None:
            s0, ln = ranges[i]
            try:
                self._stripe(handle, s0, ln, offset, put_mv, get_arr, addr,
                             entries[i])
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                errors[i] = exc

        threads = [threading.Thread(target=worker, args=(i,),
                                    name=f"ocm-stripe-{i}")
                   for i in range(1, nstripes)]
        for t in threads:
            t.start()
        worker(0)
        for t in threads:
            t.join()
        failures = [e for e in errors if e is not None]
        if failures:
            # Prefer the typed rejection over sibling stripes' transport
            # noise.
            for e in failures:
                if isinstance(e, OcmRemoteError):
                    raise e
            raise failures[0]

    def _stripe(self, handle: OcmAlloc, start: int, length: int, offset: int,
                put_mv, get_arr, addr, entry) -> None:
        host, port = addr
        if entry is None:
            entry = self._pool.lease(host, port)
        try:
            tcp_fabric.stripe_windowed(
                entry.sock, handle, start, length, offset, put_mv, get_arr,
                self.config.chunk_bytes, self.config.inflight_ops)
        except OcmRemoteError:
            # Raised only after the reply stream was drained: the
            # connection is in sync, keep it.
            self._pool.release(host, port, entry)
            raise
        except BaseException:
            # Replies may still be on the wire: the connection cannot be
            # trusted, and the lease must not leak.
            self._pool.discard(host, port, entry)
            raise
        self._pool.release(host, port, entry)

    # -- introspection ---------------------------------------------------

    def _rank_request(self, rank: int | None, msg: Message) -> Message:
        """One STATUS-family request: the control stream for the local
        rank, a short-lived direct dial for another."""
        if rank is None or rank == self.rank:
            return self._request(msg)
        e = self.entries[rank]
        s = socket.create_connection((e.connect_host, e.port), timeout=30.0)
        try:
            return request(s, msg)
        finally:
            s.close()

    def status(self, rank: int | None = None) -> dict:
        """A daemon's STATUS fields (rank, nnodes, live_allocs, bytes
        live), merged with its JSON telemetry tail when it sends one, and
        this client's wire transfers under ``transfers``."""
        r = self._rank_request(rank, Message(MsgType.STATUS, {}))
        f = dict(r.fields)
        if r.data:
            try:
                f.update(json.loads(bytes(r.data)))
            except (ValueError, UnicodeDecodeError):
                pass  # a tail from a daemon this client does not read
        with self._stats_lock:
            f["transfers"] = dict(self.transfers)
        return f
