"""The app-side control-plane client: the :class:`RemoteBackend` an
:class:`~oncilla_tpu_torch.core.context.Ocm` attached to a cluster uses.

The port's copy of ``oncilla_tpu/runtime/client.py``, line for line, with
the imports renamed to the port's modules (the app half of libocm,
reference src/lib.c): it registers with its local daemon (the CONNECT
handshake, lib.c:98-132), drives alloc/free through it, keeps its leases
alive with heartbeats, and talks directly to the owner daemon for
REMOTE_HOST bytes (the one-sided data plane bypasses the local daemon per
transfer). Large transfers are striped over pooled connections, pipelined
within a stripe, ACK-coalesced where the daemon grants it and windowed by a
per-peer tuner (:mod:`oncilla_tpu_torch.fabric.tcp`); a same-host pair may
run the shared-memory fabric instead (``OCM_FABRIC=shm``). ``OCM_MUX=1``
puts every tenant of the process on one connection per peer
(:mod:`oncilla_tpu_torch.runtime.mux`). ``OCM_REPLICAS=k`` asks for k-way
replicated placements; a transfer that cannot reach the primary walks the
failover ladder (membership address, replica chain, REQ_LOCATE), a read
may be hedged against the replica (``OCM_HEDGE_MS``), every op may carry a
time budget (``deadline_ms``, ``OCM_DEADLINE_MS``) and a per-peer circuit
breaker fails a sick peer fast (``OCM_BREAKER_THRESHOLD``).

Where a tensor meets the wire: a card tensor is copied into pinned host
staging on the caller's thread (synchronised) before its bytes go out, and
a get into a card tensor lands in that staging and goes up on the caller's
stream afterwards. Neither the mux event loop nor a stripe thread touches
the card.

Device arms (REMOTE_DEVICE, and the LOCAL_DEVICE handles of single-node
demotion) hold their bytes in an :class:`~oncilla_tpu_torch.ops.ici.
SpmdIciPlane`: the daemons only book the extents. A client given the plane
uses it directly and serves it to the cluster (:class:`_PlaneServer`); a
plane-less client reaches device bytes through the owner daemon, which
relays to the registered plane.

``start_slo`` arms the in-process SLO watcher (:mod:`oncilla_tpu_torch.obs.slo`) over
this client's STATUS_PROM path; its verdicts ride ``status()["slo"]``.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import socket
import threading
import time

import numpy as np
import torch

from oncilla_tpu_torch.analysis.lockwatch import make_lock
from oncilla_tpu_torch.core.arena import Extent
from oncilla_tpu_torch.core.errors import (
    OcmBoundsError,
    OcmConnectError,
    OcmDeadlineExceeded,
    OcmError,
    OcmInvalidHandle,
    OcmProtocolError,
    OcmRemoteError,
)
from oncilla_tpu_torch.core.handle import OcmAlloc
from oncilla_tpu_torch.core.hostmem import as_byte_tensor
from oncilla_tpu_torch.core.kinds import Fabric, OcmKind
from oncilla_tpu_torch.fabric import attach_peer
from oncilla_tpu_torch.fabric import tcp as tcp_fabric
from oncilla_tpu_torch.obs import journal as obs_journal
from oncilla_tpu_torch.obs import trace as obs_trace
from oncilla_tpu_torch.resilience import timebudget
from oncilla_tpu_torch.runtime.membership import NodeEntry
from oncilla_tpu_torch.runtime.pool import PeerPool
from oncilla_tpu_torch.runtime import mux as mux_rt
from oncilla_tpu_torch.qos.policy import pack_profile
from oncilla_tpu_torch.runtime.protocol import (
    ErrCode,
    FLAG_CAP_COALESCE,
    FLAG_CAP_DEADLINE,
    FLAG_CAP_FABRIC,
    FLAG_CAP_QOS,
    FLAG_CAP_REPLICA,
    FLAG_CAP_TRACE,
    FLAG_DEADLINE,
    FLAG_QOS_TAIL,
    FLAG_REPLICAS,
    FLAG_TRACE_CTX,
    VALID_FLAGS,
    WIRE_KIND,
    WIRE_KIND_INV,
    Message,
    MsgType,
    recv_msg,
    request,
    send_msg,
)
from oncilla_tpu_torch.utils.config import OcmConfig
from oncilla_tpu_torch.utils.debug import GLOBAL_TRACER, printd


def backoff_sleep(step_s: float, budget: timebudget.Budget | None = None,
                  ) -> float:
    """One capped-backoff pause with jitter (uniform in [0.5, 1.0] of the
    step) — shared by the CONNECT retry ladder, the QoS BUSY retry and
    the failover ladders so a herd of clients never re-dials a saturated
    daemon in lockstep. With a ``budget`` the sleep is CLAMPED to the
    op's remaining time (resilience/timebudget.py): a ladder may never
    sleep past its own deadline. Returns the seconds actually slept."""
    return timebudget.backoff_sleep(step_s, budget)


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


# The striped TCP engine lives in the fabric layer:
# the tuner and stripe loops live in oncilla_tpu_torch/fabric/tcp.py now;
# this alias keeps the long-standing import path working.
_PeerTuner = tcp_fabric.PeerTuner

# Free staging buffers a client keeps between card transfers (the largest
# ones): as many transfers as this overlap with no new pinned allocation,
# and a burst of more gives its extra buffers back to the allocator.
STAGE_KEEP = 2


class ControlPlaneClient:
    """Connects an app process to its local daemon (and, for data, directly
    to owner daemons). Implements the RemoteBackend protocol of
    :class:`oncilla_tpu_torch.core.context.Ocm`.

    When constructed with an ``ici_plane``, the client also SERVES that
    plane to the cluster (``serve_plane=False`` opts out): plane-less
    processes' device-kind data ops are relayed here by the daemons (see
    :class:`_PlaneServer`)."""

    def __init__(
        self,
        entries: list[NodeEntry],
        rank: int,
        config: OcmConfig | None = None,
        ici_plane=None,
        heartbeat: bool = True,
        serve_plane: bool = True,
        app_id: int | None = None,
    ):
        self.entries = entries
        self.rank = rank
        self.config = config or OcmConfig()
        # App identity on the wire. Defaults to the OS pid (one app per
        # process, as in the reference); ``app_id`` lets a process host
        # several logical tenants — each with its own leases, QoS
        # profile and quota — which is how the qos soak simulates dozens
        # of apps in one harness process.
        self.pid = os.getpid() if app_id is None else int(app_id)
        self.ici_plane = ici_plane
        self.tracer = GLOBAL_TRACER
        self._pool = PeerPool()
        # Async mux runtime (runtime/mux.py, OCM_MUX=1): the process-
        # shared one-connection-per-peer channel set replaces BOTH the
        # dedicated ctrl socket and the per-tenant data-plane pool
        # leases — this client becomes a thin sync facade over the
        # background event loop. Unset keeps the blocking per-request
        # client (and the wire) exactly as before.
        self._mux: mux_rt.MuxRuntime | None = None
        self._mux_hb = None
        self._hb_beats = 0
        self._ctrl_addr: tuple[str, int] | None = None
        if self.config.mux:
            self._mux = mux_rt.acquire_runtime(self.config)
            self._ctrl = None
            try:
                self._ctrl_addr, self.rank = self._mux_bootstrap(
                    entries, rank
                )
            except BaseException:
                mux_rt.release_runtime(self._mux)
                raise
        else:
            # Bootstrap CONNECT ladder (control/): the preferred seat is
            # the local rank's daemon, but boot must not hard-depend on
            # any ONE seed address being alive (the old behavior made
            # the nodefile's own-rank row — rank 0 for most single-host
            # tools — a single point of failure). Walk the remaining
            # seed addresses with capped backoff; the first live daemon
            # becomes this app's local daemon, and the client adopts ITS
            # rank as the app's origin.
            self._ctrl, self.rank = self._connect_ladder(entries, rank)
            self._ctrl.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._ctrl_lock = make_lock("client._ctrl_lock")
        # Which ranks own this app's live remote allocations (rank -> count).
        # Reported on HEARTBEAT/DISCONNECT so daemons relay/reclaim with
        # O(owners) fan-out instead of broadcasting to every node; app-side
        # because the handles live here and the set survives daemon restarts.
        self._owner_ranks: dict[int, int] = {}
        self._owner_lock = make_lock("client._owner_lock")
        # DCN data-plane state per owner daemon addr: negotiated capability
        # bits (None until probed on the first leased data socket), the
        # adaptive window/chunk tuner, and the negotiated one-sided fabric
        # (fabric/: a PeerFabric once attached, None = this pair runs
        # tcp). One leaf lock covers all three maps.
        self._dcn_caps: dict[tuple[str, int], int] = {}
        self._dcn_tuners: dict[tuple[str, int], _PeerTuner] = {}
        self._dcn_fabrics: dict[tuple[str, int], object] = {}
        self._dcn_lock = make_lock("client._dcn_lock")
        # Handle-failover swap guard: concurrent stripes retrying the
        # same handle must repoint it (and fix owner accounting) exactly
        # once (resilience/).
        self._fo_lock = make_lock("client._fo_lock")
        # Per-peer circuit breaker (resilience/timebudget.py): a no-op
        # unless OCM_BREAKER_THRESHOLD arms it. Wired into the transfer
        # path so a sick-but-not-DEAD peer fails FAST instead of eating
        # every op's budget on full connect/transfer timeouts.
        self._breaker = timebudget.breaker_from(self.config)
        # In-process SLO watcher (obs/slo.py): armed by start_slo(),
        # surfaced through status()["slo"].
        self._slo = None
        #: Wire transfers this client made (one per put/get, whatever its
        #: stripes and chunks), and their bytes.
        self.transfers = {"put": 0, "get": 0, "put_bytes": 0, "get_bytes": 0}
        self._stats_lock = threading.Lock()
        # Host staging for card tensors (pinned when CUDA is there): a card
        # put is copied down into a buffer and sent from it, a get into a
        # card tensor lands in one and is copied up. Each transfer takes a
        # buffer of its own from this pool (under the lock) and gives it
        # back after; the wire legs run with no lock held, so card puts and
        # gets of one client overlap. At most STAGE_KEEP buffers stay free.
        self._stage_free: list[torch.Tensor] = []
        self._stage_lock = threading.Lock()
        self._plane_server: _PlaneServer | None = None
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        try:
            self._handshake(ici_plane, serve_plane)
        except BaseException:
            self._teardown()
            raise
        if heartbeat:
            if self._mux is not None:
                # One loop task per tenant instead of one thread each —
                # the thread-footprint half of the mux win.
                self._mux_hb = self._mux.add_periodic(
                    self.config.heartbeat_s, self._hb_messages
                )
            else:
                self._hb_thread = threading.Thread(
                    target=self._heartbeat_loop, daemon=True,
                    name=f"ocm-hb-{rank}")
                self._hb_thread.start()

    def _handshake(self, ici_plane, serve_plane: bool) -> None:
        """CONNECT, then the plane's registration when the client serves
        one."""
        # CONNECT / CONNECT_CONFIRM handshake (lib.c:128-132), offering
        # the trace capability — and, when OCM_REPLICAS > 1, the replica
        # capability (never offered at k=1, so the default wire is
        # byte-for-byte the pre-replication protocol). Granted bits gate
        # whether _request may prefix trace context / whether alloc may
        # request replicated placements on this ctrl stream. Must be 0
        # while the handshake itself is in flight.
        self._ctrl_caps = 0
        offer = (FLAG_CAP_TRACE if self.config.trace else 0) | (
            FLAG_CAP_REPLICA if self.config.replicas > 1 else 0
        ) | (FLAG_CAP_DEADLINE if self.config.deadline_offer else 0)
        # QoS profile declaration (qos/): only a NON-default profile is
        # worth a capability offer — priority/quota unset keeps this
        # frame byte-for-byte the pre-QoS CONNECT. The profile rides the
        # same frame as a FLAG_QOS_TAIL data tail; decliners (old
        # daemons, the native C++ daemon) ignore both bit and tail.
        connect = Message(
            MsgType.CONNECT, {"pid": self.pid, "rank": self.rank},
            flags=offer,
        )
        if self.config.qos_offer:
            connect.flags |= FLAG_CAP_QOS | FLAG_QOS_TAIL
            connect.data = pack_profile(
                self.config.priority,
                self.config.quota_bytes,
                self.config.quota_handles,
            )
        r = self._request(connect)
        if r.type != MsgType.CONNECT_CONFIRM:
            raise OcmConnectError(f"bad handshake reply {r.type.name}")
        self._ctrl_caps = r.flags & (
            FLAG_CAP_TRACE | FLAG_CAP_REPLICA | FLAG_CAP_QOS
            | FLAG_CAP_DEADLINE
        )
        self.nnodes = r.fields["nnodes"]
        if ici_plane is not None and serve_plane:
            self._plane_server = _PlaneServer(ici_plane)
            r = self._request(Message(
                MsgType.PLANE_SERVE,
                {"host": _advertised_host(),
                 "port": self._plane_server.port, "relay": 0},
            ))
            if r.type != MsgType.PLANE_SERVE_OK:
                raise OcmConnectError(
                    f"plane registration failed: {r.type.name}"
                )

    # -- plumbing --------------------------------------------------------

    def _connect_ctrl(self, host: str, port: int,
                      retries: int | None = None) -> socket.socket:
        """Dial one daemon with capped exponential backoff + jitter: a
        daemon restarting (snapshot restore, mid-failover replacement)
        refuses connections for a beat, and a hard error on the very
        first attempt would surface that routine window to the app.
        Jitter (uniform in [0.5, 1.0] of the step) keeps a herd of
        clients from re-dialing a rebinding daemon in lockstep."""
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
            f"{retries + 1} attempts: {last}"
        ) from last

    def _connect_ladder(
        self, entries, rank: int
    ) -> tuple[socket.socket, int]:
        """Walk the seed addresses: the app's own rank first (with the
        full retry budget — a restarting local daemon is the routine
        case), then every other seed once each with one quick retry.
        Returns (socket, rank of the daemon it reaches). Boot therefore
        survives any single seed being down — including the nodefile's
        rank-0 row — as long as ANY seeded daemon answers; leader
        discovery from there is the daemons' NOT_MASTER/REQ_LOCATE
        backstop, not the client's problem."""
        me = entries[rank]
        try:
            return self._connect_ctrl(me.connect_host, me.port), rank
        except OcmConnectError as e:
            last: OcmConnectError = e
        for e in entries:
            r = getattr(e, "rank", None)
            if r is None or r == rank or not e.port:
                continue
            try:
                sock = self._connect_ctrl(e.connect_host, e.port, retries=1)
            except OcmConnectError as err:
                last = err
                continue
            printd(
                "client: seed rank %d unreachable, attached to rank %d "
                "at %s:%d instead", rank, r, e.connect_host, e.port,
            )
            return sock, r
        raise OcmConnectError(
            f"no seed daemon reachable (own rank {rank} and every other "
            f"nodefile address refused): {last}"
        ) from last

    def _mux_bootstrap(
        self, entries, rank: int
    ) -> tuple[tuple[str, int], int]:
        """The CONNECT ladder over mux channels: the own-rank seed gets
        the full capped-backoff retry budget (a restarting local daemon
        is the routine case), every other seed one attempt; the channel
        to the first live daemon becomes this tenant's ctrl stream and
        the client adopts that daemon's rank as its origin."""
        cfg = self.config
        me = entries[rank]
        last: OcmError | None = None
        delay = max(cfg.connect_backoff_s, 1e-3)
        for attempt in range(cfg.connect_retries + 1):
            try:
                self._mux.open_sync((me.connect_host, me.port), rank)
                return (me.connect_host, me.port), rank
            except OcmConnectError as e:
                last = e
                if attempt < cfg.connect_retries:
                    backoff_sleep(min(delay, cfg.connect_backoff_cap_s))
                    delay *= 2
        for e in entries:
            r = getattr(e, "rank", None)
            if r is None or r == rank or not e.port:
                continue
            try:
                ch = self._mux.open_sync((e.connect_host, e.port), rank)
            except OcmConnectError as err:
                last = err
                continue
            adopted = ch.peer_rank if ch.peer_rank is not None else r
            printd(
                "client: seed rank %d unreachable, attached to rank %d "
                "at %s:%d over mux", rank, adopted, e.connect_host, e.port,
            )
            return (e.connect_host, e.port), adopted
        raise OcmConnectError(
            f"no seed daemon reachable over mux (own rank {rank} and "
            f"every other nodefile address refused): {last}"
        ) from last

    def _hb_messages(self) -> list:
        """One heartbeat tick's messages for the mux runtime's periodic
        scheduler — the loop-task twin of _heartbeat_loop (including the
        every-15th-beat plane re-registration)."""
        self._hb_beats += 1
        msgs = [(self._ctrl_addr, Message(
            MsgType.HEARTBEAT,
            {"rank": self.rank, "pid": self.pid,
             "owners": self._owners_field()},
        ))]
        if self._plane_server is not None and self._hb_beats % 15 == 0:
            msgs.append((self._ctrl_addr, Message(
                MsgType.PLANE_SERVE,
                {"host": _advertised_host(),
                 "port": self._plane_server.port, "relay": 0},
            )))
        return msgs

    def _request(self, msg: Message,
                 budget: timebudget.Budget | None = None) -> Message:
        # Mux path: the runtime captures the ambient trace context and
        # the channel attaches it (peer-grant-gated) — exactly the
        # discipline below, one hop later. The budget rides explicitly.
        if self._mux is not None:
            return self._mux.request_sync(self._ctrl_addr, msg,
                                          budget=budget)
        # Time budget (resilience/timebudget.py): the op's REMAINING
        # milliseconds ride as the INNERMOST data-tail prefix (receivers
        # strip tag, then trace, then deadline) — only after the daemon
        # granted FLAG_CAP_DEADLINE at CONNECT. Expired budgets are the
        # caller's problem (its ladder raises typed); an expired tail
        # encodes as 0 and the daemon refuses it.
        if (
            budget is not None
            and self._ctrl_caps & FLAG_CAP_DEADLINE
            and VALID_FLAGS.get(msg.type, 0) & FLAG_DEADLINE
        ):
            msg = timebudget.attach(
                Message(msg.type, msg.fields, msg.data, msg.flags),
                budget, FLAG_DEADLINE,
            )
        # Trace propagation: an ambient span context (Ocm.put/get/alloc
        # wrap ops in Tracer.span) rides the request as a 16-byte data
        # prefix — only on types the wire declares traceable and only
        # after the daemon granted FLAG_CAP_TRACE at CONNECT. Attach to a
        # shallow copy so a caller-retained Message is never mutated.
        ctx = obs_trace.current()
        if (
            ctx is not None
            and self._ctrl_caps & FLAG_CAP_TRACE
            and VALID_FLAGS.get(msg.type, 0) & FLAG_TRACE_CTX
        ):
            msg = obs_trace.attach(
                Message(msg.type, msg.fields, msg.data, msg.flags),
                ctx, FLAG_TRACE_CTX,
            )
        # Held across the round-trip on purpose: the ctrl socket IS the
        # serialized resource (one framed request/reply stream to the
        # local daemon), and _ctrl_lock's only job is that framing. It is
        # a leaf lock — nothing is acquired under it — so it cannot take
        # part in an ordering cycle (lockwatch verifies this), and the
        # rpc:daemon order edge it forms is one-way for the same reason.
        # The wait stays unbounded by design: the peer is the LOCAL
        # daemon (same host, no network partition to ride out), bounding
        # it would need ctrl-socket reconnect machinery, and the daemon
        # refuses expired budgets server-side on every relayed hop.
        with self._ctrl_lock:
            return request(self._ctrl, msg)  # ocm-lint: allow[blocking-call-under-lock] ocm-lint: allow[lock-across-rpc] ocm-lint: allow[unbounded-blocking]

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
                self._request(
                    Message(
                        MsgType.HEARTBEAT,
                        {"rank": self.rank, "pid": self.pid,
                         "owners": self._owners_field()},
                    )
                )
                beats += 1
                if self._plane_server is not None and beats % 15 == 0:
                    # Periodic re-registration: self-heals daemons that
                    # dropped a stale endpoint (controller crash on the
                    # same port) or restarted from a snapshot. The daemon
                    # treats an unchanged endpoint as a no-op.
                    self._request(Message(
                        MsgType.PLANE_SERVE,
                        {"host": _advertised_host(),
                         "port": self._plane_server.port, "relay": 0},
                    ))
            except (OSError, OcmProtocolError):
                printd("client rank %d: heartbeat failed", self.rank)

    def close(self, detach: bool = False) -> None:
        """``detach=True`` skips the DISCONNECT notification: daemons keep
        the app's allocations until the lease runs out (crash simulation /
        intentional handoff within the lease window). The default notifies,
        and the daemons reclaim this app's allocations immediately.

        App identity is (pid, rank) — per OS process, as in the reference,
        where one app process owns one mailbox (pmsg.c). Multiple clients
        in one process at the same rank share that identity: closing one
        (without detach) reclaims the process's allocations at that rank.
        """
        self._hb_stop.set()
        self.stop_slo()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=10.0)
        if self._mux is not None and self._mux_hb is not None:
            self._mux.cancel_periodic(self._mux_hb)
            self._mux_hb = None
        if self._plane_server is not None and not detach:
            # Deregister the plane endpoint before it goes dark so daemons
            # stop relaying (and scrubbing) into a dead socket.
            try:
                self._request(Message(
                    MsgType.PLANE_SERVE, {"host": "", "port": 0, "relay": 0}
                ))
            except (OSError, OcmError):
                pass
        if not detach:
            # Clean-close terminal for the audit timeline: DISCONNECT is
            # fire-and-forget (a stopping daemon may never read it — the
            # lease reaper is the backstop), so the client's own journal
            # records that this app's lease chain ended deliberately.
            obs_journal.record("app_close", pid=self.pid, rank=self.rank)
            if self._mux is not None:
                # Over the SHARED channel DISCONNECT must be awaited
                # like any tagged request — an unread reply would desync
                # the other tenants' demux.
                try:
                    self._mux.request_sync(
                        self._ctrl_addr,
                        Message(MsgType.DISCONNECT,
                                {"pid": self.pid,
                                 "owners": self._owners_field()}),
                        timeout=10.0,
                    )
                except (OSError, OcmError):
                    pass  # the lease reaper covers it
            # Bounded lock (mirrors libocm.cc's try_lock teardown): a beat
            # already inside _request holds _ctrl_lock mid send/recv, and an
            # unlocked send here would interleave frames and corrupt the
            # stream, losing the DISCONNECT. If the lock stays held (daemon
            # wedged), skip the courtesy message — the lease reaper covers it.
            elif self._ctrl is not None and self._ctrl_lock.acquire(
                timeout=2.0
            ):
                try:
                    send_msg(
                        self._ctrl,
                        Message(MsgType.DISCONNECT,
                                {"pid": self.pid,
                                 "owners": self._owners_field()}),
                    )
                except OSError:
                    pass
                finally:
                    self._ctrl_lock.release()
        self._teardown()

    def _teardown(self) -> None:
        """Release what the client holds: pooled sockets, fabric
        mappings, the plane server, the ctrl socket and its share of the
        mux runtime. Also the unwind of a constructor that failed after
        connecting."""
        self._pool.close()
        # Detach negotiated fabrics (shm: unmap the peer segments).
        with self._dcn_lock:
            fabs, self._dcn_fabrics = list(self._dcn_fabrics.values()), {}
        for fab in fabs:
            try:
                fab.close()
            except OcmError:
                pass
        if self._plane_server is not None:
            self._plane_server.close()
        if self._ctrl is not None:
            try:
                self._ctrl.close()
            except OSError:
                pass
        if self._mux is not None:
            # Refcounted: the shared channel set (and its event loop)
            # lives while ANY tenant in the process still uses it.
            mux_rt.release_runtime(self._mux)
            self._mux = None

    # -- RemoteBackend: alloc / free ------------------------------------

    def alloc(self, nbytes: int, kind: OcmKind,
              deadline_ms: int | None = None) -> OcmAlloc:
        budget = timebudget.budget_from(deadline_ms, self.config)
        req = Message(
            MsgType.REQ_ALLOC,
            {
                "orig_rank": self.rank,
                "pid": self.pid,
                "kind": WIRE_KIND[kind.value],
                "nbytes": nbytes,
            },
        )
        # k-way replication: only after the daemon granted
        # FLAG_CAP_REPLICA at CONNECT, only for host kinds (device bytes
        # live in the app plane). Un-granted (old daemon, native daemon,
        # OCM_REPLICAS unset) allocations are single-copy and the frame
        # is byte-identical to the pre-replication wire.
        if (
            self.config.replicas > 1
            and self._ctrl_caps & FLAG_CAP_REPLICA
            and kind == OcmKind.REMOTE_HOST
        ):
            req.flags |= FLAG_REPLICAS
            req.data = bytes([self.config.replicas])
        r = self._alloc_request(req, budget)
        f = r.fields
        placed_kind = OcmKind(WIRE_KIND_INV[f["kind"]])
        fabric = (
            Fabric.LOCAL
            if not placed_kind.is_remote
            else (Fabric.ICI if placed_kind == OcmKind.REMOTE_DEVICE else Fabric.DCN)
        )
        h = OcmAlloc(
            alloc_id=f["alloc_id"],
            kind=placed_kind,
            fabric=fabric,
            nbytes=nbytes,
            rank=f["rank"],
            device_index=f["device_index"],
            extent=Extent(offset=f["offset"], nbytes=nbytes),
            origin_rank=self.rank,
        )
        h.owner_addr = (f["owner_host"], f["owner_port"])  # for the DCN path
        h.daemon_owned = True  # even when demoted: the daemon holds the bytes
        # Replica ranks ride an optional JSON data tail on ALLOC_RESULT
        # (only present for replicated placements); they are the client's
        # failover candidates AND extra lease owners — heartbeats and the
        # DISCONNECT reclamation fan-out must reach every holder.
        if r.data:
            import json

            try:
                reps = json.loads(bytes(r.data)).get("replicas", [])
                h.replica_ranks = tuple(
                    int(x) for x in reps if int(x) != h.rank
                )
            except (ValueError, TypeError):
                pass  # tail from a future daemon we don't understand
        self._note_owner(h.rank, +1)
        for rr in h.replica_ranks:
            self._note_owner(rr, +1)
        # Device-arm scrub (calloc parity, alloc.c:171): the daemon only
        # BOOKS device extents — the bytes live in the plane's arena. The
        # authoritative scrub is the owner daemon's free-time PLANE_SCRUB
        # (every recycle path — client free, lease reaping, DISCONNECT
        # reclamation — funnels through its one free routine, mirroring
        # how host arms are scrubbed). A plane-OWNING client additionally
        # zeroes at alloc via its plane: belt and braces for setups where
        # no endpoint is registered (serve_plane=False) and therefore the
        # daemon's free-time scrub had nowhere to go.
        if placed_kind in (OcmKind.REMOTE_DEVICE, OcmKind.LOCAL_DEVICE):
            # LOCAL_DEVICE here means single-node demotion of a
            # REMOTE_DEVICE request: still plane-resident bytes. A
            # plane-less client needs no alloc-time scrub: the owner
            # daemon scrubs device extents at FREE time through the plane
            # (PLANE_SCRUB), so recycled offsets are already clean.
            if self.ici_plane is not None:
                scrub = getattr(self.ici_plane, "scrub", None)
                if scrub is not None:
                    scrub(h)
        return h

    def _alloc_request(self, req: Message,
                       budget: timebudget.Budget | None = None) -> Message:
        """REQ_ALLOC with back-pressure compliance (qos/): a retryable
        BUSY rejection is honored with capped jittered backoff — seeded
        by the server's suggested delay when the reply carries one —
        rather than surfaced to the app. Every other error (including
        QUOTA_EXCEEDED, which only the app freeing can fix) propagates
        unchanged, as does BUSY once the retry budget is spent. With a
        time budget the ladder sleeps are CLAMPED to the remainder and
        an exhausted budget surfaces typed instead of burning more
        attempts."""
        cfg = self.config
        delay = max(cfg.busy_backoff_ms, 1) / 1e3
        for attempt in range(cfg.busy_retries + 1):
            if budget is not None:
                budget.check(f"alloc of {req.fields.get('nbytes', 0)} B")
            try:
                return self._request(req, budget)
            except OcmRemoteError as e:
                if (
                    e.code != int(ErrCode.BUSY)
                    or attempt == cfg.busy_retries
                ):
                    raise
                hint = getattr(e, "retry_after_ms", 0) / 1e3
                step = min(
                    max(delay, hint), cfg.connect_backoff_cap_s
                )
                obs_journal.record(
                    "backpressure_wait", attempt=attempt,
                    wait_s=round(step, 4),
                    nbytes=req.fields.get("nbytes", 0),
                )
                printd("client rank %d: BUSY, backing off %.0f ms "
                       "(attempt %d)", self.rank, step * 1e3, attempt + 1)
                backoff_sleep(step, budget)
                delay *= 2
        raise AssertionError("unreachable")  # loop returns or raises

    def free(self, handle: OcmAlloc,
             deadline_ms: int | None = None) -> None:
        budget = timebudget.budget_from(deadline_ms, self.config)
        # Leave the owner set BEFORE the round trip (restored on
        # failure): a heartbeat racing the free would otherwise ship a
        # stale owners list for the whole free RPC and trigger a relay
        # for an allocation that no longer exists. During the RPC a beat
        # that misses the owner only skips renewing a lease that is
        # being destroyed anyway.
        self._note_owner(handle.rank, -1)
        for rr in handle.replica_ranks:
            self._note_owner(rr, -1)

        def _restore() -> None:
            self._note_owner(handle.rank, +1)
            for rr in handle.replica_ranks:
                self._note_owner(rr, +1)

        try:
            self._request(
                Message(
                    MsgType.REQ_FREE,
                    {"alloc_id": handle.alloc_id, "rank": handle.rank},
                ),
                budget,
            )
        except BaseException as err:
            # Free ladder (resilience/): a dead primary's free re-aims
            # at the replica chain — the promoted primary serves it and
            # fans the DO_FREE out, exactly like the data-path ladder.
            # Non-failover errors (BAD_ALLOC_ID double free, ...) and
            # unreplicated handles propagate unchanged.
            if not (self._is_failover_err(err) and handle.replica_ranks):
                _restore()
                raise
            last: BaseException = err
            for rr in handle.replica_ranks:
                try:
                    self._request(Message(
                        MsgType.REQ_FREE,
                        {"alloc_id": handle.alloc_id, "rank": rr},
                    ), budget)
                    break
                except BaseException as err2:  # noqa: BLE001
                    if not self._is_failover_err(err2):
                        _restore()
                        raise
                    last = err2
            else:
                _restore()
                raise last
        # Drop any cached fabric region keys for this alloc: a recycled
        # alloc_id must re-resolve its extent, never inherit a stale map.
        with self._dcn_lock:
            fabs = list(self._dcn_fabrics.values())
        for fab in fabs:
            fab.forget(handle.alloc_id)

    # -- RemoteBackend: one-sided data ----------------------------------

    # Device arms (REMOTE_DEVICE, and its single-node demotion to
    # LOCAL_DEVICE) hold their bytes in the SPMD controller's ICI plane
    # arena — the daemon only books the extents. A client that OWNS the
    # plane uses it directly; a plane-less client (second process, C app)
    # rides the DCN path to the owner daemon, which relays to the
    # registered plane endpoint (PLANE_PUT/PLANE_GET). Host arms always
    # ride the DCN path.
    def put(self, handle: OcmAlloc, data, offset: int = 0,
            deadline_ms: int | None = None) -> None:
        if (
            handle.kind in (OcmKind.REMOTE_DEVICE, OcmKind.LOCAL_DEVICE)
            and self.ici_plane is not None
        ):
            self.ici_plane.put(handle, data, offset)
            return
        budget = timebudget.budget_from(deadline_ms, self.config)
        raw = as_byte_tensor(data)
        if raw.device.type == "cpu":
            self._dcn_put(handle, raw.numpy(), offset, budget)
            return
        # A card tensor goes out from pinned staging, copied down (and
        # synchronised) on this thread: no stripe thread and no mux loop
        # ever touches the card.
        with self._staged(raw.numel()) as stage:
            stage.copy_(raw)
            self._dcn_put(handle, stage.numpy(), offset, budget)

    @contextlib.contextmanager
    def _staged(self, n: int):
        """``n`` bytes of a staging buffer this transfer alone uses: the
        smallest free one that fits, else a new one (a smaller free buffer
        is released first). Given back to the pool on exit, which then
        releases its smallest free buffer past ``STAGE_KEEP``."""
        with self._stage_lock:
            free = self._stage_free  # smallest first
            i = next((i for i, b in enumerate(free) if b.numel() >= n), None)
            buf = None if i is None else free.pop(i)
            if buf is None and free:
                free.pop(0)
        if buf is None:
            buf = torch.empty(n, dtype=torch.uint8,
                              pin_memory=torch.cuda.is_available())
        try:
            yield buf[:n]
        finally:
            with self._stage_lock:
                free = self._stage_free
                bisect.insort(free, buf, key=torch.Tensor.numel)
                if len(free) > STAGE_KEEP:
                    free.pop(0)

    def get(self, handle: OcmAlloc, nbytes: int, offset: int = 0,
            deadline_ms: int | None = None):
        """The bytes: on the plane's device for device arms the client's
        plane holds, else a fresh CPU tensor off the wire."""
        if (
            handle.kind in (OcmKind.REMOTE_DEVICE, OcmKind.LOCAL_DEVICE)
            and self.ici_plane is not None
        ):
            return self.ici_plane.get(handle, nbytes, offset)
        return torch.from_numpy(self._dcn_get(
            handle, nbytes, offset,
            timebudget.budget_from(deadline_ms, self.config)))

    # DCN path: chunked, pipelined DATA_PUT/GET straight to the owner
    # daemon (extoll.c:47-173 scheme over TCP), STRIPED across parallel
    # pooled connections for large transfers (the UCX/NCCL multi-rail
    # scheme): the byte range splits into contiguous per-stripe ranges,
    # each stripe runs the pipelined window on its OWN leased socket, so
    # replies stay FIFO per socket and the RecvScratch contract holds per
    # stripe. On a peer ERROR reply the remaining in-flight replies are
    # drained before raising, keeping the pooled connection in sync;
    # transport errors evict the connection and retry the STRIPE (not the
    # whole transfer) once via the membership address.

    def _dcn_caps_for(self, addr: tuple[str, int], sock) -> int:
        """Negotiated capability bits for the daemon at ``addr``, probed
        once per address on the first leased data socket: a CONNECT
        offering FLAG_CAP_COALESCE and/or FLAG_CAP_TRACE (each gated by
        config) — plus FLAG_CAP_FABRIC when this config negotiates data
        fabrics (fabric/). The reply's echoed bits are what the peer
        grants; a granted fabric offer additionally carries the daemon's
        fabric descriptor tail, which this probe resolves to an ATTACHED
        PeerFabric (or None when unreachable — cross-host pairs fail the
        attach and run tcp). Old v2 Python daemons reply with flags=0 —
        the probe is how the new client discovers it must stay on the
        lockstep one-ACK-per-chunk protocol and ship plain untraced
        frames. The native C++ daemon grants exactly FLAG_CAP_COALESCE
        (its epoll data plane serves coalesced striped puts) and
        declines everything else by silence."""
        with self._dcn_lock:
            caps = self._dcn_caps.get(addr)
        if caps is not None:
            return caps
        offer = (FLAG_CAP_COALESCE if self.config.dcn_coalesce else 0) | (
            FLAG_CAP_TRACE if self.config.trace else 0
        ) | (FLAG_CAP_FABRIC if self.config.fabric_offer else 0)
        fab = None
        if not offer:
            caps = 0  # nothing to negotiate: lockstep by configuration
        else:
            r = request(sock, Message(
                MsgType.CONNECT, {"pid": self.pid, "rank": self.rank},
                flags=offer,
            ))
            caps = (
                r.flags & offer
                if r.type == MsgType.CONNECT_CONFIRM else 0
            )
            if caps & FLAG_CAP_FABRIC and r.data:
                fab = attach_peer(
                    bytes(r.data), self._fabric_control(addr)
                )
                obs_journal.record(
                    "fabric_selected", host=addr[0], port=addr[1],
                    fabric=fab.name if fab is not None else "tcp",
                )
        loser = None
        with self._dcn_lock:
            self._dcn_caps[addr] = caps
            if fab is not None:
                if addr in self._dcn_fabrics:
                    # Concurrent stripes both probed this address; the
                    # first store wins and the duplicate attachment must
                    # be unmapped, not orphaned to a noisy GC.
                    loser = fab
                else:
                    self._dcn_fabrics[addr] = fab
        if loser is not None:
            loser.close()
        return caps

    def _tuner_for(self, addr: tuple[str, int]) -> _PeerTuner:
        with self._dcn_lock:
            t = self._dcn_tuners.get(addr)
            if t is None:
                t = self._dcn_tuners[addr] = _PeerTuner(self.config)
            return t

    def _plan_stripes(self, total: int) -> int:
        """Stripe count for a ``total``-byte transfer (fabric/tcp.py)."""
        return tcp_fabric.plan_stripes(self.config, total)

    # -- fabric selection (fabric/) --------------------------------------

    def _fabric_control(self, addr: tuple[str, int]):
        """The control-leg callable a PeerFabric validates through: one
        framed request/reply to the owner daemon over the pool. Typed
        rejections (STALE_EPOCH, NOT_PRIMARY, BAD_ALLOC_ID) surface as
        OcmRemoteError; a dead daemon as OcmConnectError — both feed
        the caller's failover ladder unchanged."""
        def control(mtype: MsgType, fields: dict) -> Message:
            return self._pool.request(addr[0], addr[1], Message(mtype, fields))

        return control

    def _fabric_for(self, addr: tuple[str, int], total: int):
        """The negotiated one-sided fabric for ``addr``, or None (tcp).
        Forces the capability probe if this address was never probed —
        the fabric decision must exist BEFORE the transfer plans its
        stripes. Small transfers stay on tcp: below the shm threshold
        the control round-trip is the whole cost either way."""
        if (
            self._mux is not None
            or not self.config.fabric_offer
            or total < self.config.fabric_shm_min_bytes
        ):
            # Mux channels don't negotiate one-sided fabrics (the shm
            # probe needs a pool lease); OCM_MUX and OCM_FABRIC=shm are
            # mutually exclusive by configuration.
            return None
        with self._dcn_lock:
            if addr in self._dcn_caps:
                return self._dcn_fabrics.get(addr)
        try:
            entry = self._pool.lease(addr[0], addr[1])
        except OcmConnectError:
            return None  # the transfer path's ladder owns this failure
        try:
            self._dcn_caps_for(addr, entry.sock)
        except BaseException:
            self._pool.discard(addr[0], addr[1], entry)
            return None  # probe failed: run tcp, let the engine retry
        self._pool.release(addr[0], addr[1], entry)
        with self._dcn_lock:
            return self._dcn_fabrics.get(addr)

    def _invalidate_fabric(self, addr: tuple[str, int]) -> None:
        """Drop a peer's negotiated fabric AND its capability cache so
        the next transfer re-negotiates from scratch — the re-resolution
        step of failover (a promoted primary advertises its own segment;
        a restarted daemon a fresh one)."""
        with self._dcn_lock:
            fab = self._dcn_fabrics.pop(addr, None)
            self._dcn_caps.pop(addr, None)
        if fab is not None:
            obs_journal.record(
                "fabric_invalidated", host=addr[0], port=addr[1],
                fabric=fab.name,
            )
            try:
                fab.close()
            except OcmError:
                pass

    def _fabric_transfer(
        self, fab, handle: OcmAlloc, total: int, offset: int,
        put_mv, get_arr,
    ) -> dict:
        """One whole transfer over a negotiated one-sided fabric: resolve
        the region key (cached per alloc), then a single put/get — the
        memcpy is the data plane; the fabric's control legs carry the
        validation. Stats mirror the tcp engine's shape so telemetry and
        STATUS render uniformly."""
        key = fab.map(handle.alloc_id)
        if put_mv is not None:
            fab.put(key, offset, put_mv)
        else:
            fab.get(key, offset, memoryview(get_arr))
        return {
            "stripes": 1,
            "retries": [0],
            "window": [0],
            "chunk": [total],
            "coalesced": [False],
            "fabric": fab.name,
        }

    def _dcn_transfer(
        self, handle: OcmAlloc, total: int, offset: int,
        put_mv: memoryview | None = None,
        get_arr: np.ndarray | None = None,
        budget: timebudget.Budget | None = None,
    ) -> dict:
        """Move ``total`` bytes at handle-relative ``offset``. Reads on
        a REPLICATED handle may be hedged (OCM_HEDGE_MS): after the
        hedge delay with no primary answer, a second read fires at the
        next chain member and the first answer wins — never writes
        (hedging a put would double-apply side effects). Everything
        else goes straight to the engine."""
        if (
            get_arr is not None
            and handle.replica_ranks
            and self.config.hedge_ms != 0
        ):
            delay = timebudget.hedge_delay_s(self.config, self.tracer)
            if delay > 0:
                return self._hedged_get(
                    handle, total, offset, get_arr, budget, delay
                )
        return self._dcn_transfer_once(
            handle, total, offset, put_mv, get_arr, budget
        )

    def _hedged_get(
        self, handle: OcmAlloc, total: int, offset: int,
        get_arr: np.ndarray, budget: timebudget.Budget | None,
        delay: float,
    ) -> dict:
        """Tail-at-Scale hedged read: the primary attempt runs in a
        worker thread into a PRIVATE buffer; if it has not answered
        within ``delay``, a second read fires at the next chain member
        (replicas serve client DATA_GET — every acked write is on the
        whole chain pre-ack, so the hedge is as fresh as the primary).
        First success wins and is copied into the caller's buffer; the
        loser finishes into its own buffer and is discarded (on the mux
        path an abandoned loser's tags are CANCELed server-side by the
        channel's orphan reap). Both attempts failing re-raises the
        primary's error."""
        import copy
        import queue

        results: "queue.Queue" = queue.Queue()

        def attempt(idx: int) -> None:
            buf = np.empty(total, dtype=np.uint8)
            try:
                if idx == 0:
                    # The primary rides a PRIVATE handle clone: a losing
                    # attempt keeps running after the hedge returns, and
                    # its ladder must never repoint (or re-account) the
                    # caller's handle under a concurrent op. The next op
                    # on the real handle walks its own ladder if the
                    # primary truly died.
                    probe = copy.copy(handle)
                    probe._hedge_probe = True
                    st = self._dcn_transfer_once(
                        probe, total, offset, None, buf, budget
                    )
                else:
                    st = {"retries": [0], "window": [0], "chunk": [0],
                          "coalesced": [False], "stripes": 1}
                    rr = handle.replica_ranks[0]
                    cand = self._rank_addr(rr)
                    if cand is None:
                        raise OcmConnectError(
                            f"hedge target rank {rr} has no address"
                        )
                    self._stripe_once(handle, 0, total, offset, None,
                                      buf, cand, None, st, 0)
            except BaseException as e:  # noqa: BLE001 — reported via queue
                results.put((idx, None, None, e))
            else:
                results.put((idx, buf, st, None))

        threading.Thread(
            target=attempt, args=(0,), daemon=True, name="ocm-hedge-p",
        ).start()
        started = 1
        fired = False
        first_err: BaseException | None = None
        timeout = delay
        while True:
            try:
                idx, buf, st, err = results.get(timeout=timeout)
            except queue.Empty:
                if not fired and started == 1:
                    # Primary silent past the hedge delay: fire the
                    # hedge at the next chain member.
                    fired = True
                    started = 2
                    obs_journal.record(
                        "hedge_fired", alloc_id=handle.alloc_id,
                        nbytes=total, delay_ms=round(delay * 1e3, 3),
                        target_rank=handle.replica_ranks[0],
                    )
                    threading.Thread(
                        target=attempt, args=(1,), daemon=True,
                        name="ocm-hedge-s",
                    ).start()
                    timeout = (budget.remaining_s() if budget is not None
                               else None)
                    continue
                if budget is not None:
                    budget.check(f"hedged get of alloc {handle.alloc_id}")
                    timeout = max(budget.remaining_s(), 0.01)
                continue
            if err is not None:
                if first_err is None:
                    first_err = err
                started -= 1
                if started == 0 and not fired:
                    raise err
                if started == 0:
                    raise first_err
                timeout = (budget.remaining_s() if budget is not None
                           else None)
                continue
            flat = get_arr if get_arr.ndim == 1 else get_arr.reshape(-1)
            flat[:total] = buf
            if fired:
                obs_journal.record(
                    "hedge_won" if idx == 1 else "hedge_lost",
                    alloc_id=handle.alloc_id, nbytes=total,
                )
                st = dict(st)
                st["hedged"] = True
            return st

    def _dcn_transfer_once(
        self, handle: OcmAlloc, total: int, offset: int,
        put_mv: memoryview | None = None,
        get_arr: np.ndarray | None = None,
        budget: timebudget.Budget | None = None,
    ) -> dict:
        """Move ``total`` bytes at handle-relative ``offset``: the striped
        engine behind put (``put_mv`` = source view) and get (``get_arr``
        = destination array, stripes land in disjoint views of it).
        Returns the transfer stats for telemetry."""
        addr = self._owner_addr(handle)
        # Fabric dispatch (fabric/): a negotiated one-sided fabric serves
        # the whole transfer in one mapped-region op. Retryable failures
        # (owner died, fenced, demoted) drop the pair back to tcp for
        # THIS transfer — the engine's failover ladder below repoints the
        # handle, and the next transfer re-negotiates against the new
        # owner (fabric re-resolution). Full-range re-runs are idempotent,
        # so a half-landed fabric put is safely rewritten.
        fab = self._fabric_for(addr, total)
        if fab is not None:
            try:
                return self._fabric_transfer(
                    fab, handle, total, offset, put_mv, get_arr
                )
            except BaseException as err:
                if not self._is_failover_err(err):
                    raise
                self._invalidate_fabric(addr)
                obs_journal.record(
                    "fabric_fallback", alloc_id=handle.alloc_id,
                    host=addr[0], port=addr[1],
                    error=f"{type(err).__name__}: {err}",
                )
                printd("fabric op failed (%s); falling back to tcp", err)
        nstripes = self._plan_stripes(total)
        stats: dict = {
            "retries": [0] * nstripes,
            "window": [0] * nstripes,
            "chunk": [0] * nstripes,
            "coalesced": [False] * nstripes,
        }
        if nstripes == 1:
            self._stripe_run(handle, 0, total, offset, put_mv, get_arr,
                             addr, None, stats, 0, budget)
            stats["stripes"] = 1
            return stats
        lease0 = time.monotonic() if obs_journal.enabled() else 0.0
        try:
            entries = self._pool.lease_set(addr[0], addr[1], nstripes)
        except OcmConnectError:
            # Stale cached owner_addr (owner daemon restarted on a new
            # port) or a dead owner: walk the failover candidates — the
            # membership address for the owner rank, then each replica
            # rank — the same ladder the per-stripe retry climbs.
            entries = None
            for rank_i, cand in self._failover_candidates(handle):
                try:
                    entries = self._pool.lease_set(cand[0], cand[1], nstripes)
                except OcmConnectError:
                    continue
                printd("leasing stripe set via rank %d at %s:%d",
                       rank_i, cand[0], cand[1])
                self._failover_handle(handle, rank_i, cand,
                                      keep_old=put_mv is None)
                addr = cand
                break
            if entries is None:
                raise
        if lease0:
            obs_journal.phase(
                "client_queue", time.monotonic() - lease0,
                priority=self.config.priority,
            )
        # Contention shrank the set: re-split so every leased socket
        # still carries a contiguous range of its fair share.
        nstripes = len(entries)
        for key in ("retries", "window", "chunk", "coalesced"):
            stats[key] = stats[key][:nstripes]
        stats["stripes"] = nstripes
        base = total // nstripes
        rem = total % nstripes
        ranges = []
        start = 0
        for i in range(nstripes):
            length = base + (1 if i < rem else 0)
            ranges.append((start, length))
            start += length
        errors: list[BaseException | None] = [None] * nstripes
        # The ambient trace context is thread-local; stripe workers run
        # in fresh threads, so carry it across explicitly or stripes
        # 1..N would ship untraced chunks.
        tctx = obs_trace.current()

        def worker(i: int) -> None:
            s0, ln = ranges[i]
            try:
                with obs_trace.use_ctx(tctx):
                    self._stripe_run(handle, s0, ln, offset, put_mv,
                                     get_arr, addr, entries[i], stats, i,
                                     budget)
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                errors[i] = exc

        threads = [
            threading.Thread(
                target=worker, args=(i,), name=f"ocm-stripe-{i}",
            )
            for i in range(1, nstripes)
        ]
        for t in threads:
            t.start()
        worker(0)
        for t in threads:
            t.join()
        failures = [e for e in errors if e is not None]
        if failures:
            # Prefer the typed application error (the transfer itself was
            # rejected) over transport noise from sibling stripes.
            for e in failures:
                if isinstance(e, OcmRemoteError):
                    raise e
            raise failures[0]
        return stats

    def _rank_addr(self, rank: int) -> tuple[str, int] | None:
        """Membership address of ``rank`` — None when the rank postdates
        this client's view (a member that JOINed after boot; REQ_LOCATE
        names its address explicitly)."""
        if 0 <= rank < len(self.entries):
            e = self.entries[rank]
            if e.port:
                return (e.connect_host, e.port)
        return None

    def _failover_candidates(
        self, handle: OcmAlloc, last_err: BaseException | None = None
    ) -> list[tuple[int, tuple[str, int]]]:
        """Retry ladder for a transfer that can't reach (or is refused
        by) the cached owner: a live-migration MOVED redirect first (the
        rejection NAMES the new owner — walking anywhere else is wasted
        round trips), then the membership address of the owner rank
        (covers restarts on a new port), then each replica rank in chain
        order — the first survivor is, by the deterministic promotion
        rule, the new primary."""
        out = []
        moved = getattr(last_err, "moved_to_rank", None)
        if moved is not None:
            addr = self._rank_addr(moved)
            if addr is not None:
                out.append((moved, addr))
        addr = self._rank_addr(handle.rank)
        if addr is not None and (handle.rank, addr) not in out:
            out.append((handle.rank, addr))
        for rr in handle.replica_ranks:
            if rr == handle.rank:
                continue
            addr = self._rank_addr(rr)
            if addr is not None and (rr, addr) not in out:
                out.append((rr, addr))
        return out

    def _locate_at(
        self, addr: tuple[str, int] | None, handle: OcmAlloc,
        budget: timebudget.Budget | None = None,
    ) -> tuple[int, tuple[str, int]] | None:
        """One REQ_LOCATE against ``addr``: the reply names the current
        primary's rank AND address explicitly — the only way to reach an
        owner whose rank postdates this client's boot membership
        (elastic/). Budgeted callers bound the exchange: a locate is a
        BACKSTOP, and a peer that relays it into a frozen rank must not
        eat the op's whole budget."""
        if addr is None:
            return None
        timeout = None
        if budget is not None:
            timeout = min(2.0, max(budget.remaining_s(), 1e-3))
        try:
            r = self._pool.request(
                addr[0], addr[1],
                Message(MsgType.REQ_LOCATE, {"alloc_id": handle.alloc_id}),
                timeout=timeout,
            )
        except (OSError, OcmError):
            return None
        return (r.fields["rank"], (r.fields["host"], r.fields["port"]))

    def _locate_candidates(
        self, handle: OcmAlloc, last_err: BaseException | None,
        budget: timebudget.Budget | None = None,
    ) -> list[tuple[int, tuple[str, int]]]:
        """The ladder's locate backstops, in preference order: the
        daemon that just answered MOVED (its tombstone knows the target,
        and its live view knows the target's address — essential when
        the redirect names a rank beyond this client's boot view), then
        the seed ranks in order — rank 0 first as before, but no longer
        ONLY rank 0: once leadership is dynamic (control/) the
        coordinator holding the relocation records may be any rank, and
        the new owner's own registry answers REQ_LOCATE too, so the
        first seed that knows the id wins. Bounded: at most two distinct
        answers are collected per retry round."""
        out = []
        moved = getattr(last_err, "moved_to_rank", None)
        if moved is not None and self._rank_addr(moved) is None:
            loc = self._locate_at(self._owner_addr(handle), handle,
                                  budget)
            if loc is not None:
                out.append(loc)
        for r in range(len(self.entries)):
            loc = self._locate_at(self._rank_addr(r), handle, budget)
            if loc is not None and loc not in out:
                out.append(loc)
                if len(out) >= 2:
                    break
        return out

    def _failover_handle(
        self, handle: OcmAlloc, new_rank: int, addr: tuple[str, int],
        keep_old: bool = False,
    ) -> None:
        """Repoint a handle at the rank that just served it. Once-only
        under a lock (concurrent stripes race here): the dead old owner
        leaves the heartbeat/reclaim owner set exactly once; the promoted
        rank was already counted as a replica owner at alloc time.

        ``keep_old=True`` (READ-ladder repoints): the rank that just
        served may be a replica of a merely-slow primary (replicas serve
        client DATA_GET now), so the old primary stays in the handle's
        candidate chain — a later WRITE bounced NOT_PRIMARY can walk
        back to it instead of dead-ending on a read-only replica.

        A hedge PROBE (the private clone a hedged get's primary attempt
        rides) repoints its own fields only — never the owner
        accounting, never the journal: the real handle was not failed
        over, and the loser may still be running when the caller moves
        on."""
        if getattr(handle, "_hedge_probe", False):
            with self._fo_lock:
                handle.rank = new_rank
                handle.owner_addr = addr
                handle.replica_ranks = tuple(
                    r for r in handle.replica_ranks if r != new_rank
                )
            return
        with self._fo_lock:
            old = handle.rank
            old_addr = handle.owner_addr
            if old == new_rank:
                handle.owner_addr = addr
                return
            was_known = new_rank in handle.replica_ranks
            handle.rank = new_rank
            handle.owner_addr = addr
            rest = tuple(
                r for r in handle.replica_ranks
                if r not in (new_rank, old)
            )
            handle.replica_ranks = ((old,) + rest) if keep_old else rest
        if not was_known:
            # Live-migration repoint (elastic/): the new owner was never
            # in the replica chain, so unlike a promoted replica it was
            # never counted into the heartbeat owner set — count it now
            # or the migrated copy's lease lapses once the source's
            # forwarding tombstone goes stale.
            self._note_owner(new_rank, +1)
        # Fabric re-resolution (fabric/): the owner this handle left is
        # dead or demoted, so its negotiated one-sided fabric — and the
        # capability cache that would hand it back — must go with it.
        # The promoted owner's fabric negotiates fresh on the next
        # transfer that clears the size threshold.
        if old_addr is not None and old_addr != addr:
            self._invalidate_fabric(tuple(old_addr))
        obs_journal.record(
            "client_failover", alloc_id=handle.alloc_id,
            old_rank=old, new_rank=new_rank, kept_old=int(keep_old),
        )
        printd("handle %d failed over: owner rank %d -> %d",
               handle.alloc_id, old, new_rank)
        if not keep_old:
            # keep_old: the old rank stays in the candidate chain (it
            # may be a live primary we merely read around), so its
            # lease keeps renewing via the owner set too.
            self._note_owner(old, -1)

    # Retryable wire rejections: a fenced stale owner (STALE_EPOCH), a
    # replica still waiting for its primary's death verdict (NOT_PRIMARY),
    # a primary that can't yet honor the replication contract
    # (REPLICA_UNAVAILABLE), and a live-migration redirect (MOVED — the
    # error's rank tail names the new owner, which the ladder tries
    # first). The first three are failover-window conditions the
    # detector resolves within a few probe intervals; MOVED resolves on
    # the very next attempt.
    _RETRYABLE_CODES = frozenset({
        int(ErrCode.STALE_EPOCH),
        int(ErrCode.NOT_PRIMARY),
        int(ErrCode.REPLICA_UNAVAILABLE),
        int(ErrCode.MOVED),
    })

    @classmethod
    def _is_failover_err(cls, err: BaseException) -> bool:
        """Transport failures and retryable typed rejections mean 'try
        the next candidate'; every other remote error is an application
        error and propagates."""
        if isinstance(err, OcmRemoteError):
            return err.code in cls._RETRYABLE_CODES
        return isinstance(err, (OSError, OcmConnectError, OcmProtocolError))

    def _stripe_run(
        self, handle: OcmAlloc, start: int, length: int, offset: int,
        put_mv, get_arr, addr, entry, stats: dict, idx: int,
        budget: timebudget.Budget | None = None,
    ) -> None:
        """One stripe with the idempotent-retry contract: DATA_PUT/DATA_GET
        carry absolute offsets (same bytes, same places), so a retryable
        failure mid-stripe gets a full re-run of THIS stripe — first
        through the membership table's address for the owner rank
        (daemons that restarted on a new port), then through each replica
        rank (owner failover: the promoted replica serves the same
        alloc_id). The ladder is re-walked with a short pause until
        ``failover_wait_s`` elapses, because the retryable window IS the
        failure-detection latency: a put that races the owner's death
        verdict succeeds a few probe intervals later. A failed stripe
        only ever rewrites its own byte range, so sibling stripes'
        destination views stay intact."""
        try:
            self._stripe_once(handle, start, length, offset, put_mv,
                              get_arr, addr, entry, stats, idx, budget)
            return
        except BaseException as err:
            if not self._is_failover_err(err):
                raise
            last: BaseException = err
        # The ladder window is the failure-detection latency — but a
        # time-budgeted op may not ride it past its own deadline: the
        # window CLAMPS to the remaining budget and expiry surfaces
        # typed (never the stale transport error).
        deadline = time.monotonic() + self.config.failover_wait_s
        if budget is not None:
            deadline = min(deadline, budget.deadline)
        while True:
            cands = self._failover_candidates(handle, last)
            if budget is not None and budget.expired:
                raise OcmDeadlineExceeded(
                    f"transfer of alloc {handle.alloc_id}: "
                    f"{budget.total_ms} ms budget exhausted during "
                    f"failover (last: {type(last).__name__}: {last})"
                ) from last
            for loc in self._locate_candidates(handle, last, budget):
                if loc not in cands:
                    cands.append(loc)
            for rank_i, cand in cands:
                stats["retries"][idx] += 1
                obs_journal.record(
                    "stripe_retry",
                    stripe=idx, alloc_id=handle.alloc_id, owner_rank=rank_i,
                    nbytes=length, error=f"{type(last).__name__}: {last}",
                )
                printd("retrying stripe %d via rank %d at %s:%d",
                       idx, rank_i, cand[0], cand[1])
                try:
                    self._stripe_once(handle, start, length, offset, put_mv,
                                      get_arr, cand, None, stats, idx,
                                      budget)
                except BaseException as err:
                    if not self._is_failover_err(err):
                        raise
                    last = err
                    continue
                # Reads may have been served by a live primary's
                # replica: keep the old rank as a candidate so a later
                # write can walk back (writes repoint authoritatively —
                # only an acting/true primary ever serves them).
                self._failover_handle(handle, rank_i, cand,
                                      keep_old=put_mv is None)
                return
            if budget is not None and budget.expired:
                raise OcmDeadlineExceeded(
                    f"transfer of alloc {handle.alloc_id}: "
                    f"{budget.total_ms} ms budget exhausted during "
                    f"failover (last: {type(last).__name__}: {last})"
                ) from last
            if time.monotonic() >= deadline:
                raise last
            time.sleep(0.05)  # let the detector/promotion window close

    def _stripe_once(
        self, handle: OcmAlloc, start: int, length: int, offset: int,
        put_mv, get_arr, addr, entry, stats: dict, idx: int,
        budget: timebudget.Budget | None = None,
    ) -> None:
        """One stripe attempt behind the per-peer circuit breaker: an
        OPEN breaker fails fast (typed OcmBreakerOpen — an
        OcmConnectError, so the surrounding ladder walks on), transport
        and deadline failures feed the breaker, successes close it."""
        key = (addr[0], addr[1])
        self._breaker.check(key)
        try:
            self._stripe_attempt(handle, start, length, offset, put_mv,
                                 get_arr, addr, entry, stats, idx, budget)
        except BaseException as err:
            if isinstance(err, (OSError, OcmConnectError)) or (
                isinstance(err, OcmRemoteError)
                and err.code == int(ErrCode.DEADLINE_EXCEEDED)
            ):
                self._breaker.fail(key)
            raise
        self._breaker.ok(key)

    def _stripe_attempt(
        self, handle: OcmAlloc, start: int, length: int, offset: int,
        put_mv, get_arr, addr, entry, stats: dict, idx: int,
        budget: timebudget.Budget | None = None,
    ) -> None:
        if self._mux is not None:
            # The whole range rides the peer's mux channel (plan_stripes
            # pins nstripes to 1 under mux — one connection per peer is
            # the contract). The surrounding ladder (_stripe_run) keeps
            # every retry/failover/MOVED semantic: transfer errors come
            # back as the same typed exceptions the pool path raises.
            st = self._mux.transfer_sync(
                (addr[0], addr[1]), handle, start, length, offset,
                put_mv, get_arr, budget=budget,
            )
            stats["window"][idx] = st.get("window", 0)
            stats["chunk"][idx] = st.get("chunk", 0)
            stats["coalesced"][idx] = st.get("coalesced", False)
            stats["fabric"] = "mux"
            return
        host, port = addr
        if entry is None:
            if obs_journal.enabled():
                # Pool contention (all connections leased, at the peer
                # cap) shows up here as lease wait — mark it so critpath
                # separates "queued in the client" from wire time.
                w0 = time.monotonic()
                entry = self._pool.lease(host, port)
                obs_journal.phase(
                    "client_queue", time.monotonic() - w0,
                    priority=self.config.priority,
                )
            else:
                entry = self._pool.lease(host, port)  # exclusive stripe
        s = entry.sock
        try:
            caps = self._dcn_caps_for(addr, s)
        except BaseException:
            # Probe failed mid-exchange: connection unusable, lease must
            # not leak (same contract as the pipeline body below).
            self._pool.discard(host, port, entry)
            raise
        if budget is not None:
            # A budgeted transfer may not sit in a blocked recv past its
            # deadline (a FROZEN peer — stopped, wedged — never closes
            # the socket, so the ladder's between-attempt clamp alone
            # cannot bound it). socket.timeout is an OSError: the
            # connection is discarded and the ladder walks on, expiring
            # typed at the loop bottom. Cleared before release so the
            # pooled socket goes back blocking.
            s.settimeout(max(budget.remaining_s(), 1e-3))
        tuner = self._tuner_for(addr)
        chunk, window = tuner.plan()
        stats["window"][idx] = window
        stats["chunk"][idx] = chunk
        coalesce = (
            put_mv is not None
            and bool(caps & FLAG_CAP_COALESCE)
            and length > chunk  # a single-chunk burst is already one ACK
        )
        stats["coalesced"][idx] = coalesce
        # Ambient trace context rides this stripe's requests only when
        # the owner daemon granted FLAG_CAP_TRACE at the probe.
        tctx = obs_trace.current() if caps & FLAG_CAP_TRACE else None
        t0 = time.perf_counter()
        rtts: list[float] = []
        try:
            if coalesce:
                tcp_fabric.stripe_put_coalesced(
                    s, handle, start, length, offset, put_mv, chunk, tctx
                )
            else:
                tcp_fabric.stripe_windowed(
                    s, handle, start, length, offset, put_mv, get_arr,
                    chunk, window, rtts, tctx,
                )
        except OcmRemoteError:
            # Typed peer rejection, raised only AFTER the reply stream was
            # fully drained — the connection is still in sync, keep it.
            if budget is not None:
                s.settimeout(None)
            self._pool.release(host, port, entry)
            raise
        except BaseException:
            # Anything else escaped mid-exchange with replies possibly
            # still on the wire — the connection cannot be trusted and
            # the lease must not leak.
            self._pool.discard(host, port, entry)
            raise
        if budget is not None:
            s.settimeout(None)
        self._pool.release(host, port, entry)
        dt = time.perf_counter() - t0
        if dt > 0:
            rtt_p50 = sorted(rtts)[len(rtts) // 2] if rtts else dt
            tuner.observe(rtt_p50, length / dt)

    # (stripe_put_coalesced / stripe_windowed moved to fabric/tcp.py —
    # the tcp backend of the fabric layer; see _stripe_once.)

    def _dcn_put(self, handle: OcmAlloc, raw: np.ndarray, offset: int,
                 budget: timebudget.Budget | None = None) -> None:
        mv = memoryview(raw)  # stripes/chunks stay zero-copy views;
        # send_msg scatter-gathers them onto the wire without concatenation
        t0 = time.perf_counter()
        with self.tracer.span("dcn_put", nbytes=raw.nbytes):
            stats = self._dcn_transfer(handle, raw.nbytes, offset,
                                       put_mv=mv, budget=budget)
        self._note_dcn(stats, "put", raw.nbytes, time.perf_counter() - t0)

    def get_into(self, handle: OcmAlloc, out, offset: int = 0,
                 deadline_ms: int | None = None):
        """One-sided get landing in a CALLER-OWNED buffer: the registered-
        receive-buffer idiom (the reference posts recvs into pre-registered
        NIC buffers; a fresh destination array per get costs one page
        fault per 4 KiB, ~4x the warm-copy cost at 256 MiB). ``out`` is a
        writable C-contiguous uint8 array or a contiguous uint8 tensor;
        stripes land via recv_into directly into disjoint views of a host
        ``out`` (a pinned buffer, say); a card ``out`` is filled from the
        client's pinned staging, on the caller's stream. Returns ``out``."""
        if handle.kind in (OcmKind.REMOTE_DEVICE, OcmKind.LOCAL_DEVICE):
            raise OcmError("get_into serves host-kind handles only")
        budget = timebudget.budget_from(deadline_ms, self.config)
        if isinstance(out, torch.Tensor):
            if out.dtype != torch.uint8 or not out.is_contiguous():
                raise ValueError("out must be a contiguous uint8 tensor")
            if out.device.type != "cpu":
                with self._staged(out.numel()) as stage:
                    self._dcn_get_into(handle, stage.numpy(), out.numel(),
                                       offset, budget)
                    out.view(-1).copy_(stage)
                return out
            arr = out.numpy()
        else:
            arr = out
            if (
                arr.dtype != np.uint8 or not arr.flags.c_contiguous
                or not arr.flags.writeable
            ):
                raise ValueError(
                    "out must be a writable C-contiguous uint8 array")
        # reshape(-1) of a C-contiguous array is a VIEW — stripes index a
        # flat byte range of the caller's buffer.
        self._dcn_get_into(handle, arr.reshape(-1), arr.nbytes, offset,
                           budget)
        return out

    def _dcn_get(self, handle: OcmAlloc, nbytes: int, offset: int,
                 budget: timebudget.Budget | None = None) -> np.ndarray:
        out = np.empty(nbytes, dtype=np.uint8)
        self._dcn_get_into(handle, out, nbytes, offset, budget)
        return out

    def _dcn_get_into(self, handle: OcmAlloc, out: np.ndarray, nbytes: int,
                      offset: int,
                      budget: timebudget.Budget | None = None) -> None:
        t0 = time.perf_counter()
        with self.tracer.span("dcn_get", nbytes=nbytes):
            stats = self._dcn_transfer(handle, nbytes, offset, get_arr=out,
                                       budget=budget)
        self._note_dcn(stats, "get", nbytes, time.perf_counter() - t0)

    def _note_dcn(self, stats: dict, op: str, nbytes: int, dt: float) -> None:
        with self._stats_lock:
            self.transfers[op] += 1
            self.transfers[f"{op}_bytes"] += nbytes
        self.tracer.note_transfer(
            op, nbytes, dt,
            stripes=stats["stripes"],
            window=max(stats["window"]) if stats["window"] else 0,
            chunk_bytes=max(stats["chunk"]) if stats["chunk"] else 0,
            retries=sum(stats["retries"]),
            coalesced=any(stats["coalesced"]),
            fabric=stats.get("fabric", "tcp"),
        )

    def _owner_addr(self, handle: OcmAlloc) -> tuple[str, int]:
        addr = getattr(handle, "owner_addr", None)
        if addr is not None:
            return addr
        e = self.entries[handle.rank]
        return (e.connect_host, e.port)

    # -- introspection ---------------------------------------------------

    def _rank_request(self, rank: int | None, msg: Message) -> Message:
        """One STATUS-family request to a rank's daemon: the ctrl stream
        for the local rank, the peer's shared mux channel (no fresh
        socket) under mux, a short-lived direct dial otherwise."""
        if rank is None or rank == self.rank:
            return self._request(msg)
        e = self.entries[rank]
        if self._mux is not None:
            return self._mux.request_sync((e.connect_host, e.port), msg)
        s = socket.create_connection((e.connect_host, e.port), timeout=30.0)
        try:
            return request(s, msg)
        finally:
            s.close()

    def status(self, rank: int | None = None) -> dict:
        return self._status_fields(
            self._rank_request(rank, Message(MsgType.STATUS, {}))
        )

    # -- SLO watcher (obs/slo.py) ----------------------------------------

    def _slo_samples(self) -> list[tuple[str, str, dict, float]]:
        """Client-local counters the daemons cannot expose, injected as
        synthetic families into the SLO history every tick. Today: the
        per-peer circuit breaker's opens (an availability error the
        daemon literally cannot see — it is the peer being avoided)."""
        if not self._breaker.enabled:
            return []
        opens = float(self._breaker.snapshot().get("opens", 0))
        labels = {"rank": str(self.rank)}
        return [(
            "ocm_client_breaker_opens_total",
            "ocm_client_breaker_opens_total", labels, opens,
        )]

    def start_slo(self, interval_s: float | None = None):
        """Arm the in-process SLO watcher: a background scraper polls
        every rank's STATUS_PROM through this client's existing in-band
        path into history rings, and the burn-rate engine evaluates the
        ``OCM_SLO`` objectives each tick. Idempotent; returns the
        :class:`~oncilla_tpu_torch.obs.slo.SloRunner` (or None when
        ``OCM_SLO`` disables it). Verdicts surface in ``status()["slo"]``."""
        from oncilla_tpu_torch.obs import slo as obs_slo

        if self._slo is not None:
            return self._slo
        cfg = self.config
        runner = obs_slo.SloRunner.from_env(
            self.fetch_prom, range(self.nnodes),
            interval_s=interval_s,
            budget_s=(cfg.deadline_ms / 1000.0) if cfg.deadline_ms > 0
            else None,
            extra_samples=self._slo_samples,
        )
        if runner is not None:
            self._slo = runner.start()
        return self._slo

    def stop_slo(self) -> None:
        runner, self._slo = self._slo, None
        if runner is not None:
            runner.stop()

    def fetch_prom(self, rank: int | None = None) -> str:
        """A rank's Prometheus text exposition (STATUS_PROM), served
        in-band — no scrape port to open on the daemon."""
        r = self._rank_request(rank, Message(MsgType.STATUS_PROM, {}))
        return bytes(r.data).decode("utf-8")

    def fetch_events(self, rank: int | None = None) -> list[dict]:
        """A rank's journal ring (STATUS_EVENTS) as a list of event
        dicts — what trace exporters merge across the cluster."""
        import json

        r = self._rank_request(rank, Message(MsgType.STATUS_EVENTS, {}))
        return [
            json.loads(line)
            for line in bytes(r.data).decode("utf-8").splitlines()
            if line.strip()
        ]

    def _status_fields(self, r: Message) -> dict:
        """STATUS_OK fields + data-plane telemetry: the daemon's served-side
        records ride as a JSON data tail (absent from the C++ daemon — a
        v2 reply without a tail is simply reported without it), and the
        client's own per-transfer ring (bytes, stripes, window, achieved
        Gbps, retries) is merged under ``dcn_client``."""
        f = dict(r.fields)
        if r.data:
            try:
                f.update(json.loads(bytes(r.data)))
            except (ValueError, UnicodeDecodeError):
                pass  # tail from a future daemon we don't understand
        f["dcn_client"] = {"transfers": self.tracer.transfers(last=32)}
        f["client"] = self.client_footprint()
        if self._slo is not None:
            f["slo"] = self._slo.meta()
        with self._stats_lock:
            f["transfers"] = dict(self.transfers)
        return f

    def client_footprint(self) -> dict:
        """Open-socket and thread counts for this client process — what
        the mux soak asserts its fd win against (mux: one shared
        connection per live peer + the plane listener, vs today's
        O(tenants x stripes) pool). ``sockets`` under mux is the
        PROCESS-shared channel count (every tenant reports the same
        number, because they share the same fds)."""
        if self._mux is not None:
            sockets = self._mux.fd_count()
            mux = self._mux.counters()
        else:
            sockets = (0 if self._ctrl is None else 1) + self._pool.size()
            mux = None
        if self._plane_server is not None:
            sockets += 1
        return {
            "sockets": sockets,
            "threads": threading.active_count(),
            "mux": mux,
            "breaker": (self._breaker.snapshot()
                        if self._breaker.enabled else None),
        }
