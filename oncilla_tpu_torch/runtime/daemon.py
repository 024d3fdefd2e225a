"""The per-host daemon: control-plane state machine + DCN data plane.

The port's copy of ``oncilla_tpu/runtime/daemon.py``, line for line: only
its imports name the port's own modules, its host arena is the port's copy
of the JAX package's numpy arena (``runtime/hostarena.py``), and ``main``
drops the JAX platform pin. It imports nothing of JAX and never touches
the card: device-kind data ops are relayed to the app's plane server.
Run it as ``python -m oncilla_tpu_torch.runtime.daemon <nodefile> --rank r``
or in process through ``runtime/cluster.py``.

Python reference implementation of the daemon the reference builds as
``bin/oncillamem`` (reference src/main.c + mem.c): thread-per-connection
TCP server, rank-0 placement master, allocation registry, and — unlike the
reference, whose daemon never touches data — the server side of the DCN
data plane (REMOTE_HOST put/get into a daemon-owned host arena; the analogue
of the daemon-registered NIC buffer, alloc.c:171-176).

The C++ production daemon (runtime/native/) speaks the identical wire
protocol; this implementation is the executable spec and the test harness
(the in-process multi-daemon capability the reference lacked, SURVEY.md §4).

Protocol-race fix: the reference replies to DO_ALLOC *before* the server
listens for the data-plane connection ("XXX possible race condition",
reference src/mem.c:350-354). Here the owner reserves the extent and
registers the allocation before replying, and the data plane is
connectionless, so no such window exists.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time

from oncilla_tpu_torch.analysis import alloctrace, waitwatch
from oncilla_tpu_torch.analysis.lockwatch import make_lock, make_rlock
from oncilla_tpu_torch.core.arena import ArenaAllocator, Extent, check_bounds
from oncilla_tpu_torch.core.errors import (
    OcmAdmissionDenied,
    OcmBoundsError,
    OcmBusy,
    OcmConnectError,
    OcmDeadlineExceeded,
    OcmError,
    OcmInvalidHandle,
    OcmMoved,
    OcmOutOfMemory,
    OcmPlacementError,
    OcmNotPrimary,
    OcmProtocolError,
    OcmQuotaExceeded,
    OcmRemoteError,
    OcmReplicaUnavailable,
)
from oncilla_tpu_torch import fabric as fabric_mod
from oncilla_tpu_torch.control import hashring
from oncilla_tpu_torch.control import leader as control_leader
from oncilla_tpu_torch.runtime.hostarena import HostArena
from oncilla_tpu_torch.core.kinds import OcmKind
from oncilla_tpu_torch.elastic.rebalance import Rebalancer
from oncilla_tpu_torch.runtime.membership import NodeEntry, as_view
from oncilla_tpu_torch.runtime.pool import PeerPool
from oncilla_tpu_torch.runtime.placement import (
    POLICIES,
    NodeResources,
    Placement,
)
from oncilla_tpu_torch.obs import journal as obs_journal
from oncilla_tpu_torch.obs import trace as obs_trace
from oncilla_tpu_torch.qos.policy import (
    PRIO_HIGH,
    PRIO_LOW,
    PRIO_NORMAL,
    QosManager,
    suggest_backoff_ms,
    unpack_profile,
)
from oncilla_tpu_torch.resilience.detector import (
    DeadVerdict,
    FailureDetector,
    PeerState,
    probe,
)
from oncilla_tpu_torch.resilience.failover import FailoverCoordinator
from oncilla_tpu_torch.resilience import timebudget
from oncilla_tpu_torch.runtime.protocol import (
    FLAG_CAP_COALESCE,
    FLAG_CAP_DEADLINE,
    FLAG_CAP_FABRIC,
    FLAG_CAP_MUX,
    FLAG_CAP_QOS,
    FLAG_CAP_REPLICA,
    FLAG_CAP_TRACE,
    FLAG_DEADLINE,
    FLAG_FANOUT,
    FLAG_MORE,
    FLAG_HB_FWD,
    FLAG_MUX_TAG,
    FLAG_QOS_TAIL,
    FLAG_REPLICAS,
    FLAG_TRACE_CTX,
    VALID_FLAGS,
    WIRE_KIND,
    WIRE_KIND_INV,
    BufferedSock,
    ErrCode,
    Message,
    MsgType,
    RecvScratch,
    attach_tag,
    pack,
    pack_leader_tail,
    recv_msg,
    request,
    send_msg,
    split_tag,
)
from oncilla_tpu_torch.runtime.protocol import (
    _data_len as _data_len_of,
    _sendall_vec as protocol_sendall_vec,
)
from oncilla_tpu_torch.runtime.registry import AllocRegistry, RegEntry
from oncilla_tpu_torch.utils.config import OcmConfig
from oncilla_tpu_torch.utils.debug import Tracer, printd


# Bounded worker pool for out-of-order tagged control ops (mux serving).
# Control ops are short (or block on nested relay legs, which the pool
# must ride out) — size like the native daemon's data pool.
_MUX_POOL_WORKERS = min(8, max(2, os.cpu_count() or 2))

# Process-wide connection ids for the cancel/ack journal events: mux
# correlation tags are per-connection, so the audit invariant scopes
# them by (daemon track, conn, tag).
_conn_id_counter = 0
_conn_id_lock = make_lock("daemon._conn_id_lock")


def _next_conn_id() -> int:
    global _conn_id_counter
    with _conn_id_lock:
        _conn_id_counter += 1
        return _conn_id_counter


class _ConnMuxState:
    """Per-connection arrival bookkeeping for tagged control ops: which
    sequence numbers are still in flight, so a completion can tell
    whether it overtook an earlier arrival (the ``ooo`` counter — proof
    the out-of-order contract is actually exercised) — plus the
    server-side cancellation state: which tags are still open on the
    worker pool and which of those a CANCEL has revoked. ``cancel`` and
    ``finish_tag`` race under ONE lock, so exactly one of two outcomes
    holds per tag: the cancel wins (revoked=1 acked, the worker's reply
    suppressed — never an ack after a revoked cancel-ack, the audit
    invariant) or the completion wins (revoked=0, the ordinary reply
    stands and the client's orphan discard absorbs it)."""

    __slots__ = ("_lock", "_seq", "_inflight", "_open_tags", "_cancelled")

    def __init__(self) -> None:
        self._lock = make_lock("daemon._conn_mux_state")
        self._seq = 0
        self._inflight: set[int] = set()
        self._open_tags: set[int] = set()
        self._cancelled: set[int] = set()

    def note_start(self, tag: int | None = None) -> int:
        with self._lock:
            self._seq += 1
            self._inflight.add(self._seq)
            if tag is not None:
                self._open_tags.add(tag)
            return self._seq

    def note_done(self, seq: int) -> bool:
        """Retire ``seq``; True when an EARLIER arrival is still open
        (this completion is out of order)."""
        with self._lock:
            self._inflight.discard(seq)
            return any(s < seq for s in self._inflight)

    def cancel(self, tag: int) -> bool:
        """Revoke ``tag`` if it is still open on the pool; True = the
        revocation binds (the worker's reply WILL be suppressed), False
        = nothing to revoke (unknown tag, already answered, or an
        inline data leg past the point of no return)."""
        with self._lock:
            if tag in self._open_tags and tag not in self._cancelled:
                self._cancelled.add(tag)
                return True
            return False

    def take_if_cancelled(self, tag: int) -> bool:
        """Pre-dispatch check: True when a binding cancel already
        revoked ``tag`` (the tag state is consumed — the op must not
        run, and no reply may be sent)."""
        with self._lock:
            if tag in self._cancelled:
                self._cancelled.discard(tag)
                self._open_tags.discard(tag)
                return True
            return False

    def finish_tag(self, tag: int) -> bool:
        """Retire ``tag`` at completion; True = send the reply, False =
        a binding cancel got there first (suppress it)."""
        with self._lock:
            self._open_tags.discard(tag)
            if tag in self._cancelled:
                self._cancelled.discard(tag)
                return False
            return True


class Daemon:
    """One per host. ``rank == 0`` is the placement master."""

    def __init__(
        self,
        rank: int,
        entries: list[NodeEntry],
        config: OcmConfig | None = None,
        policy: str = "capacity",
        ndevices: int = 1,
        host: str | None = None,
        snapshot_path: str | None = None,
        incarnation: int | None = None,
        listener: socket.socket | None = None,
    ):
        self.snapshot_path = snapshot_path
        self.rank = rank
        # Membership is a LIVE epoch-stamped table (elastic/): a plain
        # nodefile list is wrapped, an existing ClusterView is shared
        # as-is (the LocalCluster idiom — every in-process daemon sees
        # one table, exactly like the reference's global nodefile, but
        # mutable under the JOIN/LEAVE protocol).
        self.entries = as_view(entries)
        self.config = config or OcmConfig()
        self.ndevices = ndevices
        # The control/data plane is unauthenticated (like the reference's,
        # sock.c binds INADDR_ANY) — so default to loopback; exposing it on
        # other interfaces is an explicit opt-in via the host= argument
        # (typically the nodefile hostname) or OCM_BIND_HOST=0.0.0.0.
        if host is None:
            host = os.environ.get("OCM_BIND_HOST", "127.0.0.1")
        self.host = host
        self.port = entries[rank].port
        # One-sided fabrics this daemon serves (fabric/): with
        # OCM_FABRIC=shm/auto the host arena is BACKED by a named
        # shared-memory segment, advertised at CONNECT behind
        # FLAG_CAP_FABRIC so same-host clients put/get by memcpy. A
        # failed registration (tiny /dev/shm) degrades to tcp-only.
        self.fabrics = fabric_mod.server_fabrics(self.config)
        backing = (
            self.fabrics["shm"].buffer() if "shm" in self.fabrics else None
        )
        # Counters for the per-fabric transfer metrics (STATUS tail +
        # ocm_fabric_* prom families): CONNECT negotiations by outcome
        # and served one-sided ops/bytes. Plain int bumps under the GIL,
        # same discipline as res_counters.
        self.fabric_counters = {
            "selected_shm": 0,   # CONNECT offers granted with a descriptor
            "selected_tcp": 0,   # offers declined (nothing to advertise)
            "shm_puts": 0,
            "shm_gets": 0,
            "shm_put_bytes": 0,
            "shm_get_bytes": 0,
        }
        # Daemon-owned storage for the REMOTE_HOST arm (DCN fabric).
        self.host_arena = HostArena(
            self.config.host_arena_bytes, self.config.alignment,
            backing=backing,
        )
        # Bookkeeping-only allocators for this host's device arenas: the HBM
        # bytes live in the SPMD app processes (the ICI fabric); the daemon
        # hands out extents inside them.
        self.device_books = [
            ArenaAllocator(self.config.device_arena_bytes, self.config.alignment)
            for _ in range(ndevices)
        ]
        self.registry = AllocRegistry(
            rank, self.config.lease_s,
            app_stale_leases=self.config.app_stale_leases,
        )
        self.policy = POLICIES[policy]()
        self.peers = PeerPool()
        # Multi-tenant QoS (qos/): tenant profiles + admission accounting
        # for apps whose ORIGIN daemon this is; rank 0 additionally runs
        # the back-pressure check and, with policy="loadaware", feeds the
        # placement policy from peer STATUS polls in the reaper loop.
        self.qos = QosManager(self.config)
        self._last_load_poll = time.monotonic()
        # FROZEN tier (persist/): disk-backed extent store, one
        # directory per daemon rank. Constructed ONLY when configured
        # (OCM_FROZEN_DIR set and OCM_FROZEN!=0) — None keeps every
        # demotion/eviction/data path byte-identical to the pre-persist
        # daemon. The open itself adopts nothing; surviving extents are
        # re-registered by _adopt_frozen() in start(). A failed open
        # (unwritable dir) degrades to no-FROZEN rather than killing
        # the daemon.
        self._frozen = None
        # Reentrant: a thaw's arena-full retry runs the pressure
        # evictor, whose demote leg re-enters the same lock.
        self._frz_lock = make_rlock("daemon._frz_lock")
        self.frz_counters = {
            "demotes": 0,        # victims spilled to disk (tier_demote)
            "promotes": 0,       # frozen entries thawed back into the arena
            "lost": 0,           # corrupt/torn entries refused at open/read
            "warm_boot_extents": 0,  # extents re-adopted after a restart
        }
        if self.config.frozen_enabled:
            from oncilla_tpu_torch.persist.store import FrozenStore

            try:
                self._frozen = FrozenStore(
                    os.path.join(self.config.frozen_dir, f"r{self.rank}"),
                    max_bytes=self.config.frozen_max_bytes,
                )
                self.frz_counters["lost"] = len(self._frozen.lost)
            except OSError as e:
                printd("daemon r%d: frozen store open failed: %s",
                       self.rank, e)
        # Device-plane endpoint (host, port) registered by the SPMD
        # controller's client via PLANE_SERVE; device-kind data ops are
        # relayed there (tuple rebind is atomic under the GIL). The daemon
        # that takes a fresh registration pushes it to every peer; ranks
        # still pending live in _plane_unsynced and are retried by the
        # reaper loop.
        self.plane_addr: tuple[str, int] | None = None
        self._plane_unsynced: set[int] = set()
        self._plane_sync_lock = make_lock("daemon._plane_sync_lock")
        # True once this daemon has relayed a device-kind write: from then
        # on freed device extents MUST be scrubbed through the plane even
        # if the local endpoint is momentarily unknown (master hop).
        self._device_writes_relayed = False
        self._listener: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._running = threading.Event()
        self._started_ok = False
        self._conns: set[socket.socket] = set()
        self._conns_mu = make_lock("daemon._conns_mu")
        # OCM_ALLOCTRACE ledger scope for registry entries this daemon
        # owns (id-qualified: one process hosts many daemons in tests).
        self._trace_scope = f"daemon:r{self.rank}:{id(self):#x}"
        # Served data-plane telemetry: per-op stats plus the per-transfer
        # ring (bytes/Gbps of each coalesced burst), surfaced as the JSON
        # data tail of STATUS_OK — trailing data on a reply is invisible
        # to old clients, so the schema stays v2-compatible. The track
        # label keys this daemon's timeline in exported traces (one test
        # process hosts many daemons; pid alone cannot tell them apart).
        self.tracer = Tracer(track=f"daemon-r{self.rank}")
        # Trace-capability bits per peer address, probed lazily with a
        # CONNECT on the first forwarded hop that has a context to carry
        # (the client-side _dcn_caps precedent) — a capability is a
        # property of the peer's software, not of one connection, so one
        # probe covers every pooled socket to that address.
        self._peer_caps: dict[tuple[str, int], int] = {}
        self._peer_caps_lock = make_lock("daemon._peer_caps_lock")
        # Per-serve-thread reusable DATA_GET_OK snapshot buffer: a fresh
        # bytes() per 16 MiB chunk costs an allocation + page faults each
        # time (measured ~4x the warm-copy cost); each connection has its
        # own serve thread, so thread-local reuse needs no locking.
        self._get_buf = threading.local()
        # -- resilience (resilience/) -----------------------------------
        # Cluster epoch: bumped by rank 0 on every DEAD verdict, gossiped
        # on PING and adopted max-wins everywhere; a fenced daemon (one
        # that outlived its own DEAD verdict) refuses writes with
        # STALE_EPOCH so it can never serve split-brain traffic. The
        # incarnation is this daemon OBJECT's identity: a restarted
        # daemon on the same port has a fresh one, so a stale fencing
        # broadcast can never hit the replacement.
        self.epoch = 0
        self._epoch_lock = make_lock("daemon._epoch_lock")
        self._fenced = False
        self.incarnation = (
            incarnation or int.from_bytes(os.urandom(8), "little") or 1
        )
        # Pre-bound listener (elastic/join_cluster): the joiner binds
        # and LISTENS before REQ_JOIN so peers reaching for the new rank
        # queue in the backlog instead of bouncing off a closed port.
        self._prebound = listener
        # -- elastic membership (elastic/) -------------------------------
        # Forwarding tombstones for live-migrated allocations:
        # alloc_id -> (new owner rank, origin_pid, origin_rank, stamp).
        # Data ops on a tombstoned id answer typed MOVED (the client
        # repoints its handle); DO_FREE forwards; heartbeats from the
        # owning app are forwarded so the migrated copy's lease stays
        # renewed until the client repoints. Pruned by the reaper once
        # the app goes stale.
        self._moved: dict[int, tuple[int, int, int, float]] = {}
        self._moved_lock = make_lock("daemon._moved_lock")
        # In-flight outbound migrations (source side): alloc_id ->
        # {"dirty": [(offset, nbytes)...], "fence": bool}. Client puts
        # landing mid-stream are recorded for the pre-copy dirty passes;
        # once fenced, they answer retryable NOT_PRIMARY and the ladder
        # re-lands them on the target after the flip.
        self._migrations: dict[int, dict] = {}
        self._mig_lock = make_lock("daemon._mig_lock")
        # MEMBER_UPDATE broadcast retry set (rank 0): peers that have
        # not confirmed the current member table yet; the reaper loop
        # re-pushes until every live member converges (the
        # _plane_unsynced pattern).
        self._member_unsynced: set[int] = set()
        self._member_sync_lock = make_lock("daemon._member_sync_lock")
        self.ela_counters = {
            "joins": 0,                  # rank 0: REQ_JOIN admissions
            "leaves": 0,                 # rank 0: graceful departures
            "migrations_started": 0,     # source side
            "migrations_completed": 0,
            "migrations_aborted": 0,
            "migration_bytes": 0,        # bytes whose ownership flipped
        }
        self.res_counters = {
            "deaths": 0,           # DEAD verdicts issued (leader only)
            "promotions": 0,       # replica entries promoted to primary here
            "rereplications": 0,   # repair copies driven (leader only)
            "repl_put_errors": 0,  # put fan-out legs that failed
            "repl_put_skips": 0,   # fan-out legs skipped (replica DEAD)
        }
        # -- decentralized control plane (control/) ----------------------
        # The master role is a dynamic LEADERSHIP, not rank 0's identity:
        # every master-bound leg (ADD_NODE, REQ_ALLOC proxy, NOTE_*,
        # SUSPECT reports, plane master hop, JOIN/LEAVE) targets
        # entries[leader_rank]. Boot-time leader is rank 0 — with
        # OCM_STANDBY_MASTERS unset it never moves, and none of the
        # MASTER_STATE/LEADER_* family ever rides the wire.
        self.leader_rank = 0
        self.leader_epoch = 0
        self._elect_lock = make_lock("daemon._elect_lock")
        self.ldr_counters = {
            "elections_won": 0,       # this daemon took leadership
            "elections_observed": 0,  # leadership changed under us
            "handoffs": 0,            # voluntary transfers (either end)
            "placements": 0,          # REQ_ALLOCs placed HERE as leader
            "hash_placements": 0,     # REQ_ALLOCs hash-placed locally
            "state_pushes": 0,        # MASTER_STATE pushes sent (leader)
            "state_resyncs": 0,       # whole-resyncs at promotion
        }
        # Replicated master state held AS a standby: the raw CRC-framed
        # document exactly as pushed (validated before storing AND again
        # at promotion — a copy torn on disk/in memory is refused whole).
        self._master_state_raw: bytes | None = None
        self._master_state_ts = 0.0
        self._master_state_seq = 0
        self._state_seq = 0          # leader-side push sequence
        self._state_lock = make_lock("daemon._state_lock")
        # LEADER_UPDATE broadcast retry set + the fields to re-send
        # (the _member_unsynced pattern: reaper retries stragglers).
        self._leader_unsynced: set[int] = set()
        self._leader_update_fields: dict | None = None
        self._leader_sync_lock = make_lock("daemon._leader_sync_lock")
        # Hash placement's deferred accounting: NOTE_ALLOC messages bound
        # for the leader, drained by the reaper so the alloc path itself
        # makes ZERO leader round trips (the acceptance pin).
        self._acct_pending: list[Message] = []
        self._acct_lock = make_lock("daemon._acct_lock")
        # Harness-level partition emulation (resilience/chaos "isolate"):
        # inbound connections are dropped, outbound pool leases refused,
        # probes short-circuit to failures — a fully partitioned host.
        self._partitioned = False
        # Mux serving (runtime/mux.py): tagged control ops complete OUT
        # OF ORDER on a small shared worker pool (created lazily — a
        # daemon that never sees a mux client never pays the threads);
        # per-connection write locks keep reply frames whole. Counters
        # feed STATUS/prom and the obs table's in-flight column.
        self._mux_pool = None
        self._mux_pool_lock = make_lock("daemon._mux_pool_lock")
        self._mux_counters = {
            "conns": 0,          # connections that negotiated mux
            "tagged_ops": 0,     # tagged requests served
            "inflight": 0,       # tagged control ops in the pool NOW
            "peak_inflight": 0,
            "ooo": 0,            # replies sent out of arrival order
        }
        self._mux_ctr_lock = make_lock("daemon._mux_ctr_lock")
        # Time-bounded data plane (resilience/timebudget.py): budget and
        # cancellation accounting. Plain int bumps under the GIL (the
        # res_counters discipline); last_budget_ms is the most recent
        # FLAG_DEADLINE tail received — what the cross-hop decrement
        # test reads to prove a relayed budget arrived strictly smaller.
        self.tb_counters = {
            "deadline_exceeded": 0,  # expired work refused typed
            "cancels": 0,            # CANCEL requests served
            "cancels_revoked": 0,    # ... that actually revoked an op
            "cancel_drops": 0,       # replies suppressed post-cancel
            "cancel_frees": 0,       # completed-then-cancelled allocs
            #                          unwound through the free path
            "last_budget_ms": -1,
        }
        # Testability hook (bench/tests, never config): artificial serve
        # delay for the named message types — how a "slow replica" is
        # built for the hedged-read cells and how a cancel storm gets a
        # deterministic window to land in.
        self.serve_delay_s = 0.0
        self.serve_delay_types: frozenset = frozenset()
        # Sibling hook, different placement: serve_delay sleeps BEFORE
        # the serve-side tracer span (a slow wire/replica — invisible in
        # ocm_op_latency_seconds), handler_delay sleeps INSIDE _dispatch
        # (a slow handler — the latency histograms see it). The SLO
        # selftest's seeded-burn fixture is built on the latter.
        self.handler_delay_s = 0.0
        self.handler_delay_types: frozenset = frozenset()
        self.detector = (
            FailureDetector(
                len(entries), rank,
                suspect_after=self.config.suspect_after,
                dead_after=self.config.dead_after,
            )
            if self.config.detect and len(entries) > 1 else None
        )
        # Every daemon carries the coordination machinery (cheap, inert
        # objects); only the CURRENT leader drives it — a promoted
        # standby resumes failover/rebalance without construction races.
        self._failover = FailoverCoordinator(self)
        self._rebalancer = Rebalancer(self)
        self._last_probe = time.monotonic()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._prebound is not None:
            # elastic join: the socket was bound AND listening before
            # REQ_JOIN, so peers dialing the freshly announced rank
            # queue in the backlog until the accept loop drains them.
            self._listener, self._prebound = self._prebound, None
        else:
            self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listener.setsockopt(
                socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
            )
            # Loopback by default (see __init__); multi-host deployments
            # pass the nodefile hostname or opt into the wildcard
            # explicitly. Peers dial the nodefile's addr column, which
            # need not match what the local resolver maps our own
            # hostname to.
            self._listener.bind((self.host, self.port))
            self._listener.listen(64)
        if self.port == 0:  # ephemeral port (tests)
            self.port = self._listener.getsockname()[1]
            self.entries[self.rank] = NodeEntry(
                self.rank, self.host, self.port, self.entries[self.rank].addr
            )
        self._running.set()
        # Join the cluster (ADD_NODE resets rank-0 accounting for this node)
        # and restore the snapshot (NOTE_ALLOC resyncs it) BEFORE serving:
        # the listen backlog queues early connections, so no request can
        # claim an extent the snapshot needs (the C++ daemon orders the same
        # way, native/daemon.cc restore-before-accept).
        if self.rank == self.leader_rank:
            self.policy.add_node(self._own_resources())
        else:
            self._notify_leader()
        self._maybe_restore()
        # Warm boot: re-adopt frozen extents that survived a hard kill
        # (no snapshot was written) AFTER the snapshot restore, so
        # snapshot-known entries win and only orphans are adopted.
        self._adopt_frozen()
        t = threading.Thread(target=self._accept_loop, daemon=True, name=f"d{self.rank}-accept")
        t.start()
        self._threads.append(t)
        r = threading.Thread(target=self._reaper_loop, daemon=True, name=f"d{self.rank}-reaper")
        r.start()
        self._threads.append(r)
        self._started_ok = True
        printd("daemon rank=%d listening on %s:%d", self.rank, self.host, self.port)

    def stop(self) -> None:
        # Quiesce first: stop accepting, kick every serve thread off its
        # socket, and only then snapshot — otherwise in-flight requests can
        # tear the snapshot (half-written puts, allocations granted after
        # the registry walk).
        self._running.clear()
        if self._listener is not None:
            # shutdown() wakes the thread blocked in accept(); a bare close()
            # leaves the kernel file description (and the LISTEN socket)
            # alive until that accept returns, blocking port rebinds.
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        with self._conns_mu:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            with self._conns_mu:
                if not self._conns:
                    break
            time.sleep(0.01)
        # Snapshot only if this daemon actually served (a failed start must
        # not clobber a good on-disk snapshot with an empty registry).
        if self.snapshot_path and self._started_ok:
            try:
                self.save_snapshot()
            except OSError:
                printd("daemon %d: snapshot write failed", self.rank)
        self.peers.close()
        with self._mux_pool_lock:
            pool, self._mux_pool = self._mux_pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        # Unregister fabrics LAST: the snapshot above reads the arena,
        # which an shm fabric backs. Idempotent (kill() may have run).
        for f in self.fabrics.values():
            f.teardown()

    def kill(self) -> None:
        """Hard-kill (resilience/chaos.py): the crash the failover
        machinery exists for. No snapshot, no drain, no courtesy to
        in-flight requests — every socket is torn down NOW, exactly what
        a SIGKILL'd daemon process looks like to its peers. Idempotent;
        a later :meth:`stop` (cluster teardown) is a no-op on top."""
        self._started_ok = False  # a kill must never write a snapshot
        # Black-box flush FIRST: the journal ring is the evidence the
        # post-mortem auditor needs, and a hard kill used to discard it.
        # With the flight recorder armed (OCM_FLIGHTREC) the ring is
        # dumped to a labelled segment; streamed duplicates dedup away
        # at merge time, so this can only ADD evidence.
        obs_journal.record(
            "daemon_kill", track=self.tracer.track, rank=self.rank,
        )
        obs_journal.spill_ring(label=f"kill-r{self.rank}")
        self._running.clear()
        if self._listener is not None:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        with self._conns_mu:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self.peers.close()
        with self._mux_pool_lock:
            pool, self._mux_pool = self._mux_pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        # A killed daemon must not leak its segment name in /dev/shm:
        # unlink NOW (attached peers' mappings stay valid; only the name
        # dies — exactly a SIGKILL'd process whose parent reaps the
        # segment). The chaos-harness kill path asserts this.
        for f in self.fabrics.values():
            f.teardown()

    # -- epoch / fencing (resilience/) -----------------------------------

    def bump_epoch(self) -> int:
        """Leader only: advance the cluster epoch (DEAD verdicts,
        membership changes, leadership transfer)."""
        with self._epoch_lock:
            self.epoch += 1
            return self.epoch

    def _adopt_epoch(self, epoch: int) -> None:
        """Max-wins epoch gossip (PING and every resilience message)."""
        with self._epoch_lock:
            if epoch > self.epoch:
                self.epoch = epoch

    def _fence(self, epoch: int) -> None:
        if not self._fenced:
            self._fenced = True
            obs_journal.record(
                "fenced", track=self.tracer.track,
                rank=self.rank, epoch=epoch,
            )
            printd("daemon %d FENCED at epoch %d: refusing writes",
                   self.rank, epoch)

    # -- leadership (control/): the master role as an epoch-fenced lease -

    @property
    def is_leader(self) -> bool:
        """Whether THIS daemon currently coordinates the cluster. A
        fenced daemon is never the leader, whatever it believes — its
        verdicts were superseded by a newer epoch."""
        return self.rank == self.leader_rank and not self._fenced

    def _leader_entry(self) -> NodeEntry:
        r = self.leader_rank
        if 0 <= r < len(self.entries):
            return self.entries[r]
        return self.entries[0]

    def _not_master_err(self, what: str) -> Message:
        """Typed NOT_MASTER rejection. Once leadership is dynamic the
        tail names the current leader (rank + address) so the sender
        re-aims instead of spinning — the MOVED redirect pattern applied
        to the master role. Static clusters keep the pre-leadership tail-less
        frame (wire byte-identity when the feature is unset)."""
        tail = b""
        if self.config.standby_masters > 0 or self.leader_rank != 0:
            le = self._leader_entry()
            tail = pack_leader_tail(
                self.leader_rank, le.connect_host, le.port
            )
        return _err(
            ErrCode.NOT_MASTER, f"{what} sent to non-master", tail
        )

    def _adopt_leader_hint(self, err) -> None:
        """A peer's NOT_MASTER redirect named the current leader."""
        lr = getattr(err, "leader_rank", None)
        if lr is not None and 0 <= lr < len(self.entries):
            if lr != self.leader_rank:
                printd("daemon %d: leader hint %d -> %d",
                       self.rank, self.leader_rank, lr)
            self.leader_rank = lr

    def set_partitioned(self, on: bool) -> None:
        """Harness seam (resilience/chaos "isolate"): emulate a full
        network partition of this daemon's host. Inbound requests are
        dropped mid-frame (peers and probes see a torn connection),
        outbound pool leases refuse, and the detector tick records
        probe failures without dialing — deterministic, reversible, and
        honest about what a partitioned process can still do: keep its
        own state and keep believing it leads."""
        self._partitioned = bool(on)
        self.peers.set_blocked(on)
        obs_journal.record(
            "chaos_isolate" if on else "chaos_heal_isolate",
            track=self.tracer.track, rank=self.rank,
        )

    def _standby_ranks(self) -> list[int]:
        """The k lowest-rank live members after the leader — where the
        master state replicates. Deterministic from the shared view, so
        every rank agrees who the standbys are."""
        k = self.config.standby_masters
        if k <= 0:
            return []
        out = [
            e.rank for e in self.entries
            if e.rank != self.rank
            and e.port
            and not self.entries.has_left(e.rank)
            and not self._believed_dead(e.rank)
        ]
        return sorted(out)[:k]

    def _push_master_state(self) -> None:
        """Leader, reaper-tick cadence: replicate the coordination state
        to every standby under the snapshot+CRC discipline. Small (a few
        KiB), so a full copy per tick beats delta bookkeeping; the seq
        lets standbys drop stale reordered pushes."""
        with self._state_lock:
            self._state_seq += 1
            seq = self._state_seq
        doc = control_leader.build_state(self, seq)
        raw = control_leader.pack_state(doc)
        msg_fields = {"seq": seq, "epoch": self.epoch, "leader": self.rank}
        for r in self._standby_ranks():
            e = self.entries[r]
            try:
                self.peers.request(
                    e.connect_host, e.port,
                    Message(MsgType.MASTER_STATE, dict(msg_fields), raw),
                )
                self.ldr_counters["state_pushes"] += 1
            except (OSError, OcmError):
                pass  # next tick retries; the standby resyncs whole if
                # it must lead from a stale copy

    def _on_master_state(self, msg: Message) -> Message:
        """Standby side: store the leader's pushed state. The CRC is
        verified BEFORE the copy is stored (a torn push is refused with
        a typed error, and the leader re-pushes next tick) and verified
        AGAIN at promotion — the copy may rot in between."""
        f = msg.fields
        self._adopt_epoch(f["epoch"])
        if 0 <= f["leader"] < len(self.entries):
            self.leader_rank = f["leader"]
        control_leader.unpack_state(msg.data)  # raises on any corruption
        with self._state_lock:
            if f["seq"] >= self._master_state_seq:
                self._master_state_raw = bytes(msg.data)
                self._master_state_seq = f["seq"]
                self._master_state_ts = time.monotonic()
        return Message(MsgType.MASTER_STATE_OK, {"seq": f["seq"]})

    def _adopt_master_state(self) -> bool:
        """Promotion path: lead from the replicated copy if — and only
        if — it verifies AND is fresh within the leader lease. Returns
        False when the winner must re-sync whole instead."""
        with self._state_lock:
            raw, ts = self._master_state_raw, self._master_state_ts
        if raw is None:
            return False
        age = time.monotonic() - ts
        horizon = max(self.config.leader_lease_s,
                      3 * self.config.heartbeat_s)
        if age > horizon:
            printd("daemon %d: replicated master state is %.2fs old "
                   "(lease %.2fs) — resyncing whole", self.rank, age,
                   horizon)
            return False
        try:
            doc = control_leader.unpack_state(raw)
        except OcmProtocolError as e:
            obs_journal.record(
                "master_state_corrupt", track=self.tracer.track,
                rank=self.rank, error=str(e),
            )
            printd("daemon %d: replicated master state REFUSED: %s",
                   self.rank, e)
            return False
        control_leader.apply_state(self, doc)
        return True

    def _rebuild_master_state(self) -> None:
        """Whole re-sync: reconstruct the placement accounting from the
        survivors' own numbers (STATUS carries capacities + live bytes)
        instead of trusting a torn or stale replica. Unreachable peers
        are skipped — the detector resolves them, and NOTE_* traffic
        self-corrects the books as it always has."""
        self.ldr_counters["state_resyncs"] += 1
        obs_journal.record(
            "leader_resync", track=self.tracer.track,
            rank=self.rank, epoch=self.epoch,
        )
        rows = [{
            "rank": self.rank,
            "ndevices": self.ndevices,
            "device_arena_bytes": self.config.device_arena_bytes,
            "host_arena_bytes": self.config.host_arena_bytes,
            "device_used": [b.bytes_live for b in self.device_books],
            "host_used": self.host_arena.allocator.bytes_live,
        }]
        for e in self.entries:
            if e.rank == self.rank or not e.port:
                continue
            if self.entries.has_left(e.rank) or self._believed_dead(e.rank):
                continue
            try:
                r = self.peers.request(
                    e.connect_host, e.port, Message(MsgType.STATUS, {})
                )
            except (OSError, OcmError):
                continue
            caps = {}
            if r.data:
                import json

                try:
                    caps = json.loads(bytes(r.data)).get("caps") or {}
                except (ValueError, UnicodeDecodeError):
                    caps = {}
            rows.append({
                "rank": e.rank,
                "ndevices": caps.get("ndevices", 1),
                "device_arena_bytes": caps.get(
                    "device_arena_bytes", self.config.device_arena_bytes
                ),
                "host_arena_bytes": caps.get(
                    "host_arena_bytes", self.config.host_arena_bytes
                ),
                # The total is accurate; the per-device split is not
                # reported — park it on device 0 (device placement is
                # capacity-gated per device, so this only errs safe).
                "device_used": [r.fields.get("device_bytes_live", 0)],
                "host_used": r.fields.get("host_bytes_live", 0),
            })
        dead = self.detector.dead_ranks() if self.detector else set()
        self.policy.restore(rows, dead)

    def _maybe_elect(self) -> None:
        """Standby election check (reaper tick, leader believed dead):
        the lowest live rank takes over. Everyone computes the same rule
        from their own view; non-winners keep probing the smaller ranks
        so a dead would-be winner is discovered and the rule re-runs."""
        det = self.detector
        dead = det.dead_ranks() if det is not None else set()
        winner = control_leader.elect(self.entries, dead, self.rank)
        if winner == self.rank:
            self._become_leader()

    def _become_leader(self) -> None:
        """Take the master role after the leader's DEAD verdict: adopt
        (or rebuild) the replicated state, bump + fence under a new
        epoch, broadcast LEADER_UPDATE, then resume the dead leader's
        coordination — failover, promotion, re-replication — exactly
        where it stopped."""
        with self._elect_lock:
            if self.is_leader or self._fenced:
                return
            old = self.leader_rank
            if not self._believed_dead(old):
                return
            old_inc = (
                self.detector.incarnation(old) if self.detector else 0
            )
            resync = not self._adopt_master_state()
            if resync:
                # Deliberately dialed under _elect_lock: the adoption
                # check, whole-cluster resync, and epoch bump must be
                # atomic w.r.t. the handoff/update handlers or a
                # concurrent LEADER_HANDOFF could interleave half-built
                # master state. The cross-process hazard stays open-
                # ended only in theory: the resync legs are STATUS
                # (leaf handlers — no back-dial), so the reverse
                # rpc:daemon -> _elect_lock edge cannot complete a
                # cycle through them; OCM_WAITWATCH=1 watches the
                # dynamic graph for regressions.
                self._rebuild_master_state()  # ocm-lint: allow[lock-across-rpc]
            self.leader_rank = self.rank
            epoch = self.bump_epoch()
            self.leader_epoch = epoch
            self.ldr_counters["elections_won"] += 1
        self.policy.mark_dead(old)
        if self.detector is not None:
            self.detector.mark_dead(old)
        obs_journal.record(
            "leader_elect", track=self.tracer.track,
            rank=self.rank, prev=old, epoch=epoch, resync=resync,
        )
        obs_journal.record(
            "leader_fence", track=self.tracer.track,
            rank=old, epoch=epoch,
        )
        printd("daemon %d: ELECTED leader at epoch %d (rank %d fenced%s)",
               self.rank, epoch, old, ", state resynced" if resync else "")
        if 0 <= old < len(self.entries):
            de = self.entries[old]
            self.peers.evict(de.connect_host, de.port)
        self._queue_leader_sync(dead_rank=old, inc=old_inc)
        # Resume coordination: the deposed leader's allocations fail
        # over under this leadership (promote + re-replicate), through
        # the same coordinator a rank-0 master always ran.
        try:
            self._failover.node_dead(old)
        except Exception as e:  # noqa: BLE001 — leadership must survive
            # a partially unreachable cluster; repair retries via the
            # detector's ongoing verdicts
            printd("daemon %d: post-election failover for rank %d "
                   "failed: %s", self.rank, old, e)

    def handoff_leadership(self) -> int:
        """Voluntary transfer (the clean-LEAVE path rank 0 never had):
        push the final state synchronously inside the handoff frame —
        the successor refuses a CRC-failing copy, and then this daemon
        simply remains leader — and demote only once the successor
        confirmed. Returns the new leader's rank."""
        if not self.is_leader:
            raise OcmError(f"rank {self.rank} is not the leader")
        det_dead = self.detector.dead_ranks() if self.detector else set()
        succ = min(
            (e.rank for e in self.entries
             if e.rank != self.rank and e.port
             and e.rank not in det_dead
             and not self.entries.has_left(e.rank)),
            default=None,
        )
        if succ is None:
            raise OcmError("no live member to hand leadership to")
        with self._elect_lock:
            epoch = self.bump_epoch()
            with self._state_lock:
                self._state_seq += 1
                seq = self._state_seq
            doc = control_leader.build_state(self, seq, leader=succ)
            doc["epoch"] = epoch
            raw = control_leader.pack_state(doc)
        se = self.entries[succ]
        self.peers.request(
            se.connect_host, se.port,
            Message(
                MsgType.LEADER_HANDOFF,
                {"leader": succ, "epoch": epoch,
                 "from_rank": self.rank, "inc": self.incarnation},
                raw,
            ),
        )
        self.leader_rank = succ
        self.leader_epoch = epoch
        self.ldr_counters["handoffs"] += 1
        obs_journal.record(
            "leader_handoff", track=self.tracer.track,
            src=self.rank, target=succ, epoch=epoch,
        )
        printd("daemon %d: leadership handed off to rank %d (epoch %d)",
               self.rank, succ, epoch)
        return succ

    def _on_leader_handoff(self, msg: Message) -> Message:
        """Successor side of a voluntary transfer: verify + adopt the
        final state (a torn tail REFUSES the handoff — the old leader
        keeps leading), then announce."""
        f = msg.fields
        if f["leader"] != self.rank:
            raise OcmInvalidHandle(
                f"handoff names rank {f['leader']}, this is {self.rank}"
            )
        doc = control_leader.unpack_state(msg.data)  # raises on corruption
        control_leader.apply_state(self, doc)
        self._adopt_epoch(f["epoch"])
        with self._elect_lock:
            self.leader_rank = self.rank
            self.leader_epoch = f["epoch"]
            self.ldr_counters["handoffs"] += 1
        obs_journal.record(
            "leader_handoff", track=self.tracer.track,
            src=f["from_rank"], target=self.rank, epoch=f["epoch"],
        )
        printd("daemon %d: leadership ADOPTED from rank %d (epoch %d)",
               self.rank, f["from_rank"], f["epoch"])
        self._queue_leader_sync(dead_rank=-1, inc=0)
        return Message(MsgType.LEADER_OK, {"epoch": self.epoch})

    def _queue_leader_sync(self, dead_rank: int, inc: int) -> None:
        """(Re)arm the LEADER_UPDATE broadcast toward every live member
        and push once inline; the reaper retries stragglers (the
        _member_unsynced pattern)."""
        with self._leader_sync_lock:
            self._leader_update_fields = {
                "leader": self.leader_rank,
                "epoch": self.epoch,
                "dead_rank": dead_rank,
                "inc": inc,
            }
            self._leader_unsynced = {
                e.rank for e in self.entries
                if e.rank != self.rank and e.port
                and not self.entries.has_left(e.rank)
            }
        self._sync_leader_update()

    def _sync_leader_update(self) -> None:
        with self._leader_sync_lock:
            fields = self._leader_update_fields
            pending = sorted(self._leader_unsynced)
        if fields is None:
            return
        dead_rank = fields["dead_rank"]
        for r in pending:
            if self.entries.has_left(r):
                with self._leader_sync_lock:
                    self._leader_unsynced.discard(r)
                continue
            # The deposed leader gets the broadcast best-effort exactly
            # once (it fences itself on receipt, or later via the PING
            # STALE_EPOCH sentinel); other dead ranks are skipped.
            if r != dead_rank and self._believed_dead(r):
                with self._leader_sync_lock:
                    self._leader_unsynced.discard(r)
                continue
            e = self.entries[r]
            try:
                self.peers.request(
                    e.connect_host, e.port,
                    Message(MsgType.LEADER_UPDATE, dict(fields)),
                )
                with self._leader_sync_lock:
                    self._leader_unsynced.discard(r)
            except (OSError, OcmError):
                if r == dead_rank:
                    # One best-effort attempt only — a genuinely dead
                    # leader would pin the retry set forever.
                    with self._leader_sync_lock:
                        self._leader_unsynced.discard(r)

    def _on_leader_update(self, msg: Message) -> Message:
        """Adopt an election/handoff broadcast. The deposed leader —
        matched by (rank, incarnation), exactly the failover layer's owner-fencing
        discipline — fences itself; everyone else re-aims master-bound
        traffic at the new leader and EAGERLY drops pooled connections
        to the dead one (the detector's evict discipline)."""
        f = msg.fields
        self._adopt_epoch(f["epoch"])
        dr = f["dead_rank"]
        if dr == self.rank:
            if f["inc"] in (0, self.incarnation):
                self._fence(f["epoch"])
                return Message(MsgType.LEADER_OK, {"epoch": self.epoch})
        lr = f["leader"]
        if 0 <= lr < len(self.entries):
            prev = self.leader_rank
            self.leader_rank = lr
            self.leader_epoch = max(self.leader_epoch, f["epoch"])
            if prev != lr and lr != self.rank:
                self.ldr_counters["elections_observed"] += 1
        if dr >= 0 and dr != self.rank and dr < len(self.entries):
            if self.detector is not None:
                self.detector.mark_dead(dr)
            self.policy.mark_dead(dr)
            de = self.entries[dr]
            self.peers.evict(de.connect_host, de.port)
        return Message(MsgType.LEADER_OK, {"epoch": self.epoch})

    def _queue_note_alloc(self, kind: OcmKind, rank: int,
                          nbytes: int) -> None:
        """Hash placement's accounting leg: applied locally when this
        daemon leads, queued for the reaper otherwise — the alloc path
        itself never waits on the leader."""
        note = Message(
            MsgType.NOTE_ALLOC,
            {"kind": WIRE_KIND[kind.value], "rank": rank,
             "device_index": 0, "nbytes": nbytes},
        )
        if self.is_leader:
            self._on_note_alloc(note)
        else:
            with self._acct_lock:
                self._acct_pending.append(note)

    def _drain_accounting(self) -> None:
        """Reaper: flush queued NOTE_ALLOCs to the current leader.
        Unreachable leader ⇒ requeue whole (the books are advisory —
        capacity placement degrades gracefully, and a resync rebuilds
        them from live numbers anyway)."""
        with self._acct_lock:
            pending, self._acct_pending = self._acct_pending, []
        if not pending:
            return
        if self.is_leader:
            for m in pending:
                self._on_note_alloc(m)
            return
        le = self._leader_entry()
        if self._believed_dead(le.rank):
            with self._acct_lock:
                self._acct_pending = pending + self._acct_pending
            return
        for i, m in enumerate(pending):
            try:
                self.peers.request(le.connect_host, le.port, m)
            except (OSError, OcmError):
                with self._acct_lock:
                    self._acct_pending = (
                        pending[i:] + self._acct_pending
                    )
                return

    # -- checkpoint / resume (SURVEY.md §5.4 upgrade) --------------------

    def save_snapshot(self, path: str | None = None) -> None:
        """Persist the registry and the REMOTE_HOST arm's live bytes.

        FROZEN entries are excluded: their payload is already durable in
        the frozen manifest (CRC-trailed extent files), which restore
        re-adopts via ``_adopt_frozen`` — writing them again here would
        double-store every demoted byte and re-couple their durability
        to the snapshot the hard-kill path never writes."""
        from oncilla_tpu_torch.runtime import snapshot as snap

        reg_entries = [e for e in self.registry.snapshot() if not e.frozen]

        def lazy_entries():
            # Arena bytes are read per entry inside the write loop, so peak
            # memory overhead is one entry, not the whole live arena.
            for e in reg_entries:
                data = b""
                if e.kind in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST):
                    data = self.host_arena.read(e.extent, e.nbytes, 0).tobytes()
                yield snap.SnapEntry(
                    alloc_id=e.alloc_id,
                    kind=WIRE_KIND[e.kind.value],
                    device_index=e.device_index,
                    offset=e.extent.offset,
                    nbytes=e.nbytes,
                    origin_rank=e.origin_rank,
                    origin_pid=e.origin_pid,
                    data=data,
                )

        snap.write_file_iter(
            path or self.snapshot_path,
            self.rank, self.registry.counter, len(reg_entries), lazy_entries(),
        )

    def _maybe_restore(self) -> None:
        import os

        from oncilla_tpu_torch.runtime import snapshot as snap

        if not self.snapshot_path or not os.path.exists(self.snapshot_path):
            return
        sp = snap.read_file(self.snapshot_path)
        if sp.rank != self.rank:
            raise OcmError(
                f"snapshot is for rank {sp.rank}, daemon is rank {self.rank}"
            )
        self.registry.restore_counter(sp.id_counter)
        import numpy as np

        for e in sp.entries:
            kind = OcmKind(WIRE_KIND_INV[e.kind])
            if kind in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST):
                ext = self.host_arena.allocator.reserve(e.offset, e.nbytes)
                if e.data:
                    self.host_arena.write(
                        ext, np.frombuffer(e.data, dtype=np.uint8), 0
                    )
            else:
                if not 0 <= e.device_index < len(self.device_books):
                    raise OcmProtocolError(
                        "snapshot device_index out of range for this "
                        f"daemon's ndevices ({e.device_index} >= "
                        f"{len(self.device_books)})"
                    )
                self.device_books[e.device_index].reserve(e.offset, e.nbytes)
            self.registry.insert(
                RegEntry(
                    alloc_id=e.alloc_id,
                    kind=kind,
                    rank=self.rank,
                    device_index=e.device_index,
                    extent=Extent(e.offset, e.nbytes),
                    nbytes=e.nbytes,
                    origin_rank=e.origin_rank,
                    origin_pid=e.origin_pid,
                    lease_expiry=self.registry.new_lease_deadline(),
                )
            )
            # Resync the master's placement accounting.
            note = Message(
                MsgType.NOTE_ALLOC,
                {
                    "kind": e.kind,
                    "rank": self.rank,
                    "device_index": e.device_index,
                    "nbytes": e.nbytes,
                },
            )
            if self.is_leader:
                self._on_note_alloc(note)
            else:
                try:
                    le = self._leader_entry()
                    self.peers.request(le.connect_host, le.port, note)
                except (OSError, OcmConnectError):
                    printd("daemon %d: NOTE_ALLOC to the leader failed",
                           self.rank)
        printd(
            "daemon %d restored %d allocations from snapshot",
            self.rank, len(sp.entries),
        )

    def _adopt_frozen(self) -> None:
        """Warm boot: re-register every surviving frozen extent (fresh
        incarnation, same addr — owner and leader fencing covers the epoch
        side). Runs after ``_maybe_restore`` so a snapshot-known id is
        never double-adopted; a hard kill writes no snapshot at all, so
        this path alone is what upholds the durability contract — every
        acked write demoted to FROZEN before the kill comes back.
        Corrupt entries were already quarantined at store open (counted
        ``lost``, never adopted, never served)."""
        if self._frozen is None:
            return
        adopted = 0
        for key in self._frozen.keys():
            if not key.startswith("alloc-"):
                continue  # serving/prefix extents are app-plane state
            meta = self._frozen.meta(key)
            if meta.get("kind") != "alloc":
                continue
            aid = int(meta["alloc_id"])
            try:
                self.registry.lookup(aid)
                continue
            except OcmInvalidHandle:
                pass
            kind = OcmKind(WIRE_KIND_INV[meta["wire_kind"]])
            self.registry.insert(
                RegEntry(
                    alloc_id=aid,
                    kind=kind,
                    rank=self.rank,
                    device_index=0,
                    extent=Extent(0, 0),
                    nbytes=int(meta["nbytes"]),
                    origin_rank=int(meta["origin_rank"]),
                    origin_pid=int(meta["origin_pid"]),
                    lease_expiry=self.registry.new_lease_deadline(),
                    priority=int(meta.get("priority", 1)),
                    frozen=True,
                )
            )
            # Same max-wins counter resync as the snapshot path: ids
            # minted after the restart must never collide with an
            # adopted one. id = (rank << 32) | (counter << 1).
            self.registry.restore_counter((aid & 0xFFFFFFFF) >> 1)
            alloctrace.note_alloc(
                self._trace_scope, aid, int(meta["nbytes"]), kind.name
            )
            adopted += 1
        self.frz_counters["warm_boot_extents"] = adopted
        if adopted:
            obs_journal.record(
                "warm_boot", track=f"daemon-r{self.rank}", rank=self.rank,
                extents=adopted, lost=len(self._frozen.lost),
                incarnation=self.incarnation,
            )
            printd("daemon %d warm-booted %d frozen extents (%d lost)",
                   self.rank, adopted, len(self._frozen.lost))

    def _on_note_alloc(self, msg: Message) -> Message:
        if self.is_leader:
            f = msg.fields
            self.policy.note_alloc(
                Placement(
                    rank=f["rank"],
                    device_index=f["device_index"],
                    kind=OcmKind(WIRE_KIND_INV[f["kind"]]),
                ),
                f["nbytes"],
            )
        return Message(MsgType.FREE_OK, {"alloc_id": 0})

    def _own_resources(self) -> NodeResources:
        return NodeResources(
            rank=self.rank,
            ndevices=self.ndevices,
            device_arena_bytes=self.config.device_arena_bytes,
            host_arena_bytes=self.config.host_arena_bytes,
        )

    def _notify_leader(self, retries: int = 20) -> None:
        """ADD_NODE to the master (notify_rank0 analogue, main.c:144-160;
        the reference SIGINTs itself if the master is absent, mem.c:466-474 —
        here we retry with backoff). A NOT_MASTER redirect re-aims at the
        leader it names (control/): the seed leader may have moved by
        the time a restarted daemon re-announces."""
        msg = Message(
            MsgType.ADD_NODE,
            {
                "rank": self.rank,
                # Announce a peer-reachable address: the bind host may be the
                # wildcard. Short-form entries fall back to the host column.
                "host": self.entries[self.rank].connect_host,
                "port": self.port,
                "ndevices": self.ndevices,
                "device_arena_bytes": self.config.device_arena_bytes,
                "host_arena_bytes": self.config.host_arena_bytes,
            },
        )
        le = self._leader_entry()
        for i in range(retries):
            try:
                self.peers.request(le.connect_host, le.port, msg)
                return
            except OcmRemoteError as e:
                if e.code == int(ErrCode.NOT_MASTER) and getattr(
                    e, "leader_rank", None
                ) is not None:
                    self._adopt_leader_hint(e)
                    le = self._leader_entry()
                    continue
                raise
            except (OSError, OcmConnectError):
                time.sleep(min(0.05 * 2**i, 2.0))
        raise OcmError(
            f"leader daemon unreachable at {le.connect_host}:{le.port}"
        )

    # -- server loops ----------------------------------------------------

    def _accept_loop(self) -> None:
        while self._running.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
                try:  # stream 8 MiB chunks without window stalls
                    conn.setsockopt(socket.SOL_SOCKET, opt, 4 << 20)
                except OSError:
                    pass
            with self._conns_mu:
                self._conns.add(conn)
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            )
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        """Per-connection handler (inbound_thread analogue, mem.c:319-393).

        ACK coalescing: a DATA_PUT carrying FLAG_MORE is a non-final chunk
        of a burst — it is applied but NOT answered; the first chunk
        without the bit closes the burst and gets ONE reply covering all
        of it (total bytes on success, the burst's first ERROR otherwise).
        Burst state is per-connection local, so concurrent stripes on
        sibling sockets never interact.

        Mux serving (runtime/mux.py): a request carrying FLAG_MUX_TAG has
        a u32 correlation id prefixed to its data tail (stripped FIRST,
        before the trace prefix); its reply carries the same tag back.
        Tagged CONTROL ops are handed to a shared worker pool and may
        complete OUT OF ORDER — one tenant's slow REQ_ALLOC relay no
        longer blocks every other tenant on the shared connection — while
        DATA ops stay inline on this thread (the zero-copy recv-into-
        arena landing and the burst state machine are serve-loop local).
        A per-connection write lock keeps concurrently-sent reply frames
        whole. Untagged traffic is served exactly as before: FIFO, one
        reply per request, byte-identical to the pre-mux protocol.
        """
        # Reusable receive buffer: every inbound bulk payload (DATA_PUT
        # chunks) is fully consumed by its handler before the next recv —
        # the RecvScratch contract. (Tagged control ops handed to the
        # worker pool first detach their payload from the scratch.)
        # Reads are buffered (one kernel recv per ~64 KiB of small
        # frames, not 2-3 per frame) — the small-op serve path is
        # syscall-bound without it; bulk payloads bypass the buffer and
        # keep the recv-into-arena landing.
        scratch = RecvScratch()
        rsock = BufferedSock(conn)
        wlock = make_lock("daemon.conn_wlock")
        cstate = _ConnMuxState()
        # Connection identity for the cancel/ack journal events: tags
        # are per-channel, so the audit invariant scopes them by
        # (daemon track, conn, tag). A plain process-wide counter.
        conn_id = _next_conn_id()
        burst_nbytes = 0        # DATA_PUT_OK bytes accumulated this burst
        burst_err: Message | None = None  # first failure, reported once
        burst_open = False
        burst_t0 = 0.0
        # Reply batching for pipelined tagged traffic: while MORE
        # requests are already buffered (the client streamed a batch),
        # small tagged replies accumulate here and flush as ONE vectored
        # send when the inbound buffer drains — the server-side writev
        # twin of the client's send coalescing. Untagged lockstep flows
        # never batch (one request in hand at a time), so their reply
        # timing is unchanged.
        pending_out: list[bytes] = []

        def flush_replies() -> None:
            if pending_out:
                with wlock:
                    protocol_sendall_vec(conn, pending_out)
                pending_out.clear()

        try:
            while self._running.is_set():
                if pending_out and not rsock.buffered():
                    flush_replies()
                try:
                    msg = recv_msg(rsock, scratch,
                                   data_router=self._route_put_payload)
                except OcmProtocolError as e:
                    # Clean EOF between frames is normal disconnect; any
                    # other decode failure (truncated frame, bad magic,
                    # malformed payload) is hostile/broken input worth a
                    # diagnostic before dropping the connection.
                    if str(e) != "peer closed":
                        printd("daemon %d: dropping conn on malformed "
                               "input: %s", self.rank, e)
                    return
                if self._partitioned:
                    # Chaos isolation: a partitioned host's replies never
                    # arrive — drop the connection mid-exchange so peers
                    # (and probes) see exactly a torn network.
                    return
                # Mux correlation tag: stripped before anything else (it
                # is the OUTERMOST data-tail prefix), remembered so the
                # reply can echo it.
                mux_tag = None
                if msg.flags & FLAG_MUX_TAG:
                    mux_tag, rest = split_tag(msg.data)
                    if mux_tag is not None:
                        msg.data = rest
                        msg.flags &= ~FLAG_MUX_TAG
                        with self._mux_ctr_lock:
                            self._mux_counters["tagged_ops"] += 1
                # Inbound trace context: a FLAG_TRACE_CTX request carries
                # a 16-byte context prefix on its data tail. Strip it
                # BEFORE any length-validating handler sees the payload,
                # and install it around dispatch so this daemon's serve
                # spans (and any hop it forwards) join the client's trace.
                tctx = None
                if msg.flags & FLAG_TRACE_CTX:
                    tctx, rest = obs_trace.split(msg.data)
                    if tctx is not None:
                        msg.data = rest
                        msg.flags &= ~FLAG_TRACE_CTX
                # Propagated time budget (resilience/timebudget.py): a
                # FLAG_DEADLINE request carries its REMAINING budget as
                # a u32-ms prefix (after tag and trace). Re-anchored on
                # THIS host's monotonic clock and installed around
                # dispatch, so expired work is refused typed and every
                # forwarded hop re-attaches the decremented remainder.
                budget = None
                if msg.flags & FLAG_DEADLINE:
                    bud_ms, rest = timebudget.split(msg.data)
                    if bud_ms is not None:
                        msg.data = rest
                        msg.flags &= ~FLAG_DEADLINE
                        budget = timebudget.Budget.from_ms(bud_ms)
                        self.tb_counters["last_budget_ms"] = bud_ms
                is_put = msg.type == MsgType.DATA_PUT
                if burst_open and not is_put:
                    # A sender may not interleave other requests inside an
                    # unfinished burst — the reply stream would desync.
                    burst_nbytes, burst_err, burst_open = 0, None, False
                    self._send_reply(conn, wlock, _err(
                        ErrCode.BAD_MSG,
                        f"{msg.type.name} inside an open DATA_PUT burst",
                    ), mux_tag, conn_id)
                    continue
                if msg.type == MsgType.CANCEL and mux_tag is not None:
                    # Server-side cancellation: served INLINE on the
                    # serve thread (never the pool — a cancel queued
                    # behind the op it revokes would be useless), keyed
                    # by the victim's correlation tag on this same
                    # connection.
                    flush_replies()
                    self._send_reply(
                        conn, wlock,
                        self._cancel_tag(msg.fields["tag"], cstate,
                                         conn_id),
                        mux_tag, conn_id,
                    )
                    continue
                if (
                    mux_tag is not None
                    and not is_put
                    and msg.type != MsgType.DATA_GET
                ):
                    # Out-of-order completion for tagged control ops.
                    if self._serve_tagged_async(conn, wlock, msg, tctx,
                                                mux_tag, cstate, budget,
                                                conn_id):
                        continue
                    # Pool unavailable (daemon stopping): fall through to
                    # the inline path — still correct, just FIFO.
                reply = self._dispatch_guarded(msg, tctx, budget)
                more = is_put and bool(msg.flags & FLAG_MORE)
                if is_put and (more or burst_open):
                    if not burst_open:
                        burst_open, burst_t0 = True, time.perf_counter()
                    if reply.type == MsgType.ERROR:
                        if burst_err is None:
                            burst_err = reply
                    else:
                        burst_nbytes += reply.fields["nbytes"]
                    if more:
                        continue  # reply deferred to the burst's last chunk
                    reply = burst_err or Message(
                        MsgType.DATA_PUT_OK, {"nbytes": burst_nbytes}
                    )
                    if burst_err is None:
                        self.tracer.note_transfer(
                            "put_srv", burst_nbytes,
                            time.perf_counter() - burst_t0, coalesced=True,
                        )
                    burst_nbytes, burst_err, burst_open = 0, None, False
                if (
                    mux_tag is not None
                    and rsock.buffered()
                    and _data_len_of(reply.data) < 4096
                ):
                    obs_journal.record(
                        "mux_reply", track=self.tracer.track,
                        conn=conn_id, tag=mux_tag,
                    )
                    pending_out.append(pack(attach_tag(
                        Message(reply.type, reply.fields, reply.data,
                                reply.flags),
                        mux_tag,
                    )))
                    continue
                flush_replies()
                self._send_reply(conn, wlock, reply, mux_tag, conn_id)
        except OSError:
            pass
        finally:
            with self._conns_mu:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch_guarded(self, msg: Message, tctx,
                          budget: timebudget.Budget | None = None
                          ) -> Message:
        """Dispatch plus the typed-error mapping: every handler failure
        becomes a typed ERROR frame (never a dropped connection). Shared
        by the inline serve loop and the mux worker pool, so the two
        completion paths cannot drift on error semantics.

        ``budget`` is the request's propagated time budget: expired
        work is refused typed BEFORE the handler runs (in particular
        before REQ_ALLOC's quota admission can reserve anything), and
        the budget is ambient during dispatch so forwarded hops carry
        the decremented remainder."""
        if self.serve_delay_s > 0 and msg.type in self.serve_delay_types:
            # Testability hook: the artificially slow daemon the hedge
            # bench and the cancel-storm smoke are built on.
            time.sleep(self.serve_delay_s)
        if budget is not None and budget.expired:
            return self._deadline_err(
                f"{msg.type.name} arrived with its "
                f"{budget.total_ms} ms budget already spent"
            )
        try:
            # OCM_WAITWATCH: the whole dispatch HOLDS the rpc:daemon
            # serve slot, so an outbound dial from a handler shows up
            # as rpc:daemon -> rpc:daemon-adjacent edges — the dynamic
            # twin of the static relay/lock-across-rpc rules.
            with waitwatch.slot(waitwatch.RPC_DAEMON):
                if msg.type in (MsgType.DATA_PUT, MsgType.DATA_GET):
                    op = ("dcn_put_srv" if msg.type == MsgType.DATA_PUT
                          else "dcn_get_srv")
                    with timebudget.use(budget), obs_trace.use_ctx(tctx), \
                            self.tracer.span(
                                op, nbytes=msg.fields["nbytes"]):
                        return self._dispatch(msg)
                elif tctx is not None or budget is not None:
                    # A traced control op gets a serve-side span so the
                    # exported trace shows the daemon hop, not just the
                    # client's view of the round-trip; a budgeted one
                    # keeps its remainder ambient for the hops it
                    # forwards.
                    with timebudget.use(budget), obs_trace.use_ctx(tctx), \
                            self.tracer.span(
                                "srv_" + msg.type.name.lower()):
                        return self._dispatch(msg)
                else:
                    return self._dispatch(msg)
        except OcmDeadlineExceeded as e:
            return self._deadline_err(str(e))
        except OcmOutOfMemory as e:
            return _err(ErrCode.OOM, str(e))
        except OcmQuotaExceeded as e:
            return _err(ErrCode.QUOTA_EXCEEDED, str(e))
        except OcmAdmissionDenied as e:
            return _err(ErrCode.ADMISSION_DENIED, str(e))
        except OcmBusy as e:
            # Retryable back-pressure: the server-suggested backoff
            # rides as a u32 (ms) data tail — invisible to peers that
            # don't know the code.
            return _err(ErrCode.BUSY, str(e),
                        struct.pack("<I", e.retry_after_ms))
        except OcmReplicaUnavailable as e:
            return _err(ErrCode.REPLICA_UNAVAILABLE, str(e))
        except OcmNotPrimary as e:
            return _err(ErrCode.NOT_PRIMARY, str(e))
        except OcmMoved as e:
            # Live-migration redirect: the new owner rank rides as an
            # i64 data tail (invisible to old peers).
            return _err(ErrCode.MOVED, str(e), struct.pack("<q", e.rank))
        except OcmBoundsError as e:
            return _err(ErrCode.BOUNDS, str(e))
        except OcmInvalidHandle as e:
            return _err(ErrCode.BAD_ALLOC_ID, str(e))
        except OcmPlacementError as e:
            return _err(ErrCode.PLACEMENT, str(e))
        except OcmRemoteError as e:
            # A relayed hop's typed rejection (REQ_ALLOC proxied to the
            # leader, DO_FREE to an owner) keeps its code — clients
            # switch on it (BUSY backoff, failover ladder), so
            # flattening to UNKNOWN here would break them one hop out.
            # BUSY re-carries its backoff tail.
            code = (
                ErrCode(e.code)
                if e.code in ErrCode._value2member_map_
                else ErrCode.UNKNOWN
            )
            if code == ErrCode.BUSY:
                tail = struct.pack("<I", getattr(e, "retry_after_ms", 0))
            elif code == ErrCode.MOVED and hasattr(e, "moved_to_rank"):
                # Relayed migration redirects keep their rank tail —
                # the redirect is useless without it.
                tail = struct.pack("<q", e.moved_to_rank)
            else:
                tail = b""
            return _err(code, e.detail, tail)
        except OcmError as e:
            return _err(ErrCode.UNKNOWN, str(e))
        except Exception as e:  # noqa: BLE001 — always answer with a
            # typed ERROR frame rather than killing the connection.
            return _err(ErrCode.UNKNOWN, f"{type(e).__name__}: {e}")

    def _deadline_err(self, detail: str) -> Message:
        """The typed DEADLINE_EXCEEDED rejection + its accounting (one
        place, so the pre-dispatch refusal and the mid-dispatch raise
        cannot drift on counters or journal shape)."""
        self.tb_counters["deadline_exceeded"] += 1
        obs_journal.record(
            "deadline_exceeded", track=self.tracer.track, detail=detail,
        )
        return _err(ErrCode.DEADLINE_EXCEEDED, detail)

    def _send_reply(self, conn: socket.socket, wlock, reply: Message,
                    tag: int | None, conn_id: int = -1) -> None:
        """One reply frame, tag echoed, whole under the connection's
        write lock (the mux pool's out-of-order completions share the
        socket with the serve loop). Tagged replies journal a
        ``mux_reply`` event — the evidence stream the
        no-ack-after-cancel-ack audit invariant walks."""
        if tag is not None:
            obs_journal.record(
                "mux_reply", track=self.tracer.track, conn=conn_id,
                tag=tag,
            )
            reply = attach_tag(
                Message(reply.type, reply.fields, reply.data, reply.flags),
                tag,
            )
        with wlock:
            send_msg(conn, reply)  # ocm-lint: allow[blocking-call-under-lock]
            # — wlock is a leaf serializing exactly this socket's writes.

    def _ensure_mux_pool(self):
        with self._mux_pool_lock:
            if self._mux_pool is None and self._running.is_set():
                from concurrent.futures import ThreadPoolExecutor

                self._mux_pool = ThreadPoolExecutor(
                    max_workers=_MUX_POOL_WORKERS,
                    thread_name_prefix=f"d{self.rank}-mux",
                )
            return self._mux_pool

    def _serve_tagged_async(self, conn, wlock, msg: Message, tctx,
                            tag: int, cstate, budget=None,
                            conn_id: int = -1) -> bool:
        """Queue one tagged control op on the mux worker pool. Returns
        False when the pool cannot take it (daemon stopping) — the
        caller serves inline instead."""
        pool = self._ensure_mux_pool()
        if pool is None:
            return False
        if not isinstance(msg.data, (bytes, bytearray)):
            # Detach from the connection's RecvScratch: the serve loop
            # recvs the NEXT frame while the worker still reads this one.
            msg.data = bytes(msg.data)
        seq = cstate.note_start(tag)
        with self._mux_ctr_lock:
            self._mux_counters["inflight"] += 1
            self._mux_counters["peak_inflight"] = max(
                self._mux_counters["peak_inflight"],
                self._mux_counters["inflight"],
            )
        try:
            pool.submit(
                self._serve_tagged, conn, wlock, msg, tctx, tag, cstate,
                seq, budget, conn_id, time.monotonic(),
            )
        except RuntimeError:  # pool shut down between check and submit
            cstate.note_done(seq)
            cstate.finish_tag(tag)
            with self._mux_ctr_lock:
                self._mux_counters["inflight"] -= 1
            return False
        return True

    def _serve_tagged(self, conn, wlock, msg: Message, tctx, tag: int,
                      cstate, seq: int, budget=None,
                      conn_id: int = -1, t_enq: float = 0.0) -> None:
        # A cancel that landed while this op sat QUEUED revokes it
        # before any side effect: nothing dispatched, nothing reserved,
        # no reply (the client already tombstoned the tag).
        if cstate.take_if_cancelled(tag):
            ooo = cstate.note_done(seq)
            with self._mux_ctr_lock:
                self._mux_counters["inflight"] -= 1
                if ooo:
                    self._mux_counters["ooo"] += 1
            self.tb_counters["cancel_drops"] += 1
            obs_journal.record(
                "cancel_drop", track=self.tracer.track, conn=conn_id,
                tag=tag, stage="queued",
            )
            return
        if t_enq and obs_journal.enabled():
            # Time spent queued behind the bounded mux worker pool. The
            # phase binds to the CLIENT op's wire ctx (tctx): the wait
            # precedes the serve span, so it falls in the client span's
            # self time — exactly where the attributor must charge it.
            obs_journal.phase(
                "daemon_queue", time.monotonic() - t_enq, ctx=tctx,
                track=self.tracer.track,
            )
        try:
            # OCM_WAITWATCH: this thread occupies a bounded mux-pool
            # slot for the dispatch — the resource the static
            # pool-stratification rule strata-checks.
            with waitwatch.slot(waitwatch.MUX_SLOT):
                reply = self._dispatch_guarded(msg, tctx, budget)
        finally:
            ooo = cstate.note_done(seq)
            with self._mux_ctr_lock:
                self._mux_counters["inflight"] -= 1
                if ooo:
                    self._mux_counters["ooo"] += 1
        if not cstate.finish_tag(tag):
            # A binding cancel won the race mid-dispatch: suppress the
            # reply — the cancel-ack already told the client "revoked",
            # so an ack here would be the exact violation the
            # no-ack-after-cancel-ack invariant audits. A completed
            # REQ_ALLOC is unwound through the ordinary free path so
            # the reserve -> commit accounting drains.
            self.tb_counters["cancel_drops"] += 1
            obs_journal.record(
                "cancel_drop", track=self.tracer.track, conn=conn_id,
                tag=tag, stage="completed",
            )
            if reply.type == MsgType.ALLOC_RESULT:
                self.tb_counters["cancel_frees"] += 1
                self._dispatch_guarded(Message(
                    MsgType.REQ_FREE,
                    {"alloc_id": reply.fields["alloc_id"],
                     "rank": reply.fields["rank"]},
                ), None)
            return
        try:
            self._send_reply(conn, wlock, reply, tag, conn_id)
        except OSError:
            pass  # connection died; the serve loop's own path closes it

    def _cancel_tag(self, victim: int, cstate: _ConnMuxState,
                    conn_id: int) -> Message:
        """Serve one CANCEL: revoke the victim tag on this connection's
        worker-pool state and ack with the outcome. The ``cancel_ack``
        journal event (recorded BEFORE the ack leaves) is the anchor of
        the no-ack-after-cancel-ack audit invariant; in-flight DATA
        legs are inline on the serve thread — they drained to their
        chunk boundary before this CANCEL could even be read, which is
        exactly the drain contract."""
        revoked = cstate.cancel(victim)
        self.tb_counters["cancels"] += 1
        if revoked:
            self.tb_counters["cancels_revoked"] += 1
        obs_journal.record(
            "cancel", track=self.tracer.track, conn=conn_id,
            tag=victim, revoked=int(revoked),
        )
        obs_journal.record(
            "cancel_ack", track=self.tracer.track, conn=conn_id,
            tag=victim, revoked=int(revoked),
        )
        return Message(
            MsgType.CANCEL_OK, {"tag": victim, "revoked": int(revoked)}
        )

    def _on_cancel(self, msg: Message) -> Message:
        """CANCEL outside a mux channel (a lockstep or untagged sender):
        with one request in flight per connection there is nothing to
        revoke — answer honestly. The real path is the serve loop's
        inline branch, which owns the connection's tag state."""
        self.tb_counters["cancels"] += 1
        return Message(
            MsgType.CANCEL_OK, {"tag": msg.fields["tag"], "revoked": 0}
        )

    def _mux_meta(self) -> dict:
        """Mux serving counters for STATUS / STATUS_PROM / the obs
        cluster table's in-flight column."""
        with self._mux_ctr_lock:
            return dict(self._mux_counters)

    def _reaper_loop(self) -> None:
        """Reclaim expired leases — the capability the reference left as a
        TODO (main.c:6-7): no heartbeat => allocations freed."""
        while self._running.is_set():
            time.sleep(self.config.heartbeat_s)
            for e in self.registry.expired():
                printd(
                    "daemon %d reaping expired alloc %d (origin pid %d)",
                    self.rank, e.alloc_id, e.origin_pid,
                )
                try:
                    self._do_free_local(e.alloc_id)
                except OcmInvalidHandle:
                    continue
                self.registry.note_reclaim()
                obs_journal.record(
                    "lease_reclaim", track=self.tracer.track,
                    alloc_id=e.alloc_id, nbytes=e.nbytes,
                    origin_pid=e.origin_pid, origin_rank=e.origin_rank,
                )
            # QoS (qos/): pressure eviction under the arena watermarks,
            # stale-tenant pruning, and the load-aware placement feed.
            # Each guarded — a QoS hiccup must never kill the reaper.
            try:
                self._pressure_evict()
                self.qos.prune_stale()
            except Exception as e:  # noqa: BLE001 — see above
                printd("daemon %d: pressure evict failed: %s", self.rank, e)
            try:
                self._feed_load_stats()
            except Exception as e:  # noqa: BLE001 — telemetry feed is
                # best-effort; placement falls back to capacity order
                printd("daemon %d: load feed failed: %s", self.rank, e)
            if self._plane_unsynced:
                self._sync_plane_endpoint()
            if self._member_unsynced:
                try:
                    self._sync_members()
                except Exception as e:  # noqa: BLE001 — gossip must never
                    # kill the reaper; unsynced peers retry next tick
                    printd("daemon %d: member sync failed: %s", self.rank, e)
            # Decentralized control plane (control/): replicate the
            # master state to standbys, retry LEADER_UPDATE stragglers,
            # flush hash placement's deferred accounting. Each guarded —
            # leadership machinery must never kill the reaper.
            try:
                if self.config.standby_masters > 0 and self.is_leader:
                    self._push_master_state()
                if self._leader_unsynced:
                    self._sync_leader_update()
                self._drain_accounting()
            except Exception as e:  # noqa: BLE001 — see above
                printd("daemon %d: leader tick failed: %s", self.rank, e)
            self._prune_tombstones()
            try:
                self._detector_tick()
            except Exception as e:  # noqa: BLE001 — liveness must never
                # kill the reaper thread (leases matter more than probes)
                printd("daemon %d: detector tick failed: %s", self.rank, e)

    # -- multi-tenant QoS (qos/) -----------------------------------------

    def _pressure_evict(self) -> None:
        """Priority eviction under arena pressure (Borg-style tiers):
        when host occupancy crosses the high watermark, free extents in
        victim order — expired first, then priority ascending, oldest
        lease first — until occupancy falls below the LOW watermark
        (hysteresis) or victims run out. The invariant this PRESERVES:
        an ACTIVE (lease-current) extent above priority 0 is never
        evicted; only the low class is preemptible while alive. Runs on
        the owner, and only over entries this rank is primary for (the
        chain free fans out), so replica copies never fork."""
        cap = self.config.host_arena_bytes
        if cap <= 0:
            return
        live = self.host_arena.allocator.bytes_live
        if live / cap < self.config.arena_high_pct / 100.0:
            return
        low_bytes = cap * self.config.arena_low_pct / 100.0
        now = time.monotonic()
        for e in self.registry.eviction_candidates(self.rank, now):
            if self.host_arena.allocator.bytes_live <= low_bytes:
                break
            active = e.lease_expiry >= now
            if active and e.priority > PRIO_LOW:
                # Victim queue is sorted, but the guard stays explicit:
                # the invariant must hold even if the ordering changes.
                continue
            # Demote-to-FROZEN leg (persist/): with a frozen store
            # attached, a victim spills to disk instead of being
            # destroyed — same victim order, same invariant, but the
            # payload survives and the first client data op thaws it
            # back. Replicated entries keep the destroy path (a frozen
            # primary under a live chain would fork ownership), as does
            # anything mid-migration. A full/unwritable store falls
            # through to the pre-FROZEN destroy.
            if (self._frozen is not None and not e.chain
                    and not e.migrating
                    and self._demote_to_frozen(e, active)):
                continue
            try:
                self._do_free_local(e.alloc_id)
            except OcmInvalidHandle:
                continue  # raced with an explicit free
            except (OSError, OcmError) as exc:
                printd("daemon %d: eviction of %d failed: %s",
                       self.rank, e.alloc_id, exc)
                continue
            self.qos.note_eviction(e.priority, active)
            self.registry.note_reclaim()
            obs_journal.record(
                "qos_evict", track=self.tracer.track,
                alloc_id=e.alloc_id, priority=e.priority, active=active,
                nbytes=e.nbytes, origin_pid=e.origin_pid,
                destroyed=True,
            )
            printd(
                "daemon %d evicted alloc %d under pressure "
                "(priority %d, %s, %d B)",
                self.rank, e.alloc_id, e.priority,
                "active" if active else "expired", e.nbytes,
            )

    def _demote_to_frozen(self, e, active: bool) -> bool:
        """Spill one eviction victim's bytes to the frozen store and
        release its arena extent, keeping the registry entry (marked
        ``frozen``) so the id stays valid and leases keep renewing.
        Returns False — caller destroys as before — when the store
        refuses (budget) or the write fails; the entry is untouched in
        that case (the write is atomic, tmp+replace)."""
        with self._frz_lock:
            if e.frozen:
                return True  # raced with another demote
            try:
                data = self.host_arena.read(e.extent, e.nbytes, 0).tobytes()
                self._frozen.write(
                    f"alloc-{e.alloc_id}", data,
                    meta={
                        "kind": "alloc",
                        "alloc_id": e.alloc_id,
                        "wire_kind": WIRE_KIND[e.kind.value],
                        "nbytes": e.nbytes,
                        "origin_rank": e.origin_rank,
                        "origin_pid": e.origin_pid,
                        "priority": e.priority,
                    },
                )
            except (OSError, OcmError) as exc:
                printd("daemon %d: demote of %d to frozen declined: %s",
                       self.rank, e.alloc_id, exc)
                return False
            self.host_arena.free(e.extent)
            e.extent = Extent(0, 0)
            e.frozen = True
        self.frz_counters["demotes"] += 1
        self.qos.note_demotion(e.priority, active)
        obs_journal.record(
            "tier_demote", track=self.tracer.track,
            alloc_id=e.alloc_id, priority=e.priority, active=active,
            nbytes=e.nbytes, origin_pid=e.origin_pid,
            dst="frozen", destroyed=False,
        )
        printd(
            "daemon %d demoted alloc %d to FROZEN under pressure "
            "(priority %d, %s, %d B)",
            self.rank, e.alloc_id, e.priority,
            "active" if active else "expired", e.nbytes,
        )
        return True

    def _thaw(self, e, _retried: bool = False) -> None:
        """Promote a frozen entry back into the host arena (the first
        client data op's page-fault). Rides the existing data-plane
        handlers — a FROZEN extent is just a slow read at its owner, so
        clients need zero new wire surface. On an arena-full fault the
        pressure evictor runs once OUTSIDE ``_frz_lock`` (its free
        fan-out may dial peers; it may demote OTHER victims to make
        room) and the thaw retries once; a corrupt frozen file surfaces
        as the typed OcmFrozenCorrupt, never as garbage bytes."""
        import numpy as np

        with self._frz_lock:
            if not e.frozen:
                return  # raced with another thaw
            data = self._frozen.read_bytes(f"alloc-{e.alloc_id}")
            try:
                extent = self.host_arena.alloc(e.nbytes)
            except OcmOutOfMemory:
                if _retried:
                    raise
                extent = None
            if extent is not None:
                self.host_arena.write(
                    extent, np.frombuffer(data, dtype=np.uint8), 0
                )
                e.extent = extent
                e.frozen = False
                self._frozen.delete(f"alloc-{e.alloc_id}")
        if extent is None:
            self._pressure_evict()
            self._thaw(e, _retried=True)
            return
        self.frz_counters["promotes"] += 1
        obs_journal.record(
            "tier_promote", track=self.tracer.track,
            alloc_id=e.alloc_id, priority=e.priority,
            nbytes=e.nbytes, origin_pid=e.origin_pid, src="frozen",
        )

    def _feed_load_stats(self) -> None:
        """Rank-0, policy="loadaware" only: refresh the placement
        policy's per-rank load scores from each daemon's live stats —
        its own locally, peers via the same STATUS the obs CLI polls."""
        observe = getattr(self.policy, "observe", None)
        if not self.is_leader or observe is None:
            return
        now = time.monotonic()
        if now - self._last_load_poll < self.config.loadaware_poll_s:
            return
        self._last_load_poll = now
        observe(
            self.rank,
            live_bytes=self.host_arena.allocator.bytes_live,
            **self._own_load_sample(),
        )
        for e in self.entries:
            if e.rank == self.rank or e.port == 0:
                continue
            if self._believed_dead(e.rank):
                continue
            try:
                r = self.peers.request(
                    e.connect_host, e.port, Message(MsgType.STATUS, {})
                )
            except (OSError, OcmError):
                continue  # detector owns liveness; skip this round
            gbps, p99 = 0.0, 0.0
            if r.data:
                import json

                try:
                    tail = json.loads(bytes(r.data))
                except (ValueError, UnicodeDecodeError):
                    tail = {}
                ops = (tail.get("dcn") or {}).get("ops") or {}
                p99 = max(
                    (v.get("p99_us", 0.0) for v in ops.values()),
                    default=0.0,
                )
                transfers = (tail.get("dcn") or {}).get("transfers") or []
                if transfers:
                    gbps = transfers[-1].get("gbps", 0.0)
            observe(
                e.rank,
                live_bytes=r.fields.get("host_bytes_live", 0),
                gbps=gbps, p99_us=p99,
            )

    def _own_load_sample(self) -> dict:
        ops = {
            k: v for k, v in self.tracer.snapshot().items()
            if k.startswith("dcn_")
        }
        transfers = self.tracer.transfers(last=1)
        return {
            "gbps": transfers[-1].get("gbps", 0.0) if transfers else 0.0,
            "p99_us": max(
                (v.get("p99_us", 0.0) for v in ops.values()), default=0.0
            ),
        }

    # -- failure detection (resilience/detector.py) ----------------------

    def _probe_ranks(self) -> list[int]:
        """Star topology + one neighbor: the LEADER probes everyone (it
        is the arbiter); every other rank probes the leader plus its
        next neighbor, so each non-master is watched by a second witness
        whose SUSPECT report gives the leader an early arbitration
        trigger. Total probe load stays O(n) per interval.

        Election evidence (control/): once a standby believes the
        leader dead it additionally probes every SMALLER live rank —
        the election rule is lowest-live-rank, so a waiting standby
        must be able to discover that the would-be winner is dead too,
        or the election would stall on a rank nobody was watching."""
        det = self.detector
        allowed = set(det.probe_targets())
        lr = self.leader_rank
        if self.rank == lr:
            return sorted(allowed)
        n = len(self.entries)
        targets = {lr}
        r = (self.rank + 1) % n
        while r in (self.rank, lr):
            r = (r + 1) % n
            if r == self.rank:  # 2-node cluster: the leader is the only peer
                break
        if r not in (self.rank, lr):
            targets.add(r)
        if self.config.standby_masters > 0 and self._believed_dead(lr):
            targets.update(
                e.rank for e in self.entries
                if e.rank < self.rank and e.rank != lr and e.port
                and not self.entries.has_left(e.rank)
            )
        return sorted(t for t in targets if t in allowed)

    def _detector_tick(self) -> None:
        det = self.detector
        if det is None or self._fenced or not self._running.is_set():
            return
        now = time.monotonic()
        if now - self._last_probe < self.config.detect_interval_s:
            return
        self._last_probe = now
        for r in self._probe_ranks():
            e = self.entries[r]
            if e.port == 0:
                continue  # ephemeral-port test daemon not started yet
            res = (
                None if self._partitioned  # chaos isolation: packets drop
                else probe(
                    e.connect_host, e.port, self.rank, self.epoch,
                    self.incarnation,
                    timeout=self.config.probe_timeout_s,
                )
            )
            if not self._running.is_set():
                return
            if isinstance(res, DeadVerdict):
                # The peer says WE were declared dead. Binding only when
                # its authority outranks ours — a deposed leader's stale
                # claim (lower leader_epoch) is ignored, while the real
                # leader's verdict fences a healed partitioned daemon.
                if res.outranks(self.leader_epoch, self.epoch):
                    self._fence(self.epoch)
                    return
                continue  # deluded claimant: neither alive nor dead news
            if res is not None:
                self._adopt_epoch(res[0])
                prev = det.record_ok(r, res[1])
                if prev == PeerState.DEAD:
                    obs_journal.record(
                        "node_recovered", track=self.tracer.track, rank=r,
                    )
                    if self.is_leader:
                        self.policy.mark_alive(r)
                continue
            st = det.record_fail(r)
            if st == PeerState.DEAD:
                # Evict pooled connections NOW: stale sockets to a dead
                # rank otherwise fail lazily, one costly error per lease.
                self.peers.evict(e.connect_host, e.port)
            if st == PeerState.SUSPECT and not self.is_leader:
                le = self._leader_entry()
                try:
                    self.peers.request(
                        le.connect_host, le.port,
                        Message(MsgType.SUSPECT_NODE,
                                {"rank": r, "reporter": self.rank,
                                 "epoch": self.epoch}),
                    )
                except (OSError, OcmError):
                    printd("daemon %d: SUSPECT report for %d failed",
                           self.rank, r)
            elif st == PeerState.DEAD and self.is_leader:
                self._failover.node_dead(r)
        # Election check (control/): a standby whose detector holds the
        # LEADER dead runs the lowest-live-rank rule each tick until a
        # LEADER_UPDATE lands or it wins.
        if (
            self.config.standby_masters > 0
            and not self.is_leader
            and not self._fenced
            and self._believed_dead(self.leader_rank)
        ):
            self._maybe_elect()

    # -- trace-aware peer forwarding -------------------------------------

    def _peer_caps_for(self, host: str, port: int) -> int:
        """Negotiated capability bits for the daemon at (host, port),
        probed once per address with a CONNECT offering FLAG_CAP_TRACE
        and FLAG_CAP_QOS (one probe covers both relay concerns: trace
        prefixes and priority tails). Un-upgraded v2 peers and the
        native C++ daemon echo flags=0 — decline by silence — and this
        daemon then ships plain frames to them. Probe failures are NOT
        cached (the peer may simply be restarting); the forwarded
        request itself will surface the real error."""
        key = (host, port)
        with self._peer_caps_lock:
            caps = self._peer_caps.get(key)
        if caps is not None:
            return caps
        import os as _os

        offer = FLAG_CAP_TRACE | FLAG_CAP_QOS | FLAG_CAP_DEADLINE
        try:
            r = self.peers.request(host, port, Message(
                MsgType.CONNECT,
                {"pid": _os.getpid(), "rank": self.rank},
                flags=offer,
            ))
            caps = (
                r.flags & offer
                if r.type == MsgType.CONNECT_CONFIRM else 0
            )
        except (OSError, OcmError):
            return 0
        with self._peer_caps_lock:
            self._peer_caps[key] = caps
        return caps

    def _peer_request(self, host: str, port: int, msg: Message) -> Message:
        """peers.request plus trace/budget propagation: when a trace
        context is ambient (this request relays a traced serve) and the
        peer granted FLAG_CAP_TRACE, the context rides the forwarded
        message — the hop that stitches client span → local daemon span
        → peer daemon span. When a time budget is ambient (this serve
        arrived with FLAG_DEADLINE) the REMAINING budget rides too —
        decremented by this hop's observed elapsed time, since the
        remainder is computed at send time — and an already-expired
        budget refuses the relay outright instead of burning a round
        trip on work the origin has given up on. Attaches to a shallow
        copy: relay loops reuse one Message for several peers."""
        valid = VALID_FLAGS.get(msg.type, 0)
        # Budget FIRST (it is the innermost prefix: receivers strip tag,
        # then trace, then deadline), trace second, so the wire layout
        # matches the strip order.
        bud = timebudget.current()
        timeout: float | None = None
        if bud is not None and valid & FLAG_DEADLINE:
            if bud.expired:
                raise OcmDeadlineExceeded(
                    f"relay of {msg.type.name} to {host}:{port}: "
                    f"{bud.total_ms} ms budget exhausted before the hop"
                )
            # The remainder bounds the WHOLE exchange, not just the wire
            # attach: without it a relay against a SIGSTOPped peer sat
            # in a blocked recv until the pool's transport default,
            # long past the origin's deadline (the deadline bug class the
            # unbounded-blocking analysis now gates).
            # Floor of 1 ms: remaining_s() can hit 0.0 in the race
            # window after the expired check, and settimeout(0) would
            # flip the socket non-blocking instead of timing out.
            timeout = max(bud.remaining_s(), 0.001)
            if self._peer_caps_for(host, port) & FLAG_CAP_DEADLINE:
                msg = timebudget.attach(
                    Message(msg.type, msg.fields, msg.data, msg.flags),
                    bud, FLAG_DEADLINE,
                )
        ctx = obs_trace.current()
        if (
            ctx is not None
            and valid & FLAG_TRACE_CTX
            and self._peer_caps_for(host, port) & FLAG_CAP_TRACE
        ):
            msg = obs_trace.attach(
                Message(msg.type, msg.fields, msg.data, msg.flags),
                ctx, FLAG_TRACE_CTX,
            )
        if timeout is not None:
            return self.peers.request(host, port, msg, timeout=timeout)
        # No ambient budget => no deadline to thread; the pool's
        # transport default bounds the exchange. Kept as a separate
        # call (not timeout=None) so test seams that wrap
        # peers.request with a (host, port, msg) signature keep
        # working on un-budgeted paths.
        return self.peers.request(host, port, msg)  # ocm-lint: allow[unbounded-blocking]

    # -- dispatch --------------------------------------------------------

    def _dispatch(self, msg: Message) -> Message:
        if self.handler_delay_s > 0 and msg.type in self.handler_delay_types:
            time.sleep(self.handler_delay_s)
        if self._fenced and msg.type in _FENCED_REJECT:
            # A fenced daemon outlived its own DEAD verdict: its replicas
            # were promoted under a newer epoch, so serving data or
            # granting extents here would be split-brain. Clients treat
            # STALE_EPOCH as a failover signal and retry the chain.
            return _err(
                ErrCode.STALE_EPOCH,
                f"rank {self.rank} fenced at epoch {self.epoch}",
            )
        h = _HANDLERS.get(msg.type)
        if h is None:
            return _err(ErrCode.BAD_MSG, f"unhandled message {msg.type.name}")
        return h(self, msg)

    # CONNECT: app attach (process_msg MSG_CONNECT analogue, main.c:58-103).
    def _on_connect(self, msg: Message) -> Message:
        printd("daemon %d: app pid %d connected", self.rank, msg.fields["pid"])
        # QoS profile declaration (qos/): a FLAG_CAP_QOS offer may carry
        # the app's (priority, quota_bytes, quota_handles) as a
        # FLAG_QOS_TAIL data tail. Registered BEFORE the echo so the
        # app's very first REQ_ALLOC already runs under its profile.
        if msg.flags & FLAG_CAP_QOS and msg.flags & FLAG_QOS_TAIL:
            prof = unpack_profile(msg.data)
            if prof is not None:
                self.qos.register(
                    msg.fields["pid"], msg.fields["rank"], *prof
                )
        # Capability negotiation: grant exactly the offered bits we
        # implement. Peers that never offer (old clients, the C++ daemon's
        # own dials) get flags=0 and the lockstep protocol unchanged.
        # FLAG_CAP_MUX (tagged request multiplexing) is granted unless
        # OCM_MUX_SERVE=0 pins this daemon to the un-upgraded behavior
        # (the interop tests' decline-by-silence lever).
        reply = Message(
            MsgType.CONNECT_CONFIRM,
            {
                "rank": self.rank,
                "nnodes": self.policy.nnodes if self.is_leader
                else len(self.entries),
            },
            flags=msg.flags
            & (FLAG_CAP_COALESCE | FLAG_CAP_TRACE | FLAG_CAP_REPLICA
               | FLAG_CAP_QOS | FLAG_CAP_DEADLINE
               | (FLAG_CAP_MUX if self.config.mux_serve else 0)),
        )
        if reply.flags & FLAG_CAP_MUX:
            with self._mux_ctr_lock:
                self._mux_counters["conns"] += 1
        # Fabric negotiation (fabric/): an offered FLAG_CAP_FABRIC is
        # granted only when this daemon actually registered a fabric —
        # the grant carries the descriptor tail the client needs to
        # prove reachability (attach the segment). Un-offered CONNECTs
        # ship the reply unchanged, so the default wire stays
        # byte-for-byte pre-fabric.
        if msg.flags & FLAG_CAP_FABRIC:
            desc = {n: f.descriptor() for n, f in self.fabrics.items()}
            if desc:
                import json

                reply.flags |= FLAG_CAP_FABRIC
                reply.data = json.dumps(
                    desc, separators=(",", ":")
                ).encode()
                self.fabric_counters["selected_shm"] += 1
            else:
                self.fabric_counters["selected_tcp"] += 1
        return reply

    def _on_disconnect(self, msg: Message) -> Message:
        """Immediate reclamation on app disconnect instead of waiting out the
        lease (the reference daemon tracks connected apps and frees on
        disconnect, main.c:46-47,58-103). The app reports which owner ranks
        hold its remote allocations ("owners", tracked app-side where the
        handles live), so the fan-out is O(owners); a crashed app never sends
        DISCONNECT and falls back to the lease reaper."""
        pid = msg.fields["pid"]
        # Terminal event for the app's lease-renewal chain: the auditor
        # requires every renewing app to end in disconnect/free/reclaim.
        obs_journal.record(
            "app_disconnect", track=self.tracer.track, pid=pid,
        )
        self._reclaim_app_local(pid, self.rank)
        # The tenant's whole QoS state goes with it — quota give-back for
        # remote-owned allocations the origin ledger still remembered.
        self.qos.drop_app(pid, self.rank)
        for r in _parse_owners(msg.fields.get("owners", "")):
            if r == self.rank or not 0 <= r < len(self.entries):
                continue
            e = self.entries[r]
            try:
                self._peer_request(
                    e.connect_host, e.port,
                    Message(MsgType.RECLAIM_APP,
                            {"pid": pid, "rank": self.rank}),
                )
            except (OSError, OcmError):
                printd("daemon %d: RECLAIM_APP to %d failed (lease reaper "
                       "is the backstop)", self.rank, r)
        return Message(MsgType.CONNECT_CONFIRM, {"rank": self.rank, "nnodes": 0})

    def _on_reclaim_app(self, msg: Message) -> Message:
        n = self._reclaim_app_local(msg.fields["pid"], msg.fields["rank"])
        return Message(MsgType.RECLAIM_APP_OK, {"count": n})

    def _reclaim_app_local(self, origin_pid: int, origin_rank: int) -> int:
        n = 0
        for e in self.registry.for_app(origin_pid, origin_rank):
            printd("daemon %d reclaiming alloc %d of disconnected app %d",
                   self.rank, e.alloc_id, origin_pid)
            try:
                self._do_free_local(e.alloc_id)
                n += 1
            except OcmInvalidHandle:  # raced with an explicit free
                pass
        return n

    # ADD_NODE: only the master records membership (alloc_add_node,
    # alloc.c:60-74).
    def _on_add_node(self, msg: Message) -> Message:
        if not self.is_leader:
            return self._not_master_err("ADD_NODE")
        f = msg.fields
        self.policy.add_node(
            NodeResources(
                rank=f["rank"],
                ndevices=f["ndevices"],
                device_arena_bytes=f["device_arena_bytes"],
                host_arena_bytes=f["host_arena_bytes"],
            )
        )
        # A (re)joining daemon is a fresh process: clear any DEAD verdict
        # (revival happens HERE, never via pings — see _on_ping).
        if self.detector is not None:
            self.detector.mark_alive(f["rank"])
        # Record the peer's address for forwarding. A nodefile-provided
        # connect address wins over the announced hostname (the announcement
        # carries the daemon's bind host, which may not be routable).
        if 0 <= f["rank"] < len(self.entries):
            prev = self.entries[f["rank"]]
            self.entries[f["rank"]] = NodeEntry(
                f["rank"], f["host"], f["port"], prev.addr
            )
        # A (re)joining daemon starts with no in-memory plane endpoint:
        # queue it for the reaper's gossip so relays work there promptly
        # (the client's periodic re-registration is the slower backstop).
        # Same bounds guard as the entries update above: an out-of-range
        # rank would IndexError inside the reaper and kill it.
        if self.plane_addr is not None and 0 <= f["rank"] < len(self.entries):
            with self._plane_sync_lock:
                self._plane_unsynced.add(f["rank"])
        return Message(MsgType.ADD_NODE_OK, {"nnodes": self.policy.nnodes})

    # REQ_ALLOC: non-masters proxy the request to rank 0 (the placement leg,
    # mem.c:128); rank 0 places (alloc_find analogue) then drives the
    # DO_ALLOC leg to the owner and returns the complete handle
    # (msg_send_req_alloc analogue, mem.c:234-260). QoS (qos/) wraps the
    # whole path: size validation first, then quota admission at the
    # app's ORIGIN daemon (the one that holds its profile), then the
    # rank-0 back-pressure check inside _place_alloc.
    def _on_req_alloc(self, msg: Message) -> Message:
        f = msg.fields
        nbytes = f["nbytes"]
        kind = OcmKind(WIRE_KIND_INV[f["kind"]])
        # Daemon-side size validation: a zero-byte request has no valid
        # extent (it previously surfaced as an untyped ValueError deep in
        # the owner's arena), and a request above every node's arena can
        # NEVER be sited — reject both up front, reserving nothing.
        if nbytes <= 0:
            raise OcmPlacementError(
                f"invalid allocation size {nbytes}: must be > 0"
            )
        if self.is_leader:
            cap = self.policy.max_capacity(kind)
            if cap and nbytes > cap:
                raise OcmOutOfMemory(
                    f"{nbytes} B of {kind.value} exceeds every node's "
                    f"arena capacity (largest is {cap} B)"
                )
        app = (f["pid"], f["orig_rank"])
        local_app = f["orig_rank"] == self.rank
        if local_app:
            # Admission: reserve against the app's quota (raises typed
            # QUOTA_EXCEEDED / ADMISSION_DENIED); committed to the alloc
            # id on success, rolled back on any downstream failure.
            self.qos.admit(app[0], app[1], nbytes)
        try:
            if (
                self.config.placement == "hash"
                and kind in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST)
            ):
                # Consistent-hash plan shape (control/hashring): the
                # placement is computed HERE, at the app's origin — no
                # leader round trip on the alloc path at all.
                r = self._hash_alloc(msg, kind, nbytes)
            elif not self.is_leader:
                r = self._proxy_alloc_to_leader(msg, local_app, app)
            else:
                r = self._place_alloc(msg, kind, nbytes)
        except BaseException:
            if local_app:
                self.qos.abort(app[0], app[1], nbytes)
            raise
        if local_app:
            self.qos.commit(app[0], app[1], r.fields["alloc_id"], nbytes)
        return r

    def _proxy_alloc_to_leader(self, msg: Message, local_app: bool,
                               app: tuple[int, int]) -> Message:
        """Forward REQ_ALLOC to the current leader. With leadership
        transfer armed, retryable failures — a dead leader mid-election,
        a fenced old leader's STALE_EPOCH, a NOT_MASTER redirect — are
        re-walked against the (possibly updated) leader until
        failover_wait_s elapses, so in-flight allocs converge through a
        leader change instead of surfacing the election window to the
        app. Unarmed clusters keep the single-shot pre-leadership behavior."""
        deadline = time.monotonic() + (
            self.config.failover_wait_s
            if self.config.standby_masters > 0 else 0.0
        )
        last: BaseException | None = None
        while True:
            le = self._leader_entry()
            fwd = self._with_priority_tail(
                msg,
                self.qos.priority_of(*app) if local_app else None,
                le.connect_host, le.port,
            )
            try:
                return self._peer_request(le.connect_host, le.port, fwd)
            except OcmRemoteError as e:
                if e.code == int(ErrCode.NOT_MASTER) and getattr(
                    e, "leader_rank", None
                ) is not None:
                    self._adopt_leader_hint(e)
                    last = e
                elif e.code == int(ErrCode.STALE_EPOCH):
                    last = e  # fenced old leader: wait out the election
                else:
                    raise
            except (OSError, OcmConnectError) as e:
                last = e
            if time.monotonic() >= deadline:
                raise last
            time.sleep(0.05)  # let the election/LEADER_UPDATE land

    def _hash_live_ranks(self) -> list[int]:
        return sorted(
            e.rank for e in self.entries
            if e.port
            and not self.entries.has_left(e.rank)
            and not self._believed_dead(e.rank)
        )

    def _hash_alloc(self, msg: Message, kind: OcmKind,
                    nbytes: int) -> Message:
        """Origin-local placement by rendezvous hashing: mint the id
        from THIS daemon's globally-unique space, compute the chain over
        the live view, provision via DO_REPLICA (idempotent chain
        upsert — the same provisioning contract the leader uses), and
        defer the leader's capacity accounting to the reaper. A primary
        whose provision fails on transport (a just-died rank the
        detector hasn't verdicted yet) is barred and the plan recomputed
        over the shrunken set; the journaled ``hash_place`` records the
        member set actually used, which is exactly what the auditor's
        ``placement-agreement`` invariant recomputes against."""
        import json

        f = msg.fields
        data = bytes(msg.data)
        off = 0
        k = 1
        if msg.flags & FLAG_REPLICAS and len(data) > off:
            k = max(1, min(data[off], 8))
            off += 1
        if msg.flags & FLAG_QOS_TAIL and len(data) > off:
            prio = min(max(data[off], PRIO_LOW), PRIO_HIGH)
        elif f["orig_rank"] == self.rank:
            prio = self.qos.priority_of(f["pid"], f["orig_rank"])
        else:
            prio = PRIO_NORMAL
        alloc_id = self.registry.next_id()
        barred: set[int] = set()
        last: BaseException | None = None
        busy_hint = -1  # max retry hint seen; >= 0 once any rank was BUSY
        live = self._hash_live_ranks()
        for _ in range(max(1, len(live))):
            cands = [r for r in live if r not in barred]
            if not cands:
                break
            chain = hashring.plan(alloc_id, cands, k)
            try:
                confirmed, offset0 = self._provision_chain(
                    alloc_id, chain, kind, nbytes,
                    f["orig_rank"], f["pid"], prio,
                )
            except (OSError, OcmError) as e:
                # Primary unreachable OR past its watermark (typed BUSY
                # from the owner-side check, _on_do_replica): bar it and
                # re-plan over the rest — the leader path's "place on
                # the least-loaded rank below high" becomes "spill to a
                # rank that still admits". Only when EVERY candidate is
                # busy does the origin surface BUSY (below), with the
                # largest suggested backoff seen.
                hint = _busy_hint_of(e)
                if hint is not None:
                    busy_hint = max(busy_hint, hint)
                barred.add(chain[0])
                last = e
                continue
            obs_journal.record(
                "hash_place", track=self.tracer.track,
                alloc_id=alloc_id, epoch=self.entries.epoch,
                live=list(cands), k=k, chain=list(chain),
            )
            self.ldr_counters["hash_placements"] += 1
            for rr in confirmed:
                self._queue_note_alloc(kind, rr, nbytes)
            owner = self.entries[chain[0]]
            tail = (
                json.dumps({"replicas": confirmed[1:]}).encode()
                if len(confirmed) > 1 else b""
            )
            return Message(
                MsgType.ALLOC_RESULT,
                {
                    "alloc_id": alloc_id,
                    "rank": chain[0],
                    "device_index": 0,
                    "kind": WIRE_KIND[kind.value],
                    "offset": offset0,
                    "nbytes": nbytes,
                    "owner_host": owner.connect_host,
                    "owner_port": owner.port,
                },
                tail,
            )
        if busy_hint >= 0:
            # Hash-mode back-pressure (ROADMAP item 2 remaining): every
            # live rank is past the high watermark — the retryable BUSY
            # the leader path would have raised, now enforced at the
            # origin from the owners' own arena accounting. The reaper's
            # pressure eviction is busy making room; clients absorb this
            # with the standard jittered backoff.
            self.qos.note_busy()
            obs_journal.record(
                "backpressure_busy", track=self.tracer.track,
                nbytes=nbytes, pid=f["pid"], orig_rank=f["orig_rank"],
                origin="hash",
            )
            raise OcmBusy(
                f"every live rank past the high watermark "
                f"({self.config.arena_high_pct}%): retry later",
                retry_after_ms=busy_hint or self.config.busy_backoff_ms,
            )
        raise OcmPlacementError(
            f"hash placement found no reachable primary among "
            f"{live} (last: {last})"
        )

    def _provision_chain(
        self, alloc_id: int, chain: tuple[int, ...], kind: OcmKind,
        nbytes: int, orig_rank: int, pid: int, prio: int,
    ) -> tuple[list[int], int]:
        """Provision one owner chain under a pre-minted id: DO_REPLICA
        to each member, primary first. The primary must succeed (its
        failure raises and nothing is charged); a replica that fails
        just shrinks the chain (degraded, journaled), and confirmed
        members are re-sent the corrected chain so every holder agrees
        on the promotion order. Shared by the leader's replicated-alloc
        path and the origin-local hash path — one provisioning contract.
        Returns (confirmed members, primary extent offset)."""
        csv = ",".join(str(r) for r in chain)
        qflags, qtail = _priority_tail(prio)
        confirmed: list[int] = []
        offset0 = 0
        for rr in chain:
            m = Message(
                MsgType.DO_REPLICA,
                {
                    "alloc_id": alloc_id,
                    "kind": WIRE_KIND[kind.value],
                    "nbytes": nbytes,
                    "orig_rank": orig_rank,
                    "pid": pid,
                    "chain": csv,
                    "epoch": self.epoch,
                },
                qtail,
                flags=qflags,
            )
            try:
                if rr == self.rank:
                    r = self._on_do_replica(m)
                else:
                    e = self.entries[rr]
                    r = self._peer_request(e.connect_host, e.port, m)
            except (OSError, OcmError):
                if rr == chain[0]:
                    raise  # no primary, no allocation
                obs_journal.record(
                    "replica_provision_fail", track=self.tracer.track,
                    alloc_id=alloc_id, rank=rr,
                )
                printd("daemon %d: replica provision on rank %d failed",
                       self.rank, rr)
                continue
            if rr == chain[0]:
                offset0 = r.fields["offset"]
            confirmed.append(rr)
        if len(confirmed) < len(chain):
            fixed = ",".join(str(r) for r in confirmed)
            m2_fields = {
                "alloc_id": alloc_id,
                "kind": WIRE_KIND[kind.value],
                "nbytes": nbytes,
                "orig_rank": orig_rank,
                "pid": pid,
                "chain": fixed,
                "epoch": self.epoch,
            }
            for rr in confirmed:
                try:
                    if rr == self.rank:
                        self._on_do_replica(
                            Message(MsgType.DO_REPLICA, dict(m2_fields))
                        )
                    else:
                        e = self.entries[rr]
                        self._peer_request(
                            e.connect_host, e.port,
                            Message(MsgType.DO_REPLICA, dict(m2_fields)),
                        )
                except (OSError, OcmError):
                    printd("daemon %d: chain fixup on rank %d failed",
                           self.rank, rr)
        return confirmed, offset0

    def _with_priority_tail(
        self, msg: Message, priority: int | None, host: str, port: int
    ) -> Message:
        """Append the FLAG_QOS_TAIL priority u8 to a forwarded
        REQ_ALLOC — only for a non-default class, and only when the peer
        granted FLAG_CAP_QOS (default-priority traffic ships unchanged
        frames, preserving wire byte-identity and skipping the
        capability probe entirely)."""
        if (
            priority is None
            or priority == PRIO_NORMAL
            or not self._peer_caps_for(host, port) & FLAG_CAP_QOS
        ):
            return msg
        return Message(
            msg.type, msg.fields,
            bytes(msg.data) + bytes([priority]),
            msg.flags | FLAG_QOS_TAIL,
        )

    def _place_alloc(self, msg: Message, kind: OcmKind,
                     nbytes: int) -> Message:
        """Leader placement: parse the optional tails, run back-pressure,
        site the allocation, drive the DO_ALLOC/DO_REPLICA leg(s)."""
        f = msg.fields
        # Pinned by the hash-placement acceptance test: with
        # OCM_PLACEMENT=hash no REQ_ALLOC is ever placed here.
        self.ldr_counters["placements"] += 1
        # Data-tail layout after the generic trace strip:
        # [k u8 if FLAG_REPLICAS] [priority u8 if FLAG_QOS_TAIL].
        data = bytes(msg.data)
        off = 0
        k = 1
        if msg.flags & FLAG_REPLICAS and len(data) > off:
            if kind in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST):
                k = max(1, min(data[off], 8))
            off += 1
        if msg.flags & FLAG_QOS_TAIL and len(data) > off:
            prio = min(max(data[off], PRIO_LOW), PRIO_HIGH)
        elif f["orig_rank"] == self.rank:
            prio = self.qos.priority_of(f["pid"], f["orig_rank"])
        else:
            prio = PRIO_NORMAL
        # Back-pressure (host kinds): when even the least-loaded alive
        # rank is past the high watermark, answer retryable BUSY with a
        # suggested backoff instead of packing arenas to the brim — the
        # reaper's pressure eviction is busy making room. High-priority
        # apps bypass it (their work is what the room is being made for).
        if (
            kind in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST)
            and prio < PRIO_HIGH
        ):
            high = self.config.arena_high_pct / 100.0
            occ = self.policy.min_host_occupancy()
            if occ is not None and occ >= high:
                self.qos.note_busy()
                obs_journal.record(
                    "backpressure_busy", track=self.tracer.track,
                    occupancy=round(occ, 4), nbytes=nbytes,
                    pid=f["pid"], orig_rank=f["orig_rank"],
                )
                raise OcmBusy(
                    f"host arenas at {occ:.0%} (high watermark "
                    f"{self.config.arena_high_pct}%): retry later",
                    retry_after_ms=suggest_backoff_ms(
                        occ, high, self.config.busy_backoff_ms
                    ),
                )
        placed = self.policy.place(f["orig_rank"], kind, nbytes, replicas=k)
        if placed.replica_ranks:
            return self._alloc_replicated(f, placed, nbytes, priority=prio)
        owner = self.entries[placed.rank]
        if placed.rank == self.rank:
            alloc_id, offset = self._do_alloc_local(
                placed.kind, placed.device_index, nbytes, f["orig_rank"],
                f["pid"], priority=prio,
            )
        else:
            leg = Message(
                MsgType.DO_ALLOC,
                {
                    "orig_rank": f["orig_rank"],
                    "pid": f["pid"],
                    "kind": WIRE_KIND[placed.kind.value],
                    "device_index": placed.device_index,
                    "nbytes": nbytes,
                },
            )
            leg = self._with_priority_tail(
                leg, prio, owner.connect_host, owner.port
            )
            r = self._peer_request(owner.connect_host, owner.port, leg)
            alloc_id, offset = r.fields["alloc_id"], r.fields["offset"]
        self.policy.note_alloc(placed, nbytes)
        return Message(
            MsgType.ALLOC_RESULT,
            {
                "alloc_id": alloc_id,
                "rank": placed.rank,
                "device_index": placed.device_index,
                "kind": WIRE_KIND[placed.kind.value],
                "offset": offset,
                "nbytes": nbytes,
                "owner_host": owner.connect_host,
                "owner_port": owner.port,
            },
        )

    def _alloc_replicated(self, f: dict, placed, nbytes: int,
                          priority: int = PRIO_NORMAL) -> Message:
        """Provision a k-way replicated allocation (leader path): one
        alloc_id minted HERE (every daemon's id space is globally
        unique, so every chain member can register the same id), then
        the shared chain-provisioning contract (_provision_chain):
        primary must succeed, failed replicas shrink the chain, and the
        corrected chain is re-pushed so every holder agrees on the
        promotion order. Non-default priority rides every leg
        (FLAG_QOS_TAIL u8) so a promoted replica inherits the class —
        eviction discipline must survive failover."""
        import json

        chain = (placed.rank, *placed.replica_ranks)
        alloc_id = self.registry.next_id()
        confirmed, offset0 = self._provision_chain(
            alloc_id, chain, placed.kind, nbytes,
            f["orig_rank"], f["pid"], priority,
        )
        for rr in confirmed:
            self.policy.note_alloc(
                Placement(rank=rr, device_index=0, kind=placed.kind), nbytes
            )
        owner = self.entries[placed.rank]
        return Message(
            MsgType.ALLOC_RESULT,
            {
                "alloc_id": alloc_id,
                "rank": placed.rank,
                "device_index": placed.device_index,
                "kind": WIRE_KIND[placed.kind.value],
                "offset": offset0,
                "nbytes": nbytes,
                "owner_host": owner.connect_host,
                "owner_port": owner.port,
            },
            # Replica ranks ride as a JSON data tail: old clients parse
            # the fixed fields and ignore trailing data, so the reply
            # stays v2-compatible.
            json.dumps({"replicas": confirmed[1:]}).encode(),
        )

    def _on_do_replica(self, msg: Message) -> Message:
        """Provision (or chain-update) one member of a replica chain.
        Idempotent upsert: an existing entry just adopts the new chain —
        how degraded-chain fixups and re-replication chain extensions
        reach surviving holders."""
        f = msg.fields
        self._adopt_epoch(f["epoch"])
        kind = OcmKind(WIRE_KIND_INV[f["kind"]])
        if kind not in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST):
            raise OcmInvalidHandle("only host-kind allocations replicate")
        chain = tuple(_parse_owners(f["chain"]))
        try:
            existing = self.registry.lookup(f["alloc_id"])
        except OcmInvalidHandle:
            existing = None
        if existing is not None:
            self.registry.set_chain(f["alloc_id"], chain, f["epoch"])
            return Message(
                MsgType.DO_REPLICA_OK,
                {"alloc_id": f["alloc_id"],
                 "offset": existing.extent.offset},
            )
        prio = PRIO_NORMAL
        if msg.flags & FLAG_QOS_TAIL and len(msg.data) >= 1:
            prio = min(max(bytes(msg.data[:1])[0], PRIO_LOW), PRIO_HIGH)
        # Hash-mode back-pressure: with OCM_PLACEMENT=hash there is no
        # leader on the alloc path to run the watermark check, so the
        # OWNER enforces it on every fresh provision from its own arena
        # book — the one ledger that is exactly synced by construction.
        # High-priority traffic bypasses, as on the leader path; the
        # origin (_hash_alloc) spills to another rank or surfaces BUSY.
        if self.config.placement == "hash" and prio < PRIO_HIGH:
            self._check_arena_watermark(f["nbytes"])
        extent = self.host_arena.alloc(f["nbytes"])
        self.registry.insert(
            RegEntry(
                alloc_id=f["alloc_id"],
                kind=kind,
                rank=self.rank,
                device_index=0,
                extent=extent,
                nbytes=f["nbytes"],
                origin_rank=f["orig_rank"],
                origin_pid=f["pid"],
                lease_expiry=self.registry.new_lease_deadline(),
                chain=chain,
                epoch=f["epoch"],
                priority=prio,
            )
        )
        alloctrace.note_alloc(
            self._trace_scope, f["alloc_id"], f["nbytes"], kind.name
        )
        return Message(
            MsgType.DO_REPLICA_OK,
            {"alloc_id": f["alloc_id"], "offset": extent.offset},
        )

    # DO_ALLOC on the owner: reserve BEFORE replying (race fix).
    def _on_do_alloc(self, msg: Message) -> Message:
        f = msg.fields
        kind = OcmKind(WIRE_KIND_INV[f["kind"]])
        prio = PRIO_NORMAL
        if msg.flags & FLAG_QOS_TAIL and len(msg.data) >= 1:
            prio = min(max(bytes(msg.data[:1])[0], PRIO_LOW), PRIO_HIGH)
        alloc_id, offset = self._do_alloc_local(
            kind, f["device_index"], f["nbytes"], f["orig_rank"], f["pid"],
            priority=prio,
        )
        return Message(MsgType.DO_ALLOC_OK, {"alloc_id": alloc_id, "offset": offset})

    def _check_arena_watermark(self, nbytes: int) -> None:
        """Owner-side BUSY watermark (hash placement): refuse a fresh
        host-kind provision once this arena crossed the high watermark,
        with the same suggested-backoff tail the leader path ships. The
        reaper's pressure eviction brings occupancy back below low."""
        cap = self.config.host_arena_bytes
        if cap <= 0:
            return
        high = self.config.arena_high_pct / 100.0
        occ = self.host_arena.allocator.bytes_live / cap
        if occ >= high:
            raise OcmBusy(
                f"rank {self.rank} host arena at {occ:.0%} (high "
                f"watermark {self.config.arena_high_pct}%): retry later",
                retry_after_ms=suggest_backoff_ms(
                    occ, high, self.config.busy_backoff_ms
                ),
            )

    def _do_alloc_local(
        self, kind: OcmKind, device_index: int, nbytes: int, orig_rank: int,
        origin_pid: int = 0, priority: int = PRIO_NORMAL,
    ) -> tuple[int, int]:
        """alloc_ate analogue (alloc.c:151-222): reserve the extent in the
        owner's arena and register the allocation."""
        if kind in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST):
            extent = self.host_arena.alloc(nbytes)
            device_index = 0
        else:
            if not 0 <= device_index < self.ndevices:
                raise OcmInvalidHandle(f"bad device_index {device_index}")
            extent = self.device_books[device_index].alloc(nbytes)
        alloc_id = self.registry.next_id()
        self.registry.insert(
            RegEntry(
                alloc_id=alloc_id,
                kind=kind,
                rank=self.rank,
                device_index=device_index,
                extent=extent,
                nbytes=nbytes,
                origin_rank=orig_rank,
                origin_pid=origin_pid,
                lease_expiry=self.registry.new_lease_deadline(),
                priority=priority,
            )
        )
        alloctrace.note_alloc(self._trace_scope, alloc_id, nbytes, kind.name)
        return alloc_id, extent.offset

    # REQ_FREE from an app: forward to the owner (msg_send_req_free
    # analogue, mem.c:265-295) and fix the rank-0 accounting the reference
    # stubbed (mem.c:221-229).
    def _on_req_free(self, msg: Message) -> Message:
        f = msg.fields
        owner_rank = f["rank"]
        if not 0 <= owner_rank < len(self.entries):
            raise OcmInvalidHandle(f"bad owner rank {owner_rank}")
        if owner_rank == self.rank:
            self._do_free_local(f["alloc_id"])
        else:
            owner = self.entries[owner_rank]
            try:
                self._peer_request(
                    owner.connect_host, owner.port,
                    Message(MsgType.DO_FREE, {"alloc_id": f["alloc_id"]}),
                )
            except (OSError, OcmConnectError):
                # Owner unreachable mid-failover: answer RETRYABLE so
                # the client's free ladder can re-aim at a promoted
                # replica (a generic UNKNOWN here left clients of a
                # killed owner unable to release replicated handles).
                return _err(
                    ErrCode.REPLICA_UNAVAILABLE,
                    f"owner rank {owner_rank} unreachable for free of "
                    f"alloc {f['alloc_id']} (retry a replica)",
                )
        # Quota give-back at the ORIGIN daemon (idempotent: the local-
        # owner branch already released through _do_free_local).
        self.qos.release(f["alloc_id"])
        return Message(MsgType.FREE_OK, {"alloc_id": f["alloc_id"]})

    def _on_do_free(self, msg: Message) -> Message:
        self._do_free_local(msg.fields["alloc_id"])
        return Message(MsgType.FREE_OK, {"alloc_id": msg.fields["alloc_id"]})

    def _do_free_local(self, alloc_id: int) -> None:
        """dealloc_ate analogue (alloc.c:231-282)."""
        try:
            e = self.registry.remove(alloc_id)
        except OcmInvalidHandle:
            # Live-migrated away (elastic/): forward the free to the new
            # owner so a client whose handle never repointed can still
            # release — and give the ORIGIN quota back here, since the
            # migration deliberately kept it reserved.
            with self._moved_lock:
                rec = self._moved.pop(alloc_id, None)
            if rec is None:
                raise
            target = rec[0]
            if 0 <= target < len(self.entries):
                pe = self.entries[target]
                try:
                    # Not an amplification loop: the tombstone was popped
                    # from _moved above, so a bounced DO_FREE can take
                    # this branch at most once per migration record —
                    # the re-send drains state instead of regenerating it.
                    self._peer_request(
                        pe.connect_host, pe.port,
                        Message(MsgType.DO_FREE, {"alloc_id": alloc_id}),  # ocm-lint: allow[relay-cycle]
                    )
                except (OSError, OcmError):
                    printd("daemon %d: forwarded free of migrated alloc "
                           "%d to rank %d failed (lease reaper is the "
                           "backstop)", self.rank, alloc_id, target)
            self.qos.release(alloc_id)
            return
        if e.frozen:
            # The payload lives on disk, not in the arena: freeing the
            # entry deletes its frozen file (idempotent) — the one
            # legitimate way a frozen extent's bytes are destroyed.
            if self._frozen is not None:
                self._frozen.delete(f"alloc-{e.alloc_id}")
        elif e.kind in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST):
            self.host_arena.free(e.extent)
        else:
            # Scrub-at-free for device extents, BEFORE the offset returns
            # to the book (no tenant can reuse a dirty extent): the device
            # twin of the host arms' free-time scrub, done at O(1) wire
            # cost by the plane controller. Skipped unless this daemon
            # knows a plane endpoint or has relayed a device write (a
            # purely bookkeeping workload would otherwise pay a wasted
            # master round trip per free); plane-owning clients also
            # scrub at alloc, covering the sync window.
            if self.plane_addr is not None or self._device_writes_relayed:
                try:
                    self._forward_to_plane(Message(
                        MsgType.PLANE_SCRUB,
                        {
                            "alloc_id": e.alloc_id,
                            "rank": self.rank,
                            "device_index": e.device_index,
                            "ext_offset": e.extent.offset,
                            "ext_nbytes": e.nbytes,
                        },
                    ))
                except (OSError, OcmError):
                    pass
            self.device_books[e.device_index].free(e.extent)
        alloctrace.note_free(self._trace_scope, alloc_id)
        obs_journal.record(
            "free_local", track=self.tracer.track, alloc_id=alloc_id,
            nbytes=e.nbytes, origin_pid=e.origin_pid,
            origin_rank=e.origin_rank, migrating=bool(e.migrating),
        )
        if e.migrating:
            # Dropping a quarantined migration copy (stream abort): its
            # bytes were never counted at rank 0 and the tenant's quota
            # still covers the SOURCE copy — no accounting to move.
            return
        # Quota give-back when this daemon is ALSO the app's origin (the
        # reaper/eviction/reclaim paths funnel here); no-op otherwise.
        self.qos.release(alloc_id)
        # Primary of a replica chain: free the replicas too (best-effort —
        # an unreachable replica's copy falls to its own lease reaper,
        # since leases stop renewing once the app's handle is gone).
        for rr in e.replica_ranks(self.rank):
            if not 0 <= rr < len(self.entries):
                continue
            pe = self.entries[rr]
            try:
                # State-bounded, not cyclic: registry.remove() succeeded
                # above, so a replica bouncing DO_FREE back finds no
                # entry here (OcmInvalidHandle with no _moved tombstone)
                # and the chain dies after one hop.
                self._peer_request(
                    pe.connect_host, pe.port,
                    Message(MsgType.DO_FREE, {"alloc_id": e.alloc_id}),  # ocm-lint: allow[relay-cycle]
                )
            except (OSError, OcmError):
                printd("daemon %d: replica free of %d on rank %d failed "
                       "(lease reaper is the backstop)",
                       self.rank, e.alloc_id, rr)
        self._note_free_leader(e)

    def _note_free_leader(self, e: RegEntry) -> None:
        note = Message(
            MsgType.NOTE_FREE,
            {
                "kind": WIRE_KIND[e.kind.value],
                "rank": e.rank,
                "device_index": e.device_index,
                "nbytes": e.nbytes,
            },
        )
        if self.is_leader:
            self._on_note_free(note)
        else:
            le = self._leader_entry()
            try:
                self._peer_request(le.connect_host, le.port, note)
            except (OSError, OcmConnectError):
                printd("daemon %d: NOTE_FREE to the leader failed",
                       self.rank)

    def _on_note_free(self, msg: Message) -> Message:
        if self.is_leader:
            f = msg.fields
            self.policy.note_free(
                Placement(
                    rank=f["rank"],
                    device_index=f["device_index"],
                    kind=OcmKind(WIRE_KIND_INV[f["kind"]]),
                ),
                f["nbytes"],
            )
        return Message(MsgType.FREE_OK, {"alloc_id": 0})

    # -- DCN data plane: one-sided put/get into the daemon's host arena ---

    def _route_put_payload(self, msg: Message, n_data: int):
        """recv_msg data router: land a DATA_PUT payload DIRECTLY in the
        destination arena extent — the recv IS the write (no scratch hop,
        no numpy copy; on this path the daemon does zero per-byte work
        beyond the kernel's socket copy). Only a chunk that fully
        validates routes; anything questionable returns None and takes
        the copy path, where the handler raises the typed error.

        TOCTOU note: a concurrent free could recycle the extent between
        this lookup and the recv completing. The window is the same class
        the copy path already has (lookup, then write) — only wider by
        the recv — and reachable only by an app freeing or abandoning an
        allocation while actively writing it; the handler revalidates
        after the recv and answers BAD_ALLOC_ID so such a writer cannot
        treat the landing as durable."""
        f = msg.fields
        if msg.type != MsgType.DATA_PUT or n_data != f["nbytes"]:
            return None
        try:
            e = self.registry.lookup(f["alloc_id"])
            if e.kind not in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST):
                return None  # device relay needs the payload as a message
            if e.frozen:
                return None  # no arena extent yet; the handler thaws
            if (
                not e.is_primary(self.rank) or e.migrating
            ) and not msg.flags & FLAG_FANOUT:
                # Replica holder or quarantined migration copy, client
                # write: the handler may have to REJECT this (role
                # discipline) — the payload must not land in the extent
                # before that decision.
                return None
            check_bounds(
                Extent(e.extent.offset, e.nbytes), f["offset"], f["nbytes"]
            )
        except OcmError:
            return None
        view = memoryview(self.host_arena.view(e.extent))
        return view[f["offset"]:f["offset"] + n_data]

    def _believed_dead(self, rank: int) -> bool:
        """Does THIS daemon consider ``rank`` dead (its own detector
        verdict, or rank 0's broadcast adopted via mark_dead)? With
        detection disabled there is no verdict and nothing is dead."""
        return (
            self.detector is not None
            and self.detector.state(rank) == PeerState.DEAD
        )

    def _check_data_role(self, e: RegEntry, msg: Message) -> None:
        """Replica-chain role discipline for client data ops: a replica
        holder serves a CLIENT op only once it believes the primary dead
        (acting primary, pending promotion); before that, accepting a
        client write would fork the copies and a read could return bytes
        the primary has already superseded. Primary-originated fan-out
        legs (FLAG_FANOUT) always land."""
        if msg.flags & FLAG_FANOUT:
            return
        if e.migrating:
            # Quarantined migration copy (elastic/): only the source's
            # stream and mirror writes may land until the flip — serving
            # a client from half-streamed bytes would break exactness.
            raise OcmNotPrimary(
                f"rank {self.rank} holds an in-flight migration copy of "
                f"alloc {e.alloc_id}; retry"
            )
        if e.is_primary(self.rank):
            return
        if msg.type == MsgType.DATA_GET:
            # Replica holders SERVE client reads (hedged replica reads,
            # Tail-at-Scale): every acked write already landed on the
            # whole chain before its ack (the pre-ack fan-out), so a
            # replica read is exactly as fresh as the client's acked
            # state — reads cannot fork copies, only writes can, and
            # those keep the NOT_PRIMARY discipline below.
            return
        primary = e.chain[0]
        if not self._believed_dead(primary):
            raise OcmNotPrimary(
                f"rank {self.rank} holds a replica of alloc {e.alloc_id}; "
                f"primary rank {primary} is not known dead"
            )

    def _on_data_put(self, msg: Message) -> Message:
        f = msg.fields
        e = self._lookup_serving(f["alloc_id"])
        if e.kind not in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST):
            return self._relay_device_op(msg, e)
        self._check_data_role(e, msg)
        if e.frozen:
            self._thaw(e)
        if len(msg.data) != f["nbytes"]:
            raise OcmProtocolError("DATA_PUT length mismatch")
        check_bounds(Extent(e.extent.offset, e.nbytes), f["offset"], f["nbytes"])
        if not getattr(msg, "data_landed", False):
            import numpy as np

            self.host_arena.write(
                e.extent, np.frombuffer(msg.data, dtype=np.uint8),
                f["offset"],
            )
        # else: payload already recv'd straight into the arena extent by
        # _route_put_payload (which enforced the same role discipline).
        if not msg.flags & FLAG_FANOUT:
            # Outbound-migration bookkeeping (elastic/), AFTER the local
            # write so a concurrent dirty flush can never stream stale
            # bytes and still clear the marker: record the dirty range
            # for the pre-copy re-stream, or bounce retryably (write
            # landed but UNACKED) once the flip fence is up.
            self._note_migration_write(e.alloc_id, f["offset"], f["nbytes"])
            self._fan_out_put(e, f["offset"], f["nbytes"], msg.data)
            # Client-facing ack (never the fan-out legs themselves): the
            # auditor pairs this against the replica_fanout recorded
            # above — an ack with chain>1 and no prior fan-out is a
            # durability violation.
            obs_journal.record(
                "put_ack", track=self.tracer.track,
                alloc_id=e.alloc_id, offset=f["offset"],
                nbytes=f["nbytes"], chain=len(e.chain),
            )
        return Message(MsgType.DATA_PUT_OK, {"nbytes": f["nbytes"]})

    def _fan_out_put(self, e: RegEntry, offset: int, nbytes: int,
                     data) -> None:
        """Write replication: mirror an applied client DATA_PUT to every
        other chain member BEFORE acking (synchronous — a byte the
        client saw acked is on every live replica, so a promoted replica
        serves it back byte-exact). Chain members the detector holds
        DEAD are skipped (counted; re-replication repairs them). A
        member that is NOT known dead but cannot be reached fails the
        put with retryable REPLICA_UNAVAILABLE after one immediate
        retry: acking a write the chain doesn't hold would silently
        break the durability contract the client asked for. Runs on the
        primary — or on a replica acting as primary once it believes the
        primary dead (the pre-promotion window)."""
        if not e.chain:
            return
        fan0 = time.monotonic() if obs_journal.enabled() else 0.0
        try:
            self._fan_out_legs(e, offset, nbytes, data)
        finally:
            if fan0:
                # Bound to the ambient serve span (dcn_put_srv): the
                # synchronous mirror legs are the dominant slice of a
                # replicated put's server time, and critpath should name
                # them instead of lumping them into "handler".
                obs_journal.phase(
                    "replica_fanout", time.monotonic() - fan0,
                    track=self.tracer.track, chain=len(e.chain),
                )

    def _fan_out_legs(self, e: RegEntry, offset: int, nbytes: int,
                      data) -> None:
        for rr in e.chain:
            if rr == self.rank or not 0 <= rr < len(self.entries):
                continue
            if self._believed_dead(rr):
                self.res_counters["repl_put_skips"] += 1
                continue
            pe = self.entries[rr]
            leg = Message(
                MsgType.DATA_PUT,
                {"alloc_id": e.alloc_id, "offset": offset,
                 "nbytes": nbytes},
                data,
                flags=FLAG_FANOUT,
            )
            err: Exception | None = None
            for _ in range(2):  # one immediate retry (fresh connection)
                try:
                    self.peers.request(pe.connect_host, pe.port, leg)
                    err = None
                    break
                except (OSError, OcmError) as exc:
                    err = exc
            if err is None:
                continue
            self.res_counters["repl_put_errors"] += 1
            obs_journal.record(
                "replica_put_fail", track=self.tracer.track,
                alloc_id=e.alloc_id, rank=rr,
                error=f"{type(err).__name__}: {err}",
            )
            printd("daemon %d: replica put of %d to rank %d failed",
                   self.rank, e.alloc_id, rr)
            raise OcmReplicaUnavailable(
                f"replica rank {rr} unreachable for alloc {e.alloc_id} "
                f"({type(err).__name__}: {err}); retry after the "
                "detector resolves it"
            )
        if len(e.chain) > 1:
            # Every live leg landed (dead members skipped + counted):
            # recorded BEFORE the caller acks, which is exactly the
            # order the audit invariant checks.
            obs_journal.record(
                "replica_fanout", track=self.tracer.track,
                alloc_id=e.alloc_id, offset=offset, nbytes=nbytes,
                legs=sum(1 for rr in e.chain
                         if rr != self.rank and not self._believed_dead(rr)),
                skips=sum(1 for rr in e.chain
                          if rr != self.rank and self._believed_dead(rr)),
            )

    def _on_data_get(self, msg: Message) -> Message:
        f = msg.fields
        e = self._lookup_serving(f["alloc_id"])
        if e.kind not in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST):
            return self._relay_device_op(msg, e)
        self._check_data_role(e, msg)
        if e.frozen:
            # Promotion rides the existing get path: the FROZEN extent
            # is just a slow read at its owner (thaw, then serve).
            self._thaw(e)
        check_bounds(Extent(e.extent.offset, e.nbytes), f["offset"], f["nbytes"])
        # One-copy reply payload: SNAPSHOT the extent bytes at handler
        # time (a live view would keep streaming the arena for the whole
        # TCP send — a reaper-expired lease could recycle the extent
        # mid-send and leak the next tenant's bytes), but skip the old
        # tobytes + frame-concat copies via send_msg's scatter-gather.
        # The snapshot lands in a per-serve-thread REUSABLE buffer: the
        # reply is fully on the wire before this thread recvs the next
        # request, so the buffer is free again by then, and reuse avoids
        # a fresh 16 MiB allocation's page faults per chunk.
        n = f["nbytes"]
        buf = getattr(self._get_buf, "buf", None)
        if buf is None or len(buf) < n or (
            len(buf) > (32 << 20) and n < len(buf) // 4
        ):
            buf = self._get_buf.buf = bytearray(n)
        sink = memoryview(buf)[:n]
        sink[:] = memoryview(self.host_arena.view(e.extent))[
            f["offset"]:f["offset"] + n
        ]
        return Message(MsgType.DATA_GET_OK, {"nbytes": n}, sink)

    # -- shm fabric control plane (fabric/shm.py) -------------------------
    #
    # The data moved by memcpy through the shared arena segment; these
    # legs carry everything that must stay authoritative on the owner:
    # registry lookup, extent identity, bounds, replica role, epoch
    # fencing (all three types are in _FENCED_REJECT) — and the replica
    # fan-out for puts, which rides TCP exactly like a framed put's.

    def _shm_entry(self, msg: Message) -> RegEntry:
        """Shared validation for the shm control legs: the entry must be
        host-kind (device bytes live in the app plane, not this arena),
        honor replica role discipline, and — for PUT/GET — match the
        extent the client's cached mapping used (a freed-and-recycled
        extent answers BAD_ALLOC_ID, so a stale mapping can never be
        blessed) and stay in bounds."""
        f = msg.fields
        # Segment identity first: a restarted daemon on the same
        # host:port serves the SAME alloc_ids (snapshot restore) out of
        # a FRESH segment — acking a client whose memcpy landed in the
        # dead daemon's orphaned mapping would silently lose the bytes.
        # STALE_EPOCH is the failover signal: the client drops its
        # cached fabric and re-negotiates.
        served = self.fabrics.get("shm")
        if served is None or f["seg"] != served.descriptor()["seg"]:
            raise OcmRemoteError(
                int(ErrCode.STALE_EPOCH),
                f"rank {self.rank} does not serve segment {f['seg']!r} "
                "(daemon restarted?) — re-negotiate the fabric",
            )
        e = self._lookup_serving(f["alloc_id"])
        if e.kind not in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST):
            raise OcmInvalidHandle(
                "shm fabric serves host-kind allocations only"
            )
        self._check_data_role(e, msg)
        if e.frozen:
            # The client's memcpy needs a live arena extent; SHM_MAP
            # replies with the thawed offset, so stale-mapping checks
            # below always see the post-thaw extent.
            self._thaw(e)
        if "ext_offset" in f:
            if f["ext_offset"] != e.extent.offset:
                raise OcmInvalidHandle(
                    f"stale fabric mapping for alloc {f['alloc_id']}: "
                    f"mapped extent {f['ext_offset']}, live extent "
                    f"{e.extent.offset} — re-map"
                )
            check_bounds(
                Extent(e.extent.offset, e.nbytes), f["offset"], f["nbytes"]
            )
        return e

    def _on_shm_map(self, msg: Message) -> Message:
        e = self._shm_entry(msg)
        return Message(
            MsgType.SHM_MAP_OK,
            {"alloc_id": e.alloc_id, "ext_offset": e.extent.offset,
             "ext_nbytes": e.nbytes},
        )

    def _on_shm_put(self, msg: Message) -> Message:
        f = msg.fields
        e = self._shm_entry(msg)
        if not msg.flags & FLAG_FANOUT:
            # Same migration bookkeeping as a framed put: the memcpy
            # already landed in the segment (unacked if fenced).
            self._note_migration_write(e.alloc_id, f["offset"], f["nbytes"])
        self.fabric_counters["shm_puts"] += 1
        self.fabric_counters["shm_put_bytes"] += f["nbytes"]
        self.tracer.note_transfer(
            "shm_put_srv", f["nbytes"], 0.0, coalesced=False, fabric="shm",
        )
        # Replica fan-out stays on TCP: mirror the just-landed segment
        # bytes to every live chain member BEFORE acking, the same
        # durability contract as a framed put (a byte the client saw
        # acked is on every live replica). Snapshot the extent window —
        # the client may already be memcpying the next transfer.
        if e.chain and not msg.flags & FLAG_FANOUT:
            view = memoryview(self.host_arena.view(e.extent))
            data = bytes(view[f["offset"]:f["offset"] + f["nbytes"]])
            self._fan_out_put(e, f["offset"], f["nbytes"], data)
        if not msg.flags & FLAG_FANOUT:
            obs_journal.record(
                "put_ack", track=self.tracer.track,
                alloc_id=e.alloc_id, offset=f["offset"],
                nbytes=f["nbytes"], chain=len(e.chain),
            )
        return Message(MsgType.DATA_PUT_OK, {"nbytes": f["nbytes"]})

    def _on_shm_get(self, msg: Message) -> Message:
        f = msg.fields
        self._shm_entry(msg)
        self.fabric_counters["shm_gets"] += 1
        self.fabric_counters["shm_get_bytes"] += f["nbytes"]
        self.tracer.note_transfer(
            "shm_get_srv", f["nbytes"], 0.0, coalesced=False, fabric="shm",
        )
        # The ack IS the reply; the client copies from the segment after.
        return Message(MsgType.DATA_GET_OK, {"nbytes": f["nbytes"]})

    # -- cross-process device plane (PLANE_SERVE / PLANE_PUT / PLANE_GET) --
    #
    # Device bytes live in the SPMD controller's plane arena (the daemon
    # only BOOKS extents), so a plane-less process's device data op is
    # relayed to the controller's registered plane endpoint — the bridge
    # that gives C apps / second processes the full kind taxonomy the
    # reference serves cross-process (alloc.c:151-222).

    def _on_plane_serve(self, msg: Message) -> Message:
        f = msg.fields
        new_addr = (f["host"], f["port"]) if f["port"] else None  # 0=clear
        changed = new_addr != self.plane_addr
        if not changed and f.get("relay", 0):
            # Gossiped copy of what we already hold: nothing to do.
            return Message(MsgType.PLANE_SERVE_OK, {"port": f["port"]})
        self.plane_addr = new_addr
        if changed:
            printd("daemon %d: device plane %s", self.rank,
                   f"registered at {f['host']}:{f['port']}" if new_addr
                   else "deregistered")
        if not f.get("relay", 0):
            # Even an UNCHANGED client re-registration re-arms the gossip:
            # a peer daemon that restarted (losing its in-memory endpoint)
            # re-learns it on the next reaper tick; receivers that already
            # hold the endpoint no-op above, so the steady-state cost is
            # one tiny message per peer per re-registration period.
            # Fresh (de)registration from a local client: every other
            # daemon must learn it too (owner daemons relay device ops
            # there; the master is the fallback hop, so it matters MOST).
            # Push to the master inline — one dial, and a cluster whose
            # master is down is already broken — but defer the rest to
            # the reaper loop: a synchronous broadcast here would stall
            # the registering client ~30 s per unreachable peer.
            with self._plane_sync_lock:
                self._plane_unsynced = {
                    r for r in range(len(self.entries)) if r != self.rank
                }
            if not self.is_leader:
                self._sync_plane_endpoint(only_rank=self.leader_rank)
        return Message(MsgType.PLANE_SERVE_OK, {"port": f["port"]})

    def _sync_plane_endpoint(self, only_rank: int | None = None) -> None:
        """Push the current endpoint state (set or cleared) to peers that
        have not confirmed yet; called from the reaper loop (a one-shot
        best-effort send would strand the cluster if a peer was briefly
        unreachable — then 'no device plane registered' forever)."""
        addr = self.plane_addr
        host, port = addr if addr is not None else ("", 0)
        with self._plane_sync_lock:
            pending = sorted(self._plane_unsynced)
        for r in pending:
            if only_rank is not None and r != only_rank:
                continue
            e = self.entries[r]
            try:
                # relay:1 marks the leg terminal: _on_plane_serve only
                # re-arms its own gossip for relay:0 (client-originated)
                # announcements, so a relayed endpoint cannot re-trigger
                # this sender — one hop, then the type dead-ends.
                self.peers.request(
                    e.connect_host, e.port,
                    Message(MsgType.PLANE_SERVE,  # ocm-lint: allow[relay-cycle]
                            {"host": host, "port": port, "relay": 1}),
                )
                with self._plane_sync_lock:
                    self._plane_unsynced.discard(r)
            except (OSError, OcmError):
                pass  # retried on the next reaper tick

    def _relay_device_op(self, msg: Message, e) -> Message:
        f = msg.fields
        # Owner-side bounds check first: never ship an op the extent
        # cannot satisfy.
        check_bounds(Extent(e.extent.offset, e.nbytes), f["offset"], f["nbytes"])
        if msg.type == MsgType.DATA_PUT and len(msg.data) != f["nbytes"]:
            raise OcmProtocolError("DATA_PUT length mismatch")
        if msg.type == MsgType.DATA_PUT:
            self._device_writes_relayed = True
        relay = Message(
            MsgType.PLANE_PUT if msg.type == MsgType.DATA_PUT
            else MsgType.PLANE_GET,
            {
                "alloc_id": e.alloc_id,
                "rank": self.rank,
                "device_index": e.device_index,
                "ext_offset": e.extent.offset,
                "ext_nbytes": e.nbytes,
                "offset": f["offset"],
                "nbytes": f["nbytes"],
            },
            msg.data,
        )
        return self._forward_to_plane(relay)

    def _forward_to_plane(self, relay: Message) -> Message:
        addr = self.plane_addr
        try:
            if addr is not None:
                try:
                    return self.peers.request(addr[0], addr[1], relay)
                except OcmConnectError:
                    # Nothing listens there anymore (controller crashed
                    # without deregistering). Drop the stale endpoint —
                    # clients re-register live planes periodically — and
                    # fall through to the master hop / typed error.
                    self.plane_addr = None
                    addr = None
            if not self.is_leader:
                le = self._leader_entry()  # master hop: the leader
                # learns endpoints first
                return self.peers.request(le.connect_host, le.port, relay)
        except OcmRemoteError as err:
            return _err(ErrCode(err.code) if err.code in
                        ErrCode._value2member_map_ else ErrCode.UNKNOWN,
                        err.detail)
        raise OcmInvalidHandle(
            "device-kind data needs a registered plane: construct the "
            "controller's ControlPlaneClient with ici_plane= (it serves "
            "the plane automatically)"
        )

    def _on_plane_relay(self, msg: Message) -> Message:
        """Master hop for owner daemons that don't know the endpoint."""
        return self._forward_to_plane(msg)

    # -- resilience protocol (resilience/) -------------------------------

    def _on_ping(self, msg: Message) -> Message:
        """Liveness probe + epoch/incarnation gossip. A sender rank 0's
        detector holds DEAD gets STALE_EPOCH instead of PING_OK: that is
        how a merely-partitioned owner that heals learns it was declared
        dead and fences itself (probe() surfaces the verdict as the
        DeadVerdict sentinel). Revival is only ever via ADD_NODE — a fresh
        daemon process announcing itself."""
        f = msg.fields
        self._adopt_epoch(f["epoch"])
        r = f["rank"]
        det = self.detector
        if det is not None and 0 <= r < len(self.entries) and r != self.rank:
            if det.state(r) == PeerState.DEAD:
                if self.is_leader:
                    # Only the (believed) leader issues probe verdicts,
                    # and the verdict carries its authority: the prober
                    # fences itself only when (leader_epoch, epoch)
                    # outranks its own, so a deposed claimant's stale
                    # verdicts can never fence a survivor (control/).
                    return _err(
                        ErrCode.STALE_EPOCH,
                        f"rank {r} was declared dead at epoch "
                        f"{self.epoch}",
                        struct.pack("<QQ", self.leader_epoch, self.epoch),
                    )
                # Non-leaders hold ADOPTED verdicts with no authority to
                # fence; answer plainly (without resurrecting the rank —
                # revival is the leader's call via ADD_NODE).
            else:
                det.record_ok(r, f["inc"])
        return Message(
            MsgType.PING_OK,
            {"rank": self.rank, "epoch": self.epoch,
             "inc": self.incarnation},
        )

    def _on_suspect(self, msg: Message) -> Message:
        """A peer's SUSPECT report; rank 0 arbitrates with its OWN probe
        so a single partitioned reporter can never take a healthy node
        down. Only the arbiter's consecutive-failure count reaching
        dead_after produces the DEAD verdict."""
        if not self.is_leader:
            return self._not_master_err("SUSPECT_NODE")
        f = msg.fields
        self._adopt_epoch(f["epoch"])
        r = f["rank"]
        det = self.detector
        state = PeerState.ALIVE
        if det is not None and 0 <= r < len(self.entries) and r != self.rank:
            state = det.state(r)
            if state != PeerState.DEAD:
                e = self.entries[r]
                res = probe(
                    e.connect_host, e.port, self.rank, self.epoch,
                    self.incarnation,
                    timeout=self.config.probe_timeout_s,
                )
                if res is not None and not isinstance(res, DeadVerdict):
                    self._adopt_epoch(res[0])
                    det.record_ok(r, res[1])
                    state = PeerState.ALIVE
                else:
                    state = det.record_fail(r)
                    obs_journal.record(
                        "suspect_arbitrated", track=self.tracer.track,
                        rank=r, reporter=f["reporter"], state=state.name,
                    )
                    if state == PeerState.DEAD:
                        self._failover.node_dead(r)
        return Message(
            MsgType.SUSPECT_OK,
            {"epoch": self.epoch, "state": int(state)},
        )

    def _on_epoch_update(self, msg: Message) -> Message:
        """Rank 0's fencing broadcast for a DEAD verdict. The incarnation
        match means the verdict fences exactly the process it was issued
        against: a replacement daemon that rebound the same port carries
        a fresh incarnation and ignores a stale broadcast."""
        f = msg.fields
        self._adopt_epoch(f["epoch"])
        dr = f["dead_rank"]
        if dr == self.rank:
            if f["inc"] in (0, self.incarnation):
                self._fence(f["epoch"])
        elif 0 <= dr < len(self.entries):
            if self.detector is not None:
                self.detector.mark_dead(dr)
            e = self.entries[dr]
            self.peers.evict(e.connect_host, e.port)
        return Message(MsgType.EPOCH_OK, {"epoch": self.epoch})

    def _on_promote(self, msg: Message) -> Message:
        """Reconcile the dead set against local replica chains: promote
        where this rank is the first survivor, and report (JSON tail) the
        allocations this rank is now primary for that lost copies."""
        import json

        f = msg.fields
        self._adopt_epoch(f["epoch"])
        dead = {r for r in _parse_owners(f["dead_ranks"]) if r != self.rank}
        for dr in dead:
            if self.detector is not None:
                self.detector.mark_dead(dr)
            if 0 <= dr < len(self.entries):
                e = self.entries[dr]
                self.peers.evict(e.connect_host, e.port)
        # Quarantined inbound migration copies whose source just died
        # are dropped BEFORE reconciliation — a half-streamed copy must
        # never be promoted into (or repaired onto) a chain.
        self._abort_migrations(dead, f["epoch"])
        promoted, repair = self.registry.reconcile_dead(
            dead, self.rank, f["epoch"]
        )
        self.res_counters["promotions"] += len(promoted)
        for e in promoted:
            obs_journal.record(
                "failover_promote", track=self.tracer.track,
                alloc_id=e.alloc_id, chain=list(e.chain),
                epoch=f["epoch"],
            )
            printd("daemon %d promoted to primary for alloc %d (epoch %d)",
                   self.rank, e.alloc_id, f["epoch"])
        return Message(
            MsgType.PROMOTE_OK,
            {"count": len(promoted)},
            json.dumps(repair).encode() if repair else b"",
        )

    def _on_re_replicate(self, msg: Message) -> Message:
        """Restore a lost copy: provision the target (DO_REPLICA with the
        extended chain), stream this primary's bytes over DATA_PUT, then
        adopt the new chain locally and push it to the surviving
        replicas (DO_REPLICA upsert)."""
        f = msg.fields
        self._adopt_epoch(f["epoch"])
        e = self.registry.lookup(f["alloc_id"])
        if not e.is_primary(self.rank):
            raise OcmInvalidHandle(
                f"rank {self.rank} is not primary for alloc {f['alloc_id']}"
            )
        target = f["target_rank"]
        if (
            not 0 <= target < len(self.entries)
            or target == self.rank
            or target in e.chain
        ):
            raise OcmInvalidHandle(f"bad re-replication target {target}")
        base_chain = e.chain or (self.rank,)
        new_chain = (*base_chain, target)
        csv = ",".join(str(r) for r in new_chain)
        prov = {
            "alloc_id": e.alloc_id,
            "kind": WIRE_KIND[e.kind.value],
            "nbytes": e.nbytes,
            "orig_rank": e.origin_rank,
            "pid": e.origin_pid,
            "chain": csv,
            "epoch": f["epoch"],
        }
        # The restored copy must inherit the allocation's QoS class —
        # eviction discipline has to survive repair exactly as it
        # survives failover (qos/; a default-priority tail is omitted so
        # default traffic ships unchanged frames).
        qflags, qtail = _priority_tail(e.priority)
        te = self.entries[target]
        self._peer_request(
            te.connect_host, te.port,
            Message(MsgType.DO_REPLICA, prov, qtail, flags=qflags),
        )
        # Adopt the chain BEFORE streaming so concurrent client puts
        # already fan out to the target; the bulk copy then overwrites
        # (at worst) bytes the fan-out just delivered. A put landing
        # exactly between a chunk's read and its write can still be
        # shadowed — docs/RESILIENCE.md records the window.
        self.registry.set_chain(e.alloc_id, new_chain, f["epoch"])
        chunk = min(self.config.chunk_bytes, 4 << 20)
        view = memoryview(self.host_arena.view(e.extent))[: e.nbytes]
        pos = 0
        while pos < e.nbytes:
            n = min(chunk, e.nbytes - pos)
            self.peers.request(
                te.connect_host, te.port,
                Message(
                    MsgType.DATA_PUT,
                    {"alloc_id": e.alloc_id, "offset": pos, "nbytes": n},
                    bytes(view[pos:pos + n]),
                    flags=FLAG_FANOUT,
                ),
            )
            pos += n
        for rr in new_chain[1:-1]:
            if not 0 <= rr < len(self.entries):
                continue
            pe = self.entries[rr]
            try:
                self._peer_request(
                    pe.connect_host, pe.port,
                    Message(MsgType.DO_REPLICA, dict(prov)),
                )
            except (OSError, OcmError):
                printd("daemon %d: chain push to rank %d failed",
                       self.rank, rr)
        obs_journal.record(
            "rereplicated", track=self.tracer.track,
            alloc_id=e.alloc_id, target=target, chain=list(new_chain),
        )
        return Message(
            MsgType.RE_REPLICATE_OK,
            {"alloc_id": e.alloc_id, "nbytes": e.nbytes},
        )

    # -- elastic membership + live migration (elastic/) -------------------

    def _ensure_detector(self) -> FailureDetector | None:
        """Create the failure detector lazily when membership GROWS past
        one node (a solo seed daemon others join post-boot was built
        without one — len(entries) was 1 at construction)."""
        if (
            self.detector is None
            and self.config.detect
            and len(self.entries) > 1
        ):
            self.detector = FailureDetector(
                len(self.entries), self.rank,
                suspect_after=self.config.suspect_after,
                dead_after=self.config.dead_after,
            )
            for r in self.entries.left_ranks():
                self.detector.forget(r)
        return self.detector

    def _reconcile_detector(self) -> None:
        """Make the detector's watch set match the member table — called
        after any view adoption. Idempotent, so a shared in-process view
        that was already mutated by rank 0 still grows THIS daemon's
        detector."""
        det = self._ensure_detector()
        if det is None:
            return
        left = self.entries.left_ranks()
        for e in self.entries:
            if e.rank == self.rank:
                continue
            if e.rank in left:
                det.forget(e.rank)
            else:
                det.add_rank(e.rank)

    def _queue_member_sync(self, defer: tuple[int, ...] = ()) -> None:
        """Rank 0: (re)arm the member-table broadcast toward every live
        peer and push once inline; the reaper retries stragglers.
        ``defer`` skips the INLINE push only (the brand-new joiner is not
        serving yet — it gets the table in JOIN_OK and the reaper's
        retry confirms it once its accept loop runs)."""
        with self._member_sync_lock:
            self._member_unsynced = {
                e.rank for e in self.entries
                if e.rank != self.rank
                and e.port
                and not self.entries.has_left(e.rank)
            }
        self._sync_members(skip=defer)

    def _sync_members(self, skip: tuple[int, ...] = ()) -> None:
        with self._member_sync_lock:
            pending = sorted(self._member_unsynced - set(skip))
        for r in pending:
            if self.entries.has_left(r) or self._believed_dead(r):
                with self._member_sync_lock:
                    self._member_unsynced.discard(r)
                continue
            e = self.entries[r]
            try:
                self.peers.request(
                    e.connect_host, e.port,
                    Message(
                        MsgType.MEMBER_UPDATE,
                        {"epoch": self.entries.epoch},
                        self.entries.to_wire(),
                    ),
                )
                with self._member_sync_lock:
                    self._member_unsynced.discard(r)
            except (OSError, OcmError):
                pass  # retried on the next reaper tick

    def _on_req_join(self, msg: Message) -> Message:
        """Admit a fresh daemon (rank 0 only): assign the next rank —
        or the SAME rank when the address was seen before, so a joiner
        whose JOIN_OK was lost retries idempotently instead of leaking a
        half-member slot — bump the epoch, adopt it everywhere."""
        if not self.is_leader:
            return self._not_master_err("REQ_JOIN")
        f = msg.fields
        view = self.entries
        existing = view.find(f["host"], f["port"])
        rank = existing if existing is not None else len(view)
        epoch = self.bump_epoch()
        view.upsert(NodeEntry(rank, f["host"], f["port"]), epoch=epoch)
        self.policy.add_node(
            NodeResources(
                rank=rank,
                ndevices=f["ndevices"],
                device_arena_bytes=f["device_arena_bytes"],
                host_arena_bytes=f["host_arena_bytes"],
            )
        )
        det = self._ensure_detector()
        if det is not None:
            det.add_rank(rank)
            det.mark_alive(rank)
            if f["inc"]:
                det.record_ok(rank, f["inc"])
        self.ela_counters["joins"] += 1
        obs_journal.record(
            "member_join", track=self.tracer.track,
            rank=rank, host=f["host"], port=f["port"], epoch=epoch,
            rejoin=existing is not None,
        )
        printd("daemon %d: rank %d joined at %s:%d (epoch %d)",
               self.rank, rank, f["host"], f["port"], epoch)
        self._queue_member_sync(defer=(rank,))
        if self.leader_rank != 0:
            # Joiners boot believing rank 0 leads; once leadership has
            # moved, the reaper pushes them the current LEADER_UPDATE.
            with self._leader_sync_lock:
                if self._leader_update_fields is not None:
                    self._leader_unsynced.add(rank)
        if self.config.rebalance and self._rebalancer is not None:
            threading.Thread(
                target=self._rebalancer.rebalance_safe,
                kwargs={"settle_s": self.config.heartbeat_s},
                daemon=True, name=f"ocm-rebalance-e{epoch}",
            ).start()
        return Message(
            MsgType.JOIN_OK,
            {"rank": rank, "epoch": epoch, "nnodes": self.policy.nnodes},
            view.to_wire(),
        )

    def _on_req_leave(self, msg: Message) -> Message:
        """Graceful departure (rank 0 only): migrate everything off the
        leaver, THEN bump the epoch and drop it from the view. A drain
        that cannot complete fails the leave — the member stays, because
        departing with data aboard is just a slow crash (the unclean
        path is simply dying, which the DEAD-verdict failover handles)."""
        if not self.is_leader:
            return self._not_master_err("REQ_LEAVE")
        f = msg.fields
        rank = f["rank"]
        view = self.entries
        if rank == self.rank:
            # The serving leader cannot drain itself mid-coordination;
            # the clean path is a voluntary handoff FIRST (closing the
            # "rank 0 cannot leave" hole noted when elastic membership landed), then an
            # ordinary member departure via the successor.
            raise OcmInvalidHandle(
                f"rank {rank} is the serving leader and cannot leave — "
                "hand off leadership first (handoff_leadership)"
            )
        if not 0 <= rank < len(view) or view.has_left(rank):
            raise OcmInvalidHandle(f"rank {rank} is not a member")
        det = self.detector
        if f["inc"] and det is not None:
            known = det.incarnation(rank)
            if known and known != f["inc"]:
                raise OcmRemoteError(
                    int(ErrCode.STALE_EPOCH),
                    f"REQ_LEAVE incarnation {f['inc']:#x} does not match "
                    f"the serving daemon at rank {rank} ({known:#x})",
                )
        # Fence NEW placements off the leaver before moving data, else
        # the drain chases a moving target.
        self.policy.mark_dead(rank)
        try:
            moved, remaining = (
                self._rebalancer.drain(rank)
                if self._rebalancer is not None else (0, 0)
            )
            if remaining:
                raise OcmError(
                    f"drain of rank {rank} incomplete: {remaining} extents "
                    "still held — leave refused, member retained"
                )
        except BaseException:
            self.policy.mark_alive(rank)  # leave failed: still a member
            raise
        epoch = self.bump_epoch()
        view.mark_left(rank, epoch=epoch)
        self.policy.remove_node(rank)
        if det is not None:
            det.forget(rank)
        de = view[rank]
        self.peers.evict(de.connect_host, de.port)
        self.ela_counters["leaves"] += 1
        obs_journal.record(
            "member_leave", track=self.tracer.track,
            rank=rank, epoch=epoch, moved=moved,
        )
        printd("daemon 0: rank %d left (epoch %d, %d extents moved)",
               rank, epoch, moved)
        self._queue_member_sync()
        return Message(MsgType.LEAVE_OK, {"epoch": epoch, "moved": moved})

    def _on_member_update(self, msg: Message) -> Message:
        """Adopt rank 0's member-table broadcast (epoch-fenced: stale
        tables are dropped by ClusterView.adopt)."""
        f = msg.fields
        self._adopt_epoch(f["epoch"])
        if msg.data:
            self.entries.adopt(f["epoch"], bytes(msg.data))
        self._reconcile_detector()
        return Message(MsgType.MEMBER_OK, {"epoch": self.epoch})

    def _lookup_serving(self, alloc_id: int) -> RegEntry:
        """Registry lookup for data ops: a live-migrated id answers the
        typed MOVED redirect (new owner rank rides the error tail)
        instead of BAD_ALLOC_ID, so clients repoint instead of failing."""
        try:
            return self.registry.lookup(alloc_id)
        except OcmInvalidHandle:
            with self._moved_lock:
                rec = self._moved.get(alloc_id)
            if rec is not None:
                raise OcmMoved(
                    f"alloc {alloc_id} was migrated to rank {rec[0]}",
                    rec[0],
                ) from None
            raise

    def _note_moved(self, alloc_id: int, target: int, origin_pid: int,
                    origin_rank: int) -> None:
        with self._moved_lock:
            self._moved[alloc_id] = (
                target, origin_pid, origin_rank, time.monotonic()
            )

    def _prune_tombstones(self) -> None:
        """Drop forwarding tombstones whose app went heartbeat-stale —
        a live app's beats keep refreshing the stamp (and by then its
        client has long repointed via MOVED/REQ_LOCATE)."""
        horizon = self.config.app_stale_leases * self.config.lease_s
        now = time.monotonic()
        with self._moved_lock:
            stale = [
                a for a, rec in self._moved.items()
                if now - rec[3] > horizon
            ]
            for a in stale:
                del self._moved[a]

    def _note_migration_write(self, alloc_id: int, offset: int,
                              nbytes: int) -> None:
        """Client-write hook while THIS daemon streams the allocation
        out: record the dirty range for the pre-copy passes, or — once
        the flip fence is up — refuse retryably so the ladder re-lands
        the write on the new primary."""
        with self._mig_lock:
            st = self._migrations.get(alloc_id)
            if st is None:
                return
            if st["fence"]:
                raise OcmNotPrimary(
                    f"alloc {alloc_id} is mid-migration flip on rank "
                    f"{self.rank}; retry"
                )
            st["dirty"].append((offset, nbytes))

    def _on_migrate(self, msg: Message) -> Message:
        """Move one allocation to ``target_rank`` with zero acked-write
        loss (the source stays primary throughout the copy):

        1. provision — MIGRATE_BEGIN registers a QUARANTINED copy on the
           target (refuses client ops; dropped if this daemon dies).
        2. stream — local-only chain adoption makes every racing client
           put fan out to the target, then the extent streams over
           FLAG_FANOUT chunks; dirty ranges written mid-pass re-stream
           (bounded pre-copy), the residue flushes under a brief fence
           that bounces writers NOT_PRIMARY (retryable).
        3. flip — the target (then every surviving replica) adopts the
           chain with the target primary and the source gone.
        4. drop-source — the local entry dies; a forwarding tombstone
           answers MOVED so stale handles repoint.

        Every other holder keeps the OLD chain until the flip, so a
        source death mid-stream promotes among FULL copies only and the
        target's quarantined partial is aborted — a chain can never
        fork onto half-streamed bytes."""
        f = msg.fields
        self._adopt_epoch(f["epoch"])
        e = self._lookup_serving(f["alloc_id"])
        if e.kind not in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST):
            raise OcmInvalidHandle("only host-kind allocations migrate")
        if e.frozen:
            # Migration streams from the arena: thaw first (the target
            # receives a plain live copy — FROZEN is owner-local state).
            self._thaw(e)
        if not e.is_primary(self.rank):
            raise OcmInvalidHandle(
                f"rank {self.rank} is not primary for alloc {f['alloc_id']}"
            )
        if f["epoch"] < e.epoch:
            raise OcmRemoteError(
                int(ErrCode.STALE_EPOCH),
                f"migration epoch {f['epoch']} predates chain epoch "
                f"{e.epoch} for alloc {f['alloc_id']}",
            )
        target = f["target_rank"]
        if (
            not 0 <= target < len(self.entries)
            or target == self.rank
            or target in e.chain
            or self.entries.has_left(target)
        ):
            raise OcmInvalidHandle(f"bad migration target {target}")
        orig_chain = e.chain
        stream_chain = (*(orig_chain or (self.rank,)), target)
        epoch = max(e.epoch, f["epoch"])
        self.ela_counters["migrations_started"] += 1
        obs_journal.record(
            "migrate_start", track=self.tracer.track,
            alloc_id=e.alloc_id, src=self.rank, target=target,
            nbytes=e.nbytes, epoch=epoch,
        )
        te = self.entries[target]
        qflags, qtail = _priority_tail(e.priority)
        begin = Message(
            MsgType.MIGRATE_BEGIN,
            {
                "alloc_id": e.alloc_id,
                "kind": WIRE_KIND[e.kind.value],
                "nbytes": e.nbytes,
                "orig_rank": e.origin_rank,
                "pid": e.origin_pid,
                "chain": ",".join(str(r) for r in stream_chain),
                "src_rank": self.rank,
                "epoch": epoch,
            },
            qtail,
            flags=qflags,
        )
        try:
            self._peer_request(te.connect_host, te.port, begin)
        except (OSError, OcmError) as exc:
            self._migrate_abort(e.alloc_id, target, "provision", exc)
            raise
        with self._mig_lock:
            self._migrations[e.alloc_id] = {"dirty": [], "fence": False}
        try:
            # Local-only chain adoption: racing puts now fan out to the
            # target too; every OTHER holder keeps the old chain.
            self.registry.set_chain(e.alloc_id, stream_chain, epoch)
            self._migrate_stream(e, te, 0, e.nbytes)
            # Bounded pre-copy: re-stream ranges dirtied mid-pass.
            st = self._migrations[e.alloc_id]
            for _ in range(8):
                with self._mig_lock:
                    dirty, st["dirty"] = st["dirty"], []
                if not dirty:
                    break
                for off, n in dirty:
                    self._migrate_stream(e, te, off, n)
            # Fence the residue: late writers bounce retryable and land
            # on the target after the flip.
            with self._mig_lock:
                st["fence"] = True
                dirty = list(st["dirty"])
            for off, n in dirty:
                self._migrate_stream(e, te, off, n)
            # Flip: the target must adopt primaryship; survivors follow.
            new_chain = (
                target, *[r for r in orig_chain if r != self.rank]
            )
            flip = {
                "alloc_id": e.alloc_id,
                "kind": WIRE_KIND[e.kind.value],
                "nbytes": e.nbytes,
                "orig_rank": e.origin_rank,
                "pid": e.origin_pid,
                "chain": ",".join(str(r) for r in new_chain),
                "epoch": epoch,
            }
            self._peer_request(
                te.connect_host, te.port,
                Message(MsgType.DO_REPLICA, dict(flip)),
            )
        except (OSError, OcmError) as exc:
            # Abort: the source stays the (sole) primary under its
            # ORIGINAL chain; the target's quarantined copy is dropped
            # best-effort (its quarantine also dies with us).
            try:
                self.registry.set_chain(e.alloc_id, orig_chain, epoch)
            except OcmInvalidHandle:
                pass  # freed underneath us: nothing to restore
            with self._mig_lock:
                self._migrations.pop(e.alloc_id, None)
            try:
                self.peers.request(
                    te.connect_host, te.port,
                    Message(MsgType.DO_FREE, {"alloc_id": e.alloc_id}),
                )
            except (OSError, OcmError):
                pass
            self._migrate_abort(e.alloc_id, target, "stream", exc)
            raise
        for rr in new_chain[1:]:
            if rr == self.rank or not 0 <= rr < len(self.entries):
                continue
            pe = self.entries[rr]
            try:
                self._peer_request(
                    pe.connect_host, pe.port,
                    Message(MsgType.DO_REPLICA, dict(flip)),
                )
            except (OSError, OcmError):
                printd("daemon %d: migrate chain push to rank %d failed",
                       self.rank, rr)
        # Drop-source + tombstone. Deliberately NOT _do_free_local: the
        # tenant's quota stays reserved at its origin ledger (the bytes
        # still exist — they just moved), and placement accounting moves
        # atomically for both ends at the rank-0 rebalancer. The
        # tombstone lands BEFORE the registry entry dies so a racing
        # data op always sees either the live entry or the MOVED
        # redirect — never a bare BAD_ALLOC_ID window.
        self._note_moved(e.alloc_id, target, e.origin_pid, e.origin_rank)
        e2 = self.registry.remove(e.alloc_id)
        with self._mig_lock:
            self._migrations.pop(e.alloc_id, None)
        self.host_arena.free(e2.extent)
        alloctrace.note_free(self._trace_scope, e.alloc_id)
        self.ela_counters["migrations_completed"] += 1
        self.ela_counters["migration_bytes"] += e2.nbytes
        obs_journal.record(
            "migrate_flip", track=self.tracer.track,
            alloc_id=e.alloc_id, src=self.rank, target=target,
            nbytes=e2.nbytes, chain=list(new_chain), epoch=epoch,
        )
        printd("daemon %d: alloc %d migrated to rank %d (%d B)",
               self.rank, e.alloc_id, target, e2.nbytes)
        return Message(
            MsgType.MIGRATE_OK,
            {"alloc_id": e.alloc_id, "nbytes": e2.nbytes},
        )

    def _migrate_stream(self, e: RegEntry, te: NodeEntry, offset: int,
                        nbytes: int) -> None:
        """Stream [offset, offset+nbytes) of the extent to the target as
        FLAG_FANOUT chunks (idempotent absolute-offset writes)."""
        chunk = min(self.config.migrate_chunk_bytes, self.config.chunk_bytes)
        end = min(offset + nbytes, e.nbytes)
        view = memoryview(self.host_arena.view(e.extent))
        pos = offset
        while pos < end:
            n = min(chunk, end - pos)
            self.peers.request(
                te.connect_host, te.port,
                Message(
                    MsgType.DATA_PUT,
                    {"alloc_id": e.alloc_id, "offset": pos, "nbytes": n},
                    bytes(view[pos:pos + n]),
                    flags=FLAG_FANOUT,
                ),
            )
            pos += n

    def _migrate_abort(self, alloc_id: int, target: int, stage: str,
                       exc: BaseException) -> None:
        self.ela_counters["migrations_aborted"] += 1
        obs_journal.record(
            "migrate_abort", track=self.tracer.track,
            alloc_id=alloc_id, src=self.rank, target=target, stage=stage,
            error=f"{type(exc).__name__}: {exc}",
        )
        printd("daemon %d: migration of %d to rank %d aborted at %s: %s",
               self.rank, alloc_id, target, stage, exc)

    def _on_migrate_begin(self, msg: Message) -> Message:
        """Target side of a migration: provision (or re-adopt) the copy
        QUARANTINED — only FLAG_FANOUT stream/mirror writes land until
        the flip's chain rewrite, and the copy is dropped (never
        promoted) if the source dies mid-stream."""
        f = msg.fields
        self._adopt_epoch(f["epoch"])
        kind = OcmKind(WIRE_KIND_INV[f["kind"]])
        if kind not in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST):
            raise OcmInvalidHandle("only host-kind allocations migrate")
        chain = tuple(_parse_owners(f["chain"]))
        prio = PRIO_NORMAL
        if msg.flags & FLAG_QOS_TAIL and len(msg.data) >= 1:
            prio = min(max(bytes(msg.data[:1])[0], PRIO_LOW), PRIO_HIGH)
        try:
            existing = self.registry.lookup(f["alloc_id"])
        except OcmInvalidHandle:
            existing = None
        if existing is not None:
            if f["epoch"] < existing.epoch:
                raise OcmRemoteError(
                    int(ErrCode.STALE_EPOCH),
                    f"MIGRATE_BEGIN epoch {f['epoch']} predates chain "
                    f"epoch {existing.epoch}",
                )
            self.registry.mark_migrating(
                f["alloc_id"], chain, f["epoch"], f["src_rank"]
            )
            return Message(
                MsgType.DO_REPLICA_OK,
                {"alloc_id": f["alloc_id"],
                 "offset": existing.extent.offset},
            )
        extent = self.host_arena.alloc(f["nbytes"])
        self.registry.insert(
            RegEntry(
                alloc_id=f["alloc_id"],
                kind=kind,
                rank=self.rank,
                device_index=0,
                extent=extent,
                nbytes=f["nbytes"],
                origin_rank=f["orig_rank"],
                origin_pid=f["pid"],
                lease_expiry=self.registry.new_lease_deadline(),
                chain=chain,
                epoch=f["epoch"],
                priority=prio,
                migrating=True,
                migrate_src=f["src_rank"],
            )
        )
        # This rank holds the allocation again: any old forwarding
        # tombstone (migrated away and now coming back) is obsolete.
        with self._moved_lock:
            self._moved.pop(f["alloc_id"], None)
        alloctrace.note_alloc(
            self._trace_scope, f["alloc_id"], f["nbytes"], kind.name
        )
        return Message(
            MsgType.DO_REPLICA_OK,
            {"alloc_id": f["alloc_id"], "offset": extent.offset},
        )

    def _abort_migrations(self, dead: set[int], epoch: int) -> None:
        """Drop quarantined inbound copies whose SOURCE died mid-stream
        (called before reconcile_dead wherever a dead set lands): a
        half-streamed copy must never be promoted or repaired into a
        chain. Outbound migrations simply fail their stream and abort
        at the source's own state machine."""
        for e in self.registry.abort_migrations(dead):
            self.host_arena.free(e.extent)
            alloctrace.note_free(self._trace_scope, e.alloc_id)
            self.ela_counters["migrations_aborted"] += 1
            obs_journal.record(
                "migrate_abort", track=self.tracer.track,
                alloc_id=e.alloc_id, src=e.migrate_src, target=self.rank,
                stage="source-died", epoch=epoch,
            )
            printd("daemon %d: dropped quarantined migration copy %d "
                   "(source rank %d died)", self.rank, e.alloc_id,
                   e.migrate_src)

    def _extent_rows(self) -> list[dict]:
        """Host-kind inventory for the rebalancer (REQ_EXTENTS)."""
        rows = []
        for e in self.registry.snapshot():
            if e.kind not in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST):
                continue
            rows.append({
                "id": e.alloc_id,
                "kind": WIRE_KIND[e.kind.value],
                "nbytes": e.nbytes,
                "chain": list(e.chain),
                "primary": e.is_primary(self.rank),
                "prio": e.priority,
                "origin_rank": e.origin_rank,
                "origin_pid": e.origin_pid,
                "migrating": e.migrating,
            })
        rows.sort(key=lambda r: r["id"])
        return rows

    def _on_req_extents(self, msg: Message) -> Message:
        import json

        rows = self._extent_rows()
        return Message(
            MsgType.EXTENTS_OK,
            {"rank": self.rank, "count": len(rows)},
            json.dumps(rows, separators=(",", ":")).encode(),
        )

    def _on_req_locate(self, msg: Message) -> Message:
        """Where does this allocation live NOW? Answered from the local
        registry (chain head) or the forwarding tombstones — at rank 0
        the rebalancer records every flip, so this is the client
        ladder's backstop once a migration source departed entirely."""
        aid = msg.fields["alloc_id"]
        rank = None
        chain: tuple[int, ...] = ()
        try:
            e = self.registry.lookup(aid)
            rank = e.chain[0] if e.chain else self.rank
            chain = e.chain
        except OcmInvalidHandle:
            with self._moved_lock:
                rec = self._moved.get(aid)
            if rec is not None:
                rank = rec[0]
        if rank is None or not 0 <= rank < len(self.entries):
            raise OcmInvalidHandle(f"unknown alloc_id {aid}")
        e2 = self.entries[rank]
        return Message(
            MsgType.LOCATE_OK,
            {
                "alloc_id": aid,
                "rank": rank,
                "host": e2.connect_host,
                "port": e2.port,
                "chain": ",".join(str(r) for r in chain),
            },
        )

    def _elastic_meta(self) -> dict:
        """Membership/migration state for STATUS, STATUS_PROM and the
        obs cluster table."""
        return {
            "members": self.entries.alive_count(),
            "left": sorted(self.entries.left_ranks()),
            "view_epoch": self.entries.epoch,
            "counters": dict(self.ela_counters),
            "tombstones": len(self._moved),
        }

    # -- liveness --------------------------------------------------------

    def _on_heartbeat(self, msg: Message) -> Message:
        """Renew leases locally; a heartbeat arriving from a *local* app
        (origin rank == ours) is relayed to every peer daemon, since owners
        hold the leases. Relayed copies have origin rank != receiver rank,
        so they are not re-relayed (no forwarding loop)."""
        f = msg.fields
        self.registry.renew_leases(f["pid"], f["rank"])
        self.qos.touch(f["pid"], f["rank"])
        obs_journal.record(
            "lease_renew", track=self.tracer.track,
            app_pid=f["pid"], app_rank=f["rank"],
            relayed=f["rank"] != self.rank,
        )
        if msg.flags & FLAG_HB_FWD:
            # A tombstone-forwarded beat is TERMINAL: renew (done above)
            # and stop. Re-relaying it would loop — the origin's relay
            # branch fires on f["rank"] == its own rank no matter how
            # the beat got there, and two swapped migrations would
            # ping-pong a forward between their sources forever.
            return Message(
                MsgType.HEARTBEAT_OK, {"lease_s": self.registry.lease_s}
            )
        relayed_to: set[int] = set()
        if f["rank"] == self.rank:
            # Relay only to the ranks the app says own its allocations —
            # O(owners) per beat, not an O(nnodes) broadcast per app.
            for r in _parse_owners(f.get("owners", "")):
                if r == self.rank or not 0 <= r < len(self.entries):
                    continue
                relayed_to.add(r)
                e = self.entries[r]
                try:
                    self._peer_request(e.connect_host, e.port, msg)
                except (OSError, OcmConnectError):
                    printd("daemon %d: heartbeat relay to %d failed",
                           self.rank, e.rank)
        # Forward the beat along live-migration tombstones (elastic/):
        # until the app's client repoints its handle, its owners list
        # still names THIS rank — the migrated copy's lease would lapse
        # without the forward. Touching the stamp keeps the tombstone
        # alive exactly as long as the app is. Never toward the app's
        # ORIGIN rank (it renews from the app's direct beats), and the
        # forward is flagged so the receiver cannot relay it onward.
        fwd: set[int] = set()
        now = time.monotonic()
        with self._moved_lock:
            for aid, rec in self._moved.items():
                if (rec[1], rec[2]) == (f["pid"], f["rank"]):
                    self._moved[aid] = (rec[0], rec[1], rec[2], now)
                    fwd.add(rec[0])
        for r in fwd - relayed_to - {self.rank, f["rank"]}:
            if not 0 <= r < len(self.entries):
                continue
            e = self.entries[r]
            try:
                self._peer_request(
                    e.connect_host, e.port,
                    Message(MsgType.HEARTBEAT, dict(f), flags=FLAG_HB_FWD),
                )
            except (OSError, OcmConnectError):
                printd("daemon %d: migrated-lease heartbeat forward to %d "
                       "failed", self.rank, r)
        return Message(MsgType.HEARTBEAT_OK, {"lease_s": self.registry.lease_s})

    def _on_status(self, msg: Message) -> Message:
        import json

        # Data-plane telemetry + lease health ride as a JSON data tail:
        # v2 clients parse the fixed fields and ignore trailing data, so
        # the schema needs no new wire fields (the C++ daemon simply
        # sends no tail).
        detail = {
            "dcn": {
                "ops": {
                    k: v for k, v in self.tracer.snapshot().items()
                    if k.startswith("dcn_")
                },
                "transfers": self.tracer.transfers(last=32),
            },
            "leases": self.registry.lease_stats(),
            "resilience": self._resilience_meta(),
            "qos": self._qos_meta(),
            "fabric": self._fabric_meta(),
            "elastic": self._elastic_meta(),
            "mux": self._mux_meta(),
            "timebudget": dict(self.tb_counters),
            "frozen": self._frozen_meta(),
            # Arena capacities (control/): what a promoted leader's
            # whole-resync reads to rebuild placement accounting from
            # the survivors' own numbers.
            "serving": self._serving_meta(),
            "caps": {
                "ndevices": self.ndevices,
                "device_arena_bytes": self.config.device_arena_bytes,
                "host_arena_bytes": self.config.host_arena_bytes,
            },
        }
        return Message(
            MsgType.STATUS_OK,
            {
                "rank": self.rank,
                "nnodes": self.policy.nnodes if self.is_leader
                else len(self.entries),
                "live_allocs": self.registry.live_count(),
                "host_bytes_live": self.host_arena.allocator.bytes_live,
                "device_bytes_live": sum(
                    b.bytes_live for b in self.device_books
                ),
            },
            json.dumps(detail, separators=(",", ":")).encode(),
        )

    def _resilience_meta(self) -> dict:
        """Epoch/fencing/peer-state/failover counters for STATUS and the
        Prometheus exposition."""
        return {
            "epoch": self.epoch,
            "fenced": self._fenced,
            "peers": self.detector.states() if self.detector else {},
            "failover": dict(self.res_counters),
            # Leadership (control/): who coordinates, since when, and
            # how this daemon got (or observed) the role.
            "leader": self.leader_rank,
            "leader_epoch": self.leader_epoch,
            "is_leader": self.is_leader,
            "leadership": dict(self.ldr_counters),
        }

    def _qos_meta(self) -> dict:
        """Tenant/quota/eviction state for STATUS, STATUS_PROM and the
        obs cluster table's per-app rows."""
        meta = self.qos.metrics()
        scores = getattr(self.policy, "load_scores", None)
        if self.is_leader and scores is not None:
            meta["load_scores"] = scores()
        return meta

    def _fabric_meta(self) -> dict:
        """Which fabrics this daemon serves + per-fabric transfer
        counters, for STATUS and the ocm_fabric_* prom families."""
        return {
            "served": sorted(self.fabrics),
            "counters": dict(self.fabric_counters),
        }

    def _frozen_meta(self) -> dict | None:
        """FROZEN-tier counters + live occupancy for STATUS and the
        ocm_frozen_* prom families. None (omitted by render) when the
        tier is off — the STATUS tail is then byte-identical to the
        pre-persist daemon's."""
        if self._frozen is None:
            return None
        return {
            **self.frz_counters,
            "lost": len(self._frozen.lost),
            "bytes": self._frozen.bytes_stored,
            "extents": len(self._frozen.keys()),
            "max_bytes": self._frozen.max_bytes,
        }

    def _serving_meta(self) -> dict | None:
        """Co-located serving-engine stats (serving/metrics.py): an
        engine in THIS process publishes its counters and the daemon
        folds them into STATUS / STATUS_PROM — the in-band, no-new-
        MsgType observability discipline. None (omitted by render) when
        no engine lives here. The import is stdlib-only by the metrics
        module's contract."""
        from oncilla_tpu_torch.serving import metrics as serving_metrics

        return serving_metrics.colocated()

    def _metrics_meta(self) -> dict:
        """Everything the Prometheus endpoint and the cluster CLI render:
        op counters, the transfer ring, arena occupancy, lease health."""
        return {
            "rank": self.rank,
            "nnodes": self.policy.nnodes if self.is_leader
            else len(self.entries),
            "ops": self.tracer.snapshot(),
            "transfers": self.tracer.transfers(last=32),
            "live_allocs": self.registry.live_count(),
            "host_arena": {
                "live_bytes": self.host_arena.allocator.bytes_live,
                "capacity_bytes": self.config.host_arena_bytes,
            },
            "device_books": [
                {
                    "live_bytes": b.bytes_live,
                    "capacity_bytes": self.config.device_arena_bytes,
                }
                for b in self.device_books
            ],
            "leases": self.registry.lease_stats(),
            "resilience": self._resilience_meta(),
            "qos": self._qos_meta(),
            "fabric": self._fabric_meta(),
            "elastic": self._elastic_meta(),
            "mux": self._mux_meta(),
            "timebudget": dict(self.tb_counters),
            "frozen": self._frozen_meta(),
            "serving": self._serving_meta(),
        }

    def _on_status_prom(self, msg: Message) -> Message:
        from oncilla_tpu_torch.obs import prom

        text = prom.render(self._metrics_meta())
        return Message(
            MsgType.STATUS_PROM_OK, {"rank": self.rank}, text.encode()
        )

    def _on_status_events(self, msg: Message) -> Message:
        evs = obs_journal.events()
        return Message(
            MsgType.STATUS_EVENTS_OK,
            {"rank": self.rank, "count": len(evs)},
            obs_journal.dump_jsonl(evs).encode(),
        )


def _err(code: ErrCode, detail: str, data: bytes = b"") -> Message:
    return Message(MsgType.ERROR, {"code": int(code), "detail": detail}, data)


def _busy_hint_of(e: BaseException) -> int | None:
    """The retry hint of a BUSY-shaped error (a local OcmBusy from this
    process's own provisioning leg, or the typed wire rejection from a
    peer owner), else None."""
    if isinstance(e, OcmBusy):
        return e.retry_after_ms
    if isinstance(e, OcmRemoteError) and e.code == int(ErrCode.BUSY):
        return getattr(e, "retry_after_ms", 0)
    return None


def _priority_tail(priority: int) -> tuple[int, bytes]:
    """(flags, data tail) carrying a NON-default QoS priority on a
    provision leg (DO_REPLICA / MIGRATE_BEGIN); default-class traffic
    ships unchanged frames so the unreplicated wire stays byte-exact."""
    if priority == PRIO_NORMAL:
        return 0, b""
    return FLAG_QOS_TAIL, bytes([priority])


def _parse_owners(s: str) -> list[int]:
    """Comma-separated rank list from the wire ("1,3" -> [1, 3])."""
    out = []
    for part in s.split(","):
        part = part.strip()
        if part:
            try:
                out.append(int(part))
            except ValueError:
                continue
    return out


def main(argv=None) -> int:
    """``python -m oncilla_tpu_torch.runtime.daemon <nodefile> [--rank N]`` — the
    per-node daemon process (``bin/oncillamem nodefile`` analogue,
    reference src/main.c:187-221, minus the busy-spin: we block on a
    signal-interruptible event)."""
    import argparse
    import signal

    from oncilla_tpu_torch.runtime.membership import detect_rank, parse_nodefile
    ap = argparse.ArgumentParser(description="oncilla-tpu daemon (PyTorch port)")
    ap.add_argument("nodefile")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--policy", default="capacity", choices=sorted(POLICIES))
    ap.add_argument("--ndevices", type=int, default=1)
    ap.add_argument("--snapshot", default=None,
                    help="snapshot file: restored on start, written on stop")
    ap.add_argument("--host-arena-bytes", type=int, default=None,
                    help="served DRAM arena size (native daemon parity)")
    ap.add_argument("--device-arena-bytes", type=int, default=None,
                    help="booked per-device HBM size (native daemon parity)")
    ap.add_argument("--lease-s", type=float, default=None,
                    help="app lease (native daemon parity)")
    ap.add_argument("--heartbeat-s", type=float, default=None,
                    help="reaper cadence (native daemon parity)")
    args = ap.parse_args(argv)

    entries = parse_nodefile(args.nodefile)
    rank = args.rank if args.rank is not None else detect_rank(entries)
    cfg_kw = {}
    if args.host_arena_bytes is not None:
        cfg_kw["host_arena_bytes"] = args.host_arena_bytes
    if args.device_arena_bytes is not None:
        cfg_kw["device_arena_bytes"] = args.device_arena_bytes
    if args.lease_s is not None:
        cfg_kw["lease_s"] = args.lease_s
    if args.heartbeat_s is not None:
        cfg_kw["heartbeat_s"] = args.heartbeat_s
    d = Daemon(rank, entries, policy=args.policy, ndevices=args.ndevices,
               host=entries[rank].host, snapshot_path=args.snapshot,
               config=OcmConfig(**cfg_kw) if cfg_kw else None)
    d.start()
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    print(f"oncilla daemon rank={rank} listening on "
          f"{entries[rank].host}:{d.port}", flush=True)
    stop.wait()
    d.stop()
    return 0


# Flag bits the daemon acts on, per request type. The protocol
# exhaustiveness gate (analysis/project.py) checks every bit declared in
# protocol.VALID_FLAGS for a request type appears here — a flag added to
# the wire without daemon support fails lint instead of silently
# degrading to lockstep (or worse, desyncing the reply stream) under
# load. CONNECT's capability offer is handled in _on_connect (echo of
# the implemented subset); DATA_PUT's FLAG_MORE in _serve_conn's burst
# loop.
# FLAG_TRACE_CTX is handled GENERICALLY in _serve_conn (the context
# prefix is stripped and installed around dispatch before any handler
# runs), so every traced request type claims it here.
_FLAGS_HANDLED = {
    # FLAG_CAP_QOS / FLAG_QOS_TAIL: QoS profile declaration parsed in
    # _on_connect; priority tails parsed in _place_alloc / _on_do_alloc /
    # _on_do_replica (qos/). FLAG_CAP_MUX: granted in _on_connect (gated
    # on config.mux_serve). FLAG_MUX_TAG: the u32 correlation id is
    # stripped GENERICALLY in _serve_conn (before the trace prefix) and
    # echoed on the reply — the same generic-strip discipline as
    # FLAG_TRACE_CTX, so it appears on every client-facing request type.
    # FLAG_CAP_DEADLINE: granted in _on_connect; FLAG_DEADLINE (the u32
    # remaining-budget prefix) is stripped GENERICALLY in _serve_conn —
    # the FLAG_TRACE_CTX discipline — re-anchored on this host's clock,
    # refused typed when expired (before any handler side effect), and
    # re-attached decremented on forwarded hops via _peer_request.
    MsgType.CONNECT: (
        FLAG_CAP_COALESCE | FLAG_CAP_TRACE | FLAG_CAP_REPLICA
        | FLAG_CAP_QOS | FLAG_QOS_TAIL | FLAG_CAP_FABRIC
        | FLAG_CAP_MUX | FLAG_MUX_TAG | FLAG_CAP_DEADLINE
    ),
    # FLAG_FANOUT: replica-chain role discipline in _check_data_role /
    # _route_put_payload (fan-out legs land, clients need primary role).
    MsgType.DATA_PUT: (
        FLAG_MORE | FLAG_TRACE_CTX | FLAG_FANOUT | FLAG_MUX_TAG
        | FLAG_DEADLINE
    ),
    MsgType.DATA_GET: FLAG_TRACE_CTX | FLAG_MUX_TAG | FLAG_DEADLINE,
    # FLAG_REPLICAS: the data tail's u8 copy count, read in _place_alloc.
    MsgType.REQ_ALLOC: (
        FLAG_TRACE_CTX | FLAG_REPLICAS | FLAG_QOS_TAIL | FLAG_MUX_TAG
        | FLAG_DEADLINE
    ),
    MsgType.DO_ALLOC: FLAG_TRACE_CTX | FLAG_QOS_TAIL | FLAG_DEADLINE,
    MsgType.DO_REPLICA: FLAG_QOS_TAIL | FLAG_DEADLINE,
    # FLAG_QOS_TAIL: the migrated copy inherits the allocation's QoS
    # class — parsed in _on_migrate_begin (elastic/).
    MsgType.MIGRATE_BEGIN: FLAG_QOS_TAIL | FLAG_DEADLINE,
    MsgType.REQ_FREE: FLAG_TRACE_CTX | FLAG_MUX_TAG | FLAG_DEADLINE,
    MsgType.DO_FREE: FLAG_TRACE_CTX | FLAG_DEADLINE,
    MsgType.RECLAIM_APP: FLAG_TRACE_CTX,
    MsgType.NOTE_ALLOC: FLAG_TRACE_CTX,
    MsgType.NOTE_FREE: FLAG_TRACE_CTX,
    # FLAG_HB_FWD: a tombstone-forwarded beat is renewed but never
    # re-relayed (elastic/; the loop-prevention contract).
    MsgType.HEARTBEAT: FLAG_TRACE_CTX | FLAG_HB_FWD | FLAG_MUX_TAG,
    MsgType.STATUS: FLAG_TRACE_CTX | FLAG_MUX_TAG,
    MsgType.STATUS_PROM: FLAG_TRACE_CTX | FLAG_MUX_TAG,
    MsgType.STATUS_EVENTS: FLAG_TRACE_CTX | FLAG_MUX_TAG,
    # Over a mux channel DISCONNECT/REQ_LOCATE are awaited tagged
    # requests (generic tag strip + echo, handlers unchanged).
    MsgType.DISCONNECT: FLAG_MUX_TAG,
    MsgType.REQ_LOCATE: FLAG_MUX_TAG,
    # CANCEL: served inline in _serve_conn's cancel branch (keyed by
    # the victim tag on the SAME connection); _on_cancel covers the
    # lockstep/untagged sender honestly (nothing in flight to revoke).
    MsgType.CANCEL: FLAG_MUX_TAG,
    # shm fabric control legs (fabric/): validated in _shm_entry; the
    # FLAG_CAP_FABRIC offer itself is handled in _on_connect (echo +
    # descriptor tail).
    MsgType.SHM_MAP: FLAG_TRACE_CTX,
    MsgType.SHM_PUT: FLAG_TRACE_CTX,
    MsgType.SHM_GET: FLAG_TRACE_CTX,
}

# Requests a FENCED daemon (one that outlived its own DEAD verdict) must
# refuse with STALE_EPOCH: anything that grants extents or moves data.
# Reads are fenced too — after promotion the replica chain is the truth,
# and a stale primary serving reads would hand back pre-failover bytes.
_FENCED_REJECT = frozenset({
    MsgType.REQ_ALLOC,
    MsgType.DO_ALLOC,
    MsgType.DO_REPLICA,
    MsgType.RE_REPLICATE,
    MsgType.DATA_PUT,
    MsgType.DATA_GET,
    # A fenced daemon must neither drive membership nor move extents:
    # its verdicts were superseded by a newer epoch (elastic/).
    MsgType.REQ_JOIN,
    MsgType.REQ_LEAVE,
    MsgType.MIGRATE,
    MsgType.MIGRATE_BEGIN,
    # A fenced old LEADER must never coordinate (control/): membership
    # announcements, suspicion arbitration, and state replication all
    # bounce STALE_EPOCH so the sender re-aims at the live leader —
    # the split-brain scenario the leader-unique invariant audits.
    MsgType.ADD_NODE,
    MsgType.SUSPECT_NODE,
    MsgType.MASTER_STATE,
    MsgType.LEADER_HANDOFF,
    # The shm fabric's control legs are data ops: a fenced daemon must
    # refuse to bless a segment write OR hand out a mapping — the
    # STALE_EPOCH reply is what sends the client down its failover
    # ladder to the promoted replica (fabric re-resolution).
    MsgType.SHM_MAP,
    MsgType.SHM_PUT,
    MsgType.SHM_GET,
    # The device plane rides the same contract as DATA_*: a fenced owner
    # relaying PLANE_PUT/PLANE_GET would move bytes for extents a newer
    # epoch already re-homed, and a fenced master must not accept plane
    # endpoint registrations (the ADD_NODE rule). Found by the
    # fenced-reject-gap conformance check.
    MsgType.PLANE_SERVE,
    MsgType.PLANE_PUT,
    MsgType.PLANE_GET,
    MsgType.PLANE_SCRUB,
})

_HANDLERS = {
    MsgType.CONNECT: Daemon._on_connect,
    MsgType.DISCONNECT: Daemon._on_disconnect,
    MsgType.ADD_NODE: Daemon._on_add_node,
    MsgType.REQ_ALLOC: Daemon._on_req_alloc,
    MsgType.RECLAIM_APP: Daemon._on_reclaim_app,
    MsgType.DO_ALLOC: Daemon._on_do_alloc,
    MsgType.REQ_FREE: Daemon._on_req_free,
    MsgType.DO_FREE: Daemon._on_do_free,
    MsgType.NOTE_FREE: Daemon._on_note_free,
    MsgType.NOTE_ALLOC: Daemon._on_note_alloc,
    MsgType.DATA_PUT: Daemon._on_data_put,
    MsgType.DATA_GET: Daemon._on_data_get,
    MsgType.SHM_MAP: Daemon._on_shm_map,
    MsgType.SHM_PUT: Daemon._on_shm_put,
    MsgType.SHM_GET: Daemon._on_shm_get,
    MsgType.PLANE_SERVE: Daemon._on_plane_serve,
    MsgType.PLANE_PUT: Daemon._on_plane_relay,
    MsgType.PLANE_GET: Daemon._on_plane_relay,
    MsgType.PLANE_SCRUB: Daemon._on_plane_relay,
    MsgType.HEARTBEAT: Daemon._on_heartbeat,
    MsgType.STATUS: Daemon._on_status,
    MsgType.STATUS_PROM: Daemon._on_status_prom,
    MsgType.STATUS_EVENTS: Daemon._on_status_events,
    MsgType.PING: Daemon._on_ping,
    MsgType.SUSPECT_NODE: Daemon._on_suspect,
    MsgType.EPOCH_UPDATE: Daemon._on_epoch_update,
    MsgType.DO_REPLICA: Daemon._on_do_replica,
    MsgType.PROMOTE: Daemon._on_promote,
    MsgType.RE_REPLICATE: Daemon._on_re_replicate,
    MsgType.REQ_JOIN: Daemon._on_req_join,
    MsgType.REQ_LEAVE: Daemon._on_req_leave,
    MsgType.MEMBER_UPDATE: Daemon._on_member_update,
    MsgType.MIGRATE: Daemon._on_migrate,
    MsgType.MIGRATE_BEGIN: Daemon._on_migrate_begin,
    MsgType.REQ_LOCATE: Daemon._on_req_locate,
    MsgType.REQ_EXTENTS: Daemon._on_req_extents,
    MsgType.CANCEL: Daemon._on_cancel,
    MsgType.MASTER_STATE: Daemon._on_master_state,
    MsgType.LEADER_UPDATE: Daemon._on_leader_update,
    MsgType.LEADER_HANDOFF: Daemon._on_leader_handoff,
}

if __name__ == "__main__":
    raise SystemExit(main())
