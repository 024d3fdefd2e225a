"""The port's copy of ``oncilla_tpu/utils/config.py``, line for line: the
same fields, defaults, ``OCM_*`` env knobs and checks, read by the port's
data planes, its client and its daemon.

Configuration.

The reference's config surface is (a) the positional nodefile text format
``#rank hostname eth_ip ocm_port rdmacm_port`` (reference src/
nodefile.c:30-37), (b) env var ``OCM_VERBOSE`` (reference inc/
debug.h:22), and (c) compile-time fabric flags (SConstruct:96-122). Here the
same knobs are a dataclass with env-var overrides, and fabric selection is
runtime (both fabrics always built, as SConstruct:122 allowed).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


# Wire-frame payload cap (protocol.MAX_PAYLOAD's value) minus slack for the
# frame's fixed fields: a DATA_PUT chunk is fixed fields + chunk payload in
# ONE frame, so a chunk_bytes above this encodes to a frame the peer must
# reject (OcmProtocolError at the daemon — a config-legal value turning
# into a wire error mid-transfer). Kept as a literal rather than an import
# because utils.config must stay import-light (no runtime package pull-in
# at config time); test_dcn_stripe.py pins it against protocol.MAX_PAYLOAD.
MAX_CHUNK_BYTES = (64 << 20) - 4096


@dataclass
class OcmConfig:
    # Arena capacities. The reference sizes buffers per-allocation at
    # registration time; we pre-reserve arenas (HBM must be carved out of the
    # chip up front to be remotely addressable).
    host_arena_bytes: int = field(
        default_factory=lambda: _env_int("OCM_HOST_ARENA_BYTES", 256 << 20)
    )
    device_arena_bytes: int = field(
        default_factory=lambda: _env_int("OCM_DEVICE_ARENA_BYTES", 128 << 20)
    )
    # 4096 = the Pallas data-plane block (one (32,128) uint8 tile): extents
    # aligned to it let the remote-DMA kernels address HBM by whole blocks
    # (Mosaic cannot prove arbitrary dynamic byte offsets tile-aligned).
    alignment: int = 4096

    # Control plane. The reference's daemon listens on the nodefile's
    # ocm_port; per-allocation IB ports came from a counter at 67980
    # (reference src/mem.c:38) — here the data plane is connectionless
    # so only the daemon port exists.
    daemon_port: int = field(
        default_factory=lambda: _env_int("OCM_DAEMON_PORT", 17980)
    )
    nodefile: str | None = field(
        default_factory=lambda: os.environ.get("OCM_NODEFILE")
    )
    rank: int | None = None  # None = autodetect (nodefile hostname match
    # in the reference, nodefile.c:92-103; jax.process_index() on TPU pods)

    # Data-plane tuning. The reference pipelines 8 MB chunks with 2 in-flight
    # ops (reference src/extoll.c:47-51) — but its 8 MB is an EXTOLL
    # RMA2 hardware command limit (extoll.c:49-51), which doesn't bind a
    # TCP/ICI transport. Same 2-deep pipelining SCHEME here; 16 MiB chunks
    # measured best on the daemon path (r5 loopback sweep: GET leg
    # 1.04 → 1.32 GB/s vs 8 MiB, PUT 1.86 → 1.94; 32 MiB regresses PUT).
    chunk_bytes: int = field(
        default_factory=lambda: _env_int("OCM_CHUNK_BYTES", 16 << 20)
    )
    inflight_ops: int = field(default_factory=lambda: _env_int("OCM_INFLIGHT", 2))

    # Multi-stream striping: large DCN transfers split into N contiguous
    # byte ranges, each pipelined over its OWN pooled connection (parallel
    # TCP streams to the owner daemon — the UCX/NCCL multi-rail scheme).
    # 1 = the original single-stream path. Stripes below stripe_min_bytes
    # are not worth a thread + socket; transfers shrink their stripe count
    # so every stripe moves at least that much.
    dcn_stripes: int = field(
        default_factory=lambda: _env_int("OCM_DCN_STRIPES", 4)
    )
    dcn_stripe_min_bytes: int = field(
        default_factory=lambda: _env_int("OCM_DCN_STRIPE_MIN_BYTES", 8 << 20)
    )
    # Adaptive windowing: autotune the in-flight window and chunk size per
    # peer from observed per-chunk RTT (0 = pin the configured values).
    dcn_adaptive: bool = field(
        default_factory=lambda: bool(_env_int("OCM_DCN_ADAPTIVE", 1))
    )
    # Offer FLAG_CAP_COALESCE at CONNECT so capable daemons ACK a put
    # stripe once per burst instead of once per chunk (0 = always lockstep;
    # peers that don't grant the capability get lockstep regardless).
    dcn_coalesce: bool = field(
        default_factory=lambda: bool(_env_int("OCM_DCN_COALESCE", 1))
    )

    # Data-plane fabric selection (fabric/). "tcp" (and OCM_FABRIC
    # unset) is the framed-TCP engine with NO negotiation — the wire is
    # byte-for-byte the pre-fabric protocol. "shm" offers FLAG_CAP_FABRIC
    # at the data-plane CONNECT probe and, when the peer daemon serves a
    # shared-memory segment THIS process can attach (same host, verified
    # by attaching — never by hostname comparison), large put/get becomes
    # a bounds-checked memcpy into the peer's mapped arena; every pair
    # that can't (old daemons, the native C++ daemon, cross-host peers)
    # falls back to tcp per pair. "auto" is an alias for "shm".
    fabric: str = field(
        default_factory=lambda: os.environ.get("OCM_FABRIC") or "tcp"
    )
    # Transfers below this ride tcp even when shm is negotiated: the
    # mapped-segment path costs a TCP control round-trip per transfer
    # either way, and tiny ops gain nothing from the memcpy.
    fabric_shm_min_bytes: int = field(
        default_factory=lambda: _env_int("OCM_FABRIC_SHM_MIN_BYTES", 64 << 10)
    )

    # Async multiplexed client runtime (runtime/mux.py). OCM_MUX=1 puts
    # the CLIENT data plane on the asyncio mux core: one connection per
    # peer daemon shared by every tenant in the process, tagged request
    # pipelining (FLAG_CAP_MUX + u32 correlation ids), small-op
    # batching, and heartbeats scheduled on the shared event loop
    # instead of one thread per tenant. Unset (the default) keeps the
    # per-request blocking client AND the wire byte-for-byte the
    # pre-mux protocol (the capability is never offered). Peers that
    # decline (old Python daemons, the native C++ daemon) are served
    # lockstep over the same single connection.
    mux: bool = field(default_factory=lambda: bool(_env_int("OCM_MUX", 0)))
    # Per-peer in-flight window: how many tagged requests a mux channel
    # keeps outstanding before submitters wait. Bounds daemon-side queue
    # depth exactly like the reference's inflight_ops bounds a pipelined
    # transfer.
    mux_window: int = field(
        default_factory=lambda: _env_int("OCM_MUX_WINDOW", 64)
    )
    # Daemon side: whether to GRANT an offered FLAG_CAP_MUX. =0 makes
    # this daemon behave like an un-upgraded peer (decline by silence) —
    # the interop tests' lever, the OCM_NATIVE_OBS=0 precedent.
    mux_serve: bool = field(
        default_factory=lambda: bool(_env_int("OCM_MUX_SERVE", 1))
    )

    # Distributed tracing (obs/): offer FLAG_CAP_TRACE at CONNECT and
    # prefix requests with a 16-byte trace context once granted, so one
    # trace_id stitches client → local daemon → peer daemon spans.
    # Always-on by the Dapper premise (ids are too cheap to gate);
    # OCM_TRACE=0 opts the process out entirely (never offered, never
    # attached). Journal recording is gated separately by OCM_EVENTS.
    trace: bool = field(
        default_factory=lambda: bool(_env_int("OCM_TRACE", 1))
    )

    # Liveness (capability upgrade over the reference's unresolved TODO,
    # reference src/main.c:6-7).
    lease_s: float = 30.0
    heartbeat_s: float = 5.0
    # How many lease periods of heartbeat silence before an app is
    # considered stale: its row is pruned from lease_stats' per-app view
    # and its QoS tenant state is dropped (the maps must not grow with
    # every app that ever attached).
    app_stale_leases: float = field(
        default_factory=lambda: float(_env_int("OCM_APP_STALE_LEASES", 10))
    )

    # Multi-tenant QoS (qos/). Server side, these are the DEFAULT per-app
    # caps a daemon enforces at REQ_ALLOC admission (0 = unlimited); an
    # app may declare its own profile at CONNECT behind FLAG_CAP_QOS.
    # Client side, a non-default profile (priority != 1 or a quota set)
    # is what triggers the capability offer — all unset keeps the wire
    # byte-for-byte the pre-QoS protocol.
    quota_bytes: int = field(
        default_factory=lambda: _env_int("OCM_QUOTA_BYTES", 0)
    )
    quota_handles: int = field(
        default_factory=lambda: _env_int("OCM_QUOTA_HANDLES", 0)
    )
    # Priority class: 0 low (evictable under arena pressure), 1 normal
    # (default), 2 high (also exempt from back-pressure BUSY).
    priority: int = field(default_factory=lambda: _env_int("OCM_PRIORITY", 1))
    # Concurrent-app admission cap per daemon (0 = unlimited): the
    # "thousands of apps per daemon" guard — past it, REQ_ALLOC from a
    # NEW app answers ADMISSION_DENIED until others disconnect/go stale.
    max_apps: int = field(default_factory=lambda: _env_int("OCM_MAX_APPS", 0))
    # Back-pressure watermarks, percent of host-arena capacity. Crossing
    # high makes REQ_ALLOC answer retryable BUSY (rank 0, host kinds,
    # priority < high) and arms the reaper's pressure eviction, which
    # frees low-priority extents until occupancy falls below low.
    arena_high_pct: int = field(
        default_factory=lambda: _env_int("OCM_ARENA_HIGH_PCT", 90)
    )
    arena_low_pct: int = field(
        default_factory=lambda: _env_int("OCM_ARENA_LOW_PCT", 75)
    )
    # Client retry budget for BUSY rejections: capped exponential backoff
    # with jitter (the CONNECT-retry helper), seeded by the server's
    # suggested delay when one rides the reply.
    busy_retries: int = field(
        default_factory=lambda: _env_int("OCM_BUSY_RETRIES", 4)
    )
    busy_backoff_ms: int = field(
        default_factory=lambda: _env_int("OCM_BUSY_BACKOFF_MS", 50)
    )
    # Load-aware placement (policy="loadaware"): how often rank 0 polls
    # peer STATUS to refresh the per-rank load scores.
    loadaware_poll_s: float = field(
        default_factory=lambda: _env_int("OCM_LOADAWARE_POLL_MS", 2000) / 1e3
    )

    # Resilience (resilience/): k-way replicated allocations. k = total
    # copies (primary + k-1 replicas on distinct nodes); 1 = today's
    # single-copy behavior and the pre-replication wire protocol
    # byte-for-byte (the capability is never offered). Host-kind
    # allocations only — device bytes live in the app plane's arena and
    # are not daemon-replicable.
    replicas: int = field(default_factory=lambda: _env_int("OCM_REPLICAS", 1))
    # Daemon-to-daemon failure detection (resilience/detector.py), driven
    # from the reaper loop in a star topology (every rank probes rank 0,
    # rank 0 probes everyone): OCM_DETECT=0 disables; probes fire at most
    # every detect_interval_s (floored at heartbeat_s); suspect_after /
    # dead_after are consecutive probe failures before the SUSPECT report
    # and the rank-0 DEAD verdict.
    detect: bool = field(default_factory=lambda: bool(_env_int("OCM_DETECT", 1)))
    detect_interval_s: float = field(
        default_factory=lambda: _env_int("OCM_DETECT_INTERVAL_MS", 1000) / 1e3
    )
    suspect_after: int = field(
        default_factory=lambda: _env_int("OCM_SUSPECT_AFTER", 2)
    )
    dead_after: int = field(
        default_factory=lambda: _env_int("OCM_DEAD_AFTER", 5)
    )
    probe_timeout_s: float = field(
        default_factory=lambda: _env_int("OCM_PROBE_TIMEOUT_MS", 1000) / 1e3
    )

    # Time-bounded data plane (resilience/timebudget.py). OCM_DEADLINE_MS
    # is the DEFAULT per-op time budget: > 0 arms deadline propagation —
    # the client offers FLAG_CAP_DEADLINE at CONNECT, ops carry their
    # remaining budget as a u32 tail on every hop, daemons refuse
    # already-expired work with typed DEADLINE_EXCEEDED, and every retry
    # ladder clamps its sleeps to the remainder. 0 (the default) keeps
    # the wire byte-for-byte the pre-deadline protocol (per-op
    # deadline_ms arguments still clamp the CLIENT's own ladders).
    deadline_ms: int = field(
        default_factory=lambda: _env_int("OCM_DEADLINE_MS", 0)
    )
    # Hedged replica reads: after this delay with no primary answer, a
    # replicated get() fires a second read at the next chain member and
    # the first answer wins (losers are cancelled where the channel
    # supports it). 0 disables; -1 derives the delay from this client's
    # own observed dcn_get p99 (hedge only the tail). Never applies to
    # writes.
    hedge_ms: int = field(default_factory=lambda: _env_int("OCM_HEDGE_MS", 0))
    # Per-peer circuit breaker: this many CONSECUTIVE transport/deadline
    # failures flip the peer OPEN (fail-fast typed OcmBreakerOpen); a
    # half-open probe is admitted every breaker_probe_ms and a success
    # closes it. 0 (the default) disables the breaker entirely.
    breaker_threshold: int = field(
        default_factory=lambda: _env_int("OCM_BREAKER_THRESHOLD", 0)
    )
    breaker_probe_ms: int = field(
        default_factory=lambda: _env_int("OCM_BREAKER_PROBE_MS", 1000)
    )

    # Decentralized control plane (control/). OCM_STANDBY_MASTERS = k
    # replicates the leader's coordination state (placement accounting,
    # member view, dead set — JSON + CRC32, the snapshot-v2 discipline)
    # to the k lowest-rank live standbys every reaper tick, and arms the
    # election machinery: on a DEAD verdict for the leader the lowest
    # live rank bumps the epoch, fences the old leader by
    # (rank, incarnation), broadcasts LEADER_UPDATE and resumes
    # coordination from the replicated state. 0 (the default) disables
    # the whole family — no MASTER_STATE/LEADER_* frame ever rides, the
    # master stays pinned at rank 0, and the wire is byte-for-byte the
    # pre-leadership protocol.
    standby_masters: int = field(
        default_factory=lambda: _env_int("OCM_STANDBY_MASTERS", 0)
    )
    # Replicated-state freshness bound: a standby whose newest
    # MASTER_STATE copy is older than this at election time refuses to
    # lead from it and re-syncs WHOLE from the survivors (STATUS polls),
    # exactly as it does for a CRC-failing copy.
    leader_lease_s: float = field(
        default_factory=lambda: _env_int("OCM_LEADER_LEASE_MS", 3000) / 1e3
    )
    # Placement plan shape. "leader" (default) is the pre-hash behavior:
    # every REQ_ALLOC funnels through the leader for placement. "hash"
    # computes host-kind placements at the app's ORIGIN daemon by
    # rendezvous/HRW hashing over the live member view
    # (control/hashring.py) — zero leader round trips on the alloc
    # path; admission/quota checks stay at the origin, and accounting
    # syncs to the leader in the background. Device kinds and the
    # back-pressure watermark check keep the leader path.
    placement: str = field(
        default_factory=lambda: os.environ.get("OCM_PLACEMENT") or "leader"
    )

    # Elastic membership (elastic/): OCM_REBALANCE=1 makes rank 0 kick a
    # background capacity-weighted rebalance after every JOIN (LEAVE
    # always drains regardless — a graceful departure without moving the
    # data would just be a slow crash). Off by default: moving tenant
    # bytes on membership change is an operator policy, not a given.
    rebalance: bool = field(
        default_factory=lambda: bool(_env_int("OCM_REBALANCE", 0))
    )
    # Chunk size of the migration stream (provision -> FLAG_FANOUT chunk
    # stream -> flip). Smaller than the DCN transfer chunk by default:
    # migration shares the source daemon's serve capacity with live
    # traffic, and finer chunks keep the racing-put fencing windows
    # short.
    migrate_chunk_bytes: int = field(
        default_factory=lambda: _env_int("OCM_MIGRATE_CHUNK", 1 << 20)
    )

    # FROZEN tier (persist/): disk-backed fourth arena tier below COLD.
    # OCM_FROZEN_DIR names the root directory (each daemon uses the
    # subdirectory r<rank>); unset leaves the tier off entirely — no
    # FrozenStore is constructed and behavior (and the wire) is
    # byte-identical to a build without persist/. OCM_FROZEN=0 is the
    # hard off-switch even with a dir configured (the usual pinned
    # escape hatch). OCM_FROZEN_MAX_BYTES bounds the payload bytes per
    # store (0 = unbounded); writes past the budget fall back to the
    # pre-FROZEN destroy path.
    frozen: bool = field(
        default_factory=lambda: bool(_env_int("OCM_FROZEN", 1))
    )
    frozen_dir: str | None = field(
        default_factory=lambda: os.environ.get("OCM_FROZEN_DIR") or None
    )
    frozen_max_bytes: int = field(
        default_factory=lambda: _env_int("OCM_FROZEN_MAX_BYTES", 0)
    )

    # Client CONNECT retry: a daemon restarting mid-failover refuses
    # connections for a beat; the app-side client retries with capped
    # exponential backoff + jitter instead of surfacing a hard connect
    # error. 0 retries = the old single-attempt behavior.
    connect_retries: int = field(
        default_factory=lambda: _env_int("OCM_CONNECT_RETRIES", 4)
    )
    connect_backoff_s: float = field(
        default_factory=lambda: _env_int("OCM_CONNECT_BACKOFF_MS", 50) / 1e3
    )
    connect_backoff_cap_s: float = 2.0
    # How long a data transfer keeps re-walking its failover ladder
    # (owner membership address, then each replica) on RETRYABLE
    # failures — transport errors, STALE_EPOCH, NOT_PRIMARY,
    # REPLICA_UNAVAILABLE — before surfacing the error. Sized to cover
    # the detection window (dead_after probes) plus promotion.
    failover_wait_s: float = field(
        default_factory=lambda: _env_int("OCM_FAILOVER_WAIT_MS", 10000) / 1e3
    )

    def __post_init__(self) -> None:
        # A 0-byte chunk livelocks every chunked transfer loop
        # (n = min(chunk_bytes, total - pos) never advances pos) and a
        # non-positive in-flight window never issues a request — fail at
        # config construction, where OCM_CHUNK_BYTES=0 would otherwise
        # slip past int() (the C twin clamps to its default instead,
        # libocm.cc).
        if not 0 < self.chunk_bytes <= MAX_CHUNK_BYTES:
            raise ValueError(
                f"chunk_bytes must be in (0, {MAX_CHUNK_BYTES}] — a 0 chunk "
                "livelocks the transfer loops, and a chunk above "
                "MAX_PAYLOAD minus fixed-field slack encodes to a wire "
                "frame the peer daemon rejects mid-transfer "
                f"(got {self.chunk_bytes})"
            )
        if self.inflight_ops <= 0:
            raise ValueError(
                f"inflight_ops must be > 0 (got {self.inflight_ops})"
            )
        if self.mux_window <= 0:
            raise ValueError(
                f"mux_window must be > 0 (got {self.mux_window}) — a "
                "zero window never admits a request to the channel"
            )
        if self.dcn_stripes <= 0:
            raise ValueError(
                f"dcn_stripes must be >= 1 (got {self.dcn_stripes}); "
                "1 selects the single-stream path"
            )
        if self.dcn_stripe_min_bytes <= 0:
            raise ValueError(
                "dcn_stripe_min_bytes must be > 0 "
                f"(got {self.dcn_stripe_min_bytes})"
            )
        # The replica count rides the wire as one u8 and a chain must stay
        # a short csv string; 8 copies is already far past any sane
        # durability/overhead trade-off.
        if not 1 <= self.replicas <= 8:
            raise ValueError(
                f"replicas must be in [1, 8] (got {self.replicas}); "
                "1 selects the single-copy path"
            )
        if self.suspect_after < 1 or self.dead_after < self.suspect_after:
            raise ValueError(
                "need 1 <= suspect_after <= dead_after (got "
                f"{self.suspect_after}/{self.dead_after}) — a DEAD verdict "
                "before a SUSPECT report skips arbitration"
            )
        if self.connect_retries < 0 or self.connect_backoff_s < 0:
            raise ValueError(
                "connect_retries/connect_backoff_s must be >= 0 (got "
                f"{self.connect_retries}/{self.connect_backoff_s})"
            )
        if not 0 <= self.priority <= 2:
            raise ValueError(
                f"priority must be 0 (low), 1 (normal) or 2 (high) "
                f"(got {self.priority})"
            )
        if (self.quota_bytes < 0 or self.quota_handles < 0
                or self.max_apps < 0):
            raise ValueError(
                "quota_bytes/quota_handles/max_apps must be >= 0 "
                "(0 = unlimited)"
            )
        if not 0 < self.arena_low_pct <= self.arena_high_pct <= 100:
            raise ValueError(
                "need 0 < arena_low_pct <= arena_high_pct <= 100 (got "
                f"{self.arena_low_pct}/{self.arena_high_pct}) — eviction "
                "hysteresis must sit at or below the BUSY threshold"
            )
        if self.busy_retries < 0 or self.busy_backoff_ms < 0:
            raise ValueError(
                "busy_retries/busy_backoff_ms must be >= 0"
            )
        if self.app_stale_leases <= 0:
            raise ValueError(
                f"app_stale_leases must be > 0 (got {self.app_stale_leases})"
            )
        if self.fabric not in ("tcp", "shm", "auto"):
            raise ValueError(
                f"fabric must be 'tcp', 'shm' or 'auto' (got "
                f"{self.fabric!r}); 'tcp' is the framed-TCP engine with "
                "no negotiation, 'shm'/'auto' negotiate per peer pair"
            )
        if not 0 < self.migrate_chunk_bytes <= MAX_CHUNK_BYTES:
            raise ValueError(
                f"migrate_chunk_bytes must be in (0, {MAX_CHUNK_BYTES}] "
                f"(got {self.migrate_chunk_bytes}) — same wire-frame bound "
                "as chunk_bytes"
            )
        if self.fabric_shm_min_bytes < 0:
            raise ValueError(
                "fabric_shm_min_bytes must be >= 0 "
                f"(got {self.fabric_shm_min_bytes})"
            )
        if self.deadline_ms < 0:
            raise ValueError(
                f"deadline_ms must be >= 0 (got {self.deadline_ms}); "
                "0 disables the default per-op budget"
            )
        if self.hedge_ms < -1:
            raise ValueError(
                f"hedge_ms must be >= -1 (got {self.hedge_ms}); 0 "
                "disables hedging, -1 derives the delay from the "
                "observed dcn_get p99"
            )
        if self.breaker_threshold < 0 or self.breaker_probe_ms <= 0:
            raise ValueError(
                "need breaker_threshold >= 0 (0 disables) and "
                f"breaker_probe_ms > 0 (got {self.breaker_threshold}/"
                f"{self.breaker_probe_ms})"
            )
        # Same u8/short-csv bound as replica chains: standbys beyond a
        # handful add replication traffic for no availability win.
        if not 0 <= self.standby_masters <= 8:
            raise ValueError(
                f"standby_masters must be in [0, 8] (got "
                f"{self.standby_masters}); 0 disables leadership transfer"
            )
        if self.leader_lease_s <= 0:
            raise ValueError(
                f"leader_lease_s must be > 0 (got {self.leader_lease_s}) — "
                "a zero lease makes every replicated state copy stale"
            )
        if self.frozen_max_bytes < 0:
            raise ValueError(
                f"frozen_max_bytes must be >= 0 (got "
                f"{self.frozen_max_bytes}); 0 = unbounded"
            )
        if self.placement not in ("leader", "hash"):
            raise ValueError(
                f"placement must be 'leader' or 'hash' (got "
                f"{self.placement!r}); 'leader' is the rank-0-funneled "
                "leader-funneled plan shape, 'hash' computes host-kind placements "
                "at the origin daemon by rendezvous hashing"
            )

    @property
    def frozen_enabled(self) -> bool:
        """Whether this daemon runs a FROZEN tier: a directory is
        configured AND the OCM_FROZEN off-switch is not thrown. False
        keeps demotion/eviction byte-identical to the pre-persist
        behavior (victims destroyed, ``qos_evict`` only)."""
        return self.frozen and self.frozen_dir is not None

    @property
    def fabric_offer(self) -> bool:
        """Whether this process negotiates fabrics at all — the gate on
        offering FLAG_CAP_FABRIC at the data-plane CONNECT probe (client
        side) and on creating a shared-memory-backed arena (daemon
        side). OCM_FABRIC unset/"tcp" keeps the wire byte-for-byte the
        pre-fabric protocol."""
        return self.fabric in ("shm", "auto")

    @property
    def deadline_offer(self) -> bool:
        """Whether this client offers FLAG_CAP_DEADLINE at CONNECT — a
        default budget must be armed; unset keeps the wire byte-for-byte
        the pre-deadline protocol."""
        return self.deadline_ms > 0

    @property
    def qos_offer(self) -> bool:
        """Whether a client has a non-default QoS profile to declare —
        the gate on offering FLAG_CAP_QOS at CONNECT. All-default keeps
        the CONNECT frame byte-for-byte the pre-QoS wire."""
        return (
            self.priority != 1
            or self.quota_bytes > 0
            or self.quota_handles > 0
        )
