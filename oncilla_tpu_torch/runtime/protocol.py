"""The port's copy of ``oncilla_tpu/runtime/protocol.py``, line for line,
byte-identical on the wire: the JAX package's Python daemon, the native
daemon and the port's own daemon and client all speak it.

Control-plane wire protocol.

The reference ships raw fixed-size C structs over TCP with no versioning or
endianness handling (``send_recv_msg``, reference src/mem.c:63-88), a
homogeneous-architecture assumption SURVEY.md flags as a bug to replace. This
module defines a versioned, explicitly little-endian framed protocol spoken
identically by the Python client/daemon and the C++ daemon
(oncilla_tpu/runtime/native/daemon.cc).

Frame:  magic "OCM1" (4 B) | version u8 | type u8 | flags u16 | payload_len u32
Payload: type-specific packed fields, strings length-prefixed (u16 + utf-8),
raw data carried after the fixed fields (DATA_PUT / DATA_GET_OK).

Message set mirrors reference inc/msg.h:24-45 (CONNECT, ADD_NODE,
REQ_ALLOC, DO_ALLOC, REQ_FREE, DO_FREE, RELEASE_APP) plus the capability
upgrades: DATA_PUT/DATA_GET (the DCN data plane), HEARTBEAT (leases — the
reference's unresolved liveness TODO, main.c:6-7), and STATUS for
observability.
"""

from __future__ import annotations

import enum
import socket
import struct
from dataclasses import dataclass, field

from oncilla_tpu_torch.core.errors import OcmProtocolError, OcmRemoteError

MAGIC = b"OCM1"
VERSION = 2  # v2: owners field on DISCONNECT/HEARTBEAT, RECLAIM_APP
HEADER = struct.Struct("<4sBBHI")  # magic, version, type, flags, payload_len
MAX_PAYLOAD = 64 << 20  # sanity cap; large transfers are chunked above this

# Header-flag bits (the u16 the v2 frame always carried but never used).
# Capabilities ride the SAME frame format, so a v2 peer that ignores
# flags interoperates unmodified: it simply never grants a capability.
# The native C++ daemon serves the DATA-plane subset (it echoes
# FLAG_CAP_COALESCE and lands FLAG_MORE bursts zero-copy) and declines
# every other bit by silence — its grant mask is protocol.hh
# kCapsImplemented, pinned by the declined-by-silence tests.
#
# FLAG_MORE on DATA_PUT marks a non-final chunk of a coalesced burst: the
# daemon applies the chunk but defers its reply, answering ONCE — at the
# first chunk without the bit — with a DATA_PUT_OK covering the whole
# burst (or the burst's first ERROR). Senders may only set it after the
# peer granted FLAG_CAP_COALESCE.
FLAG_MORE = 0x0001
# FLAG_CAP_COALESCE on CONNECT offers ACK coalescing; a daemon that
# implements it (the Python daemon AND the native C++ daemon) echoes the
# bit on CONNECT_CONFIRM. A flags=0 reply (old v2 Python daemon)
# declines, and the sender stays on the lockstep one-reply-per-chunk
# protocol.
FLAG_CAP_COALESCE = 0x0002
# FLAG_CAP_TRACE on CONNECT offers distributed-trace propagation (the
# same offer/echo dance as FLAG_CAP_COALESCE). Only after the peer
# echoes it may a sender set FLAG_TRACE_CTX on requests; a flags=0 reply
# (un-upgraded v2 daemon, native C++ daemon) declines by silence and the
# sender ships plain frames — interop untouched.
FLAG_CAP_TRACE = 0x0004
# FLAG_TRACE_CTX on a request: the first 16 bytes of the data tail are a
# trace context (obs/trace.py: trace_id u64 | span_id u64), NOT payload.
# Receivers strip the prefix before dispatch and attach the context to
# their serve-side spans / forwarded hops. Replies never carry it (the
# requester already owns the context).
FLAG_TRACE_CTX = 0x0008
# FLAG_CAP_REPLICA on CONNECT offers k-way replicated allocations
# (resilience/): same offer/echo dance as FLAG_CAP_COALESCE. Only after
# the daemon echoes it may a client set FLAG_REPLICAS on REQ_ALLOC; a
# flags=0 reply (un-upgraded v2 daemon, native C++ daemon) declines by
# silence and every allocation stays single-copy — with OCM_REPLICAS
# unset/1 the bit is never even offered, so the wire is byte-for-byte
# the pre-replication protocol.
FLAG_CAP_REPLICA = 0x0010
# FLAG_REPLICAS on REQ_ALLOC: the data tail carries one u8 — the
# requested copy count k (after any trace prefix is stripped). The fixed
# schema stays untouched so un-flagged frames remain byte-identical and
# parseable by every v2 peer; chain membership itself rides the new
# DO_REPLICA message, never a legacy type.
FLAG_REPLICAS = 0x0020
# FLAG_FANOUT on DATA_PUT marks a primary->replica replication leg (and
# re-replication streaming). Replica holders accept ONLY fan-out writes
# while they believe their primary alive — a client write landing on a
# replica is rejected NOT_PRIMARY so the copies can never diverge — and
# never re-fan a fan-out write (no forwarding loops).
FLAG_FANOUT = 0x0040
# FLAG_CAP_QOS on CONNECT offers multi-tenant QoS (qos/): per-app
# quota/priority declaration and the priority tails on the alloc chain.
# Same offer/echo dance as the other capabilities: a flags=0 reply
# (un-upgraded v2 daemon, native C++ daemon) declines by silence and the
# app runs at the server-side defaults. With OCM_QUOTA_*/OCM_PRIORITY
# unset the bit is never offered, so the wire stays byte-for-byte the
# pre-QoS protocol.
FLAG_CAP_QOS = 0x0080
# FLAG_QOS_TAIL marks a QoS data tail (after any trace prefix is
# stripped): on CONNECT, the app's declared profile
# (priority u8 | quota_bytes u64 | quota_handles u32, qos/policy.py
# PROFILE_TAIL); on REQ_ALLOC / DO_ALLOC / DO_REPLICA, one u8 — the
# allocation's priority class, appended AFTER the FLAG_REPLICAS u8 when
# both ride. Only ever set toward a peer that granted FLAG_CAP_QOS;
# the fixed schemas stay untouched so un-flagged frames remain
# byte-identical and parseable by every v2 peer.
FLAG_QOS_TAIL = 0x0100
# FLAG_CAP_FABRIC on CONNECT offers data-fabric negotiation (fabric/):
# the client asks which one-sided fabrics the daemon serves besides the
# framed-TCP engine this protocol itself rides on. A daemon that serves
# one echoes the bit on CONNECT_CONFIRM and appends a JSON descriptor
# data tail (e.g. {"shm": {"seg": <segment name>, "size": <bytes>}});
# the CLIENT then proves reachability (for shm: by actually attaching
# the named segment — same-host detection is attachability, never a
# hostname comparison). Decline-by-silence as ever: a flags=0 reply
# (un-upgraded v2 daemon, native C++ daemon) or an unattachable
# descriptor (cross-host pair) keeps the peer pair on tcp. With
# OCM_FABRIC unset/"tcp" the bit is never offered, so the default wire
# is byte-for-byte the pre-fabric protocol.
FLAG_CAP_FABRIC = 0x0200
# FLAG_HB_FWD marks a HEARTBEAT forwarded along a live-migration
# tombstone (elastic/): the receiver renews leases but must NEVER
# relay or re-forward it — the origin's relay branch triggering on a
# forwarded beat would loop (origin -> owner -> tombstone-forward ->
# origin -> ...), and two swapped migrations would ping-pong forever.
# With no migrations there are no tombstones and the bit never rides,
# so the static-membership heartbeat stays byte-identical.
FLAG_HB_FWD = 0x0400
# FLAG_CAP_MUX on CONNECT offers tagged request multiplexing
# (runtime/mux.py): once granted, the sender may interleave many
# in-flight requests on ONE connection, each carrying a u32 correlation
# id (FLAG_MUX_TAG), and the daemon may complete them OUT OF ORDER —
# every reply carries its request's tag back, so a response
# demultiplexer matches them regardless of completion order. Same
# offer/echo dance as every capability: a flags=0 reply (un-upgraded v2
# Python daemon, the native C++ daemon) declines by silence and the
# sender stays on the lockstep one-request-one-reply protocol over that
# same single connection. With OCM_MUX unset the bit is never offered,
# so the default wire is byte-for-byte the pre-mux protocol.
FLAG_CAP_MUX = 0x0800
# FLAG_MUX_TAG: the FIRST 4 bytes of the data tail are a u32 correlation
# id, NOT payload (prefixed OUTSIDE any trace context — strip order on
# receive is tag, then trace, then payload). Requests carry it only
# toward a peer that granted FLAG_CAP_MUX; the peer echoes the same tag
# on the reply (ERROR replies included — a typed rejection must reach
# the tenant that earned it, not a random waiter). A coalesced DATA_PUT
# burst tags only its CLOSING chunk: body chunks produce no reply and
# stay eligible for the zero-copy recv-into-arena landing.
FLAG_MUX_TAG = 0x1000
# FLAG_CAP_DEADLINE on CONNECT offers time-budget propagation
# (resilience/timebudget.py): once granted, requests may carry a
# FLAG_DEADLINE remaining-budget tail and the daemon refuses
# already-expired work with typed DEADLINE_EXCEEDED instead of serving
# it into the void. Same offer/echo dance as every capability: a
# flags=0 reply (un-upgraded v2 Python daemon, the native C++ daemon)
# declines by silence and the sender ships plain frames — budgets then
# only clamp the CLIENT's own ladders. With OCM_DEADLINE_MS unset the
# bit is never offered, so the default wire is byte-for-byte the
# pre-deadline protocol.
FLAG_CAP_DEADLINE = 0x2000
# FLAG_DEADLINE: a u32 data-tail prefix — the op's REMAINING time
# budget in milliseconds, measured by the SENDER at send time (each hop
# re-attaches the remainder on forwarded legs, so the budget decrements
# by observed elapsed time as it crosses the cluster; no clock sync
# needed, only monotonic local clocks). Strip order on receive is tag,
# then trace, then deadline, then payload — handlers see the same
# payload bytes they always did. Only ever set toward a peer that
# granted FLAG_CAP_DEADLINE.
FLAG_DEADLINE = 0x4000

# Which flag bits each message type may carry on the wire. pack() rejects
# undeclared bits (a typo'd flag must fail at the sender, not surface as
# peer misbehavior); receivers stay tolerant and just expose msg.flags.
# The analysis gate (analysis/project.py) checks every declared request
# bit against the daemon's handled-flags table, so a bit added here
# without daemon support fails lint rather than turning into silent
# lockstep behavior under load.
VALID_FLAGS: dict["MsgType", int] = {}


def _valid_flags(mtype: "MsgType") -> int:
    return VALID_FLAGS.get(mtype, 0)


class MsgType(enum.IntEnum):
    # app <-> local daemon (reference: pmsg mailbox messages)
    CONNECT = 1
    CONNECT_CONFIRM = 2
    DISCONNECT = 3
    # daemon <-> daemon control (reference: mem.c TCP messages)
    ADD_NODE = 10
    ADD_NODE_OK = 11
    REQ_ALLOC = 12          # origin -> rank 0: place this allocation
    ALLOC_PLACED = 13       # rank 0 -> origin: (rank, device, kind)
    DO_ALLOC = 14           # origin -> owner: reserve the extent
    DO_ALLOC_OK = 15        # owner -> origin: (alloc_id, offset)
    REQ_FREE = 16
    DO_FREE = 17
    FREE_OK = 18
    ALLOC_RESULT = 19       # local daemon -> app: the complete handle
    NOTE_FREE = 20          # owner -> rank 0: update placement accounting
    NOTE_ALLOC = 21         # restored owner -> rank 0: resync accounting
    RECLAIM_APP = 22        # origin daemon -> owner: free a dead app's allocs
    RECLAIM_APP_OK = 23
    # DCN data plane (reference: the per-fabric one-sided put/get)
    DATA_PUT = 30
    DATA_PUT_OK = 31
    DATA_GET = 32
    DATA_GET_OK = 33
    # liveness + observability (capability upgrades)
    HEARTBEAT = 40
    HEARTBEAT_OK = 41
    STATUS = 42
    STATUS_OK = 43
    # STATUS family extensions (obs/): Prometheus text exposition and the
    # structured event journal, served in-band so observability needs no
    # extra listening port. Replies carry the document as the data tail.
    STATUS_PROM = 44
    STATUS_PROM_OK = 45
    STATUS_EVENTS = 46
    STATUS_EVENTS_OK = 47
    # cross-process device plane: the SPMD controller's client registers
    # its plane endpoint (PLANE_SERVE -> master), and daemons relay
    # device-kind data ops to it as PLANE_PUT/PLANE_GET enriched with the
    # registry extent (replies reuse DATA_PUT_OK/DATA_GET_OK). This is how
    # a plane-less process (a C app over libocm, a second Python process)
    # reaches device bytes — the reference serves every arm cross-process
    # (alloc.c:151-222); here the daemon bridges to the controller.
    PLANE_SERVE = 50
    PLANE_SERVE_OK = 51
    PLANE_PUT = 52
    PLANE_GET = 53
    PLANE_SCRUB = 54
    # resilience (resilience/): daemon-to-daemon liveness, cluster-epoch
    # arbitration, k-way replica provisioning and failover repair. All new
    # types — a v2 peer that predates them never receives one (the client
    # capability gate is FLAG_CAP_REPLICA; liveness probes treat a typed
    # BAD_MSG ERROR reply as "alive, capability absent").
    PING = 60               # liveness probe; carries sender epoch+incarnation
    PING_OK = 61
    SUSPECT_NODE = 62       # non-master -> rank 0: I can't reach this rank
    SUSPECT_OK = 63
    EPOCH_UPDATE = 64       # rank 0 -> all: epoch bump + DEAD verdict (fence)
    EPOCH_OK = 65
    DO_REPLICA = 66         # provision a replica extent under a given id
    DO_REPLICA_OK = 67
    PROMOTE = 68            # rank 0 -> survivor: reconcile dead ranks
    PROMOTE_OK = 69
    RE_REPLICATE = 70       # rank 0 -> primary: copy an alloc to a new rank
    RE_REPLICATE_OK = 71
    # shm fabric control plane (fabric/shm.py). The DATA itself never
    # rides these frames — it is a one-sided memcpy through the peer's
    # mapped arena segment; these carry the registration lookup and the
    # validate/ack legs (role discipline, epoch fencing, bounds, replica
    # fan-out all stay on TCP, exactly the reference's split between the
    # allocation protocol and the per-fabric one-sided put/get). All new
    # types: only ever sent to a peer that granted FLAG_CAP_FABRIC, so a
    # v2/native peer never receives one.
    SHM_MAP = 72            # client -> owner: where does alloc_id live?
    SHM_MAP_OK = 73         # owner -> client: (ext_offset, ext_nbytes)
    SHM_PUT = 74            # "I wrote [off,off+n) via the segment": validate+ack
    SHM_GET = 75            # "may I read [off,off+n)?": validate before copy
    # elastic membership + live migration (elastic/). All new types: a
    # v2 peer that predates them answers a typed BAD_MSG ERROR (how the
    # native C++ daemon declines the whole family by silence), and with
    # no JOIN/LEAVE traffic none of them ever rides the wire — the
    # static-membership protocol stays byte-for-byte the pre-elastic protocol.
    REQ_JOIN = 76           # fresh daemon -> rank 0: admit me (addr+capacity)
    JOIN_OK = 77            # rank 0 -> joiner: (rank, epoch) + member table
    REQ_LEAVE = 78          # member -> rank 0: drain me, then drop me
    LEAVE_OK = 79           # rank 0 -> leaver: (epoch, extents moved off)
    MEMBER_UPDATE = 80      # rank 0 -> all: epoch bump + full member table
    MEMBER_OK = 81
    MIGRATE = 82            # rank 0 -> source primary: move alloc to target
    MIGRATE_OK = 83
    MIGRATE_BEGIN = 84      # source -> target: provision a QUARANTINED copy
    #                       (reply: DO_REPLICA_OK — same provision contract)
    REQ_LOCATE = 85         # client -> rank 0: where does alloc_id live NOW?
    LOCATE_OK = 86
    REQ_EXTENTS = 87        # rank 0 -> member: your host-kind inventory
    EXTENTS_OK = 88
    # Decentralized control plane (control/): the master role as an
    # epoch-fenced lease. All new types, only ever sent when
    # OCM_STANDBY_MASTERS > 0 arms leadership replication — with it
    # unset none of them ride, so the default wire stays byte-for-byte
    # the pre-leadership protocol. A v2/native peer answers typed BAD_MSG (decline by
    # silence), which just means "no standby there".
    MASTER_STATE = 89       # leader -> standby: replicated master state
    #                       (JSON + CRC32 trailer data tail, the
    #                       snapshot-v2 integrity discipline)
    MASTER_STATE_OK = 90
    LEADER_UPDATE = 91      # new leader -> all: leadership + epoch bump
    #                       (dead_rank/inc fence the deposed leader the
    #                       way EPOCH_UPDATE fences a dead owner;
    #                       dead_rank -1 = voluntary handoff, no fence)
    LEADER_OK = 92
    LEADER_HANDOFF = 93     # old leader -> successor: voluntary transfer
    #                       (final master state rides the data tail; a
    #                       CRC-failing tail REFUSES the handoff)
    # Server-side cancellation (resilience/timebudget.py + runtime/mux.py):
    # revoke a tagged in-flight op by its mux correlation id. A tenant
    # whose awaitable times out (or is cancelled) sends CANCEL instead of
    # only tombstoning the tag client-side; the daemon marks the tag
    # revoked — a queued op never dispatches, a completed op's reply is
    # suppressed (and a completed REQ_ALLOC's reservation is unwound
    # through the ordinary free path) — and answers CANCEL_OK with
    # whether anything was actually revoked. Only ever sent on a channel
    # that granted FLAG_CAP_MUX; the native C++ daemon answers typed
    # BAD_MSG with the stream in sync (the unknown-type contract).
    CANCEL = 94
    CANCEL_OK = 95
    # failure
    ERROR = 99


# Kind tags on the wire (stable small ints, not Python enum identities).
WIRE_KIND = {
    "local_host": 0,
    "local_device": 1,
    "remote_device": 2,
    "remote_host": 3,
}
WIRE_KIND_INV = {v: k for k, v in WIRE_KIND.items()}

VALID_FLAGS.update({
    # Capability offer/echo bits. CONNECT may also carry the QoS profile
    # tail (FLAG_QOS_TAIL) alongside the FLAG_CAP_QOS offer; decliners
    # ignore both the bit and the tail. A TENANT's CONNECT riding an
    # already-multiplexed channel (one process hosting many app ids over
    # one connection) is itself a tagged request, hence FLAG_MUX_TAG.
    MsgType.CONNECT: (
        FLAG_CAP_COALESCE | FLAG_CAP_TRACE | FLAG_CAP_REPLICA
        | FLAG_CAP_QOS | FLAG_QOS_TAIL | FLAG_CAP_FABRIC
        | FLAG_CAP_MUX | FLAG_MUX_TAG | FLAG_CAP_DEADLINE
    ),
    MsgType.CONNECT_CONFIRM: (
        FLAG_CAP_COALESCE | FLAG_CAP_TRACE | FLAG_CAP_REPLICA
        | FLAG_CAP_QOS | FLAG_CAP_FABRIC | FLAG_CAP_MUX | FLAG_MUX_TAG
        | FLAG_CAP_DEADLINE
    ),
    # Requests that may carry a trace-context prefix once the peer
    # granted FLAG_CAP_TRACE. DATA_PUT also keeps the coalesced-burst
    # bit; its trace prefix rides the burst-CLOSING chunk only, so the
    # body chunks stay eligible for the zero-copy recv-into-arena path.
    # FLAG_MUX_TAG marks the client-facing request set a mux channel
    # interleaves (the same discipline: a burst tags only its closing
    # chunk).
    # FLAG_DEADLINE (the u32 remaining-budget prefix) rides the
    # budgetable op set: the client-facing data/alloc/free requests and
    # every hop they forward onto — the REQ_ALLOC leader relay, the
    # DO_ALLOC/DO_REPLICA provisioning legs, and the MIGRATE_BEGIN
    # migration leg — so an expiring budget is refused at whichever hop
    # it dies on, not served into the void.
    MsgType.DATA_PUT: (
        FLAG_MORE | FLAG_TRACE_CTX | FLAG_FANOUT | FLAG_MUX_TAG
        | FLAG_DEADLINE
    ),
    MsgType.DATA_GET: FLAG_TRACE_CTX | FLAG_MUX_TAG | FLAG_DEADLINE,
    MsgType.REQ_ALLOC: (
        FLAG_TRACE_CTX | FLAG_REPLICAS | FLAG_QOS_TAIL | FLAG_MUX_TAG
        | FLAG_DEADLINE
    ),
    MsgType.DO_ALLOC: FLAG_TRACE_CTX | FLAG_QOS_TAIL | FLAG_DEADLINE,
    MsgType.DO_REPLICA: FLAG_QOS_TAIL | FLAG_DEADLINE,
    # A migration-provisioned copy inherits the allocation's QoS class
    # (elastic/): non-default priorities ride the same u8 tail DO_REPLICA
    # carries; default-class migrations ship unchanged frames.
    MsgType.MIGRATE_BEGIN: FLAG_QOS_TAIL | FLAG_DEADLINE,
    MsgType.REQ_FREE: FLAG_TRACE_CTX | FLAG_MUX_TAG | FLAG_DEADLINE,
    MsgType.DO_FREE: FLAG_TRACE_CTX | FLAG_DEADLINE,
    MsgType.RECLAIM_APP: FLAG_TRACE_CTX,
    MsgType.NOTE_ALLOC: FLAG_TRACE_CTX,
    MsgType.NOTE_FREE: FLAG_TRACE_CTX,
    MsgType.HEARTBEAT: FLAG_TRACE_CTX | FLAG_HB_FWD | FLAG_MUX_TAG,
    MsgType.STATUS: FLAG_TRACE_CTX | FLAG_MUX_TAG,
    MsgType.STATUS_PROM: FLAG_TRACE_CTX | FLAG_MUX_TAG,
    MsgType.STATUS_EVENTS: FLAG_TRACE_CTX | FLAG_MUX_TAG,
    # Over a shared mux channel DISCONNECT is awaited like any request
    # (fire-and-forget would leave an unmatched reply to desync the
    # demux); REQ_LOCATE is part of the client failover ladder, which
    # runs over the channel too.
    MsgType.DISCONNECT: FLAG_MUX_TAG,
    MsgType.REQ_LOCATE: FLAG_MUX_TAG,
    # CANCEL rides the mux channel as an ordinary tagged request (its
    # OWN tag; the victim tag is a payload field) so its ack demuxes
    # like any reply.
    MsgType.CANCEL: FLAG_MUX_TAG,
    MsgType.CANCEL_OK: FLAG_MUX_TAG,
    # Replies: a request that arrived tagged is answered tagged — the
    # echo is what lets the demultiplexer match out-of-order
    # completions. ERROR included: typed rejections (BUSY, MOVED,
    # QUOTA_EXCEEDED) must reach exactly the tenant that earned them.
    MsgType.ALLOC_RESULT: FLAG_MUX_TAG,
    MsgType.FREE_OK: FLAG_MUX_TAG,
    MsgType.DATA_PUT_OK: FLAG_MUX_TAG,
    MsgType.DATA_GET_OK: FLAG_MUX_TAG,
    MsgType.HEARTBEAT_OK: FLAG_MUX_TAG,
    MsgType.STATUS_OK: FLAG_MUX_TAG,
    MsgType.STATUS_PROM_OK: FLAG_MUX_TAG,
    MsgType.STATUS_EVENTS_OK: FLAG_MUX_TAG,
    MsgType.LOCATE_OK: FLAG_MUX_TAG,
    MsgType.ERROR: FLAG_MUX_TAG,
    # shm fabric control legs are ordinary traceable requests: the
    # exported trace shows the validate/ack hop where a DATA_* span
    # would have been.
    MsgType.SHM_MAP: FLAG_TRACE_CTX,
    MsgType.SHM_PUT: FLAG_TRACE_CTX,
    MsgType.SHM_GET: FLAG_TRACE_CTX,
})


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 0xFFFF:
        raise OcmProtocolError("string field too long")
    return struct.pack("<H", len(b)) + b


def _unpack_str(buf, off: int) -> tuple[str, int]:
    (n,) = struct.unpack_from("<H", buf, off)
    off += 2
    if off + n > len(buf):  # a silent short slice would hide truncation
        raise OcmProtocolError("truncated string field")
    return bytes(buf[off : off + n]).decode("utf-8"), off + n


@dataclass
class Message:
    type: MsgType
    fields: dict = field(default_factory=dict)
    # On SEND, ``data`` may also be a list/tuple of buffers — the vectored
    # form obs/trace.attach uses to prefix a 16-byte trace context onto a
    # bulk payload without copying it (send_msg scatter-gathers the parts;
    # the wire bytes are identical to the concatenation). Received
    # messages always carry one contiguous buffer.
    data: bytes = b""
    flags: int = 0  # header-flag bits (FLAG_*), preserved by the codec

    def __repr__(self) -> str:  # data elided for log hygiene
        fl = f", flags={self.flags:#x}" if self.flags else ""
        return (
            f"Message({self.type.name}, {self.fields}, "
            f"data={_data_len(self.data)}B{fl})"
        )


def _data_parts(data) -> list:
    return list(data) if isinstance(data, (list, tuple)) else [data]


def _data_len(data) -> int:
    if isinstance(data, (list, tuple)):
        return sum(len(p) for p in data)
    return len(data)


# Payload schemas: (field_name, struct_char or "s" for string) in order.
# "q" = i64, "Q" = u64, "I" = u32, "B" = u8, "d" = f64, "s" = string.
_SCHEMAS: dict[MsgType, list[tuple[str, str]]] = {
    MsgType.CONNECT: [("pid", "q"), ("rank", "q")],
    MsgType.CONNECT_CONFIRM: [("rank", "q"), ("nnodes", "q")],
    # "owners" on DISCONNECT/HEARTBEAT is the comma-separated set of ranks
    # holding this app's remote allocations, tracked app-side (the app is
    # the source of truth for its own handles, and the set survives daemon
    # restarts). Bounds reclamation/relay fan-out to O(owners), not
    # O(nnodes).
    MsgType.DISCONNECT: [("pid", "q"), ("owners", "s")],
    MsgType.ADD_NODE: [
        ("rank", "q"),
        ("host", "s"),
        ("port", "I"),
        ("ndevices", "I"),
        ("device_arena_bytes", "Q"),
        ("host_arena_bytes", "Q"),
    ],
    MsgType.ADD_NODE_OK: [("nnodes", "q")],
    MsgType.REQ_ALLOC: [
        ("orig_rank", "q"),
        ("pid", "q"),
        ("kind", "B"),
        ("nbytes", "Q"),
    ],
    MsgType.ALLOC_PLACED: [
        ("rank", "q"),
        ("device_index", "I"),
        ("kind", "B"),
    ],
    MsgType.DO_ALLOC: [
        ("orig_rank", "q"),
        ("pid", "q"),
        ("kind", "B"),
        ("device_index", "I"),
        ("nbytes", "Q"),
    ],
    MsgType.DO_ALLOC_OK: [("alloc_id", "Q"), ("offset", "Q")],
    MsgType.REQ_FREE: [("alloc_id", "Q"), ("rank", "q")],
    MsgType.ALLOC_RESULT: [
        ("alloc_id", "Q"),
        ("rank", "q"),
        ("device_index", "I"),
        ("kind", "B"),
        ("offset", "Q"),
        ("nbytes", "Q"),
        ("owner_host", "s"),
        ("owner_port", "I"),
    ],
    MsgType.NOTE_FREE: [
        ("kind", "B"),
        ("rank", "q"),
        ("device_index", "I"),
        ("nbytes", "Q"),
    ],
    MsgType.NOTE_ALLOC: [
        ("kind", "B"),
        ("rank", "q"),
        ("device_index", "I"),
        ("nbytes", "Q"),
    ],
    MsgType.DO_FREE: [("alloc_id", "Q")],
    MsgType.FREE_OK: [("alloc_id", "Q")],
    MsgType.RECLAIM_APP: [("pid", "q"), ("rank", "q")],
    MsgType.RECLAIM_APP_OK: [("count", "Q")],
    MsgType.DATA_PUT: [("alloc_id", "Q"), ("offset", "Q"), ("nbytes", "Q")],
    MsgType.DATA_PUT_OK: [("nbytes", "Q")],
    MsgType.DATA_GET: [("alloc_id", "Q"), ("offset", "Q"), ("nbytes", "Q")],
    MsgType.DATA_GET_OK: [("nbytes", "Q")],
    MsgType.HEARTBEAT: [("rank", "q"), ("pid", "q"), ("owners", "s")],
    MsgType.HEARTBEAT_OK: [("lease_s", "d")],
    MsgType.STATUS: [],
    # Prometheus text exposition / event-journal JSONL ride as the reply
    # data tail (documents, not fields — same pattern as STATUS_OK's
    # telemetry tail).
    MsgType.STATUS_PROM: [],
    MsgType.STATUS_PROM_OK: [("rank", "q")],
    MsgType.STATUS_EVENTS: [],
    MsgType.STATUS_EVENTS_OK: [("rank", "q"), ("count", "Q")],
    MsgType.STATUS_OK: [
        ("rank", "q"),
        ("nnodes", "q"),
        ("live_allocs", "Q"),
        ("host_bytes_live", "Q"),
        ("device_bytes_live", "Q"),
    ],
    # "relay" = 0 from the registering client, 1 daemon-to-daemon (the
    # forward-to-master and master-broadcast legs never re-forward).
    MsgType.PLANE_SERVE: [("host", "s"), ("port", "I"), ("relay", "B")],
    MsgType.PLANE_SERVE_OK: [("port", "I")],
    # The daemon->plane relay legs carry the registry extent so the plane
    # controller can address its arena without a registry of its own.
    MsgType.PLANE_PUT: [
        ("alloc_id", "Q"),
        ("rank", "q"),
        ("device_index", "I"),
        ("ext_offset", "Q"),
        ("ext_nbytes", "Q"),
        ("offset", "Q"),
        ("nbytes", "Q"),
    ],
    MsgType.PLANE_GET: [
        ("alloc_id", "Q"),
        ("rank", "q"),
        ("device_index", "I"),
        ("ext_offset", "Q"),
        ("ext_nbytes", "Q"),
        ("offset", "Q"),
        ("nbytes", "Q"),
    ],
    # Owner-daemon -> plane: zero a recycled device extent at free time
    # (O(1) wire; the device twin of "host arms are scrubbed at free time
    # by the owner daemon"). Reply: DATA_PUT_OK.
    MsgType.PLANE_SCRUB: [
        ("alloc_id", "Q"),
        ("rank", "q"),
        ("device_index", "I"),
        ("ext_offset", "Q"),
        ("ext_nbytes", "Q"),
    ],
    # Resilience family (resilience/). "inc" is the sender's incarnation —
    # a random u64 minted per daemon object, so a DEAD verdict can fence
    # exactly the process it was issued against (a restarted daemon on the
    # same port carries a fresh incarnation and is never falsely fenced).
    MsgType.PING: [("rank", "q"), ("epoch", "Q"), ("inc", "Q")],
    MsgType.PING_OK: [("rank", "q"), ("epoch", "Q"), ("inc", "Q")],
    MsgType.SUSPECT_NODE: [("rank", "q"), ("reporter", "q"), ("epoch", "Q")],
    # "state" is the arbiter's PeerState verdict (resilience/detector.py
    # wire values: 0 ALIVE, 1 SUSPECT, 2 DEAD).
    MsgType.SUSPECT_OK: [("epoch", "Q"), ("state", "B")],
    MsgType.EPOCH_UPDATE: [("epoch", "Q"), ("dead_rank", "q"), ("inc", "Q")],
    MsgType.EPOCH_OK: [("epoch", "Q")],
    # "chain" is the ordered comma-separated owner chain "primary,r1,...";
    # every holder of a replicated allocation records it, so promotion on
    # a DEAD verdict is a deterministic local computation.
    MsgType.DO_REPLICA: [
        ("alloc_id", "Q"),
        ("kind", "B"),
        ("nbytes", "Q"),
        ("orig_rank", "q"),
        ("pid", "q"),
        ("chain", "s"),
        ("epoch", "Q"),
    ],
    MsgType.DO_REPLICA_OK: [("alloc_id", "Q"), ("offset", "Q")],
    MsgType.PROMOTE: [("dead_ranks", "s"), ("epoch", "Q")],
    # PROMOTE_OK carries a JSON data tail listing the allocations this
    # rank is now primary for that lost copies (re-replication work list).
    MsgType.PROMOTE_OK: [("count", "Q")],
    MsgType.RE_REPLICATE: [
        ("alloc_id", "Q"),
        ("target_rank", "q"),
        ("epoch", "Q"),
    ],
    MsgType.RE_REPLICATE_OK: [("alloc_id", "Q"), ("nbytes", "Q")],
    # shm fabric control (fabric/shm.py). Every leg names the SEGMENT
    # the client attached ("seg"): a daemon that restarted on the same
    # host:port serves a fresh segment under the same alloc_ids
    # (snapshot restore), and without the identity check it would bless
    # a memcpy that landed in the dead daemon's orphaned mapping. A
    # mismatch answers STALE_EPOCH — the failover signal — so the
    # client re-negotiates instead of trusting the stale region.
    # SHM_PUT/SHM_GET additionally carry the ext_offset the client's
    # cached mapping used, so the owner can refuse a STALE mapping
    # (extent freed and recycled since SHM_MAP) with BAD_ALLOC_ID
    # instead of blessing a write that landed on the wrong tenant's
    # bytes. "offset" is handle-relative, as on DATA_*. Replies:
    # SHM_PUT -> DATA_PUT_OK, SHM_GET -> DATA_GET_OK (the get reply
    # carries NO payload — the client copies from the segment after
    # the validation lands).
    MsgType.SHM_MAP: [("alloc_id", "Q"), ("seg", "s")],
    MsgType.SHM_MAP_OK: [
        ("alloc_id", "Q"),
        ("ext_offset", "Q"),
        ("ext_nbytes", "Q"),
    ],
    MsgType.SHM_PUT: [
        ("alloc_id", "Q"),
        ("ext_offset", "Q"),
        ("offset", "Q"),
        ("nbytes", "Q"),
        ("seg", "s"),
    ],
    MsgType.SHM_GET: [
        ("alloc_id", "Q"),
        ("ext_offset", "Q"),
        ("offset", "Q"),
        ("nbytes", "Q"),
        ("seg", "s"),
    ],
    # Elastic membership (elastic/). REQ_JOIN announces the joiner's
    # peer-reachable address, capacities and incarnation (the same
    # triple ADD_NODE carries, plus "inc" so rank 0 can tell a restarted
    # daemon on a reused address from a duplicate). JOIN_OK and
    # MEMBER_UPDATE carry the full epoch-stamped member table as a JSON
    # data tail (membership.ClusterView.to_wire) — a table, not fixed
    # fields, because the row count changes by definition.
    MsgType.REQ_JOIN: [
        ("host", "s"),
        ("port", "I"),
        ("ndevices", "I"),
        ("device_arena_bytes", "Q"),
        ("host_arena_bytes", "Q"),
        ("inc", "Q"),
    ],
    MsgType.JOIN_OK: [("rank", "q"), ("epoch", "Q"), ("nnodes", "q")],
    MsgType.REQ_LEAVE: [("rank", "q"), ("inc", "Q")],
    MsgType.LEAVE_OK: [("epoch", "Q"), ("moved", "Q")],
    MsgType.MEMBER_UPDATE: [("epoch", "Q")],
    MsgType.MEMBER_OK: [("epoch", "Q")],
    # Live migration: rank 0's rebalancer drives MIGRATE at the source
    # primary, which runs the provision -> stream -> flip -> drop-source
    # state machine (daemon._on_migrate). MIGRATE_BEGIN provisions the
    # target's copy QUARANTINED (refuses client ops, aborted if the
    # source dies mid-stream) under the source's chain + itself;
    # "src_rank" is the abort key. Replies with DO_REPLICA_OK.
    MsgType.MIGRATE: [
        ("alloc_id", "Q"),
        ("target_rank", "q"),
        ("epoch", "Q"),
    ],
    MsgType.MIGRATE_OK: [("alloc_id", "Q"), ("nbytes", "Q")],
    MsgType.MIGRATE_BEGIN: [
        ("alloc_id", "Q"),
        ("kind", "B"),
        ("nbytes", "Q"),
        ("orig_rank", "q"),
        ("pid", "q"),
        ("chain", "s"),
        ("src_rank", "q"),
        ("epoch", "Q"),
    ],
    # Handle re-resolution: a client whose ladder dead-ends (owner
    # migrated away, maybe departed entirely) asks rank 0 where the
    # allocation lives now. The reply names the primary's address
    # explicitly — the rank may postdate the client's boot membership.
    MsgType.REQ_LOCATE: [("alloc_id", "Q")],
    MsgType.LOCATE_OK: [
        ("alloc_id", "Q"),
        ("rank", "q"),
        ("host", "s"),
        ("port", "I"),
        ("chain", "s"),
    ],
    # Rebalancer inventory: the member's host-kind registry entries as a
    # JSON data tail (id, nbytes, chain, priority, origin) — what the
    # capacity-weighted planner and the LEAVE drain walk.
    MsgType.REQ_EXTENTS: [],
    MsgType.EXTENTS_OK: [("rank", "q"), ("count", "Q")],
    # Decentralized control plane (control/leader.py). MASTER_STATE's
    # data tail is the leader's replicated coordination state (placement
    # accounting, member view, dead set) as JSON with a trailing CRC32 —
    # the snapshot-v2 discipline, so a standby can refuse a torn copy
    # WHOLE instead of leading from it. "seq" is the push sequence
    # (monotonic per leader incarnation); stale pushes are dropped.
    MsgType.MASTER_STATE: [("seq", "Q"), ("epoch", "Q"), ("leader", "q")],
    MsgType.MASTER_STATE_OK: [("seq", "Q")],
    # LEADER_UPDATE: the election/handoff broadcast. "dead_rank"/"inc"
    # fence the deposed leader by (rank, incarnation) exactly like
    # EPOCH_UPDATE fences a dead owner; dead_rank -1 marks a voluntary
    # handoff (nobody is fenced). Receivers adopt the leader, evict the
    # dead leader's pooled connections, and re-aim master-bound traffic.
    MsgType.LEADER_UPDATE: [
        ("leader", "q"),
        ("epoch", "Q"),
        ("dead_rank", "q"),
        ("inc", "Q"),
    ],
    MsgType.LEADER_OK: [("epoch", "Q")],
    MsgType.LEADER_HANDOFF: [
        ("leader", "q"),
        ("epoch", "Q"),
        ("from_rank", "q"),
        ("inc", "Q"),
    ],
    # Server-side cancellation: "tag" is the VICTIM op's mux correlation
    # id on this same connection. "revoked" on the ack: 1 when the
    # daemon actually revoked something (queued op skipped, or a
    # completed op's reply suppressed), 0 when the tag was unknown /
    # already answered / an inline data leg past the point of no return.
    MsgType.CANCEL: [("tag", "I")],
    MsgType.CANCEL_OK: [("tag", "I"), ("revoked", "B")],
    MsgType.ERROR: [("code", "I"), ("detail", "s")],
}


class ErrCode(enum.IntEnum):
    UNKNOWN = 0
    OOM = 1
    BAD_ALLOC_ID = 2
    BOUNDS = 3
    BAD_MSG = 4
    PLACEMENT = 5
    # A master-bound message (ADD_NODE, REQ_JOIN, SUSPECT_NODE, ...)
    # reached a daemon that is not the current leader. Once leadership
    # is dynamic (control/: OCM_STANDBY_MASTERS > 0, or the leader ever
    # moved off rank 0) the ERROR frame's data tail names the CURRENT
    # leader — i64 rank, then host (u16-length string) + u32 port —
    # which request() surfaces as OcmRemoteError.leader_rank /
    # .leader_addr so senders re-aim instead of spinning (the MOVED
    # redirect pattern applied to the master role). Static clusters
    # ship the tail-less pre-leadership frame.
    NOT_MASTER = 6
    # The serving daemon was fenced by a newer cluster epoch (a DEAD
    # verdict it outlived): it must not serve data or grant extents, and
    # clients treat this as a failover signal, retrying via the replica
    # chain instead of surfacing an application error.
    STALE_EPOCH = 7
    # A replica refused a CLIENT data op because it still believes its
    # primary alive (accepting would fork the copies). Retryable: the
    # client re-walks its failover ladder — by the time the primary's
    # death verdict lands, the replica starts serving.
    NOT_PRIMARY = 8
    # A primary could not reach a replica that is not (yet) declared
    # DEAD, so it cannot honor the replication contract for this write.
    # Retryable: the detector resolves the replica's fate within a few
    # probe intervals, after which the put either fans out or degrades.
    REPLICA_UNAVAILABLE = 9
    # QoS admission control (qos/): the app's byte or handle quota
    # cannot admit this allocation. Not retryable until the app frees —
    # the quota is the app's own budget, not a transient condition.
    QUOTA_EXCEEDED = 10
    # Admission control refused the app outright (e.g. the daemon's
    # concurrent-app cap is reached). Retrying only helps once other
    # apps disconnect or go stale.
    ADMISSION_DENIED = 11
    # Back-pressure: the arena(s) crossed the high watermark. Retryable;
    # the ERROR frame's data tail carries a u32 server-suggested backoff
    # in milliseconds, which request() surfaces as
    # OcmRemoteError.retry_after_ms.
    BUSY = 12
    # Live migration (elastic/): the allocation was migrated off this
    # rank; the data tail carries the new owner rank as an i64, which
    # request() surfaces as OcmRemoteError.moved_to_rank. Retryable by
    # definition — the client repoints its handle at the named rank and
    # re-runs, exactly the failover-ladder contract.
    MOVED = 13
    # Time budget (resilience/timebudget.py): the op's propagated
    # deadline expired before (or while) this daemon could serve it —
    # "The Tail at Scale"'s fail-fast contract. NOT retryable: the
    # budget is the caller's own clock, and every retry ladder must
    # surface it typed instead of burning the remaining window.
    DEADLINE_EXCEEDED = 14


# Precompiled one-shot codecs for string-free schemas: the per-frame
# encode/decode is the control-plane hot path (a mux channel moves
# thousands of tiny frames per second), and compiling a struct.Struct
# per FIELD per frame dominated it. Filled after _SCHEMAS below.
_FIXED_CODEC: dict["MsgType", tuple[struct.Struct, tuple[str, ...]]] = {}


def _pack_prefix(msg: Message) -> bytes:
    """Header + encoded fields ONLY (the frame length still counts
    msg.data) — shared by pack() and send_msg's scatter-gather fast path
    so the wire encoding has exactly one implementation (protocol.cc's
    pack_prefix twin)."""
    if msg.type not in _SCHEMAS:
        raise OcmProtocolError(f"no schema for {msg.type}")
    if msg.flags & ~_valid_flags(msg.type):
        raise OcmProtocolError(
            f"flags {msg.flags:#x} invalid for {msg.type.name} "
            f"(allowed mask {_valid_flags(msg.type):#x})"
        )
    fixed = _FIXED_CODEC.get(msg.type)
    if fixed is not None:
        st, names = fixed
        f = msg.fields
        try:
            fields = st.pack(*(f[n] for n in names))
        except (KeyError, struct.error) as e:
            raise OcmProtocolError(
                f"bad {msg.type.name} fields: {e}"
            ) from e
        plen = st.size + _data_len(msg.data)
        if plen > MAX_PAYLOAD:
            raise OcmProtocolError(f"payload {plen} exceeds cap")
        return HEADER.pack(
            MAGIC, VERSION, int(msg.type), msg.flags, plen
        ) + fields
    schema = _SCHEMAS[msg.type]
    fields = bytearray()
    for name, fmt in schema:
        v = msg.fields[name]
        if fmt == "s":
            fields += _pack_str(v)
        else:
            fields += struct.pack("<" + fmt, v)
    plen = len(fields) + _data_len(msg.data)
    if plen > MAX_PAYLOAD:
        raise OcmProtocolError(f"payload {plen} exceeds cap")
    return HEADER.pack(MAGIC, VERSION, int(msg.type), msg.flags, plen) + fields


def pack(msg: Message) -> bytes:
    return _pack_prefix(msg) + b"".join(
        bytes(p) for p in _data_parts(msg.data)
    )


def _parse_fields(mtype: MsgType, payload) -> tuple[dict, int]:
    """Parse the schema'd fields; returns (fields, data offset). The
    payload is untrusted wire input: truncated fields and invalid UTF-8
    must surface as protocol errors, not struct/unicode internals."""
    fixed = _FIXED_CODEC.get(mtype)
    if fixed is not None:
        st, names = fixed
        try:
            values = st.unpack_from(payload, 0)
        except struct.error as e:
            raise OcmProtocolError(
                f"malformed {mtype.name} payload: {e}"
            ) from e
        return dict(zip(names, values)), st.size
    schema = _SCHEMAS[mtype]
    fields: dict = {}
    off = 0
    try:
        for name, fmt in schema:
            if fmt == "s":
                fields[name], off = _unpack_str(payload, off)
            else:
                st = struct.Struct("<" + fmt)
                (fields[name],) = st.unpack_from(payload, off)
                off += st.size
    except (struct.error, UnicodeDecodeError) as e:
        raise OcmProtocolError(
            f"malformed {mtype.name} payload: {e}"
        ) from e
    return fields, off


def _unpack_fields(mtype: MsgType, fields_buf) -> Message:
    fields, _ = _parse_fields(mtype, fields_buf)
    return Message(mtype, fields, b"")


def unpack(header: bytes, payload: bytes) -> Message:
    try:
        magic, version, mtype, flags, plen = HEADER.unpack(header)
    except struct.error as e:
        raise OcmProtocolError(f"short header: {e}") from e
    if magic != MAGIC:
        raise OcmProtocolError(f"bad magic {magic!r}")
    if version != VERSION:
        raise OcmProtocolError(f"unsupported protocol version {version}")
    if plen != len(payload):
        raise OcmProtocolError("length mismatch")
    try:
        mtype = MsgType(mtype)
    except ValueError as e:
        raise OcmProtocolError(f"unknown message type {mtype}") from e
    fields, off = _parse_fields(mtype, payload)
    # Bulk payloads stay a zero-copy view into the receive buffer (an
    # 8 MiB DATA_PUT chunk would otherwise be copied once more here);
    # small ones become plain bytes, the friendliest type for callers.
    n_data = len(payload) - off
    data = (
        memoryview(payload)[off:] if n_data >= (64 << 10)
        else bytes(payload[off:])
    )
    # Receivers are TOLERANT of unknown flag bits (only senders validate):
    # the bits are exposed as-is and handlers act on the ones they know.
    return Message(mtype, fields, data, flags=flags)


# -- blocking socket transport (conn_put/conn_get analogue, sock.c:215-253) --


def _sendall_vec(sock: socket.socket, parts: list) -> None:
    """sendall over a list of buffers WITHOUT concatenating them — the
    bulk-data fast path (a DATA_PUT frame is header+fields plus an 8 MiB
    payload; building one contiguous frame copies the payload twice)."""
    views = [memoryview(p) for p in parts if len(p)]
    while views:
        sent = sock.sendmsg(views)
        while views and sent >= len(views[0]):
            sent -= len(views[0])
            views.pop(0)
        if views and sent:
            views[0] = views[0][sent:]


def send_msg(sock: socket.socket, msg: Message) -> None:
    prefix = _pack_prefix(msg)
    n_data = _data_len(msg.data)
    if n_data >= (64 << 10):
        _sendall_vec(sock, [prefix, *_data_parts(msg.data)])
    elif n_data:
        sock.sendall(
            prefix + b"".join(bytes(p) for p in _data_parts(msg.data))
        )
    else:
        sock.sendall(prefix)


def _recv_into(sock: socket.socket, view: memoryview,
               eof_ok: bool = False) -> bool:
    """Fill ``view`` exactly. ``eof_ok`` permits a clean EOF *before the
    first byte* (returns False) — EOF mid-message always raises."""
    n = len(view)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], min(n - got, 1 << 20))
        if r == 0:
            if eof_ok and got == 0:
                return False
            raise OcmProtocolError("peer closed mid-message")
        got += r
    return True


def _recv_exact(sock: socket.socket, n: int, eof_ok: bool = False):
    """Read exactly n bytes into one fresh buffer (no chunk-list join)."""
    buf = bytearray(n)
    if not _recv_into(sock, memoryview(buf), eof_ok=eof_ok):
        return b""
    return buf


class BufferedSock:
    """Read-side buffering shim over a connected socket: ``recv_into``
    is served from an internal buffer refilled by large kernel reads —
    one recv syscall per ~64 KiB of small frames instead of 2-3 per
    frame (header, fields, payload). The small-op serving hot path (mux
    channels pipeline thousands of tiny tagged requests per second onto
    one connection) is syscall-bound without this. Bulk reads bypass the
    buffer whenever it is empty, so large DATA_PUT payloads keep their
    single recv-into-arena landing. The send side is untouched — pass
    the REAL socket to send_msg."""

    __slots__ = ("sock", "_buf", "_pos")

    CAP = 64 << 10

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._buf = b""
        self._pos = 0

    def buffered(self) -> int:
        """Bytes already read off the kernel but not yet consumed — the
        serve loop's "more requests are in hand" signal (reply batching
        flushes only once this drains, so pipelined peers get one
        writev per burst of replies)."""
        return len(self._buf) - self._pos

    def recv_into(self, view, nbytes: int = 0) -> int:
        n = nbytes or len(view)
        avail = len(self._buf) - self._pos
        if avail > 0:
            take = min(avail, n)
            view[:take] = memoryview(self._buf)[self._pos:self._pos + take]
            self._pos += take
            return take
        if n >= self.CAP:
            # Bulk payload with an empty buffer: straight into the
            # caller's destination (the zero-copy landing).
            return self.sock.recv_into(view, n)
        data = self.sock.recv(self.CAP)
        if not data:
            return 0
        take = min(len(data), n)
        view[:take] = memoryview(data)[:take]
        if take < len(data):
            self._buf = data
            self._pos = take
        else:
            self._buf = b""
            self._pos = 0
        return take


class RecvScratch:
    """Reusable receive buffer for the data-plane hot loops: a fresh
    bytearray per 8 MiB reply chunk costs an allocation + kernel zeroing
    each time. A payload decoded into scratch is a VIEW valid only until
    the next recv on the same socket — use only where the message is
    fully consumed before the next receive (the pipelined client loop,
    the daemon serve loop)."""

    __slots__ = ("buf",)

    def __init__(self) -> None:
        self.buf = bytearray()

    def get(self, n: int) -> memoryview:
        if len(self.buf) < n:
            self.buf = bytearray(max(n, 2 * len(self.buf)))
        elif len(self.buf) > (32 << 20) and n < len(self.buf) // 4:
            # Don't pin a burst's high-water buffer on a long-lived
            # connection that went back to small messages.
            self.buf = bytearray(n)
        return memoryview(self.buf)[:n]


# Encoded size of each type's fields when the schema is fixed-width
# (absent when it contains strings): lets recv_msg land a bulk payload's
# data STRAIGHT in the caller's destination buffer.
_FIXED_FIELD_SIZE: dict[MsgType, int] = {
    t: sum(struct.calcsize("<" + fmt) for _, fmt in schema)
    for t, schema in _SCHEMAS.items()
    if all(fmt != "s" for _, fmt in schema)
}

# One precompiled Struct + field-name tuple per string-free schema (the
# hot-path codec _pack_prefix/_parse_fields dispatch through).
_FIXED_CODEC.update({
    t: (
        struct.Struct("<" + "".join(fmt for _, fmt in schema)),
        tuple(name for name, _ in schema),
    )
    for t, schema in _SCHEMAS.items()
    if schema and all(fmt != "s" for _, fmt in schema)
})


def recv_msg(
    sock: socket.socket,
    scratch: RecvScratch | None = None,
    data_into: memoryview | None = None,
    data_router=None,
) -> Message:
    """Receive one message. With ``data_into`` (pipelined readers that
    know the expected reply), a fixed-field message whose data length
    matches lands its payload DIRECTLY in that buffer — ``Message.data``
    IS ``data_into`` then (identity-comparable by the caller); any other
    message (an ERROR reply, a length mismatch) falls back to the normal
    path untouched.

    ``data_router`` is the server-side twin for readers that DON'T know
    what arrives next: called as ``data_router(msg, n_data)`` after the
    fixed fields of a bulk message are decoded (but before its payload is
    read), it may return a writable memoryview of exactly ``n_data``
    bytes to land the payload into (e.g. the destination arena extent of
    a DATA_PUT — the recv IS the write, no scratch hop, no copy). The
    returned message then has ``data_landed = True`` set on it. Any
    ``None``/mis-sized return or router exception falls back to the
    scratch path; string-schema'd types bypass routing entirely."""
    header = _recv_exact(sock, HEADER.size, eof_ok=True)
    if not header:
        # Clean disconnect at a frame boundary — ordinary, not an anomaly.
        raise OcmProtocolError("peer closed")
    magic, version, mtype_raw, flags, plen = HEADER.unpack(header)
    if plen > MAX_PAYLOAD:
        raise OcmProtocolError(f"advertised payload {plen} exceeds cap")
    if data_into is not None and magic == MAGIC and version == VERSION:
        # Magic/version checked HERE (the normal path does it in unpack):
        # a corrupt or wrong-version frame must raise, never land bytes
        # in the caller's buffer.
        try:
            mt = MsgType(mtype_raw)
            ffix = _FIXED_FIELD_SIZE.get(mt)
        except ValueError:
            ffix = None  # unknown type: let unpack raise the real error
        if ffix is not None and plen - ffix == len(data_into):
            fields = _recv_exact(sock, ffix) if ffix else b""
            _recv_into(sock, data_into)
            msg = _unpack_fields(mt, fields)
            msg.data = data_into
            msg.flags = flags
            return msg
    if data_router is not None and magic == MAGIC and version == VERSION:
        try:
            mt = MsgType(mtype_raw)
            ffix = _FIXED_FIELD_SIZE.get(mt)
        except ValueError:
            ffix = None  # unknown type: let unpack raise the real error
        if ffix is not None and plen >= ffix:
            fields_buf = _recv_exact(sock, ffix) if ffix else b""
            msg = _unpack_fields(mt, fields_buf)
            msg.flags = flags
            n_data = plen - ffix
            if n_data == 0:
                return msg
            sink = None
            try:
                sink = data_router(msg, n_data)
            except Exception:  # noqa: BLE001 — routing is best-effort;
                sink = None  # the handler re-raises the real error later
            if sink is not None and len(sink) == n_data:
                _recv_into(sock, sink)
                msg.data = sink
                msg.data_landed = True
                return msg
            if scratch is not None and n_data >= (64 << 10):
                payload = scratch.get(n_data)
                _recv_into(sock, payload)
                msg.data = payload
            else:
                msg.data = bytes(_recv_exact(sock, n_data))
            return msg
    if plen == 0:
        payload = b""
    elif scratch is not None and plen >= (64 << 10):
        payload = scratch.get(plen)
        _recv_into(sock, payload)
    else:
        payload = _recv_exact(sock, plen)
    return unpack(header, payload)


def remote_error(reply: Message) -> OcmRemoteError:
    """Build the typed OcmRemoteError for an ERROR reply, including the
    code-specific data tails — a BUSY retry hint (u32 ms) and a MOVED
    live-migration redirect (i64 new owner rank). EVERY path that turns
    an ERROR frame into an exception must come through here: an error
    built from code+detail alone silently drops the redirect, and the
    client ladder then spins on the old owner instead of following it."""
    code = reply.fields["code"]
    detail = reply.fields["detail"]
    if code in ErrCode._value2member_map_:
        detail = f"{ErrCode(code).name}: {detail}"
    err = OcmRemoteError(code, detail)
    # A BUSY rejection carries the server-suggested backoff as a u32
    # (milliseconds) data tail — the retry hint back-pressured clients
    # honor (qos/). A MOVED rejection names the new owner rank as an
    # i64 tail (elastic/). Other codes never carry one; a short or
    # absent tail just means "no hint".
    if code == int(ErrCode.BUSY) and len(reply.data) >= 4:
        (err.retry_after_ms,) = struct.unpack_from("<I", reply.data, 0)
    if code == int(ErrCode.MOVED) and len(reply.data) >= 8:
        (err.moved_to_rank,) = struct.unpack_from("<q", reply.data, 0)
    if code == int(ErrCode.STALE_EPOCH) and len(reply.data) >= 16:
        # A PING answered with a DEAD verdict carries the verdict
        # holder's authority as a (leader_epoch u64, epoch u64) tail:
        # the probing daemon fences itself only when that authority
        # exceeds its own — a deposed leader's stale claim must never
        # fence a survivor (control/).
        (err.verdict_leader_epoch, err.verdict_epoch) = struct.unpack_from(
            "<QQ", reply.data, 0
        )
    if code == int(ErrCode.NOT_MASTER) and len(reply.data) >= 8:
        # Leader redirect (control/): rank, then optionally the leader's
        # explicit address (a joiner bounced off a non-leader seed has
        # no member table to resolve the rank through).
        (err.leader_rank,) = struct.unpack_from("<q", reply.data, 0)
        err.leader_addr = None
        try:
            host, off = _unpack_str(reply.data, 8)
            (port,) = struct.unpack_from("<I", reply.data, off)
            if host and port:
                err.leader_addr = (host, port)
        except (OcmProtocolError, struct.error):
            pass  # rank-only tail from a terser sender
    return err


# -- mux correlation tags (runtime/mux.py) -------------------------------

_TAG = struct.Struct("<I")
TAG_BYTES = _TAG.size  # 4


def attach_tag(msg: Message, tag: int) -> Message:
    """Prefix ``msg``'s data tail with a u32 correlation id and set
    FLAG_MUX_TAG — in place; returns ``msg`` for chaining. The caller has
    already checked the peer granted FLAG_CAP_MUX. The tag goes OUTSIDE
    any trace-context prefix (obs/trace.attach runs first; receivers
    strip tag, then trace). A bulk payload becomes the vectored
    ``[tag, payload]`` form send_msg scatter-gathers — never a
    concatenating copy of the payload."""
    msg.flags |= FLAG_MUX_TAG
    head = _TAG.pack(tag)
    if isinstance(msg.data, (list, tuple)):
        msg.data = [head, *msg.data]
    elif len(msg.data) >= 4096:
        msg.data = [head, msg.data]
    else:
        msg.data = head + bytes(msg.data) if len(msg.data) else head
    return msg


def split_tag(data) -> tuple[int | None, object]:
    """Strip the u32 correlation id off a data tail. A tail shorter than
    the tag is malformed-but-tolerated (receivers must not die on a
    confused peer): returns (None, data) unchanged. The rest comes back
    as a VIEW (no payload copy — this runs per tagged frame on both
    sides); every consumer treats Message.data as a read-only buffer
    already."""
    if len(data) < TAG_BYTES:
        return None, data
    tag = _TAG.unpack_from(data, 0)[0]
    rest = (data if isinstance(data, memoryview)
            else memoryview(data))[TAG_BYTES:]
    return tag, rest


def pack_leader_tail(rank: int, host: str, port: int) -> bytes:
    """The NOT_MASTER redirect tail: current leader rank + address.
    Parsed back by :func:`remote_error` into ``leader_rank`` /
    ``leader_addr``; old peers ignore trailing data on ERROR frames."""
    return struct.pack("<q", rank) + _pack_str(host) + struct.pack("<I", port)


def request(sock: socket.socket, msg: Message) -> Message:
    """Send and await the reply (``send_recv_msg`` analogue, mem.c:63-88).
    An ERROR reply raises :class:`OcmRemoteError` — the connection stays in
    sync and reusable, unlike transport-level OcmProtocolError."""
    send_msg(sock, msg)
    reply = recv_msg(sock)
    if reply.type == MsgType.ERROR:
        raise remote_error(reply)
    return reply
