"""Async multiplexed client runtime — one connection per peer, tagged
request pipelining, thousands of tenants per process.

The port's copy of ``oncilla_tpu/runtime/mux.py``, line for line, with
the imports renamed to the port's modules. Two things differ, both where a
tensor meets the wire: :meth:`AsyncOcm.put` takes a host tensor (or any
array) as flat bytes and refuses a card tensor, and :meth:`AsyncOcm.get`
lands in a host tensor or array and returns a CPU tensor. The event loop
never touches ``torch.cuda``: the sync facade (``runtime/client.py``)
stages a card tensor through pinned memory on the caller's thread before
it submits the transfer, and copies a get up to the card after the
transfer's future resolved. The runtime is this package's own: its
process-shared loop, channels and chaos hook (the port's ``pool``) are
never the JAX package's.

The reference OncillaMem library is a synchronous per-request client
(``send_recv_msg``, reference src/mem.c:63-88); our client
inherited that shape and pays one socket per (tenant × stripe) plus a
full lockstep round trip per small op. This module rebuilds the client
data plane on an asyncio core:

- **MuxChannel** — ONE connection to one peer daemon. At CONNECT it
  offers ``FLAG_CAP_MUX``; once granted, every request carries a u32
  correlation id (``FLAG_MUX_TAG``, the first 4 bytes of the data tail,
  outside any trace prefix) and a response demultiplexer matches
  replies to waiters regardless of completion order — the daemon may
  finish control ops out of order. Un-upgraded peers (old Python
  daemons, the native C++ daemon) decline by silence and are served
  LOCKSTEP over the same single connection: one request in flight,
  plain frames, wire-identical to the pre-mux protocol.
- **small-op batching** — senders enqueue packed frames; a single writer
  task drains the queue with one ``writelines`` per wakeup, so adjacent
  control ops from different tenants coalesce into one syscall (the
  writev discipline).
- **per-peer in-flight window** — an asyncio semaphore
  (``OCM_MUX_WINDOW``) bounds outstanding tagged requests, exactly as
  ``inflight_ops`` bounds a pipelined transfer.
- **MuxRuntime** — the sync facade: a background thread runs the event
  loop; ``ControlPlaneClient`` (and with it the unchanged sync ``Ocm``)
  drives the same channels via ``run_coroutine_threadsafe``, and tenant
  heartbeats become loop-scheduled tasks instead of one thread each.
- **AsyncOcm** — the ``async``/``await`` public API (alloc / put / get /
  free / status) on the caller's own event loop.

Large transfers ride the channel too: a coalesced ``FLAG_MORE`` burst is
enqueued as ONE atomic batch (no foreign frame can interleave inside an
open burst), tagged only on its closing chunk; gets issue windowed
tagged chunks whose replies land by tag into disjoint views of the
destination. Failover keeps the established ladder semantics: transport
errors and retryable typed rejections (STALE_EPOCH / NOT_PRIMARY /
MOVED / REPLICA_UNAVAILABLE) surface as the same exception types the
sync engine's ladder already climbs.
"""

from __future__ import annotations

import asyncio
import os
import threading
import time

import torch

from oncilla_tpu_torch.analysis import alloctrace
from oncilla_tpu_torch.analysis.lockwatch import make_lock
from oncilla_tpu_torch.core.arena import Extent
from oncilla_tpu_torch.core.errors import (
    OcmConnectError,
    OcmDeadlineExceeded,
    OcmError,
    OcmProtocolError,
    OcmRemoteError,
)
from oncilla_tpu_torch.core.handle import OcmAlloc
from oncilla_tpu_torch.core.kinds import Fabric, OcmKind
from oncilla_tpu_torch.obs import journal as obs_journal
from oncilla_tpu_torch.obs import trace as obs_trace
from oncilla_tpu_torch.resilience import timebudget
from oncilla_tpu_torch.runtime import pool as peer_pool
from oncilla_tpu_torch.runtime.protocol import (
    FLAG_CAP_COALESCE,
    FLAG_CAP_DEADLINE,
    FLAG_CAP_MUX,
    FLAG_CAP_QOS,
    FLAG_CAP_REPLICA,
    FLAG_CAP_TRACE,
    FLAG_DEADLINE,
    FLAG_MORE,
    FLAG_MUX_TAG,
    FLAG_QOS_TAIL,
    FLAG_REPLICAS,
    FLAG_TRACE_CTX,
    HEADER,
    MAGIC,
    MAX_PAYLOAD,
    VALID_FLAGS,
    VERSION,
    WIRE_KIND,
    WIRE_KIND_INV,
    ErrCode,
    Message,
    MsgType,
    _data_parts,
    _pack_prefix,
    attach_tag,
    remote_error,
    split_tag,
    unpack,
)
from oncilla_tpu_torch.utils.debug import GLOBAL_TRACER, printd

Addr = tuple[str, int]

# Capability bits a tenant-level CONNECT may carry back (the same mask
# the blocking client stores as _ctrl_caps).
TENANT_CAPS = (FLAG_CAP_TRACE | FLAG_CAP_REPLICA | FLAG_CAP_QOS
               | FLAG_CAP_DEADLINE)

# Bound on the orphan-tag tombstone set: a SILENT peer (one that never
# answers, never errors, never closes) used to grow _orphans by one tag
# per abandoned waiter forever. Past the cap the OLDEST tombstone is
# dropped — if that peer later answers a tag this old, the demux treats
# it as unmatched and tears the channel down, which is the correct
# outcome for a connection thousands of replies behind.
ORPHAN_CAP = 1024


def _chaos_gate(addr: Addr) -> None:
    """The pool's chaos seam, honored at channel dials and data-plane
    transfers (the pool-lease analogues — ctrl ops and heartbeats never
    leased either) so the deterministic fault injector (drop / partition
    / scheduled kill at a logical op index) keeps working when the mux
    path bypasses PeerPool.lease entirely."""
    hook = peer_pool.current_chaos_hook()
    if hook is not None:
        try:
            hook(addr[0], addr[1])
        except OSError as e:
            raise OcmConnectError(
                f"peer {addr[0]}:{addr[1]} unreachable: {e}"
            ) from e


def _host_array(data, writable: bool = False):
    """``data`` as flat uint8 host bytes, a view where it can be: a host
    tensor, a numpy array or a bytes-like. A card tensor is refused: the
    loop thread never touches the card (stage through pinned memory on
    the caller's thread, as the sync client does)."""
    import numpy as np

    if isinstance(data, torch.Tensor):
        if data.device.type != "cpu":
            raise OcmError(
                "AsyncOcm moves host bytes; copy a card tensor to a "
                "(pinned) host tensor on the caller's thread first"
            )
        if writable and not data.is_contiguous():
            raise ValueError("out must be a contiguous tensor")
        data = data.contiguous().reshape(-1).view(torch.uint8).numpy()
    if writable:
        if (data.dtype != np.uint8 or not data.flags.c_contiguous
                or not data.flags.writeable):
            raise ValueError(
                "out must be a writable C-contiguous uint8 array")
        return data.reshape(-1)
    return np.ascontiguousarray(np.asarray(data)).view(np.uint8).reshape(-1)


def _frame_parts(msg: Message) -> list:
    """Packed frame as a scatter-gather part list (prefix + data parts):
    bulk payloads stay views of the caller's buffer all the way into the
    transport (the sender awaits the reply, so the buffer outlives the
    write)."""
    return [_pack_prefix(msg), *(p for p in _data_parts(msg.data)
                                 if len(p))]


class _MuxProtocol(asyncio.Protocol):
    """Transport glue for one MuxChannel: an incremental frame parser in
    ``data_received`` (no stream-reader task, no readexactly wakeups —
    every complete frame demuxes synchronously in the receive callback)
    and write-side flow-control callbacks. The channel owns all state;
    this class is deliberately dumb."""

    def __init__(self, ch: "MuxChannel") -> None:
        self.ch = ch
        self._buf = bytearray()

    def connection_made(self, transport) -> None:
        sock = transport.get_extra_info("socket")
        if sock is not None:
            import socket as _s

            try:
                sock.setsockopt(_s.IPPROTO_TCP, _s.TCP_NODELAY, 1)
                for opt in (_s.SO_SNDBUF, _s.SO_RCVBUF):
                    sock.setsockopt(_s.SOL_SOCKET, opt, 4 << 20)
            except OSError:
                pass

    def data_received(self, data: bytes) -> None:
        buf = self._buf
        buf += data
        pos = 0
        end = len(buf)
        hsize = HEADER.size
        try:
            while end - pos >= hsize:
                magic, version, _mt, _fl, plen = HEADER.unpack_from(buf, pos)
                if magic != MAGIC or version != VERSION:
                    raise OcmProtocolError(
                        f"bad frame header {bytes(buf[pos:pos + hsize])!r}"
                    )
                if plen > MAX_PAYLOAD:
                    raise OcmProtocolError(
                        f"advertised payload {plen} exceeds cap"
                    )
                if end - pos - hsize < plen:
                    break
                msg = unpack(
                    bytes(buf[pos:pos + hsize]),
                    bytes(buf[pos + hsize:pos + hsize + plen]),
                )
                pos += hsize + plen
                self.ch._on_frame(msg)
        except OcmError as e:
            self.ch._fail(e)
            return
        if pos:
            del buf[:pos]

    def pause_writing(self) -> None:
        self.ch._write_paused = True

    def resume_writing(self) -> None:
        self.ch._write_paused = False
        waiter = self.ch._drain_waiter
        if waiter is not None and not waiter.done():
            waiter.set_result(None)

    def connection_lost(self, exc) -> None:
        self.ch._fail(exc or OcmConnectError("peer closed"))


class MuxChannel:
    """One multiplexed connection to one peer daemon. Loop-confined: all
    methods run on the event loop that opened it."""

    def __init__(self, loop: asyncio.AbstractEventLoop, addr: Addr,
                 config) -> None:
        self.addr = addr
        self.config = config
        self._loop = loop
        self._transport = None
        self.caps = 0
        self.peer_rank: int | None = None
        self._tag = 0
        self._pending: dict[int, asyncio.Future] = {}
        # Tags whose waiter gave up (cancelled heartbeat task, timed-out
        # sync bridge) before the reply arrived: the demux must DISCARD
        # the orphan reply once instead of treating it as unmatched —
        # which would tear the shared channel down for every tenant.
        # A dict-as-ordered-set, BOUNDED at ORPHAN_CAP (a mute peer must
        # not grow it forever) and reclaimed when the peer acks the
        # CANCEL we send for each abandoned tag (a revoked op's reply
        # is suppressed server-side, so the tombstone has nothing left
        # to absorb).
        self._orphans: dict[int, None] = {}
        # Peer answered CANCEL with typed BAD_MSG (an un-upgraded or
        # native daemon): stop sending cancels on this channel.
        self._no_cancel = False
        # Strong refs to in-flight cancel-collect tasks: the loop keeps
        # only a weak reference, so an unreferenced task can be GC'd
        # mid-flight and the revocation silently dropped.
        self._cancel_tasks: set[asyncio.Task] = set()
        # In-flight window as a raw credit counter: an asyncio.Semaphore
        # costs a few µs per acquire/release even uncontended, and this
        # sits on every tagged request. Waiters queue only at saturation.
        self._credits = config.mux_window
        self._credit_waiters: list[asyncio.Future] = []
        self._lockstep_mu = asyncio.Lock()
        # Batched sends: frames enqueue here; one call_soon-scheduled
        # flush per loop beat hands the whole batch to the transport in
        # one writelines — the writev discipline, with zero writer task.
        self._sendq: list = []
        self._write_paused = False
        self._drain_waiter: asyncio.Future | None = None
        # Lockstep mode (peer declined mux): the single outstanding
        # reply's future — _on_frame resolves it instead of demuxing.
        self._ls_waiter: asyncio.Future | None = None
        self._dead: BaseException | None = None
        self.counters = {
            "ops": 0, "batches": 0, "frames": 0,
            "inflight": 0, "peak_inflight": 0, "lockstep": 0,
            "cancels": 0, "cancels_revoked": 0, "orphans_dropped": 0,
        }

    # -- lifecycle -------------------------------------------------------

    @classmethod
    async def open(cls, loop, addr: Addr, config, pid: int,
                   rank: int) -> "MuxChannel":
        ch = cls(loop, addr, config)
        _chaos_gate(addr)
        try:
            transport, _proto = await loop.create_connection(
                lambda: _MuxProtocol(ch), addr[0], addr[1]
            )
        except OSError as e:
            raise OcmConnectError(
                f"peer {addr[0]}:{addr[1]} unreachable: {e}"
            ) from e
        ch._transport = transport
        # Capability probe: one lockstep CONNECT offering mux (plus the
        # data-plane capabilities the channel itself exercises). The
        # reply's echoed bits are what the peer serves; flags=0 (old
        # Python daemon, native C++ daemon) declines by silence and the
        # channel runs lockstep.
        offer = FLAG_CAP_MUX | (
            FLAG_CAP_COALESCE if config.dcn_coalesce else 0
        ) | (FLAG_CAP_TRACE if config.trace else 0) | (
            FLAG_CAP_DEADLINE if config.deadline_offer else 0
        )
        try:
            reply = await ch._request_lockstep(Message(
                MsgType.CONNECT, {"pid": pid, "rank": rank}, flags=offer,
            ), raw=True)
        except OcmConnectError:
            ch.close()
            raise
        if reply.type != MsgType.CONNECT_CONFIRM:
            ch.close()
            raise OcmConnectError(
                f"bad mux probe reply {reply.type.name}"
            )
        ch.caps = reply.flags & offer
        ch.peer_rank = reply.fields["rank"]
        if not ch.muxed:
            ch.counters["lockstep"] = 1
            obs_journal.record(
                "mux_declined", host=addr[0], port=addr[1],
            )
        return ch

    @property
    def alive(self) -> bool:
        return self._dead is None

    @property
    def muxed(self) -> bool:
        return bool(self.caps & FLAG_CAP_MUX)

    def _fail(self, exc: BaseException) -> None:
        if self._dead is not None:
            return
        self._dead = exc
        err = OcmConnectError(
            f"mux channel to {self.addr[0]}:{self.addr[1]} failed: {exc}"
        )
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(err)
        self._pending.clear()
        self._orphans.clear()
        if self._ls_waiter is not None and not self._ls_waiter.done():
            self._ls_waiter.set_exception(err)
        if self._drain_waiter is not None and not self._drain_waiter.done():
            self._drain_waiter.set_result(None)
        self._sendq.clear()
        if self._transport is not None:
            try:
                self._transport.close()
            except (OSError, RuntimeError):
                pass

    def close(self) -> None:
        self._fail(OcmConnectError("mux channel closed"))

    # -- frame demux (runs inside data_received) -------------------------

    def _on_frame(self, msg: Message) -> None:
        if msg.flags & FLAG_MUX_TAG:
            tag, rest = split_tag(msg.data)
            msg.data = rest
            msg.flags &= ~FLAG_MUX_TAG
        else:
            tag = None
        if tag is None:
            # Untagged reply: legal only as the single outstanding
            # lockstep exchange (the probe, or a declined peer's serve).
            waiter = self._ls_waiter
            if waiter is None or waiter.done():
                self._fail(OcmProtocolError(
                    f"mux demux: unsolicited untagged {msg.type.name}"
                ))
                return
            waiter.set_result(msg)
            return
        fut = self._pending.pop(tag, None)
        if fut is None:
            if tag in self._orphans:
                self._orphans.pop(tag, None)
                return  # abandoned waiter's late reply
            self._fail(OcmProtocolError(
                f"mux demux: unmatched reply {msg.type.name} (tag {tag})"
            ))
            return
        if not fut.done():
            fut.set_result(msg)

    # -- batched sends ----------------------------------------------------

    def _enqueue(self, parts: list) -> None:
        if not self._sendq:
            self._loop.call_soon(self._flush)
        self._sendq.append(parts)

    def _flush(self) -> None:
        batch, self._sendq = self._sendq, []
        if not batch or self._dead is not None:
            return
        out: list = []
        for parts in batch:
            out.extend(parts)
        try:
            self._transport.writelines(out)
        except (OSError, RuntimeError) as e:
            self._fail(e)
            return
        self.counters["batches"] += 1
        self.counters["frames"] += len(batch)

    async def _drained(self) -> None:
        """Await write-side flow control (after enqueueing a large
        burst): resume_writing releases the waiter."""
        while self._write_paused and self._dead is None:
            if self._drain_waiter is None or self._drain_waiter.done():
                self._drain_waiter = self._loop.create_future()
            await self._drain_waiter

    # -- tagged request/reply --------------------------------------------

    async def _take_credit(self) -> None:
        while self._credits <= 0:
            fut = self._loop.create_future()
            self._credit_waiters.append(fut)
            await fut
        self._credits -= 1

    def _give_credit(self) -> None:
        self._credits += 1
        while self._credit_waiters:
            fut = self._credit_waiters.pop()
            if not fut.done():
                fut.set_result(None)
                break

    def _next_tag(self) -> int:
        while True:
            self._tag = (self._tag + 1) & 0xFFFFFFFF
            if (
                self._tag
                and self._tag not in self._pending
                and self._tag not in self._orphans
            ):
                return self._tag

    def _trace_wrap(self, msg: Message, tctx) -> Message:
        """Attach the trace context to a shallow copy when the peer
        granted FLAG_CAP_TRACE and the type is traceable."""
        if (
            tctx is not None
            and self.caps & FLAG_CAP_TRACE
            and VALID_FLAGS.get(msg.type, 0) & FLAG_TRACE_CTX
        ):
            return obs_trace.attach(
                Message(msg.type, msg.fields, msg.data, msg.flags),
                tctx, FLAG_TRACE_CTX,
            )
        return msg

    def _budget_wrap(self, msg: Message, budget) -> Message:
        """Attach the remaining time budget to a shallow copy when the
        peer granted FLAG_CAP_DEADLINE and the type is budgetable. Runs
        BEFORE _trace_wrap: the budget is the innermost data-tail prefix
        (receivers strip tag, then trace, then deadline)."""
        if (
            budget is not None
            and self.caps & FLAG_CAP_DEADLINE
            and VALID_FLAGS.get(msg.type, 0) & FLAG_DEADLINE
        ):
            return timebudget.attach(
                Message(msg.type, msg.fields, msg.data, msg.flags),
                budget, FLAG_DEADLINE,
            )
        return msg

    async def request(self, msg: Message, tctx=None,
                      owned: bool = False, budget=None) -> Message:
        """One round trip. Muxed: tagged, pipelined, window-bounded, and
        completion-order independent. Lockstep (peer declined): plain
        frames, one at a time — the pre-mux protocol byte-for-byte.

        ``owned=True`` promises ``msg`` was built for this one call and
        may be tagged in place (the data-plane hot path skips a Message
        copy per op); callers that may retry the same object leave it
        False."""
        if self._dead is not None:
            raise OcmConnectError(
                f"mux channel to {self.addr[0]}:{self.addr[1]} is down: "
                f"{self._dead}"
            )
        msg = self._trace_wrap(self._budget_wrap(msg, budget), tctx)
        if not self.muxed:
            return await self._request_lockstep(msg)
        if self._credits <= 0 and obs_journal.enabled():
            # Saturated in-flight window: the op is about to queue behind
            # the credit counter. Mark the wait as a phase of the op span
            # so the critical-path attributor can tell "window full" from
            # "daemon slow".
            w0 = time.monotonic()
            await self._take_credit()
            obs_journal.phase(
                "mux_window_wait", time.monotonic() - w0, ctx=tctx
            )
        else:
            await self._take_credit()
        tag = self._next_tag()
        fut = self._loop.create_future()
        self._pending[tag] = fut
        # Tag a shallow copy unless owned: callers may retry the
        # same Message via the failover ladder and must not
        # accumulate stale tags.
        tagged = attach_tag(
            msg if owned else
            Message(msg.type, msg.fields, msg.data, msg.flags), tag
        )
        c = self.counters
        c["ops"] += 1
        c["inflight"] += 1
        if c["inflight"] > c["peak_inflight"]:
            c["peak_inflight"] = c["inflight"]
        try:
            self._enqueue(_frame_parts(tagged))
            reply = await fut
        finally:
            self._reap(tag)
            c["inflight"] -= 1
            self._give_credit()
        if reply.type == MsgType.ERROR:
            raise remote_error(reply)
        return reply

    def _reap(self, tag: int) -> None:
        """End a tagged exchange. If the reply never arrived (the waiter
        was cancelled or timed out) the tag becomes an orphan the demux
        discards on arrival, keeping the channel in sync for everyone
        else — AND a CANCEL is sent so the daemon revokes the op
        server-side instead of serving it into the void. The orphan set
        is bounded (ORPHAN_CAP, oldest dropped) so a mute peer cannot
        grow it without bound, and a cancel-ack reclaims its tag
        eagerly (a revoked op's reply is suppressed at the server)."""
        if self._pending.pop(tag, None) is not None and self.alive:
            self._orphan_add(tag)
            self._send_cancel(tag)

    def _orphan_add(self, tag: int) -> None:
        self._orphans[tag] = None
        while len(self._orphans) > ORPHAN_CAP:
            self._orphans.pop(next(iter(self._orphans)))
            self.counters["orphans_dropped"] += 1

    def _send_cancel(self, victim: int) -> None:
        """Fire-and-collect server-side revocation of an abandoned tag:
        its own tagged CANCEL exchange (no credit taken — cancels must
        flow exactly when the window is saturated), processed by a loop
        task. A revoked ack reclaims the orphan tombstone; a typed
        BAD_MSG (un-upgraded peer, native daemon) disables further
        cancels on this channel."""
        if not self.alive or not self.muxed or self._no_cancel:
            return
        tag = self._next_tag()
        fut = self._loop.create_future()
        self._pending[tag] = fut
        self.counters["cancels"] += 1
        obs_journal.record(
            "cancel_sent", host=self.addr[0], port=self.addr[1],
            tag=victim,
        )
        try:
            self._enqueue(_frame_parts(attach_tag(
                Message(MsgType.CANCEL, {"tag": victim}), tag
            )))
        except (OSError, RuntimeError):
            self._pending.pop(tag, None)
            return

        async def collect() -> None:
            try:
                # Bounded wait: a MUTE peer must not grow _pending by
                # one never-resolving cancel future per abandoned op —
                # on timeout the cancel's own tag just joins the
                # bounded orphan set (never recursively re-cancelled).
                reply = await asyncio.wait_for(fut, 30.0)
            except asyncio.TimeoutError:
                if self._pending.pop(tag, None) is not None and self.alive:
                    self._orphan_add(tag)
                return
            except OcmError:
                return  # channel died; nothing left to reclaim
            finally:
                self._pending.pop(tag, None)
            if (
                reply.type == MsgType.ERROR
                and reply.fields.get("code") == int(ErrCode.BAD_MSG)
            ):
                self._no_cancel = True
                return
            if (
                reply.type == MsgType.CANCEL_OK
                and reply.fields.get("revoked")
            ):
                # The server suppressed the op's reply: the orphan
                # tombstone has nothing left to absorb.
                self.counters["cancels_revoked"] += 1
                self._orphans.pop(victim, None)

        task = self._loop.create_task(collect())
        self._cancel_tasks.add(task)
        task.add_done_callback(self._cancel_tasks.discard)

    async def _request_lockstep(self, msg: Message,
                                raw: bool = False) -> Message:
        """One request, one reply, nothing else in flight — the pre-mux
        protocol against a declining peer (and the CONNECT probe itself,
        ``raw=True``: the reply is returned even when it is an ERROR)."""
        # Holding the mutex across the awaited reply IS lockstep mode:
        # exactly one exchange in flight.
        async with self._lockstep_mu:  # ocm-lint: allow[async-lock-held-across-await]
            if self._dead is not None:
                raise OcmConnectError(
                    f"mux channel to {self.addr[0]}:{self.addr[1]} is "
                    f"down: {self._dead}"
                )
            self.counters["ops"] += 1
            waiter = self._ls_waiter = self._loop.create_future()
            try:
                self._enqueue(_frame_parts(msg))
                reply = await waiter
            finally:
                self._ls_waiter = None
        if not raw and reply.type == MsgType.ERROR:
            raise remote_error(reply)
        return reply

    # -- data plane ------------------------------------------------------

    async def put_range(self, handle: OcmAlloc, mv, start: int,
                        length: int, offset: int, tctx=None,
                        budget=None) -> dict:
        """Write [start, start+length) of ``mv`` at handle-relative
        ``offset+start``. Absolute offsets per chunk, so a failed range
        is idempotently re-runnable by the caller's ladder."""
        _chaos_gate(self.addr)  # data-plane parity with PeerPool.lease
        chunk = self.config.chunk_bytes
        base = offset + start
        end = start + length
        if length <= chunk and self.muxed:
            # Single-chunk fast path — the small-op hot loop: one tagged
            # request, no burst machinery, no per-chunk closures.
            r = await self.request(Message(
                MsgType.DATA_PUT,
                {"alloc_id": handle.alloc_id, "offset": base,
                 "nbytes": length},
                mv[start:end],
            ), tctx, owned=True, budget=budget)
            if r.type != MsgType.DATA_PUT_OK or r.fields["nbytes"] != length:
                raise OcmProtocolError(
                    f"mux put ack mismatch: {r.type.name} "
                    f"{r.fields.get('nbytes')} != {length}"
                )
            return {"window": self.config.mux_window, "chunk": chunk,
                    "coalesced": False}
        coalesced = (
            self.muxed
            and bool(self.caps & FLAG_CAP_COALESCE)
            and length > chunk
        )
        if coalesced:
            await self._put_burst(handle, mv, start, end, base, chunk,
                                  tctx, budget)
        else:
            # Windowed tagged chunks when muxed (independent requests,
            # replies matched by tag — no FIFO assumption), sequential
            # lockstep chunks against a declining peer.
            async def one(pos: int, n: int) -> None:
                m = Message(
                    MsgType.DATA_PUT,
                    {"alloc_id": handle.alloc_id,
                     "offset": base + (pos - start), "nbytes": n},
                    mv[pos:pos + n],
                )
                if self.muxed:
                    r = await self.request(m, tctx, owned=True,
                                           budget=budget)
                else:
                    r = await self._request_lockstep(
                        self._trace_wrap(m, tctx)
                    )
                if (
                    r.type != MsgType.DATA_PUT_OK
                    or r.fields["nbytes"] != n
                ):
                    raise OcmProtocolError(
                        f"mux put ack mismatch: {r.type.name} "
                        f"{r.fields.get('nbytes')} != {n}"
                    )

            await self._chunked(one, start, end, chunk)
        return {"window": self.config.mux_window, "chunk": chunk,
                "coalesced": coalesced}

    async def _put_burst(self, handle: OcmAlloc, mv, start: int, end: int,
                         base: int, chunk: int, tctx=None,
                         budget=None) -> None:
        """Coalesced FLAG_MORE burst as ONE atomic send-queue item: the
        whole burst's frames are enqueued in one synchronous step, so no
        other sender's frame can interleave inside the open burst (the
        daemon answers BAD_MSG to foreign frames mid-burst) — and the
        daemon replies ONCE, at the tagged closing chunk."""
        await self._take_credit()
        tag = self._next_tag()
        fut = self._loop.create_future()
        self._pending[tag] = fut
        parts: list = []
        pos = start
        while pos < end:
            n = min(chunk, end - pos)
            last = pos + n >= end
            m = Message(
                MsgType.DATA_PUT,
                {"alloc_id": handle.alloc_id,
                 "offset": base + (pos - start), "nbytes": n},
                mv[pos:pos + n],
                flags=0 if last else FLAG_MORE,
            )
            if last:
                m = self._trace_wrap(self._budget_wrap(m, budget), tctx)
                attach_tag(m, tag)
            parts.extend(_frame_parts(m))
            pos += n
        self.counters["ops"] += 1
        self.counters["inflight"] += 1
        self.counters["peak_inflight"] = max(
            self.counters["peak_inflight"], self.counters["inflight"]
        )
        try:
            self._enqueue(parts)
            await self._drained()  # flow control: bound the burst's
            # footprint in the transport buffer before awaiting
            reply = await fut
        finally:
            self._reap(tag)
            self.counters["inflight"] -= 1
            self._give_credit()
        if reply.type == MsgType.ERROR:
            raise remote_error(reply)
        if (
            reply.type != MsgType.DATA_PUT_OK
            or reply.fields["nbytes"] != end - start
        ):
            raise OcmProtocolError(
                f"mux burst ack mismatch: {reply.type.name} "
                f"{reply.fields.get('nbytes')} != {end - start}"
            )

    async def get_range(self, handle: OcmAlloc, out_mv, start: int,
                        length: int, offset: int, tctx=None,
                        budget=None) -> dict:
        """Read [start, start+length) into the matching view of
        ``out_mv``. Muxed gets pipeline chunked tagged requests; each
        reply lands by tag into its disjoint destination slice."""
        _chaos_gate(self.addr)  # data-plane parity with PeerPool.lease
        chunk = self.config.chunk_bytes
        base = offset + start
        end = start + length
        if length <= chunk and self.muxed:
            # Single-chunk fast path (see put_range).
            r = await self.request(Message(
                MsgType.DATA_GET,
                {"alloc_id": handle.alloc_id, "offset": base,
                 "nbytes": length},
            ), tctx, owned=True, budget=budget)
            if len(r.data) != length:
                raise OcmProtocolError(
                    f"mux get reply length {len(r.data)} != {length}"
                )
            out_mv[start:end] = r.data
            return {"window": self.config.mux_window, "chunk": chunk,
                    "coalesced": False}

        async def one(pos: int, n: int) -> None:
            m = Message(
                MsgType.DATA_GET,
                {"alloc_id": handle.alloc_id,
                 "offset": base + (pos - start), "nbytes": n},
            )
            if self.muxed:
                r = await self.request(m, tctx, owned=True, budget=budget)
            else:
                r = await self._request_lockstep(self._trace_wrap(m, tctx))
            if len(r.data) != n:
                raise OcmProtocolError(
                    f"mux get reply length {len(r.data)} != {n}"
                )
            out_mv[pos:pos + n] = r.data

        await self._chunked(one, start, end, chunk)
        return {"window": self.config.mux_window, "chunk": chunk,
                "coalesced": False}

    async def _chunked(self, one, start: int, end: int,
                       chunk: int) -> None:
        """Run ``one(pos, n)`` over every chunk of [start, end):
        concurrently (window-bounded by request()) when muxed, strictly
        sequentially against a lockstep peer."""
        if end - start <= chunk:
            # Single-chunk fast path: no gather, no Task per op — the
            # small-op hot loop is exactly this branch.
            await one(start, end - start)
            return
        if self.muxed:
            waits = []
            pos = start
            while pos < end:
                n = min(chunk, end - pos)
                waits.append(one(pos, n))
                pos += n
            await asyncio.gather(*waits)
        else:
            pos = start
            while pos < end:
                n = min(chunk, end - pos)
                await one(pos, n)
                pos += n


class ChannelMap:
    """Lazy per-address channel registry, loop-confined. Shared by the
    background-thread runtime (sync facade) and AsyncOcm (caller loop).
    A dead channel is replaced on the next request; concurrent opens to
    one address are deduplicated so two racing tenants share one dial."""

    def __init__(self, loop, config, pid: int | None = None) -> None:
        self._loop = loop
        self.config = config
        self.pid = os.getpid() if pid is None else pid
        self._channels: dict[Addr, MuxChannel] = {}
        self._opening: dict[Addr, asyncio.Task] = {}

    async def channel(self, addr: Addr, rank: int = -1) -> MuxChannel:
        addr = (addr[0], addr[1])
        ch = self._channels.get(addr)
        if ch is not None and ch.alive:
            return ch
        task = self._opening.get(addr)
        if task is None:
            task = self._loop.create_task(
                MuxChannel.open(self._loop, addr, self.config,
                                self.pid, rank)
            )
            self._opening[addr] = task
        try:
            ch = await asyncio.shield(task)
        except asyncio.CancelledError:
            raise
        except OcmError:
            raise
        except OSError as e:
            raise OcmConnectError(
                f"peer {addr[0]}:{addr[1]} unreachable: {e}"
            ) from e
        finally:
            if self._opening.get(addr) is task:
                self._opening.pop(addr, None)
        self._channels[addr] = ch
        return ch

    def drop(self, addr: Addr) -> None:
        ch = self._channels.pop((addr[0], addr[1]), None)
        if ch is not None:
            ch.close()

    def live_channels(self) -> list[MuxChannel]:
        return [c for c in self._channels.values() if c.alive]

    def fd_count(self) -> int:
        return len(self.live_channels())

    def counters(self) -> dict:
        agg = {"conns": 0, "ops": 0, "batches": 0, "frames": 0,
               "inflight": 0, "peak_inflight": 0, "lockstep": 0,
               "window": self.config.mux_window}
        for c in self.live_channels():
            agg["conns"] += 1
            for k in ("ops", "batches", "frames", "inflight",
                      "peak_inflight", "lockstep"):
                agg[k] += c.counters[k]
        return agg

    def close(self) -> None:
        for ch in self._channels.values():
            ch.close()
        self._channels.clear()


# -- failover ladder (shared shape with runtime/client.py) ---------------

RETRYABLE_CODES = frozenset({
    int(ErrCode.STALE_EPOCH),
    int(ErrCode.NOT_PRIMARY),
    int(ErrCode.REPLICA_UNAVAILABLE),
    int(ErrCode.MOVED),
})


def is_failover_err(err: BaseException) -> bool:
    if isinstance(err, OcmRemoteError):
        return err.code in RETRYABLE_CODES
    return isinstance(err, (OSError, OcmConnectError, OcmProtocolError))


def failover_candidates(entries, handle: OcmAlloc,
                        last_err: BaseException | None
                        ) -> list[tuple[int, Addr]]:
    """A MOVED redirect first, then the membership address of the owner
    rank, then each replica in chain order — the sync ladder's exact
    preference order (runtime/client.py)."""
    def rank_addr(rank: int) -> Addr | None:
        if 0 <= rank < len(entries):
            e = entries[rank]
            if e.port:
                return (e.connect_host, e.port)
        return None

    out: list[tuple[int, Addr]] = []
    moved = getattr(last_err, "moved_to_rank", None)
    if moved is not None:
        a = rank_addr(moved)
        if a is not None:
            out.append((moved, a))
    a = rank_addr(handle.rank)
    if a is not None and (handle.rank, a) not in out:
        out.append((handle.rank, a))
    for rr in handle.replica_ranks:
        if rr == handle.rank:
            continue
        a = rank_addr(rr)
        if a is not None and (rr, a) not in out:
            out.append((rr, a))
    return out


def _mint_op_ctx():
    """A per-op trace context for the async client: child of any
    ambient context (a sync caller's enclosing span), else a fresh
    root — WITHOUT installing it thread-locally (see
    Tracer.note_span)."""
    if not obs_trace.enabled():
        return None
    parent = obs_trace.current()
    return obs_trace.child(parent) if parent is not None \
        else obs_trace.mint()


def handle_from_alloc_result(reply: Message, nbytes: int,
                             origin_rank: int) -> OcmAlloc:
    """Build the client-side handle from an ALLOC_RESULT — shared by the
    blocking client and AsyncOcm so the two front ends cannot drift on
    kind demotion, fabric selection, or the replica tail."""
    f = reply.fields
    placed_kind = OcmKind(WIRE_KIND_INV[f["kind"]])
    fabric = (
        Fabric.LOCAL if not placed_kind.is_remote
        else (Fabric.ICI if placed_kind == OcmKind.REMOTE_DEVICE
              else Fabric.DCN)
    )
    h = OcmAlloc(
        alloc_id=f["alloc_id"],
        kind=placed_kind,
        fabric=fabric,
        nbytes=nbytes,
        rank=f["rank"],
        device_index=f["device_index"],
        extent=Extent(offset=f["offset"], nbytes=nbytes),
        origin_rank=origin_rank,
    )
    h.owner_addr = (f["owner_host"], f["owner_port"])
    h.daemon_owned = True
    if reply.data:
        import json

        try:
            reps = json.loads(bytes(reply.data)).get("replicas", [])
            h.replica_ranks = tuple(
                int(x) for x in reps if int(x) != h.rank
            )
        except (ValueError, TypeError):
            pass  # tail from a future daemon we don't understand
    return h


class MuxRuntime:
    """Sync facade over one event loop on a background thread. Shared
    process-wide (refcounted via :func:`acquire_runtime`) so every
    tenant's ``ControlPlaneClient`` in the process drives the SAME
    one-connection-per-peer channel set — the fd-footprint win."""

    def __init__(self, config) -> None:
        self.config = config
        self._loop = asyncio.new_event_loop()
        self._refs = 0
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="ocm-mux-loop", daemon=True
        )
        self._thread.start()
        self.channels = ChannelMap(self._loop, config)

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()
        try:
            self._loop.close()
        except RuntimeError:
            pass

    # -- sync bridge -----------------------------------------------------

    def run(self, coro, timeout: float = 120.0):
        import concurrent.futures

        if self._closed:
            raise OcmConnectError("mux runtime is shut down")
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        try:
            return fut.result(timeout)
        except concurrent.futures.TimeoutError:
            fut.cancel()
            raise OcmConnectError(
                f"mux operation timed out after {timeout}s"
            ) from None

    def submit(self, coro) -> "concurrent.futures.Future":
        """Schedule ``coro`` on the loop WITHOUT blocking: the
        concurrent future completes when it does. The fire-and-collect
        half of the sync bridge — what the serving prefetcher uses to
        overlap cold-page fetches with compute (``run`` is the blocking
        half)."""
        import concurrent.futures  # noqa: F401 — annotation only

        if self._closed:
            raise OcmConnectError("mux runtime is shut down")
        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    def open_sync(self, addr: Addr, rank: int = -1,
                  timeout: float = 60.0) -> MuxChannel:
        return self.run(self.channels.channel(addr, rank), timeout)

    def request_sync(self, addr: Addr, msg: Message,
                     timeout: float = 120.0, budget=None) -> Message:
        tctx = obs_trace.current()
        if budget is not None:
            # The sync bridge must give up when the budget does (plus
            # slack for the typed refusal to travel back), or a timed-out
            # bridge would mask the typed DEADLINE_EXCEEDED.
            timeout = min(timeout, budget.remaining_s() + 5.0)

        async def go():
            ch = await self.channels.channel(addr)
            return await ch.request(msg, tctx, budget=budget)

        return self.run(go(), timeout)

    def transfer_sync(self, addr: Addr, handle: OcmAlloc, start: int,
                      length: int, offset: int, put_mv=None,
                      get_arr=None, timeout: float = 600.0,
                      budget=None) -> dict:
        """One stripe-range transfer for the sync engine's ladder. On
        transport failure the channel is dropped so the ladder's next
        attempt re-dials (the PeerPool.discard discipline)."""
        tctx = obs_trace.current()
        if budget is not None:
            timeout = min(timeout, budget.remaining_s() + 5.0)

        async def go():
            ch = await self.channels.channel(addr)
            try:
                if put_mv is not None:
                    return await ch.put_range(
                        handle, put_mv, start, length, offset, tctx,
                        budget,
                    )
                return await ch.get_range(
                    handle, memoryview(get_arr), start, length, offset,
                    tctx, budget,
                )
            except (OSError, OcmConnectError, asyncio.IncompleteReadError):
                self.channels.drop(addr)
                raise

        return self.run(go(), timeout)

    # -- loop-scheduled heartbeats ---------------------------------------

    def add_periodic(self, interval_s: float, fn) -> "asyncio.Task":
        """Schedule ``fn`` — a fast, non-blocking callable returning a
        list of (addr, Message) to send (or None to skip a beat) — every
        ``interval_s``. One tenant's heartbeat costs a loop task, not a
        thread. Returns the task; cancel via :meth:`cancel_periodic`."""
        async def loop_body():
            import random

            await asyncio.sleep(interval_s * random.random())
            while True:
                try:
                    for addr, msg in (fn() or ()):
                        ch = await self.channels.channel(addr)
                        await ch.request(msg)
                except asyncio.CancelledError:
                    raise
                except (OSError, OcmError) as e:
                    printd("mux heartbeat failed: %s", e)
                await asyncio.sleep(interval_s)

        return asyncio.run_coroutine_threadsafe(
            _task_holder(loop_body()), self._loop
        ).result(10.0)

    def cancel_periodic(self, task) -> None:
        if task is not None:
            self._loop.call_soon_threadsafe(task.cancel)

    # -- introspection / teardown ----------------------------------------

    def fd_count(self) -> int:
        return self.channels.fd_count()

    def counters(self) -> dict:
        return self.channels.counters()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True

        def _teardown():
            self.channels.close()
            # One extra loop beat so just-cancelled reader/writer tasks
            # actually process their CancelledError before the loop
            # stops (a hard stop leaves "task was destroyed but it is
            # pending" noise behind).
            self._loop.call_soon(self._loop.stop)

        try:
            self._loop.call_soon_threadsafe(_teardown)
            self._thread.join(timeout=10.0)
        except RuntimeError:
            pass


async def _task_holder(coro):
    """Wrap a coroutine into a Task from inside the loop (so add_periodic
    can hand the Task object back across the thread boundary)."""
    return asyncio.get_running_loop().create_task(coro)


_runtime: MuxRuntime | None = None
_runtime_lock = make_lock("mux._runtime_lock")


def acquire_runtime(config) -> MuxRuntime:
    """The process-shared runtime, created on first use. The FIRST
    acquirer's config shapes the channels (window, chunking); per-tenant
    QoS profiles still ride each tenant's own CONNECT frames."""
    global _runtime
    with _runtime_lock:
        if _runtime is None or _runtime._closed:
            _runtime = MuxRuntime(config)
        _runtime._refs += 1
        return _runtime


def release_runtime(rt: MuxRuntime) -> None:
    global _runtime
    with _runtime_lock:
        rt._refs -= 1
        if rt._refs <= 0:
            rt.close()
            if _runtime is rt:
                _runtime = None


def runtime_stats() -> dict | None:
    """Live counters of the process-shared runtime (None when no mux
    client is active) — what Ocm.status() surfaces as ``client.mux``."""
    with _runtime_lock:
        rt = _runtime
    if rt is None or rt._closed:
        return None
    out = rt.counters()
    out["fds"] = rt.fd_count()
    return out


# -- the async public API ------------------------------------------------


class AsyncOcm:
    """``async``/``await`` client for host-kind disaggregated memory:
    ``alloc`` / ``put`` / ``get`` / ``free`` / ``status`` over the mux
    core on the CALLER's event loop — no background threads at all.

    One process can host thousands of these (one per tenant, each with
    its own ``app_id``, leases and QoS profile) over one connection per
    peer: pass a shared :class:`ChannelMap` via ``channels=``. Device
    kinds still need the SPMD plane and stay with the blocking client.

    Usage::

        async with await AsyncOcm.open(entries, rank=0) as ocm:
            h = await ocm.alloc(1 << 20)
            await ocm.put(h, data)
            back = await ocm.get(h, 1 << 20)
            await ocm.free(h)
    """

    def __init__(self, entries, rank: int, config, app_id: int | None,
                 channels: ChannelMap) -> None:
        self.entries = entries
        self.rank = rank
        self.config = config
        self.pid = os.getpid() if app_id is None else int(app_id)
        self.channels = channels
        self._own_channels = False
        self.tracer = GLOBAL_TRACER
        self._ctrl_addr: Addr | None = None
        self._ctrl_caps = 0
        self._hb_task: asyncio.Task | None = None
        self._owner_ranks: dict[int, int] = {}
        self._closed = False
        self._trace_scope = f"actx-{self.pid}"
        # Per-peer circuit breaker (resilience/timebudget.py): no-op
        # unless OCM_BREAKER_THRESHOLD arms it.
        self._breaker = timebudget.breaker_from(config)

    @classmethod
    async def open(cls, entries, rank: int, config=None,
                   app_id: int | None = None,
                   channels: ChannelMap | None = None,
                   heartbeat: bool = True) -> "AsyncOcm":
        from oncilla_tpu_torch.utils.config import OcmConfig

        config = config or OcmConfig()
        loop = asyncio.get_running_loop()
        own = channels is None
        if channels is None:
            channels = ChannelMap(loop, config)
        ocm = cls(entries, rank, config, app_id, channels)
        ocm._own_channels = own
        await ocm._bootstrap(heartbeat)
        return ocm

    async def __aenter__(self) -> "AsyncOcm":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    # -- bootstrap / teardown -------------------------------------------

    async def _bootstrap(self, heartbeat: bool) -> None:
        """Walk the seed addresses (own rank first) exactly like the
        blocking client's CONNECT ladder, then register this tenant with
        its own tagged CONNECT — profile tail, replica offer and all."""
        last: BaseException | None = None
        seeds = [self.entries[self.rank]] + [
            e for e in self.entries
            if getattr(e, "rank", None) not in (None, self.rank) and e.port
        ]
        ch = None
        for e in seeds:
            addr = (e.connect_host, e.port)
            try:
                ch = await self.channels.channel(addr, self.rank)
            except (OcmConnectError, OSError) as err:
                last = err
                continue
            self._ctrl_addr = addr
            if ch.peer_rank is not None and ch.peer_rank != self.rank:
                printd("async client: seed rank %d unreachable, attached "
                       "to rank %d", self.rank, ch.peer_rank)
                self.rank = ch.peer_rank
            break
        if ch is None:
            raise OcmConnectError(
                f"no seed daemon reachable: {last}"
            ) from last
        from oncilla_tpu_torch.qos.policy import pack_profile

        connect = Message(
            MsgType.CONNECT, {"pid": self.pid, "rank": self.rank},
            flags=(FLAG_CAP_TRACE if self.config.trace else 0) | (
                FLAG_CAP_REPLICA if self.config.replicas > 1 else 0
            ),
        )
        if self.config.qos_offer:
            connect.flags |= FLAG_CAP_QOS | FLAG_QOS_TAIL
            connect.data = pack_profile(
                self.config.priority,
                self.config.quota_bytes,
                self.config.quota_handles,
            )
        r = await ch.request(connect)
        if r.type != MsgType.CONNECT_CONFIRM:
            raise OcmConnectError(f"bad handshake reply {r.type.name}")
        self._ctrl_caps = r.flags & TENANT_CAPS
        self.nnodes = r.fields["nnodes"]
        if heartbeat:
            self._hb_task = asyncio.get_running_loop().create_task(
                self._heartbeat_loop()
            )

    async def _heartbeat_loop(self) -> None:
        import random

        await asyncio.sleep(self.config.heartbeat_s * random.random())
        while True:
            try:
                await self._ctrl_request(Message(
                    MsgType.HEARTBEAT,
                    {"rank": self.rank, "pid": self.pid,
                     "owners": self._owners_field()},
                ))
            except asyncio.CancelledError:
                raise
            except (OSError, OcmError) as e:
                printd("async client %d: heartbeat failed: %s",
                       self.pid, e)
            await asyncio.sleep(self.config.heartbeat_s)

    async def aclose(self, detach: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        if self._hb_task is not None:
            self._hb_task.cancel()
        if not detach and self._ctrl_addr is not None:
            obs_journal.record("app_close", pid=self.pid, rank=self.rank)
            try:
                await self._ctrl_request(Message(
                    MsgType.DISCONNECT,
                    {"pid": self.pid, "owners": self._owners_field()},
                ))
            except (OSError, OcmError):
                pass  # the lease reaper is the backstop
        if self._own_channels:
            self.channels.close()

    # -- plumbing --------------------------------------------------------

    def _owners_field(self) -> str:
        return ",".join(str(r) for r in sorted(self._owner_ranks))

    def _note_owner(self, rank: int, delta: int) -> None:
        if rank == self.rank:
            return
        n = self._owner_ranks.get(rank, 0) + delta
        if n > 0:
            self._owner_ranks[rank] = n
        else:
            self._owner_ranks.pop(rank, None)

    async def _ctrl_request(self, msg: Message, budget=None) -> Message:
        ch = await self.channels.channel(self._ctrl_addr)
        return await ch.request(msg, obs_trace.current(), budget=budget)

    def _owner_addr(self, handle: OcmAlloc) -> Addr:
        addr = getattr(handle, "owner_addr", None)
        if addr is not None:
            return tuple(addr)
        e = self.entries[handle.rank]
        return (e.connect_host, e.port)

    # -- API -------------------------------------------------------------

    async def alloc(self, nbytes: int,
                    kind: OcmKind = OcmKind.REMOTE_HOST,
                    deadline_ms: int | None = None) -> OcmAlloc:
        if kind in (OcmKind.REMOTE_DEVICE, OcmKind.LOCAL_DEVICE):
            raise OcmError(
                "AsyncOcm serves host kinds; device arms need the SPMD "
                "plane (use the blocking client)"
            )
        budget = timebudget.budget_from(deadline_ms, self.config)
        req = Message(
            MsgType.REQ_ALLOC,
            {"orig_rank": self.rank, "pid": self.pid,
             "kind": WIRE_KIND[kind.value], "nbytes": nbytes},
        )
        if (
            self.config.replicas > 1
            and self._ctrl_caps & FLAG_CAP_REPLICA
            and kind == OcmKind.REMOTE_HOST
        ):
            req.flags |= FLAG_REPLICAS
            req.data = bytes([self.config.replicas])
        r = await self._busy_absorbing(req, budget)
        h = handle_from_alloc_result(r, nbytes, self.rank)
        self._note_owner(h.rank, +1)
        for rr in h.replica_ranks:
            self._note_owner(rr, +1)
        if alloctrace.enabled():
            alloctrace.note_alloc(
                self._trace_scope, h.alloc_id, nbytes, h.kind.name
            )
        return h

    async def _busy_absorbing(self, req: Message, budget=None) -> Message:
        """REQ_ALLOC with the QoS BUSY retry contract — async twin of the
        blocking client's _alloc_request (capped jittered backoff seeded
        by the server's hint, CLAMPED to any remaining time budget)."""
        import random

        cfg = self.config
        delay = max(cfg.busy_backoff_ms, 1) / 1e3
        for attempt in range(cfg.busy_retries + 1):
            if budget is not None:
                budget.check(
                    f"alloc of {req.fields.get('nbytes', 0)} B"
                )
            try:
                return await self._ctrl_request(req, budget)
            except OcmRemoteError as e:
                if (
                    e.code != int(ErrCode.BUSY)
                    or attempt == cfg.busy_retries
                ):
                    raise
                hint = getattr(e, "retry_after_ms", 0) / 1e3
                step = min(max(delay, hint), cfg.connect_backoff_cap_s)
                obs_journal.record(
                    "backpressure_wait", attempt=attempt,
                    wait_s=round(step, 4),
                    nbytes=req.fields.get("nbytes", 0),
                )
                dur = step * (0.5 + random.random() / 2)
                if budget is not None:
                    dur = min(dur, budget.remaining_s())
                await asyncio.sleep(dur)
                delay *= 2
        raise AssertionError("unreachable")

    async def free(self, handle: OcmAlloc,
                   deadline_ms: int | None = None) -> None:
        budget = timebudget.budget_from(deadline_ms, self.config)
        self._note_owner(handle.rank, -1)
        for rr in handle.replica_ranks:
            self._note_owner(rr, -1)

        def _restore() -> None:
            self._note_owner(handle.rank, +1)
            for rr in handle.replica_ranks:
                self._note_owner(rr, +1)

        try:
            await self._ctrl_request(Message(
                MsgType.REQ_FREE,
                {"alloc_id": handle.alloc_id, "rank": handle.rank},
            ), budget)
        except BaseException as err:
            # Free ladder: re-aim a dead primary's free at the replica
            # chain (the blocking client's exact discipline).
            if not (is_failover_err(err) and handle.replica_ranks):
                _restore()
                raise
            last: BaseException = err
            for rr in handle.replica_ranks:
                try:
                    await self._ctrl_request(Message(
                        MsgType.REQ_FREE,
                        {"alloc_id": handle.alloc_id, "rank": rr},
                    ), budget)
                    break
                except BaseException as err2:  # noqa: BLE001
                    if not is_failover_err(err2):
                        _restore()
                        raise
                    last = err2
            else:
                _restore()
                raise last
        handle.freed = True
        if alloctrace.enabled():
            alloctrace.note_free(self._trace_scope, handle.alloc_id)

    async def put(self, handle: OcmAlloc, data, offset: int = 0,
                  deadline_ms: int | None = None) -> None:
        import numpy as np

        if (
            isinstance(data, np.ndarray)
            and data.dtype == np.uint8
            and data.ndim == 1
            and data.flags.c_contiguous
        ):
            raw = data  # small-op fast path: no coerce chain
        else:
            raw = _host_array(data)
        mv = memoryview(raw)
        ctx = _mint_op_ctx()
        budget = timebudget.budget_from(deadline_ms, self.config)
        t0 = time.perf_counter()
        stats = await self._transfer(
            handle, raw.nbytes, offset, put_mv=mv, tctx=ctx,
            budget=budget,
        )
        dt = time.perf_counter() - t0
        self.tracer.note_span("dcn_put", raw.nbytes, dt, ctx)
        self._note(stats, "put", raw.nbytes, dt)

    async def get(self, handle: OcmAlloc, nbytes: int | None = None,
                  offset: int = 0, out=None,
                  deadline_ms: int | None = None):
        import numpy as np

        n = handle.nbytes if nbytes is None else nbytes
        dest = np.empty(n, dtype=np.uint8) if out is None else out
        flat = _host_array(dest, writable=True)
        ctx = _mint_op_ctx()
        budget = timebudget.budget_from(deadline_ms, self.config)
        t0 = time.perf_counter()
        delay = (timebudget.hedge_delay_s(self.config, self.tracer)
                 if handle.replica_ranks and self.config.hedge_ms != 0
                 else 0.0)
        if delay > 0:
            stats = await self._hedged_get(handle, n, offset, flat, ctx,
                                           budget, delay)
        else:
            stats = await self._transfer(handle, n, offset, get_arr=flat,
                                         tctx=ctx, budget=budget)
        dt = time.perf_counter() - t0
        self.tracer.note_span("dcn_get", n, dt, ctx)
        self._note(stats, "get", n, dt)
        return torch.from_numpy(dest) if out is None else dest

    async def _hedged_get(self, handle: OcmAlloc, n: int, offset: int,
                          flat, ctx, budget, delay: float) -> dict:
        """Tail-at-Scale hedged read on the async client: the primary
        attempt runs as a task into a private buffer; past ``delay``
        with no answer, a second read fires DIRECTLY at the next chain
        member (replicas serve client DATA_GET). First success wins and
        is copied into the destination; the LOSER task is cancelled —
        which on a mux channel tombstones its tags and sends CANCEL, so
        the daemon drops the abandoned work server-side."""
        import copy

        import numpy as np

        buf_a = np.empty(n, dtype=np.uint8)
        # The primary rides a PRIVATE handle clone: a losing attempt is
        # cancelled, but until the cancellation lands its ladder must
        # never repoint (or re-account) the caller's handle under a
        # concurrent op.
        probe = copy.copy(handle)
        probe._hedge_probe = True
        primary = asyncio.ensure_future(self._transfer(
            probe, n, offset, get_arr=buf_a, tctx=ctx, budget=budget,
        ))
        done, _ = await asyncio.wait((primary,), timeout=delay)
        if done:
            stats = primary.result()  # raises the primary's error as-is
            flat[:n] = buf_a
            return stats

        async def hedge_attempt():
            rr = handle.replica_ranks[0]
            if 0 <= rr < len(self.entries) and self.entries[rr].port:
                e = self.entries[rr]
            else:
                raise OcmConnectError(f"hedge target rank {rr} unknown")
            buf = np.empty(n, dtype=np.uint8)
            ch = await self.channels.channel((e.connect_host, e.port))
            await ch.get_range(handle, memoryview(buf), 0, n, offset,
                               ctx, budget)
            return buf

        obs_journal.record(
            "hedge_fired", alloc_id=handle.alloc_id, nbytes=n,
            delay_ms=round(delay * 1e3, 3),
            target_rank=handle.replica_ranks[0],
        )
        hedge = asyncio.ensure_future(hedge_attempt())
        pending = {primary, hedge}
        first_err = None
        try:
            while pending:
                timeout = (max(budget.remaining_s(), 0.01)
                           if budget is not None else None)
                done, pending = await asyncio.wait(
                    pending, timeout=timeout,
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if not done:
                    budget.check(
                        f"hedged get of alloc {handle.alloc_id}"
                    )
                    continue
                for t in done:
                    err = t.exception()
                    if err is not None:
                        if first_err is None:
                            first_err = err
                        continue
                    if t is primary:
                        stats = t.result()
                        flat[:n] = buf_a
                        obs_journal.record(
                            "hedge_lost", alloc_id=handle.alloc_id,
                            nbytes=n,
                        )
                    else:
                        flat[:n] = t.result()
                        stats = {"window": self.config.mux_window,
                                 "chunk": self.config.chunk_bytes,
                                 "coalesced": False}
                        obs_journal.record(
                            "hedge_won", alloc_id=handle.alloc_id,
                            nbytes=n,
                        )
                    stats = dict(stats)
                    stats["hedged"] = True
                    return stats
            raise first_err
        finally:
            # Cancel the loser (and on error paths, every survivor):
            # an abandoned mux exchange tombstones its tag and sends
            # CANCEL — the server-side revocation contract. The done
            # callback retrieves a loser's late exception so asyncio
            # never logs it as unretrieved.
            for t in (primary, hedge):
                if not t.done():
                    t.cancel()
                t.add_done_callback(
                    lambda t: None if t.cancelled() else t.exception()
                )

    async def status(self, rank: int | None = None) -> dict:
        if rank is None or rank == self.rank:
            r = await self._ctrl_request(Message(MsgType.STATUS, {}))
        else:
            e = self.entries[rank]
            ch = await self.channels.channel((e.connect_host, e.port))
            r = await ch.request(Message(MsgType.STATUS, {}))
        f = dict(r.fields)
        if r.data:
            import json

            try:
                f.update(json.loads(bytes(r.data)))
            except (ValueError, UnicodeDecodeError):
                pass
        f["client"] = {
            "sockets": self.channels.fd_count(),
            "mux": self.channels.counters(),
        }
        return f

    async def _transfer(self, handle: OcmAlloc, total: int, offset: int,
                        put_mv=None, get_arr=None, tctx=None,
                        budget=None) -> dict:
        """One whole transfer with the failover ladder: first the cached
        owner address, then — on retryable failure — the MOVED redirect /
        membership / replica-chain candidates, re-walked with a short
        pause until failover_wait_s elapses (the window IS the failure-
        detection latency) — CLAMPED to any remaining time budget, which
        expires typed. ``tctx`` is threaded EXPLICITLY (never the
        thread-local ambient: coroutines must not install it across
        awaits)."""
        addr = self._owner_addr(handle)

        async def attempt(a: Addr):
            self._breaker.check(a)
            try:
                ch = await self.channels.channel(a)
                if put_mv is not None:
                    r = await ch.put_range(
                        handle, put_mv, 0, total, offset, tctx, budget
                    )
                else:
                    r = await ch.get_range(
                        handle, memoryview(get_arr), 0, total, offset,
                        tctx, budget,
                    )
            except BaseException as err:
                if isinstance(err, (OSError, OcmConnectError,
                                    asyncio.IncompleteReadError)):
                    self.channels.drop(a)
                    self._breaker.fail(a)
                elif (
                    isinstance(err, OcmRemoteError)
                    and err.code == int(ErrCode.DEADLINE_EXCEEDED)
                ):
                    self._breaker.fail(a)
                raise
            self._breaker.ok(a)
            return r

        # First attempt inline (no candidate walk): the hot path.
        try:
            return await attempt(addr)
        except BaseException as err:
            if not is_failover_err(err):
                raise
            last = err

        deadline = time.monotonic() + self.config.failover_wait_s
        if budget is not None:
            deadline = min(deadline, budget.deadline)
        while True:
            for rank_i, cand in failover_candidates(
                self.entries, handle, last
            ):
                obs_journal.record(
                    "stripe_retry", stripe=0, alloc_id=handle.alloc_id,
                    owner_rank=rank_i, nbytes=total,
                    error=f"{type(last).__name__}: {last}",
                )
                try:
                    stats = await attempt(cand)
                except BaseException as err:
                    if not is_failover_err(err):
                        raise
                    last = err
                    continue
                if handle.rank != rank_i:
                    # Reads may have been served by a live primary's
                    # replica (replicas serve client DATA_GET): keep
                    # the old rank in the candidate chain — a later
                    # write bounced NOT_PRIMARY walks back to it. A
                    # hedge probe repoints its own clone only — never
                    # the tenant's owner accounting.
                    keep_old = get_arr is not None
                    old = handle.rank
                    if not getattr(handle, "_hedge_probe", False):
                        self._note_owner(rank_i, +1)
                        if not keep_old:
                            self._note_owner(old, -1)
                    rest = tuple(
                        r for r in handle.replica_ranks
                        if r not in (rank_i, old)
                    )
                    handle.replica_ranks = (
                        ((old,) + rest) if keep_old else rest
                    )
                    handle.rank = rank_i
                handle.owner_addr = cand
                stats["retries"] = 1
                return stats
            if budget is not None and budget.expired:
                raise OcmDeadlineExceeded(
                    f"transfer of alloc {handle.alloc_id}: "
                    f"{budget.total_ms} ms budget exhausted during "
                    f"failover (last: {type(last).__name__}: {last})"
                ) from last
            if time.monotonic() >= deadline:
                raise last
            await asyncio.sleep(0.05)

    def _note(self, stats: dict, op: str, nbytes: int, dt: float) -> None:
        self.tracer.note_transfer(
            op, nbytes, dt,
            stripes=1,
            window=stats.get("window", 0),
            chunk_bytes=stats.get("chunk", 0),
            retries=stats.get("retries", 0),
            coalesced=stats.get("coalesced", False),
            fabric="mux",
        )
