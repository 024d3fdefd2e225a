"""The port's copy of ``oncilla_tpu/runtime/pool.py``, line for line: the
daemon's and the client's connection pool.

Shared cached-connection pool for daemon⇄daemon and app⇄owner traffic.

One implementation serves both sides (the client previously duplicated this
logic without reconnect handling). Semantics are deliberately conservative:

- A peer's well-formed ERROR reply (:class:`OcmRemoteError`) leaves the
  connection cached — it is still in sync.
- A transport failure (OSError, malformed frame) **discards** the
  connection and raises; the pool never re-sends a request, because control
  messages are not idempotent (a re-sent DO_ALLOC would leak an extent, a
  re-sent DO_FREE would report a spurious unknown-id error). Callers with
  idempotent messages (ADD_NODE, HEARTBEAT) retry themselves.

Concurrency design — MULTIPLE connections per peer. One-connection-per-peer
with a mutex held across the request/reply round-trip deadlocks the
cluster: the waits-for graph couples "holds conn A→B's mutex awaiting B's
reply" with "B's handler needs conn B→C" edges, and with ≥3 daemons
exchanging REQ_ALLOC forwards, DO_ALLOC/DO_FREE legs, and NOTE_FREE
accounting simultaneously those edges form cycles (observed: the
multi-client stress test stalling ~30 s until every socket timed out).
The message call graph itself is acyclic, so leasing an idle-or-new
connection per request removes every mutex edge and with it the deadlock;
``per_peer`` only bounds descriptor growth (reaching it blocks on an
existing connection — with the cap far above any realistic outbound
concurrency, that fallback never participates in a cycle in practice).
"""

from __future__ import annotations

import socket
import threading

from oncilla_tpu_torch.analysis import waitwatch
from oncilla_tpu_torch.analysis.lockwatch import make_lock
from oncilla_tpu_torch.core.errors import (
    OcmConnectError,
    OcmProtocolError,
    OcmRemoteError,
)
from oncilla_tpu_torch.obs import journal as obs_journal
from oncilla_tpu_torch.runtime.protocol import Message, request

# Chaos seam (resilience/chaos.py): a process-global hook fired once per
# connection lease, BEFORE the caller touches the socket. The deterministic
# fault injector uses it to drop (raise OSError), delay, or partition
# traffic — and to trigger scheduled daemon kills — at a reproducible
# logical op index. None (the default) costs one global read per lease.
_chaos_hook = None


def set_chaos_hook(fn) -> None:
    """Install (or clear with None) the process-wide chaos hook, called as
    ``fn(host, port)`` on every pool lease. Test/harness-only."""
    global _chaos_hook
    _chaos_hook = fn


def current_chaos_hook():
    """The installed chaos hook (or None). The mux channel runtime
    (runtime/mux.py) honors the same seam per request, so deterministic
    fault schedules keyed by logical op index keep firing when the data
    plane bypasses pool leases entirely."""
    return _chaos_hook


class PoolEntry:
    """One pooled connection; ``lock`` is held by whoever leased it."""

    __slots__ = ("sock", "lock", "dead")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.lock = make_lock("pool.entry")
        self.dead = False


class PeerPool:
    """Connections keyed by (host, port), several per peer, leased
    exclusively per exchange."""

    def __init__(self, timeout: float = 30.0, per_peer: int = 16):
        self._timeout = timeout
        self._per_peer = per_peer
        self._conns: dict[tuple[str, int], list[PoolEntry]] = {}
        self._lock = make_lock("pool._lock")
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._blocked = False

    def set_blocked(self, on: bool) -> None:
        """Harness-level partition emulation (resilience/chaos): while
        set, every lease raises OcmConnectError — what a fully
        partitioned host's outbound traffic looks like to its own
        daemon. Unlike close(), fully reversible; cached connections
        survive for the heal."""
        self._blocked = bool(on)

    def lease(self, host: str, port: int) -> PoolEntry:
        """An exclusively held connection (``entry.lock`` acquired):
        an idle cached one, else a fresh dial — callers doing multi-frame
        pipelining keep the lease for the whole exchange, then
        :meth:`release` (still in sync) or :meth:`discard` (broken)."""
        if self._blocked:
            raise OcmConnectError(
                f"peer {host}:{port} unreachable: pool partitioned "
                "(chaos isolation)"
            )
        hook = _chaos_hook
        if hook is not None:
            try:
                hook(host, port)
            except OSError as e:
                # An injected fault wears the pool's normal unreachable-
                # peer shape, so every caller's retry ladder sees exactly
                # what a real torn connection would produce.
                raise OcmConnectError(
                    f"peer {host}:{port} unreachable: {e}"
                ) from e
        key = (host, port)
        with self._cond:
            while True:
                if self._closed:
                    raise OcmConnectError("peer pool is shut down")
                entries = self._conns.setdefault(key, [])
                for e in entries:
                    if not e.dead and e.lock.acquire(blocking=False):
                        if e.dead:  # discarded between scan and acquire
                            e.lock.release()
                            continue
                        return e
                if len(entries) < self._per_peer:
                    break  # room to dial a fresh connection
                # At the cap: wait until ANY lease to this peer ends
                # (release or discard notifies); the timeout is a
                # belt-and-braces rescan, not the wakeup mechanism.
                # Blocking on pool admission is the wait-graph edge the
                # pool-stratification rule reasons about — record it.
                waitwatch.note_wait(waitwatch.POOL_SLOT)
                self._cond.wait(timeout=1.0)
        return self._dial(key)

    def _dial(self, key: tuple[str, int]) -> PoolEntry:
        """Dial a fresh connection to ``key`` and register it, leased."""
        try:
            s = socket.create_connection(key, timeout=self._timeout)
        except OSError as e:
            raise OcmConnectError(
                f"peer {key[0]}:{key[1]} unreachable: {e}"
            ) from e
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Large buffers so an 8 MiB pipelined chunk streams without the
        # sender stalling on the default ~208 KiB window (the kernel may
        # clamp; best effort).
        for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
            try:
                s.setsockopt(socket.SOL_SOCKET, opt, 4 << 20)
            except OSError:
                pass
        entry = PoolEntry(s)
        entry.lock.acquire()
        with self._lock:
            if self._closed:
                s.close()
                raise OcmConnectError("peer pool is shut down")
            self._conns.setdefault(key, []).append(entry)
        return entry

    def lease_set(self, host: str, port: int, n: int) -> list[PoolEntry]:
        """Lease up to ``n`` connections to one peer — the stripe set of a
        multi-stream transfer (one logical transfer split across parallel
        sockets, each with its own FIFO request/reply stream). The first
        lease has :meth:`lease` semantics (may block at the cap); the rest
        are OPPORTUNISTIC — an idle cached entry or a fresh dial while the
        peer is under its cap — so two concurrent striped transfers to one
        peer degrade to fewer stripes each instead of deadlocking on each
        other's leases. Always returns at least one entry; callers size
        their stripes to ``len(result)``."""
        entries = [self.lease(host, port)]
        key = (host, port)
        while len(entries) < n:
            fresh_ok = False
            with self._cond:
                if self._closed:
                    break
                lst = self._conns.setdefault(key, [])
                got = None
                for e in lst:
                    if (
                        e not in entries
                        and not e.dead
                        and e.lock.acquire(blocking=False)
                    ):
                        if e.dead:  # discarded between scan and acquire
                            e.lock.release()
                            continue
                        got = e
                        break
                if got is not None:
                    entries.append(got)
                    continue
                fresh_ok = len(lst) < self._per_peer
            if not fresh_ok:
                break  # at the cap: never wait for siblings' leases
            try:
                entries.append(self._dial(key))
            except OcmConnectError:
                break  # a dial failure shrinks the stripe set, not the op
        return entries

    def release(self, host: str, port: int, entry: PoolEntry) -> None:
        """Return a healthy leased connection to the pool."""
        entry.lock.release()
        with self._cond:
            self._cond.notify_all()

    def discard(self, host: str, port: int, entry: PoolEntry) -> None:
        """Drop a broken leased connection (closes it, ends the lease);
        waiters at the cap are woken because the peer's list shrank."""
        # Connection churn is a leading indicator of a flapping peer —
        # journaled (OCM_EVENTS=1) so the obs CLI's merged timeline shows
        # discards next to the stripe retries they caused.
        obs_journal.record("pool_discard", host=host, port=port)
        entry.dead = True
        with self._cond:
            lst = self._conns.get((host, port), [])
            if entry in lst:
                lst.remove(entry)
        try:
            entry.sock.close()
        except OSError:
            pass
        entry.lock.release()
        with self._cond:
            self._cond.notify_all()

    def request(self, host: str, port: int, msg: Message,
                timeout: float | None = None) -> Message:
        """One request/reply. No resend on failure (see module
        docstring). ``timeout`` bounds the whole exchange
        (resilience/timebudget.py: a budgeted caller may not sit in a
        blocked recv against a frozen peer) — a timed-out connection is
        discarded like any transport failure, and a bounded exchange
        that succeeds goes back to the pool blocking."""
        # The exchange blocks on the peer daemon while this thread may
        # hold locks — exactly the held-across-RPC edge lock-across-rpc
        # lints for. Recorded BEFORE the lease on purpose: the
        # per-connection pool.entry lease is try-acquire-or-fresh
        # (never an ordering resource), and counting it as held here
        # would report the by-construction-safe pool.entry ->
        # rpc:daemon -> pool.entry cycle on every daemon that both
        # serves and dials.
        waitwatch.note_wait(waitwatch.RPC_DAEMON)
        entry = self.lease(host, port)
        if timeout is not None:
            entry.sock.settimeout(timeout)
        try:
            reply = request(entry.sock, msg)
        except OcmRemoteError:
            if timeout is not None:
                entry.sock.settimeout(None)
            self.release(host, port, entry)
            raise  # connection still in sync
        except (OSError, OcmProtocolError) as e:
            self.discard(host, port, entry)
            raise OcmConnectError(f"peer {host}:{port} failed: {e}") from e
        except BaseException:
            # Anything else that interrupts the exchange (decode bugs,
            # KeyboardInterrupt mid-recv) leaves the stream desynced; the
            # lease must end either way, and never with a cached
            # half-read connection.
            self.discard(host, port, entry)
            raise
        if timeout is not None:
            entry.sock.settimeout(None)
        self.release(host, port, entry)
        return reply

    def evict(self, host: str, port: int) -> int:
        """Drop every cached connection to ONE peer (resilience/: the
        failure detector's DEAD verdict). Without this, stale sockets to
        a crashed daemon only fail lazily — each subsequent lease hands
        out a dead connection that costs a full send/recv error cycle
        before the caller's retry path engages. Leased (in-flight)
        entries are marked dead and closed too; their holders hit the
        error immediately and discard on their own path. Returns the
        number of entries dropped; the pool stays usable (a restarted
        daemon on the same port dials fresh)."""
        key = (host, port)
        with self._cond:
            lst = self._conns.pop(key, [])
            for e in lst:
                e.dead = True
                try:
                    e.sock.close()
                except OSError:
                    pass
            self._cond.notify_all()
        if lst:
            obs_journal.record("pool_evict", host=host, port=port, n=len(lst))
        return len(lst)

    def size(self) -> int:
        """Cached connections across all peers — the pool's share of the
        client's fd footprint (Ocm.status() ``client.sockets``)."""
        with self._lock:
            return sum(
                sum(1 for e in lst if not e.dead)
                for lst in self._conns.values()
            )

    def reset(self) -> None:
        """Drop every cached connection but keep the pool usable (e.g. to
        free a peer's port before it rebinds); in-flight leases see their
        socket close and discard on their own error path."""
        with self._cond:
            for lst in self._conns.values():
                for e in lst:
                    e.dead = True
                    try:
                        e.sock.close()
                    except OSError:
                        pass
            self._conns.clear()
            self._cond.notify_all()

    def close(self) -> None:
        """Terminal: drops every connection AND refuses new dials, so a
        worker racing shutdown cannot re-dial a hung peer."""
        with self._lock:
            self._closed = True
        self.reset()
