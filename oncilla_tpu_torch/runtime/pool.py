"""Cached connections to peer daemons, leased per exchange: the port's
copy of ``oncilla_tpu/runtime/pool.py:77-330`` (``PeerPool``).

- A peer's well-formed ERROR reply (:class:`OcmRemoteError`) leaves the
  connection cached: it is still in sync.
- A transport failure (OSError, malformed frame) discards the connection
  and raises; the pool never re-sends a request, because control messages
  are not idempotent.

Several connections per peer, each leased exclusively for one exchange (a
single request/reply, or a whole pipelined stripe): a mutex held across a
round trip on one shared connection per peer would couple every
concurrent transfer to that peer. ``per_peer`` bounds descriptor growth.
"""

from __future__ import annotations

import socket
import threading

from oncilla_tpu_torch.core.errors import (
    OcmConnectError,
    OcmProtocolError,
    OcmRemoteError,
)
from oncilla_tpu_torch.runtime.protocol import Message, request


class PoolEntry:
    """One pooled connection; ``lock`` is held by whoever leased it."""

    __slots__ = ("sock", "lock", "dead")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.lock = threading.Lock()
        self.dead = False


class PeerPool:
    """Connections keyed by (host, port), several per peer, leased
    exclusively per exchange."""

    def __init__(self, timeout: float = 30.0, per_peer: int = 16):
        self._timeout = timeout
        self._per_peer = per_peer
        self._conns: dict[tuple[str, int], list[PoolEntry]] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False

    def lease(self, host: str, port: int) -> PoolEntry:
        """An exclusively held connection (``entry.lock`` acquired): an
        idle cached one, else a fresh dial. End the lease with
        :meth:`release` (still in sync) or :meth:`discard` (broken)."""
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
                # At the cap: wait until a lease to this peer ends; the
                # timeout is a rescan, not the wakeup mechanism.
                self._cond.wait(timeout=1.0)
        return self._dial(key)

    def _dial(self, key: tuple[str, int]) -> PoolEntry:
        """Dial a fresh connection to ``key`` and register it, leased."""
        try:
            s = socket.create_connection(key, timeout=self._timeout)
        except OSError as e:
            raise OcmConnectError(f"peer {key[0]}:{key[1]} unreachable: {e}") from e
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Large buffers so a pipelined 16 MiB chunk streams without the
        # sender stalling on the default window (the kernel may clamp).
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
        """Lease up to ``n`` connections to one peer, the stripe set of a
        striped transfer. The first lease has :meth:`lease` semantics; the
        rest are opportunistic (an idle cached entry, or a fresh dial while
        under the cap), so two concurrent striped transfers to one peer
        degrade to fewer stripes each instead of waiting on each other.
        Always returns at least one entry."""
        entries = [self.lease(host, port)]
        key = (host, port)
        while len(entries) < n:
            with self._cond:
                if self._closed:
                    break
                lst = self._conns.setdefault(key, [])
                got = None
                for e in lst:
                    if (e not in entries and not e.dead
                            and e.lock.acquire(blocking=False)):
                        if e.dead:
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
        """Drop a broken leased connection (closes it, ends the lease)."""
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
        """One request/reply, no resend on failure. ``timeout`` bounds the
        exchange; a timed-out connection is discarded like any transport
        failure."""
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
            # Anything else interrupting the exchange leaves the stream
            # desynced: never cache a half-read connection.
            self.discard(host, port, entry)
            raise
        if timeout is not None:
            entry.sock.settimeout(None)
        self.release(host, port, entry)
        return reply

    def evict(self, host: str, port: int) -> int:
        """Drop every cached connection to one peer; leased entries are
        marked dead and closed too (their holders discard on their own
        error path). Returns the number dropped; the pool stays usable."""
        with self._cond:
            lst = self._conns.pop((host, port), [])
            for e in lst:
                e.dead = True
                try:
                    e.sock.close()
                except OSError:
                    pass
            self._cond.notify_all()
        return len(lst)

    def close(self) -> None:
        """Terminal: drops every connection and refuses new dials."""
        with self._cond:
            self._closed = True
            for lst in self._conns.values():
                for e in lst:
                    e.dead = True
                    try:
                        e.sock.close()
                    except OSError:
                        pass
            self._conns.clear()
            self._cond.notify_all()
