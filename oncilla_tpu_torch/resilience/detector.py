"""Daemon-to-daemon failure detection.

Liveness rides the machinery the control plane already has: each daemon's
reaper loop (the heartbeat/lease thread) doubles as the probe driver, in
a STAR topology — every rank probes rank 0, rank 0 probes everyone — so
the cluster-wide probe load is O(n) per interval, not O(n²). A probe is
one short-timeout PING round-trip that also gossips the cluster epoch
and the peer's incarnation (the random u64 minted per daemon object that
lets a DEAD verdict fence exactly the process it was issued against).

Verdicts are per-observer counters over CONSECUTIVE probe failures:

    ALIVE --suspect_after fails--> SUSPECT --dead_after fails--> DEAD

Non-zero ranks report SUSPECT transitions to rank 0 (SUSPECT_NODE);
rank 0 arbitrates — it re-probes the suspect itself, and only its OWN
counter reaching ``dead_after`` produces the DEAD verdict that bumps the
cluster epoch and triggers failover (resilience/failover.py). A DEAD
rank is still probed at a reduced cadence so a restarted daemon on the
same port is re-admitted (probe success -> ALIVE).

A peer that answers with a typed ERROR (the native C++ daemon replying
BAD_MSG to the unknown PING type) is ALIVE — capability absent is not
failure.
"""

from __future__ import annotations

import enum
import socket
from typing import NamedTuple

from oncilla_tpu_torch.analysis.lockwatch import make_lock
from oncilla_tpu_torch.core.errors import OcmProtocolError, OcmRemoteError
from oncilla_tpu_torch.runtime.protocol import ErrCode, Message, MsgType, request


class PeerState(enum.IntEnum):
    """Wire values (SUSPECT_OK.state) — keep stable."""

    ALIVE = 0
    SUSPECT = 1
    DEAD = 2


# Probe DEAD ranks only every Nth tick: enough to notice a restart
# promptly without paying a connect-timeout per tick for a peer that is
# genuinely gone.
_DEAD_PROBE_EVERY = 8


class DeadVerdict(NamedTuple):
    """probe()'s sentinel for "YOU were declared dead": the verdict
    holder's authority — its leadership epoch and cluster epoch. The
    receiver fences itself only when ``(leader_epoch, epoch)``
    lexicographically exceeds its own: leadership epoch dominates so a
    deposed leader that kept bumping its cluster epoch in isolation can
    never out-rank the elected one, and a survivor that already adopted
    the new leadership ignores the deposed claimant's stale verdicts
    entirely (control/)."""

    leader_epoch: int
    epoch: int

    def outranks(self, leader_epoch: int, epoch: int) -> bool:
        return (self.leader_epoch, self.epoch) > (leader_epoch, epoch)


def probe(
    host: str,
    port: int,
    rank: int,
    epoch: int,
    inc: int,
    timeout: float = 1.0,
) -> tuple[int, int] | None:
    """One liveness round-trip to the daemon at (host, port): returns
    (peer_epoch, peer_incarnation) when the peer is alive, None when it
    is unreachable/unresponsive. Uses a dedicated short-timeout dial, NOT
    the peer pool — a pooled lease to a wedged host blocks for the full
    30 s connect timeout, which would stall the reaper loop driving the
    probes. An ERROR reply means alive-but-PING-less (v2/native peer):
    (0, 0) — EXCEPT a typed STALE_EPOCH, which is the peer telling the
    SENDER it was declared dead: surfaced as a :class:`DeadVerdict`
    sentinel (with the verdict holder's authority) so a
    merely-partitioned daemon that heals fences itself instead of
    resuming as a split brain. (The sentinel was documented since replication landed
    but the probe flattened every typed rejection to (0, 0); the
    detector-driven self-fence now works as specified.)"""
    try:
        s = socket.create_connection((host, port), timeout=timeout)
    except OSError:
        return None
    try:
        s.settimeout(timeout)
        r = request(s, Message(
            MsgType.PING, {"rank": rank, "epoch": epoch, "inc": inc}
        ))
        if r.type != MsgType.PING_OK:
            return None
        return r.fields["epoch"], r.fields["inc"]
    except OcmRemoteError as e:
        if e.code == int(ErrCode.STALE_EPOCH):
            # "YOU were declared dead" — with the verdict holder's
            # authority so the caller can decide whether it binds.
            return DeadVerdict(
                getattr(e, "verdict_leader_epoch", 0),
                getattr(e, "verdict_epoch", 0),
            )
        return 0, 0  # typed rejection: the peer is alive, just older
    except (OSError, OcmProtocolError):
        return None
    finally:
        try:
            s.close()
        except OSError:
            pass


class FailureDetector:
    """Per-daemon peer-state table. Thread-safe; pure bookkeeping (no
    sockets) so it is unit-testable without a cluster."""

    def __init__(
        self,
        nranks: int,
        self_rank: int,
        suspect_after: int = 2,
        dead_after: int = 5,
    ):
        self.self_rank = self_rank
        self.suspect_after = max(1, suspect_after)
        self.dead_after = max(self.suspect_after, dead_after)
        self._lock = make_lock("resilience.detector._lock")
        self._states: dict[int, PeerState] = {
            r: PeerState.ALIVE for r in range(nranks) if r != self_rank
        }
        self._fails: dict[int, int] = {r: 0 for r in self._states}
        # Last incarnation seen per rank — what EPOCH_UPDATE fences with.
        self._incs: dict[int, int] = {}
        self._tick = 0

    # -- observations ----------------------------------------------------

    def record_ok(self, rank: int, inc: int = 0) -> PeerState:
        """A successful probe (or any inbound evidence of life). Returns
        the PREVIOUS state so callers can journal recoveries."""
        with self._lock:
            prev = self._states.get(rank)
            if prev is None:
                return PeerState.ALIVE
            self._fails[rank] = 0
            self._states[rank] = PeerState.ALIVE
            if inc:
                self._incs[rank] = inc
            return prev

    def record_fail(self, rank: int) -> PeerState:
        """One failed probe; returns the (possibly escalated) state."""
        with self._lock:
            if rank not in self._states:
                return PeerState.ALIVE
            n = self._fails[rank] = self._fails[rank] + 1
            if n >= self.dead_after:
                st = PeerState.DEAD
            elif n >= self.suspect_after:
                st = PeerState.SUSPECT
            else:
                st = self._states[rank]
            self._states[rank] = st
            return st

    def mark_dead(self, rank: int) -> None:
        """Adopt an arbiter's verdict (EPOCH_UPDATE receivers)."""
        with self._lock:
            if rank in self._states:
                self._states[rank] = PeerState.DEAD
                self._fails[rank] = self.dead_after

    def mark_alive(self, rank: int) -> None:
        """A rank rejoined (ADD_NODE at the master)."""
        with self._lock:
            if rank in self._states:
                self._states[rank] = PeerState.ALIVE
                self._fails[rank] = 0

    # -- elastic membership (elastic/) -----------------------------------

    def add_rank(self, rank: int) -> None:
        """A member JOINed post-boot: start watching it (idempotent —
        an existing row keeps its state)."""
        with self._lock:
            if rank != self.self_rank and rank not in self._states:
                self._states[rank] = PeerState.ALIVE
                self._fails[rank] = 0

    def forget(self, rank: int) -> None:
        """A member LEFT cleanly: stop probing it entirely. Unlike
        mark_dead, no verdict is implied — a clean departure is not a
        death and must not be journaled or repaired as one."""
        with self._lock:
            self._states.pop(rank, None)
            self._fails.pop(rank, None)
            self._incs.pop(rank, None)

    # -- queries ---------------------------------------------------------

    def state(self, rank: int) -> PeerState:
        with self._lock:
            return self._states.get(rank, PeerState.ALIVE)

    def incarnation(self, rank: int) -> int:
        with self._lock:
            return self._incs.get(rank, 0)

    def dead_ranks(self) -> set[int]:
        with self._lock:
            return {
                r for r, s in self._states.items() if s == PeerState.DEAD
            }

    def states(self) -> dict[int, str]:
        """Snapshot for metrics/status surfaces."""
        with self._lock:
            return {r: s.name for r, s in self._states.items()}

    def probe_targets(self) -> list[int]:
        """Ranks to probe THIS tick (star topology is the caller's
        concern; this only applies the reduced-DEAD cadence)."""
        with self._lock:
            self._tick += 1
            return [
                r for r, s in self._states.items()
                if s != PeerState.DEAD
                or self._tick % _DEAD_PROBE_EVERY == 0
            ]
