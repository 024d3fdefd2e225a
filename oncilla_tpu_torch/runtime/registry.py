"""Allocation registry with monotonic ids and leases.

Analogue of the reference's ``rem_alloc_id`` counter + per-node allocation
lists (reference src/mem.c:45,345-348; alloc.c:41-43,242-255), with two
fixes SURVEY.md mandates: the rank-0 bookkeeping actually removes entries on
free (the reference's ``root_allocs`` list grows forever, alloc.c:134-137,
and its free path is a stub, mem.c:221-229), and entries carry leases so a
dead app's allocations are reclaimed (the unresolved TODO, main.c:6-7).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from oncilla_tpu_torch.analysis.lockwatch import make_lock
from oncilla_tpu_torch.core.arena import Extent
from oncilla_tpu_torch.core.errors import OcmInvalidHandle
from oncilla_tpu_torch.core.kinds import OcmKind


@dataclass
class RegEntry:
    alloc_id: int
    kind: OcmKind
    rank: int            # owner rank
    device_index: int
    extent: Extent
    nbytes: int          # user-requested size
    origin_rank: int
    origin_pid: int
    lease_expiry: float  # absolute monotonic deadline; renewed by heartbeat
    # Replication (resilience/): the ordered owner chain of a k-way
    # replicated allocation — chain[0] is the primary, the rest hold
    # replicas. Every holder records the SAME chain, so when rank 0
    # declares a member DEAD each survivor computes the identical
    # promotion locally (first alive member becomes primary). () = the
    # unreplicated common case. ``epoch`` stamps the cluster epoch of the
    # last chain rewrite (failover fencing evidence).
    chain: tuple[int, ...] = ()
    epoch: int = 0
    # QoS priority class (qos/): 0 low, 1 normal, 2 high. Carried from
    # the app's CONNECT declaration via the FLAG_QOS_TAIL alloc tails;
    # the reaper's pressure eviction orders victims by it and never
    # touches an ACTIVE entry above class 0. Snapshot-restored entries
    # come back at the default (the snapshot format predates priorities).
    priority: int = 1
    # Live migration quarantine (elastic/): a MIGRATE_BEGIN-provisioned
    # copy is ``migrating`` until the flip's chain rewrite lands — it
    # refuses client ops (only FLAG_FANOUT stream/mirror writes land)
    # and is DROPPED, not promoted, if ``migrate_src`` dies mid-stream:
    # a half-streamed copy must never serve or fork a chain.
    migrating: bool = False
    migrate_src: int = -1
    # FROZEN tier (persist/): True while the payload lives in the
    # daemon's FrozenStore instead of the host arena. ``extent`` is a
    # zero placeholder meanwhile (the arena bytes were freed at
    # demotion); the first client data op thaws the entry back into the
    # arena. A frozen entry is never an eviction candidate — it holds
    # no arena bytes, and destroying it would silently lose durable
    # payload (the audit's eviction-priority invariant pins this).
    frozen: bool = False

    def is_primary(self, self_rank: int) -> bool:
        """Primary = unreplicated owner, or first member of the chain."""
        return not self.chain or self.chain[0] == self_rank

    def replica_ranks(self, self_rank: int) -> tuple[int, ...]:
        """Ranks this holder must fan writes out to (primary only)."""
        if self.chain and self.chain[0] == self_rank:
            return self.chain[1:]
        return ()


class AllocRegistry:
    """Owner-side registry of live allocations. Ids are even and globally
    unique per daemon: ``id = rank * 2^32 + counter*2`` (apps use odd local
    ids, so the spaces never collide)."""

    def __init__(self, rank: int, lease_s: float = 30.0,
                 app_stale_leases: float = 10.0):
        self._rank = rank
        self._lease_s = lease_s
        # Heartbeat-silence threshold (in lease periods) before an app's
        # row is pruned from the per-app view (config.app_stale_leases;
        # previously a hardcoded 10).
        self._app_stale_leases = app_stale_leases
        self._counter = 0
        self._entries: dict[int, RegEntry] = {}
        self._lock = make_lock("registry._lock")
        # Lease/heartbeat health counters — what Ocm.status() surfaces so
        # the cluster CLI's "lease pressure" column has real data: how
        # often leases were renewed, how many the reaper took back, and
        # when each app was last heard from.
        self._renewals = 0
        self._reclaims = 0
        self._last_beat: dict[tuple[int, int], float] = {}  # (pid, rank)

    def next_id(self) -> int:
        with self._lock:
            self._counter += 1
            return (self._rank << 32) | (self._counter << 1)

    @property
    def counter(self) -> int:
        with self._lock:
            return self._counter

    def restore_counter(self, value: int) -> None:
        with self._lock:
            self._counter = max(self._counter, value)

    def insert(self, entry: RegEntry) -> None:
        with self._lock:
            self._entries[entry.alloc_id] = entry

    def lookup(self, alloc_id: int) -> RegEntry:
        with self._lock:
            e = self._entries.get(alloc_id)
        if e is None:
            raise OcmInvalidHandle(f"unknown alloc_id {alloc_id}")
        return e

    def remove(self, alloc_id: int) -> RegEntry:
        with self._lock:
            e = self._entries.pop(alloc_id, None)
        if e is None:
            raise OcmInvalidHandle(f"unknown alloc_id {alloc_id}")
        return e

    def renew_leases(self, origin_pid: int, origin_rank: int) -> None:
        now = time.monotonic()
        deadline = now + self._lease_s
        with self._lock:
            self._renewals += 1
            self._last_beat[(origin_pid, origin_rank)] = now
            for e in self._entries.values():
                if e.origin_pid == origin_pid and e.origin_rank == origin_rank:
                    e.lease_expiry = deadline

    def note_reclaim(self, n: int = 1) -> None:
        """Count allocations the lease reaper took back."""
        with self._lock:
            self._reclaims += n

    def lease_stats(self, now: float | None = None) -> dict:
        """Lease/heartbeat health: renewal + reaper-reclaim totals, how
        many live entries are past their lease right now, and seconds
        since each app's last heartbeat. Apps silent for
        ``app_stale_leases`` lease periods are pruned from the per-app
        view (the dict must not grow with every app that ever
        attached)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            stale = [
                k for k, t in self._last_beat.items()
                if now - t > self._app_stale_leases * self._lease_s
            ]
            for k in stale:
                del self._last_beat[k]
            return {
                "renewals": self._renewals,
                "reclaims": self._reclaims,
                "expired": sum(
                    1 for e in self._entries.values()
                    if e.lease_expiry < now
                ),
                "lease_s": self._lease_s,
                "apps": {
                    f"{pid}@r{rank}": round(now - t, 3)
                    for (pid, rank), t in self._last_beat.items()
                },
            }

    def set_chain(self, alloc_id: int, chain: tuple[int, ...],
                  epoch: int) -> None:
        """Record (or rewrite) an allocation's replica chain. A chain
        rewrite clears migration quarantine: the flip's DO_REPLICA push
        is the only rewrite a quarantined copy ever sees while its
        source lives (a dead source goes through abort_migrations
        BEFORE any reconcile touches chains)."""
        with self._lock:
            e = self._entries.get(alloc_id)
            if e is None:
                raise OcmInvalidHandle(f"unknown alloc_id {alloc_id}")
            e.chain = tuple(chain)
            e.epoch = epoch
            e.migrating = False
            e.migrate_src = -1

    def mark_migrating(self, alloc_id: int, chain: tuple[int, ...],
                       epoch: int, src: int) -> None:
        """Re-quarantine an existing entry as an in-flight migration
        copy (a retried MIGRATE_BEGIN after a lost reply): chain, epoch
        and quarantine state set under one lock."""
        with self._lock:
            e = self._entries.get(alloc_id)
            if e is None:
                raise OcmInvalidHandle(f"unknown alloc_id {alloc_id}")
            e.chain = tuple(chain)
            e.epoch = epoch
            e.migrating = True
            e.migrate_src = src

    def abort_migrations(self, dead: set[int]) -> list[RegEntry]:
        """Drop quarantined migration copies whose source rank died
        mid-stream (elastic/): a half-streamed copy must never be
        promoted or repaired into a chain. Returns the removed entries
        so the daemon can free their arena extents and journal the
        aborts. MUST run before reconcile_dead for the same dead set."""
        with self._lock:
            doomed = [
                e for e in self._entries.values()
                if e.migrating and e.migrate_src in dead
            ]
            for e in doomed:
                del self._entries[e.alloc_id]
        return doomed

    def reconcile_dead(
        self, dead: set[int], self_rank: int, epoch: int
    ) -> tuple[list[RegEntry], list[dict]]:
        """Drop ``dead`` ranks from every replica chain (resilience/
        failover.py). Returns (newly promoted entries, re-replication work
        list): an entry whose chain's first ALIVE member is ``self_rank``
        is promoted here — registry ownership rewritten under ``epoch`` —
        and every entry this rank is primary for that now holds fewer
        copies than it was built with is reported for repair. Each holder
        of a chain runs the same pure computation, so no coordination
        beyond the dead-set is needed."""
        promoted: list[RegEntry] = []
        repair: list[dict] = []
        with self._lock:
            for e in self._entries.values():
                if not e.chain or not (set(e.chain) & dead):
                    continue
                want = len(e.chain)
                alive = tuple(r for r in e.chain if r not in dead)
                if not alive:
                    continue  # unreachable: this holder is alive
                was_primary = e.chain[0] == self_rank
                e.chain = alive
                e.epoch = epoch
                if alive[0] != self_rank:
                    continue
                if e.migrating:
                    # A quarantined migration copy is never promoted —
                    # abort_migrations (run first) drops it when its
                    # source died; this guard covers any other ordering.
                    continue
                if not was_primary:
                    promoted.append(e)
                if len(alive) < want:
                    repair.append({
                        "alloc_id": e.alloc_id,
                        "kind": e.kind.value,
                        "nbytes": e.nbytes,
                        "chain": list(alive),
                        "want": want,
                        "origin_rank": e.origin_rank,
                        "origin_pid": e.origin_pid,
                    })
        return promoted, repair

    def for_app(self, origin_pid: int, origin_rank: int) -> list[RegEntry]:
        """Every allocation originated by an app — feeds the disconnect-time
        reclamation the reference left as a TODO
        (reference src/main.c:6-7,58-103)."""
        with self._lock:
            return [
                e for e in self._entries.values()
                if e.origin_pid == origin_pid and e.origin_rank == origin_rank
            ]

    def expired(self, now: float | None = None) -> list[RegEntry]:
        now = time.monotonic() if now is None else now
        with self._lock:
            return [e for e in self._entries.values() if e.lease_expiry < now]

    def eviction_candidates(
        self, self_rank: int, now: float | None = None
    ) -> list[RegEntry]:
        """Victim order for the reaper's pressure eviction (qos/):
        host-kind entries this rank is PRIMARY for (evicting a replica
        copy out from under its chain would silently degrade k), sorted
        expired-first, then priority ascending, then oldest lease. The
        caller enforces the class invariant — an ACTIVE entry above
        priority 0 is never evicted — this just supplies the queue."""
        now = time.monotonic() if now is None else now
        with self._lock:
            cands = [
                e for e in self._entries.values()
                if e.kind in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST)
                and e.is_primary(self_rank)
                and not e.frozen
            ]
        cands.sort(
            key=lambda e: (e.lease_expiry >= now, e.priority, e.lease_expiry)
        )
        return cands

    def new_lease_deadline(self) -> float:
        return time.monotonic() + self._lease_s

    @property
    def lease_s(self) -> float:
        return self._lease_s

    def live_count(self) -> int:
        with self._lock:
            return len(self._entries)

    def live_bytes(self, kind_filter=None) -> int:
        with self._lock:
            return sum(
                e.extent.nbytes
                for e in self._entries.values()
                if kind_filter is None or e.kind == kind_filter
            )

    def snapshot(self) -> list[RegEntry]:
        with self._lock:
            return list(self._entries.values())
