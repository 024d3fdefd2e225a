"""The port's copy of ``oncilla_tpu/qos/policy.py``, line for line: the
priority classes the serving engine seats by, and the daemon's QoS.

Multi-tenant QoS core: quotas, priority classes, admission control.

The reference trusts every application equally — REQ_ALLOC is
first-come-first-served with no notion of a tenant (alloc_find places
whatever arrives, reference src/alloc.c:77-140). At "thousands of
concurrent apps per daemon" that free-for-all lets one runaway tenant
starve everyone, so this module adds the Borg-style tiers on top of the
existing lease machinery:

- **profiles** — an app declares (priority, quota_bytes, quota_handles)
  at CONNECT behind ``FLAG_CAP_QOS`` (declined-by-silence by v2/native
  peers); undeclared apps run at the daemon's ``OCM_QUOTA_*`` defaults.
- **admission** — the app's LOCAL daemon gates every REQ_ALLOC against
  the profile (``QUOTA_EXCEEDED``) and the daemon-wide concurrent-app
  cap (``ADMISSION_DENIED``). Reservations are optimistic: ``admit``
  reserves, ``commit`` pins the alloc id, ``abort`` rolls back a
  placement that failed downstream.
- **priority classes** — 0 low, 1 normal, 2 high. Low is preemptible:
  the owner reaper may evict ACTIVE low-priority extents under arena
  pressure; normal/high active extents are never evicted (the
  no-eviction-of-active-priority invariant); high additionally bypasses
  back-pressure BUSY.

Accounting is origin-side (the daemon the app connected to): that daemon
sees every REQ_ALLOC and REQ_FREE of a well-behaved app, and DISCONNECT
or heartbeat staleness clears the whole tenant — so an app that crashes
mid-lease cannot pin quota forever. An owner-side lease reaping of a
REMOTE allocation is reconciled by those same paths, not per-event.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field

from oncilla_tpu_torch.analysis.lockwatch import make_lock
from oncilla_tpu_torch.core.errors import OcmAdmissionDenied, OcmQuotaExceeded

# Priority classes (wire: one u8). Keep the numeric order meaningful:
# the reaper's victim queue sorts ascending.
PRIO_LOW, PRIO_NORMAL, PRIO_HIGH = 0, 1, 2
PRIO_NAMES = {PRIO_LOW: "low", PRIO_NORMAL: "normal", PRIO_HIGH: "high"}

# The CONNECT profile tail (FLAG_QOS_TAIL): priority u8 | quota_bytes
# u64 | quota_handles u32. 0 quotas mean "use the daemon's defaults".
PROFILE_TAIL = struct.Struct("<BQI")


def pack_profile(priority: int, quota_bytes: int, quota_handles: int) -> bytes:
    return PROFILE_TAIL.pack(priority, quota_bytes, quota_handles)


def unpack_profile(data) -> tuple[int, int, int] | None:
    """Parse a CONNECT profile tail; None when too short (a decliner's
    echo or a future layout we don't understand — run at defaults)."""
    if data is None or len(data) < PROFILE_TAIL.size:
        return None
    prio, qb, qh = PROFILE_TAIL.unpack_from(data, 0)
    return min(max(prio, PRIO_LOW), PRIO_HIGH), qb, qh


def suggest_backoff_ms(occupancy: float, high_frac: float,
                       base_ms: int) -> int:
    """Server-suggested BUSY backoff: the deeper past the watermark, the
    longer the hint (base at the threshold, 5x base when the arena is
    packed solid) — so a saturated cluster spreads its retry herd out
    instead of inviting it back in lockstep."""
    if high_frac >= 1.0:
        return max(1, base_ms)
    over = max(0.0, min(1.0, (occupancy - high_frac) / (1.0 - high_frac)))
    return max(1, int(base_ms * (1.0 + 4.0 * over)))


@dataclass
class Tenant:
    """One app's QoS state on its origin daemon. ``quota_*`` of 0 defer
    to the daemon-wide defaults at check time (so an operator can raise
    OCM_QUOTA_BYTES without re-registering every app)."""

    pid: int
    rank: int
    priority: int = PRIO_NORMAL
    quota_bytes: int = 0
    quota_handles: int = 0
    used_bytes: int = 0
    handles: int = 0
    last_seen: float = field(default_factory=time.monotonic)

    @property
    def key(self) -> tuple[int, int]:
        return (self.pid, self.rank)


class QosManager:
    """Per-daemon tenant table + admission bookkeeping. Thread-safe; the
    lock is a leaf (nothing is acquired under it)."""

    def __init__(self, config):
        self._cfg = config
        self._tenants: dict[tuple[int, int], Tenant] = {}
        # alloc_id -> (tenant key, nbytes): how REQ_FREE / local frees
        # give quota back without the wire carrying tenant identity.
        self._allocs: dict[int, tuple[tuple[int, int], int]] = {}
        self._lock = make_lock("qos._lock")
        self.counters = {
            "quota_exceeded": 0,
            "admission_denied": 0,
            "busy": 0,
        }
        # Pressure evictions by (priority, was the lease active): the
        # [priority][active] split is what pins the invariant — the
        # active column above PRIO_LOW must stay 0 forever.
        self.evictions = [[0, 0], [0, 0], [0, 0]]
        # Demotions to FROZEN (persist/), same shape: victims that
        # spilled to disk instead of being destroyed. Split from
        # evictions so the journal's tier_demote/qos_evict distinction
        # survives into the accounting — a demotion is NOT data
        # destruction, and the tenant's quota stays held (the bytes are
        # still stored on its behalf).
        self.demotions = [[0, 0], [0, 0], [0, 0]]

    # -- profile registration (CONNECT) ----------------------------------

    def register(self, pid: int, rank: int, priority: int,
                 quota_bytes: int, quota_handles: int) -> None:
        key = (pid, rank)
        with self._lock:
            t = self._tenants.get(key)
            if t is None:
                t = self._tenants[key] = Tenant(pid, rank)
            t.priority = min(max(priority, PRIO_LOW), PRIO_HIGH)
            t.quota_bytes = max(0, quota_bytes)
            t.quota_handles = max(0, quota_handles)
            t.last_seen = time.monotonic()

    def priority_of(self, pid: int, rank: int) -> int:
        with self._lock:
            t = self._tenants.get((pid, rank))
            return t.priority if t is not None else PRIO_NORMAL

    def touch(self, pid: int, rank: int) -> None:
        """Heartbeat hook: keeps an app's tenant state from going stale."""
        with self._lock:
            t = self._tenants.get((pid, rank))
            if t is not None:
                t.last_seen = time.monotonic()

    # -- admission (REQ_ALLOC at the origin daemon) ----------------------

    def _limits(self, t: Tenant) -> tuple[int, int]:
        qb = t.quota_bytes or self._cfg.quota_bytes
        qh = t.quota_handles or self._cfg.quota_handles
        return qb, qh

    def admit(self, pid: int, rank: int, nbytes: int) -> None:
        """Reserve ``nbytes`` + one handle against the app's quota, or
        raise the typed rejection. A successful reservation must be
        followed by exactly one :meth:`commit` or :meth:`abort`."""
        key = (pid, rank)
        with self._lock:
            t = self._tenants.get(key)
            if t is None:
                cap = self._cfg.max_apps
                active = sum(
                    1 for x in self._tenants.values()
                    if x.handles > 0 or x.used_bytes > 0
                )
                if cap and active >= cap:
                    self.counters["admission_denied"] += 1
                    raise OcmAdmissionDenied(
                        f"app {pid}@r{rank} refused: daemon already serves "
                        f"{active} apps (OCM_MAX_APPS={cap})"
                    )
                t = self._tenants[key] = Tenant(pid, rank)
            qb, qh = self._limits(t)
            if qb and t.used_bytes + nbytes > qb:
                self.counters["quota_exceeded"] += 1
                raise OcmQuotaExceeded(
                    f"app {pid}@r{rank} byte quota: {t.used_bytes} live "
                    f"+ {nbytes} requested > {qb} allowed"
                )
            if qh and t.handles + 1 > qh:
                self.counters["quota_exceeded"] += 1
                raise OcmQuotaExceeded(
                    f"app {pid}@r{rank} handle quota: {t.handles} live "
                    f">= {qh} allowed"
                )
            t.used_bytes += nbytes
            t.handles += 1
            t.last_seen = time.monotonic()

    def commit(self, pid: int, rank: int, alloc_id: int,
               nbytes: int) -> None:
        """Pin an admitted reservation to its alloc id (release path)."""
        with self._lock:
            self._allocs[alloc_id] = ((pid, rank), nbytes)

    def abort(self, pid: int, rank: int, nbytes: int) -> None:
        """Roll back a reservation whose placement failed downstream."""
        with self._lock:
            t = self._tenants.get((pid, rank))
            if t is not None:
                t.used_bytes = max(0, t.used_bytes - nbytes)
                t.handles = max(0, t.handles - 1)

    def release(self, alloc_id: int) -> None:
        """Give quota back on free. Idempotent — reaper, client free and
        disconnect reclamation may all race to the same id."""
        with self._lock:
            rec = self._allocs.pop(alloc_id, None)
            if rec is None:
                return
            key, nbytes = rec
            t = self._tenants.get(key)
            if t is not None:
                t.used_bytes = max(0, t.used_bytes - nbytes)
                t.handles = max(0, t.handles - 1)

    def drop_app(self, pid: int, rank: int) -> None:
        """DISCONNECT: the tenant and every remembered alloc go at once."""
        key = (pid, rank)
        with self._lock:
            self._tenants.pop(key, None)
            dead = [a for a, (k, _) in self._allocs.items() if k == key]
            for a in dead:
                del self._allocs[a]

    def prune_stale(self, now: float | None = None) -> int:
        """Drop tenants silent past app_stale_leases lease periods — the
        QoS twin of lease_stats' per-app pruning, and the backstop that
        returns a crashed app's quota."""
        now = time.monotonic() if now is None else now
        horizon = self._cfg.app_stale_leases * self._cfg.lease_s
        with self._lock:
            stale = [
                k for k, t in self._tenants.items()
                if now - t.last_seen > horizon
            ]
            for k in stale:
                del self._tenants[k]
                dead = [a for a, (key, _) in self._allocs.items() if key == k]
                for a in dead:
                    del self._allocs[a]
        return len(stale)

    # -- telemetry -------------------------------------------------------

    def note_busy(self) -> None:
        with self._lock:
            self.counters["busy"] += 1

    def note_eviction(self, priority: int, active: bool) -> None:
        with self._lock:
            p = min(max(priority, PRIO_LOW), PRIO_HIGH)
            self.evictions[p][1 if active else 0] += 1

    def note_demotion(self, priority: int, active: bool) -> None:
        """A pressure victim spilled to FROZEN (not destroyed): counted
        apart from evictions, quota untouched."""
        with self._lock:
            p = min(max(priority, PRIO_LOW), PRIO_HIGH)
            self.demotions[p][1 if active else 0] += 1

    def metrics(self, now: float | None = None) -> dict:
        """What STATUS / STATUS_PROM / the obs cluster table render."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return {
                "counters": dict(self.counters),
                "evictions_by_priority": {
                    PRIO_NAMES[p]: {
                        "expired": self.evictions[p][0],
                        "active": self.evictions[p][1],
                    }
                    for p in (PRIO_LOW, PRIO_NORMAL, PRIO_HIGH)
                },
                "demotions_by_priority": {
                    PRIO_NAMES[p]: {
                        "expired": self.demotions[p][0],
                        "active": self.demotions[p][1],
                    }
                    for p in (PRIO_LOW, PRIO_NORMAL, PRIO_HIGH)
                },
                "apps": {
                    f"{t.pid}@r{t.rank}": {
                        "priority": t.priority,
                        "used_bytes": t.used_bytes,
                        "quota_bytes": self._limits(t)[0],
                        "handles": t.handles,
                        "quota_handles": self._limits(t)[1],
                        "age_s": round(now - t.last_seen, 3),
                    }
                    for t in self._tenants.values()
                },
            }
