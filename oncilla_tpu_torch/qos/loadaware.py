"""Load-aware placement: site allocations off HOT ranks, not just full ones.

``CapacityAware`` ranks candidates by free bytes — static capacity minus
booked bytes, the accounting the reference commented out
(alloc.c:87-92). But a rank can have plenty of free arena and still be
the worst place to land a new tenant: its daemon may be saturating its
NIC or serving with a long p99. ``LoadAware`` keeps the capacity math
and discounts each rank's free bytes by a load score computed from the
live per-rank stats the obs subsystem already exports (STATUS /
STATUS_PROM: live bytes, dcn serve p99, recent Gbit/s) — the same
telemetry-driven-placement shape as Ray's resource-aware scheduler.

Rank 0 feeds :meth:`observe` from its reaper loop (``Daemon``
polls peer STATUS every ``OCM_LOADAWARE_POLL_MS``); a rank never
observed scores 0 and behaves exactly like CapacityAware, so the policy
degrades gracefully when telemetry is missing.
"""

from __future__ import annotations

import time

from oncilla_tpu_torch.runtime.placement import CapacityAware

# Normalization references: a rank at/above these reads as "fully hot"
# on that axis. Conservative round numbers — the score only needs to
# ORDER ranks, not measure them.
_REF_GBPS = 8.0        # recent DCN serve throughput, gigabits/s
_REF_P99_US = 50_000.0  # dcn serve p99, microseconds

# Weights: utilization dominates (it is also the back-pressure signal),
# bandwidth and latency refine. Sum < 1 keeps the discounted weight
# positive so a hot-but-huge rank still beats a full small one.
_W_UTIL, _W_GBPS, _W_P99 = 0.5, 0.25, 0.15


class LoadAware(CapacityAware):
    """CapacityAware whose candidate weight is ``free * (1 - load)``."""

    # Scores older than this are ignored — a stalled poller must not
    # pin a long-gone hot spot.
    STALE_S = 30.0

    def __init__(self):
        super().__init__()
        # rank -> (score in [0, ~0.9], monotonic stamp). Written by the
        # rank-0 poller thread, read under place()'s lock; tuple rebind
        # is atomic so a torn read is impossible.
        self._load: dict[int, tuple[float, float]] = {}

    def observe(self, rank: int, live_bytes: int = 0, gbps: float = 0.0,
                p99_us: float = 0.0) -> float:
        """Fold one rank's live stats into its load score; returns it."""
        with self._lock:
            node = self._nodes.get(rank)
            cap = node.host_arena_bytes if node is not None else 0
        util = (live_bytes / cap) if cap else 0.0
        score = (
            _W_UTIL * min(1.0, max(0.0, util))
            + _W_GBPS * min(1.0, max(0.0, gbps) / _REF_GBPS)
            + _W_P99 * min(1.0, max(0.0, p99_us) / _REF_P99_US)
        )
        self._load[rank] = (score, time.monotonic())
        return score

    def load_scores(self) -> dict[int, float]:
        """Current (non-stale) scores — surfaced by STATUS for the obs
        table and the soak's assertions."""
        now = time.monotonic()
        return {
            r: round(s, 4)
            for r, (s, ts) in list(self._load.items())
            if now - ts <= self.STALE_S
        }

    def _weight(self, rank: int, free: int) -> int:
        rec = self._load.get(rank)
        if rec is None:
            return free
        score, ts = rec
        if time.monotonic() - ts > self.STALE_S:
            return free
        return int(free * (1.0 - min(0.9, score)))
