"""Serving-side metrics: counters and the co-located publication registry,
the port's copy of ``oncilla_tpu/serving/metrics.py``.

Stdlib only. Every live :class:`ServingStats` can be published in this
package's own registry (:func:`publish`); :func:`colocated` snapshots every
published engine. The port's daemon folds the registry of its process
into its STATUS and STATUS_PROM replies (``runtime/daemon.py``,
``obs/prom.py``), as the JAX package's daemons fold theirs.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_published: dict[str, "ServingStats"] = {}


class ServingStats:
    """Thread-safe counter block for one serving engine.

    All mutation goes through the ``note_*`` methods; :meth:`snapshot`
    returns the plain-dict meta that a status reader renders. Byte
    figures are *live* occupancy (gauges); token/stall/move figures are
    lifetime counters.
    """

    def __init__(self, engine: str = "engine") -> None:
        self.engine = engine
        self._mu = threading.Lock()
        self.prefill_tokens = 0
        self.decode_tokens = 0
        # Page-residency lookups at schedule time: hit = the page was
        # already decode-resident (hot tier), miss = a fetch was needed.
        self.lookups = 0
        self.hits = 0
        self.promotes = 0
        self.demotes = 0
        self.cow_copies = 0
        # Prefix sharing.
        self.prefix_hits = 0
        self.prefix_shared_bytes = 0
        self.prefix_extents = 0
        # Prefetch / stall.
        self.prefetch_issued = 0
        self.prefetch_completed = 0
        self.stalls = 0
        self.stall_s = 0.0
        # Live per-tier occupancy (set absolutely by the page store).
        self.tier_bytes: dict[str, int] = {}
        self.tier_pages: dict[str, int] = {}
        # Cold-tier (remote) data-plane traffic.
        self.remote_bytes_in = 0
        self.remote_bytes_out = 0
        # True-batched decode: per-tick fused-step accounting. size_hist
        # and step_s_hist are cumulative prom-style bucket counts
        # (bucket upper bound -> observations <= bound), so a histogram
        # can be rendered from a stdlib-only snapshot.
        self.batch_steps = 0
        self.batch_size_sum = 0
        self.batch_size_last = 0
        self.batch_size_max = 0
        self.batch_size_hist = {b: 0 for b in self.BATCH_BUCKETS}
        self.step_s_sum = 0.0
        self.step_s_hist = {b: 0 for b in self.STEP_BUCKETS}
        self.prefill_chunks = 0
        self.preempts: dict[str, int] = {}
        # Time-to-first-token per session (submit -> first emitted
        # token), same cumulative prom-style bucket shape as the step
        # histogram so the SLO engine can window a quantile over it.
        self.ttft_count = 0
        self.ttft_s_sum = 0.0
        self.ttft_s_hist = {b: 0 for b in self.TTFT_BUCKETS}

    BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)
    STEP_BUCKETS = (0.001, 0.005, 0.025, 0.1, 0.5, 2.5)
    TTFT_BUCKETS = (0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0)

    # -- mutation ---------------------------------------------------------

    def note_tokens(self, n: int, phase: str = "decode") -> None:
        with self._mu:
            if phase == "prefill":
                self.prefill_tokens += n
            else:
                self.decode_tokens += n

    def note_lookup(self, hit: bool) -> None:
        with self._mu:
            self.lookups += 1
            if hit:
                self.hits += 1

    def note_move(self, promote: bool) -> None:
        with self._mu:
            if promote:
                self.promotes += 1
            else:
                self.demotes += 1

    def note_cow(self) -> None:
        with self._mu:
            self.cow_copies += 1

    def note_prefix_hit(self, shared_bytes: int) -> None:
        with self._mu:
            self.prefix_hits += 1
            self.prefix_shared_bytes += shared_bytes

    def note_prefix_release(self, shared_bytes: int) -> None:
        with self._mu:
            self.prefix_shared_bytes -= shared_bytes

    def note_extents(self, delta: int) -> None:
        with self._mu:
            self.prefix_extents += delta

    def note_prefetch(self, completed: bool = False) -> None:
        with self._mu:
            if completed:
                self.prefetch_completed += 1
            else:
                self.prefetch_issued += 1

    def note_stall(self, seconds: float) -> None:
        with self._mu:
            self.stalls += 1
            self.stall_s += seconds

    def note_remote(self, nbytes: int, inbound: bool) -> None:
        with self._mu:
            if inbound:
                self.remote_bytes_in += nbytes
            else:
                self.remote_bytes_out += nbytes

    def note_batch_step(self, size: int, seconds: float) -> None:
        """One fused batched decode tick: ``size`` sessions advanced one
        token in one decode step taking ``seconds``."""
        with self._mu:
            self.batch_steps += 1
            self.batch_size_sum += size
            self.batch_size_last = size
            self.batch_size_max = max(self.batch_size_max, size)
            self.step_s_sum += seconds
            for b in self.BATCH_BUCKETS:
                if size <= b:
                    self.batch_size_hist[b] += 1
            for b in self.STEP_BUCKETS:
                if seconds <= b:
                    self.step_s_hist[b] += 1

    def note_ttft(self, seconds: float) -> None:
        """One session's time-to-first-token."""
        with self._mu:
            self.ttft_count += 1
            self.ttft_s_sum += seconds
            for b in self.TTFT_BUCKETS:
                if seconds <= b:
                    self.ttft_s_hist[b] += 1

    def note_preempt(self, reason: str) -> None:
        """A session lost (or yielded) its batch slot this tick:
        ``slot`` = lost priority-ordered slot contention, ``cold_page``
        = yielded because its pages had not prefetched yet."""
        with self._mu:
            self.preempts[reason] = self.preempts.get(reason, 0) + 1

    def note_prefill_chunk(self) -> None:
        with self._mu:
            self.prefill_chunks += 1

    def set_occupancy(self, tier_pages: dict[str, int],
                      tier_bytes: dict[str, int]) -> None:
        with self._mu:
            self.tier_pages = dict(tier_pages)
            self.tier_bytes = dict(tier_bytes)

    # -- export -----------------------------------------------------------

    @property
    def hit_ratio(self) -> float:
        with self._mu:
            return self.hits / self.lookups if self.lookups else 0.0

    def snapshot(self) -> dict:
        with self._mu:
            lookups, hits = self.lookups, self.hits
            return {
                "engine": self.engine,
                "tokens": {
                    "prefill": self.prefill_tokens,
                    "decode": self.decode_tokens,
                },
                "lookups": lookups,
                "hits": hits,
                "hit_ratio": round(hits / lookups, 4) if lookups else 0.0,
                "tier_bytes": dict(self.tier_bytes),
                "tier_pages": dict(self.tier_pages),
                "prefix": {
                    "hits": self.prefix_hits,
                    "shared_bytes": max(self.prefix_shared_bytes, 0),
                    "extents": self.prefix_extents,
                    "cow": self.cow_copies,
                },
                "stalls": self.stalls,
                "stall_s": round(self.stall_s, 6),
                "prefetch": {
                    "issued": self.prefetch_issued,
                    "completed": self.prefetch_completed,
                },
                "moves": {
                    "promote": self.promotes,
                    "demote": self.demotes,
                },
                "remote_bytes": {
                    "in": self.remote_bytes_in,
                    "out": self.remote_bytes_out,
                },
                "batch": {
                    "steps": self.batch_steps,
                    "size_sum": self.batch_size_sum,
                    "size_last": self.batch_size_last,
                    "size_max": self.batch_size_max,
                    "size_hist": dict(self.batch_size_hist),
                    "step_s": round(self.step_s_sum, 6),
                    "step_s_hist": dict(self.step_s_hist),
                    "prefill_chunks": self.prefill_chunks,
                },
                "preempts": dict(self.preempts),
                "ttft": {
                    "count": self.ttft_count,
                    "sum_s": round(self.ttft_s_sum, 6),
                    "hist": dict(self.ttft_s_hist),
                },
            }


# -- co-located publication -------------------------------------------------


def publish(stats: ServingStats) -> None:
    """Register a live engine's stats in this process's registry.
    Idempotent per engine name (latest wins —
    a restarted engine under the same name replaces the stale block)."""
    with _lock:
        _published[stats.engine] = stats


def unpublish(stats: ServingStats) -> None:
    with _lock:
        cur = _published.get(stats.engine)
        if cur is stats:
            del _published[stats.engine]


def colocated() -> dict | None:
    """Snapshot every published engine's meta, or None when no engine
    lives in this process."""
    with _lock:
        stats = list(_published.values())
    if not stats:
        return None
    return {"engines": [s.snapshot() for s in stats]}
