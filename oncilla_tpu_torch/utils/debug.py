"""Env-gated logging and per-op span counters, the port's copy of
``oncilla_tpu/utils/debug.py``.

``printd`` prints only under ``OCM_VERBOSE`` (the reference's debug.h:22
contract). ``Tracer.span(op, nbytes)`` times an op on the host clock and
keeps count / bytes / a ring of latencies / a lifetime histogram per op
name, from which p50/p99 and Gbit/s are read — the counters
``core.context`` (alloc, put, get, copy), ``models.kv_paging``
(kv_store_page, kv_fetch_pages) and the daemon's serve side feed. A span
around a device op measures its enqueue unless the op synchronises.
Spans join the ambient trace context (:mod:`..obs.trace`) and the
slow-op watchdog (:mod:`..obs.watchdog`) as in the JAX package; they put
no annotation on a profiler timeline (``capture_trace`` is not ported).
"""

from __future__ import annotations

import bisect
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from oncilla_tpu_torch.obs import journal as _journal
from oncilla_tpu_torch.obs import trace as _trace
from oncilla_tpu_torch.obs import watchdog as _watchdog

_logger = logging.getLogger("oncilla_tpu_torch")
if os.environ.get("OCM_VERBOSE"):
    logging.basicConfig(
        level=logging.DEBUG,
        format="%(asctime)s %(process)d/%(threadName)s %(name)s "
        "%(filename)s:%(lineno)d %(message)s",
    )
    _logger.setLevel(logging.DEBUG)


# Cached at import like the logger config above: OCM_VERBOSE is a
# process-start decision (debug.h:22 contract), and printd sits on hot
# paths (one call per span close) where even logging's isEnabledFor
# check is measurable under the mux runtime's small-op load.
_VERBOSE = bool(os.environ.get("OCM_VERBOSE"))


def printd(msg: str, *args) -> None:
    """Debug print, active only under ``OCM_VERBOSE`` (debug.h:22 contract)."""
    if _VERBOSE:
        _logger.debug(msg, *args)


# Fixed log-spaced latency histogram bounds (seconds), +Inf implicit.
# Unlike the p50/p99 gauges (computed over the bounded sample ring, so
# they forget), the bucket counts are true CUMULATIVE counters over the
# op's lifetime — what a Prometheus scraper can rate() and quantile over
# (ocm_op_latency_seconds_bucket in obs/prom.py).
LATENCY_BUCKETS_S: tuple[float, ...] = (
    50e-6, 200e-6, 1e-3, 5e-3, 20e-3, 100e-3, 500e-3, 2.0,
)


@dataclass
class OpStats:
    count: int = 0
    total_s: float = 0.0
    total_bytes: int = 0
    # Ring buffer: a deque with maxlen keeps the LATEST max_samples
    # latencies (a capped list kept only the oldest and froze p50 at the
    # warm-up distribution, and could overshoot the cap under races).
    samples_s: "deque[float]" = field(default_factory=deque)
    # Lifetime histogram: bucket_counts[i] = spans with latency <=
    # LATENCY_BUCKETS_S[i] (last slot = +Inf overflow). exemplars maps a
    # bucket index to the (trace_id, latency_s, wall_ts) of the most
    # recent traced span that landed there — the scrape-side hook from a
    # latency bucket back into the distributed trace.
    bucket_counts: list[int] = field(
        default_factory=lambda: [0] * (len(LATENCY_BUCKETS_S) + 1)
    )
    exemplars: dict[int, tuple[int, float, float]] = field(
        default_factory=dict
    )

    def _quantile(self, q: float) -> float:
        if not self.samples_s:
            return 0.0
        s = sorted(self.samples_s)
        return s[min(int(len(s) * q), len(s) - 1)]

    @property
    def p50_s(self) -> float:
        if not self.samples_s:
            return 0.0
        s = sorted(self.samples_s)
        return s[len(s) // 2]

    @property
    def p99_s(self) -> float:
        return self._quantile(0.99)

    @property
    def gbps(self) -> float:
        """GigaBITS per second — the unit every ``gbps`` key in this
        codebase reports (Tracer.note_transfer set the precedent; this
        property used to report gigaBYTES under the same key, so the
        status JSON showed op throughput 8x below the transfer ring's)."""
        return (
            self.total_bytes * 8 / self.total_s / 1e9 if self.total_s else 0.0
        )


class _Span:
    """The span context manager: adopts/mints the trace context, times
    the body, feeds the op stats + histogram + watchdog on exit. Slotted
    and hand-rolled for the hot path (see Tracer.span)."""

    __slots__ = ("tracer", "op", "nbytes", "ctx", "saved_ctx",
                 "journal_on", "wall0", "t0", "rec")

    def __init__(self, tracer: "Tracer", op: str, nbytes: int):
        self.tracer = tracer
        self.op = op
        self.nbytes = nbytes

    def __enter__(self):
        # Trace context: child of the ambient span (an inbound wire hop
        # or an enclosing local span), else a fresh root — the
        # client-side "mint a (trace_id, span_id) per logical op".
        ctx = None
        if _trace.enabled():
            parent = _trace.current()
            ctx = _trace.child(parent) if parent is not None else _trace.mint()
        self.ctx = ctx
        self.saved_ctx = _trace.swap(ctx) if ctx is not None else None
        self.journal_on = _journal.enabled()
        self.wall0 = time.time() if self.journal_on else 0.0
        slow_us = _watchdog.threshold_us()
        self.rec = None
        t0 = self.t0 = time.perf_counter()
        if slow_us > 0:
            rec = self.rec = {
                "op": self.op, "track": self.tracer.track, "t0": t0,
                "nbytes": self.nbytes,
                "trace_id": ctx.trace_id if ctx else 0,
                "span_id": ctx.span_id if ctx else 0,
            }
            with self.tracer._open_lock:
                self.tracer._open[id(rec)] = rec
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        if self.ctx is not None:
            _trace.restore(self.saved_ctx)
        rec = self.rec
        if rec is not None:
            with self.tracer._open_lock:
                self.tracer._open.pop(id(rec), None)
            # Slow-but-finished spans flag at close; the watchdog scan
            # only sees the ones still open between its ticks.
            slow_us = _watchdog.threshold_us()
            if dt * 1e6 >= slow_us and not rec.get("flagged"):
                rec["flagged"] = True
                _watchdog.flag(rec, dt * 1e6)
        self.tracer._span_close(
            self.op, self.nbytes, dt, self.ctx, self.journal_on, self.wall0
        )


class Tracer:
    """Per-op timing registry. ``tracer.span("put", nbytes=...)`` wraps an op;
    ``tracer.stats("put")`` reports count / p50 latency / Gbit/s.

    Spans participate in distributed tracing (obs/): each span adopts the
    thread's active :class:`~oncilla_tpu_torch.obs.trace.TraceCtx` as its
    parent (minting a fresh root when there is none) and installs its own
    context for the duration, so nested spans — and wire hops that attach
    the ambient context — stitch into one trace_id. ``track`` labels this
    tracer's timeline in exported traces (one in-process test cluster
    hosts many daemons, so pid alone cannot tell their spans apart).
    """

    def __init__(self, max_samples: int = 4096, max_transfers: int = 256,
                 track: str | None = None):
        self._stats: dict[str, OpStats] = {}
        self._lock = threading.Lock()
        self._max_samples = max_samples
        self.track = track or f"pid{os.getpid()}"
        # Per-transfer records of the DCN data plane (bytes, stripes,
        # window, achieved Gbps, retries) — the ring the STATUS endpoint
        # surfaces so operators see data-plane throughput without a
        # profiler attached.
        self._transfers: "deque[dict]" = deque(maxlen=max_transfers)
        # Open (in-flight) spans, keyed by record identity — what the
        # slow-op watchdog scans. Touched only when OCM_SLOWOP_US is set.
        self._open: dict[int, dict] = {}
        self._open_lock = threading.Lock()
        _watchdog.register(self)

    def open_spans(self) -> list[dict]:
        """Snapshot of in-flight span records (for the watchdog)."""
        with self._open_lock:
            return list(self._open.values())

    def _get_locked(self, op: str) -> OpStats:
        st = self._stats.get(op)
        if st is None:
            st = self._stats[op] = OpStats(
                samples_s=deque(maxlen=self._max_samples)
            )
        return st

    def span(self, op: str, nbytes: int = 0) -> "_Span":
        """One timed span (a reusable slotted context manager, not a
        generator — span sits on every data-plane op and the
        @contextmanager machinery was a measurable slice of the mux
        runtime's small-op budget)."""
        return _Span(self, op, nbytes)

    def _span_close(self, op: str, nbytes: int, dt: float, ctx,
                    journal_on: bool, wall0: float) -> None:
        with self._lock:
            st = self._get_locked(op)
            st.count += 1
            st.total_s += dt
            st.total_bytes += nbytes
            st.samples_s.append(dt)  # deque(maxlen) evicts the oldest
            bi = bisect.bisect_left(LATENCY_BUCKETS_S, dt)
            st.bucket_counts[bi] += 1
            if ctx is not None and ctx.trace_id:
                st.exemplars[bi] = (ctx.trace_id, dt, time.time())
        if journal_on:
            _journal.record(
                "span", op=op, track=self.track, nbytes=nbytes,
                t_wall=wall0, dur_us=round(dt * 1e6, 1),
                trace_id=ctx.trace_id if ctx else 0,
                span_id=ctx.span_id if ctx else 0,
                parent_span_id=ctx.parent_span_id if ctx else 0,
            )
        printd("op=%s nbytes=%d dt_us=%.1f", op, nbytes, dt * 1e6)

    def stats(self, op: str) -> OpStats:
        """A consistent SNAPSHOT of the op's stats: copied under the lock,
        so concurrent span() completions can't mutate the samples mid-sort
        in the caller's p50 computation."""
        with self._lock:
            st = self._get_locked(op)
            return OpStats(
                count=st.count,
                total_s=st.total_s,
                total_bytes=st.total_bytes,
                samples_s=deque(st.samples_s),
                bucket_counts=list(st.bucket_counts),
                exemplars=dict(st.exemplars),
            )

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()

    def note_transfer(
        self,
        op: str,
        nbytes: int,
        seconds: float,
        *,
        stripes: int = 1,
        window: int = 0,
        chunk_bytes: int = 0,
        retries: int = 0,
        coalesced: bool = False,
        fabric: str = "tcp",
    ) -> None:
        """Record one completed data-plane transfer in the ring buffer."""
        rec = {
            "op": op,
            "bytes": int(nbytes),
            "seconds": seconds,
            "gbps": (nbytes * 8 / seconds / 1e9) if seconds > 0 else 0.0,
            "stripes": int(stripes),
            "window": int(window),
            "chunk_bytes": int(chunk_bytes),
            "retries": int(retries),
            "coalesced": bool(coalesced),
            "fabric": str(fabric),
        }
        with self._lock:
            self._transfers.append(rec)

    def transfers(self, last: int | None = None) -> list[dict]:
        """Copies of the most recent transfer records (all by default)."""
        with self._lock:
            recs = list(self._transfers)
        return recs if last is None else recs[-last:]

    def snapshot(self) -> dict[str, dict]:
        """Per-op counters; ``gbps`` is gigaBITS/s, same unit as the
        transfer ring (tests/test_obs.py pins the two paths together)."""
        with self._lock:
            return {
                k: {
                    "count": v.count,
                    "p50_us": v.p50_s * 1e6,
                    "p99_us": v.p99_s * 1e6,
                    "gbps": v.gbps,
                    "total_bytes": v.total_bytes,
                    # Lifetime latency histogram + trace exemplars
                    # (JSON-safe: rides the STATUS data tail).
                    "hist": {
                        "le": list(LATENCY_BUCKETS_S),
                        "counts": list(v.bucket_counts),
                        "sum_s": v.total_s,
                        "exemplars": {
                            str(i): {
                                "trace_id": f"{tid:016x}",
                                "value": val,
                                "ts": ts,
                            }
                            for i, (tid, val, ts) in v.exemplars.items()
                        },
                    },
                }
                for k, v in self._stats.items()
            }


GLOBAL_TRACER = Tracer()
