"""Slow-op watchdog: flag spans that exceed ``OCM_SLOWOP_US``.

A daemon wedged inside one serve-side span (a stuck DATA_GET against a
dead plane endpoint, an alloc blocked on a peer) produces NO completed
span the journal could show — the evidence is the span that never ends.
The watchdog is a single daemon thread scanning every live
:class:`~oncilla_tpu_torch.utils.debug.Tracer`'s open-span table; a span open
longer than the threshold is journaled ONCE (``ev=slow_op``) with its
full trace context, so the cluster CLI can point at the exact hop of the
exact logical op that is stuck. Span close also checks the threshold, so
ops that finish slow-but-finished are flagged even between scans.

Events are recorded with ``force=True``: setting ``OCM_SLOWOP_US`` is
the opt-in; it must not additionally require ``OCM_EVENTS``.
"""

from __future__ import annotations

import os
import threading
import weakref

from oncilla_tpu_torch.obs import journal

# Tracers register here at construction (weak: a dropped Tracer must not
# be pinned alive by its own observability).
_tracers: "weakref.WeakSet" = weakref.WeakSet()
_lock = threading.Lock()
_thread: threading.Thread | None = None


def threshold_us() -> int:
    """0 = watchdog disabled. Cached: this sits on EVERY span's entry
    path (thousands of small ops per second under the mux runtime) and
    an os.environ lookup per span is measurable; tests that flip the
    knob mid-process call :func:`reload_threshold`."""
    return _threshold_us


def reload_threshold() -> int:
    """Re-read OCM_SLOWOP_US (test hook / runtime re-decision)."""
    global _threshold_us
    try:
        _threshold_us = int(os.environ.get("OCM_SLOWOP_US", "") or 0)
    except ValueError:
        _threshold_us = 0
    return _threshold_us


_threshold_us = 0
reload_threshold()


def register(tracer) -> None:
    """Called by every Tracer.__init__; starts the scan thread lazily on
    the first registration with the env knob set. Re-reads the env knob
    so a Tracer constructed after OCM_SLOWOP_US changes (tests, runtime
    re-decisions) sees the new threshold despite the hot-path cache."""
    with _lock:
        reload_threshold()
        _tracers.add(tracer)
        _maybe_start_locked()


def _maybe_start_locked() -> None:
    global _thread
    if _thread is not None and _thread.is_alive():
        return
    us = threshold_us()
    if us <= 0:
        return
    _thread = threading.Thread(
        target=_scan_loop, args=(us,), daemon=True, name="ocm-slowop-watchdog"
    )
    _thread.start()


def flag(rec: dict, elapsed_us: float) -> None:
    """Journal one slow-op event for an open-span record (idempotence is
    the caller's job via rec['flagged'])."""
    journal.record(
        "slow_op",
        force=True,
        op=rec["op"],
        track=rec["track"],
        elapsed_us=round(elapsed_us, 1),
        trace_id=rec["trace_id"],
        span_id=rec["span_id"],
        nbytes=rec.get("nbytes", 0),
    )


def _scan_loop(us: int) -> None:
    import time

    period_s = max(min(us / 1e6 / 2.0, 1.0), 0.005)
    while True:
        time.sleep(period_s)
        now = time.perf_counter()
        for tracer in list(_tracers):
            for rec in tracer.open_spans():
                elapsed_us = (now - rec["t0"]) * 1e6
                if elapsed_us >= us and not rec.get("flagged"):
                    rec["flagged"] = True
                    flag(rec, elapsed_us)
