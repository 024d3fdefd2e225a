"""Bounded per-process structured event journal (``OCM_EVENTS=1``), the
port's copy of ``oncilla_tpu/obs/journal.py``.

A ring of small dict events (page moves, prefix hits, prefetch stalls,
batch steps, the daemon's spans, lease reclaims, elections, migrations),
each stamped with wall-clock (``ts``) and monotonic (``mono``) time and
the recording thread. The ring is capped (``OCM_EVENTS_CAP``, default 8192
events): old events fall off. The ring is this package's own, so events of
the port never land in the JAX package's journal, nor the reverse.

Not ported: the flight recorder (``OCM_FLIGHTREC`` is not read, so
:func:`spill_ring` has nowhere to spill and returns None).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque

_ENABLED = os.environ.get("OCM_EVENTS", "") not in ("", "0")
# Tolerant parse (same stance as watchdog.reload_threshold): a typo'd
# knob must degrade to the default, not crash every importer of obs.
try:
    _CAP = int(os.environ.get("OCM_EVENTS_CAP", "") or 8192)
except ValueError:
    _CAP = 8192

# Journal identity: exporters merging event streams from several sources
# must drop duplicates when two sources turn out to be the SAME journal
# (the in-process test cluster serves its daemons' STATUS_EVENTS from the
# one ring the client also reads). (jid, seq) is that identity.
_JID = f"{os.getpid():x}-{random.Random(os.urandom(4)).getrandbits(32):08x}"

_lock = threading.Lock()
_ring: "deque[dict]" = deque(maxlen=_CAP)
_seq = 0


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Test hook / programmatic enable (the env var is read at import)."""
    global _ENABLED
    _ENABLED = bool(on)


def record(ev: str, *, force: bool = False, **fields) -> None:
    """Append one event when journaling is on. ``force`` records even
    with journaling off — the slow-op watchdog's channel, which must not
    require ``OCM_EVENTS`` to be useful."""
    global _seq
    if not (_ENABLED or force):
        return
    t = threading.current_thread()
    rec = {
        "ev": ev,
        "ts": time.time(),
        "mono": time.monotonic(),
        "pid": os.getpid(),
        "tid": t.ident or 0,
        "thread": t.name,
        **fields,
    }
    with _lock:
        _seq += 1
        rec["jid"] = _JID
        rec["seq"] = _seq
        _ring.append(rec)


def phase(name: str, dur_s: float, *, ctx=None, **fields) -> None:
    """Record a named phase of an enclosing span's wall time (``ev=
    "phase"``). Phases are the critical-path attributor's raw material:
    each one says "``dur_s`` of the surrounding span went to ``name``".
    ``ctx`` is an explicit :class:`obs.trace.TraceCtx` to bind to; when
    omitted the ambient context is used, so a phase recorded inside a
    tracer span lands on that span without plumbing."""
    if not _ENABLED:
        return
    if ctx is None:
        from oncilla_tpu_torch.obs import trace as _trace

        ctx = _trace.current()
    if ctx is not None:
        fields.setdefault("trace_id", ctx.trace_id)
        fields.setdefault("span_id", ctx.span_id)
    record("phase", phase=name, dur_us=round(dur_s * 1e6, 1), **fields)


def set_cap(n: int) -> None:
    """Test hook / programmatic ring bound (the env var is read at
    import). Keeps the newest ``n`` events."""
    global _CAP, _ring
    with _lock:
        _CAP = int(n)
        _ring = deque(_ring, maxlen=_CAP)


def events() -> list[dict]:
    """Snapshot copy of the ring (oldest first)."""
    with _lock:
        return list(_ring)


def spill_ring(label: str = "ringdump") -> str | None:
    """Flush the ring to the flight recorder: a no-op returning None, as
    the JAX package's is when its recorder is off (the recorder is not
    ported)."""
    return None


def clear() -> None:
    with _lock:
        _ring.clear()


def dump_jsonl(evts: list[dict] | None = None) -> str:
    """The ring (or an explicit event list) as JSONL text."""
    evts = events() if evts is None else evts
    return "".join(
        json.dumps(e, separators=(",", ":"), default=str) + "\n" for e in evts
    )
