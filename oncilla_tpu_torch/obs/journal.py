"""Bounded per-process structured event journal (``OCM_EVENTS=1``), the
port's copy of ``oncilla_tpu/obs/journal.py``.

A ring of small dict events (page moves, prefix hits, prefetch stalls,
batch steps, the daemon's spans, lease reclaims, elections, migrations),
each stamped with wall-clock (``ts``) and monotonic (``mono``) time and
the recording thread. The ring is capped (``OCM_EVENTS_CAP``, default 8192
events): old events fall off. The ring is this package's own, so events of
the port never land in the JAX package's journal, nor the reverse.

With the flight recorder armed (``OCM_FLIGHTREC=dir`` or
``flightrec.set_dir``), every recorded event is ALSO streamed into
crash-safe CRC-framed segment files on disk, so the bounded ring stays
the hot in-memory view while the disk keeps the full stream for the
post-mortem auditor (``obs/audit.py``). ``OCM_FLIGHTREC`` alone turns the
journal on. The segments carry this journal's ``jid``, which differs from
the JAX package's in the same process.

Stdlib-only on purpose: ``utils.debug`` imports this at module level.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque

from oncilla_tpu_torch.obs import flightrec as _flightrec

# OCM_FLIGHTREC alone is a complete opt-in: a flight recorder that also
# required OCM_EVENTS=1 would silently record nothing.
_ENABLED = (
    os.environ.get("OCM_EVENTS", "") not in ("", "0")
    or bool(os.environ.get(_flightrec.ENV_DIR))
)
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
    # Spill OUTSIDE the ring lock: the recorder has its own lock, and a
    # slow disk must never serialize hot-path record() callers.
    _flightrec.append(rec)


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


def jid() -> str:
    """This process's journal identity (segment naming, dedup)."""
    return _JID


def events() -> list[dict]:
    """Snapshot copy of the ring (oldest first)."""
    with _lock:
        return list(_ring)


def spill_ring(label: str = "ringdump") -> str | None:
    """Flush the CURRENT in-memory ring to the flight-recorder dir as a
    labelled segment (no-op when the recorder is off). The kill path's
    black-box flush: events the stream already spilled dedup away on
    merge, so calling this is always safe and never loses evidence."""
    if not _flightrec.configured():
        return None
    return _flightrec.dump_events(events(), label=label)


def clear() -> None:
    with _lock:
        _ring.clear()


def dump_jsonl(evts: list[dict] | None = None) -> str:
    """The ring (or an explicit event list) as JSONL text."""
    evts = events() if evts is None else evts
    return "".join(
        json.dumps(e, separators=(",", ":"), default=str) + "\n" for e in evts
    )


def dump(path: str) -> int:
    """Write the ring to ``path`` as JSONL; returns the event count."""
    evts = events()
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(dump_jsonl(evts))
    return len(evts)


def load_jsonl(path: str) -> list[dict]:
    """Read one journal file back (blank lines tolerated; a malformed
    line raises — a corrupt journal must not silently drop evidence)."""
    out: list[dict] = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
