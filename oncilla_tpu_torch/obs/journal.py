"""Bounded per-process structured event journal (``OCM_EVENTS=1``), the
port's copy of ``oncilla_tpu/obs/journal.py``.

A ring of small dict events (page moves, prefix hits, prefetch stalls,
batch steps), each stamped with wall-clock (``ts``) and monotonic
(``mono``) time and the recording thread. The ring is capped
(``OCM_EVENTS_CAP``, default 8192 events): old events fall off. The ring
is this package's own, so events of the port never land in the JAX
package's journal, nor the reverse.

Not ported: the flight recorder (``OCM_FLIGHTREC`` is not read) and the
trace context that ``phase`` binds to in the JAX package.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

_ENABLED = os.environ.get("OCM_EVENTS", "") not in ("", "0")
try:
    _CAP = int(os.environ.get("OCM_EVENTS_CAP", "") or 8192)
except ValueError:  # a typo'd knob degrades to the default
    _CAP = 8192

_lock = threading.Lock()
_ring: "deque[dict]" = deque(maxlen=_CAP)
_seq = 0


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Programmatic enable (the env var is read at import)."""
    global _ENABLED
    _ENABLED = bool(on)


def record(ev: str, **fields) -> None:
    """Append one event when journaling is on."""
    global _seq
    if not _ENABLED:
        return
    t = threading.current_thread()
    rec = {"ev": ev, "ts": time.time(), "mono": time.monotonic(),
           "pid": os.getpid(), "tid": t.ident or 0, "thread": t.name,
           **fields}
    with _lock:
        _seq += 1
        rec["seq"] = _seq
        _ring.append(rec)


def phase(name: str, dur_s: float, **fields) -> None:
    """Record that ``dur_s`` of the enclosing step went to ``name``."""
    if _ENABLED:
        record("phase", phase=name, dur_us=round(dur_s * 1e6, 1), **fields)


def set_cap(n: int) -> None:
    """Bound the ring to the newest ``n`` events."""
    global _CAP, _ring
    with _lock:
        _CAP = int(n)
        _ring = deque(_ring, maxlen=_CAP)


def events() -> list[dict]:
    """Snapshot copy of the ring (oldest first)."""
    with _lock:
        return list(_ring)


def clear() -> None:
    with _lock:
        _ring.clear()


def dump_jsonl(evts: list[dict] | None = None) -> str:
    """The ring (or an explicit event list) as JSONL text."""
    evts = events() if evts is None else evts
    return "".join(json.dumps(e, separators=(",", ":"), default=str) + "\n"
                   for e in evts)
