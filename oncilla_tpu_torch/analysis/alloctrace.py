"""Runtime allocation ledger (``OCM_ALLOCTRACE=1``).

The static twin (:mod:`~.lifecycle`) sees lexical lifecycles; this ledger
sees the dynamic ones — every allocation that actually happened, who asked
for it, and which ones are still live. Mirrors the :mod:`~.lockwatch`
pattern: disabled (the default) every hook is a cheap early-return; with
``OCM_ALLOCTRACE=1`` each alloc/free records the **call site** (the first
stack frame outside this package — i.e. the app/test line that asked),
the thread name, and a timestamp into the process-global :data:`LEDGER`.

Instrumented layers, each with its own scope prefix so reports separate
cleanly:

- ``ctx:``    :class:`oncilla_tpu_torch.core.context.Ocm` alloc/free (handles)
- ``arena:``  :class:`oncilla_tpu_torch.core.arena.ArenaAllocator` (extents)
- ``daemon:`` :class:`oncilla_tpu_torch.runtime.daemon.Daemon` registry entries

``Ocm.tini()`` asks the ledger for the context's still-live allocations
*before* reclaiming them and emits a structured leak report (also kept as
:func:`last_tini_report` so tests can assert a deliberately-leaked
handle's allocation site shows up). The soak/stress suites run with the
ledger live and assert it drains to empty — the dynamic proof that the
alloc/free books balance under concurrency.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass

__all__ = [
    "enabled", "note_alloc", "note_free", "drop_scope", "live",
    "leak_report", "note_tini", "last_tini_report", "reset",
    "AllocRecord", "AllocLedger", "LEDGER",
]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enabled() -> bool:
    return os.environ.get("OCM_ALLOCTRACE", "") not in ("", "0")


def _call_site(skip: int = 2) -> str:
    """``file:line`` of the nearest frame outside oncilla_tpu — the app or
    test line that requested the allocation. Falls back to the outermost
    in-package frame (daemon service threads have all-internal stacks)."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return "<unknown>"
    fallback = "<unknown>"
    depth = 0
    while f is not None and depth < 32:
        fn = f.f_code.co_filename
        if not fn.startswith(_PKG_DIR):
            return f"{fn}:{f.f_lineno}"
        fallback = f"{fn}:{f.f_lineno}"
        f = f.f_back
        depth += 1
    return fallback


@dataclass(frozen=True)
class AllocRecord:
    scope: str
    alloc_id: int
    nbytes: int
    kind: str
    site: str
    thread: str
    ts: float

    def describe(self) -> dict:
        return {
            "scope": self.scope,
            "alloc_id": self.alloc_id,
            "nbytes": self.nbytes,
            "kind": self.kind,
            "site": self.site,
            "thread": self.thread,
            "age_s": round(time.time() - self.ts, 3),
        }


class AllocLedger:
    """Thread-safe process-global allocation ledger."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._records: dict[tuple[str, int], AllocRecord] = {}
        self.last_tini_report: dict | None = None

    # -- recording ------------------------------------------------------

    def note_alloc(self, scope: str, alloc_id: int, nbytes: int,
                   kind: str = "") -> None:
        if not enabled():
            return
        rec = AllocRecord(
            scope=scope, alloc_id=alloc_id, nbytes=nbytes, kind=kind,
            site=_call_site(2), thread=threading.current_thread().name,
            ts=time.time(),
        )
        with self._mu:
            self._records[(scope, alloc_id)] = rec

    def note_free(self, scope: str, alloc_id: int) -> None:
        if not enabled():
            return
        with self._mu:
            # Unknown keys are silently ignored: frees of allocations made
            # before the ledger was enabled (or restored from a snapshot)
            # must not crash the data path.
            self._records.pop((scope, alloc_id), None)

    def drop_scope(self, scope: str) -> None:
        """Forget a whole scope (arena reset / daemon teardown)."""
        with self._mu:
            for key in [k for k in self._records if k[0] == scope]:
                del self._records[key]

    # -- reporting ------------------------------------------------------

    def live(self, scope_prefix: str | None = None) -> list[AllocRecord]:
        with self._mu:
            recs = list(self._records.values())
        if scope_prefix is not None:
            recs = [r for r in recs if r.scope.startswith(scope_prefix)]
        return sorted(recs, key=lambda r: (r.scope, r.alloc_id))

    def leak_report(self, scope_prefix: str | None = None) -> dict:
        """Structured still-live report: what tini prints and tests assert
        against. ``live`` entries carry the allocation site."""
        recs = self.live(scope_prefix)
        return {
            "scope": scope_prefix or "*",
            "count": len(recs),
            "bytes": sum(r.nbytes for r in recs),
            "live": [r.describe() for r in recs],
        }

    def note_tini(self, scope: str) -> dict:
        """Called by ``Ocm.tini()`` before reclamation; records and
        returns the leak report for that context."""
        report = self.leak_report(scope)
        with self._mu:
            self.last_tini_report = report
        return report

    def reset(self) -> None:
        with self._mu:
            self._records.clear()
            self.last_tini_report = None


LEDGER = AllocLedger()


# Module-level conveniences (the lockwatch idiom).

def note_alloc(scope: str, alloc_id: int, nbytes: int, kind: str = "") -> None:
    LEDGER.note_alloc(scope, alloc_id, nbytes, kind)


def note_free(scope: str, alloc_id: int) -> None:
    LEDGER.note_free(scope, alloc_id)


def drop_scope(scope: str) -> None:
    LEDGER.drop_scope(scope)


def live(scope_prefix: str | None = None) -> list[AllocRecord]:
    return LEDGER.live(scope_prefix)


def leak_report(scope_prefix: str | None = None) -> dict:
    return LEDGER.leak_report(scope_prefix)


def note_tini(scope: str) -> dict:
    return LEDGER.note_tini(scope)


def last_tini_report() -> dict | None:
    return LEDGER.last_tini_report


def reset() -> None:
    LEDGER.reset()
