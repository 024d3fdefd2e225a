"""Runtime lock-order watchdog (``OCM_LOCKWATCH=1``).

The control plane's deadlock history is ordering, not atomicity: the
reference wedged when a per-peer connection mutex was held across a
request/reply round-trip (see runtime/pool.py's module docstring). Static
lint catches the lexical shape; this watchdog catches the dynamic one — it
records which locks are held when another is acquired, aggregates the
edges into a site-level acquisition-order graph, and reports cycles
(potential deadlocks) plus over-threshold hold times.

Usage: runtime modules create locks through :func:`make_lock` with a
stable *site name* (e.g. ``"daemon._conns_mu"``). Disabled (the default),
that returns a plain ``threading.Lock`` — zero overhead. With
``OCM_LOCKWATCH=1`` it returns a :class:`WatchedLock` recording into the
module-global :class:`LockGraph`. Tests then assert
``lockwatch.cycles() == []``.

Design notes:

- Edges are keyed by site name, not lock instance: every daemon's
  ``_conns_mu`` is the same node, so ordering discipline is checked
  across the whole cluster in one graph.
- Only *blocking* acquires record edges. A ``acquire(blocking=False)``
  probe cannot deadlock, and the pool's lease fast path (try-acquire of
  an entry lock while holding the pool condition) would otherwise report
  a by-construction-safe cycle.
- Hold times over ``OCM_LOCKWATCH_HOLD_MS`` (default 250 ms) are recorded
  with the site name; a long hold is not an error by itself but is the
  precondition for every convoy the stress tests chase.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = [
    "enabled", "make_lock", "make_rlock", "cycles", "assert_acyclic",
    "snapshot", "reset", "WatchedLock", "LockGraph",
]


def enabled() -> bool:
    # OCM_WAITWATCH implies lock instrumentation: the unified wait-for
    # graph (analysis/waitwatch.py) fuses pool slots and RPC edges into
    # this module's GRAPH, and those edges are only meaningful if lock
    # holds land on the same per-thread stack.
    env = os.environ
    return (env.get("OCM_LOCKWATCH", "") not in ("", "0")
            or env.get("OCM_WAITWATCH", "") not in ("", "0"))


def _hold_threshold_s() -> float:
    try:
        return float(os.environ.get("OCM_LOCKWATCH_HOLD_MS", "250")) / 1e3
    except ValueError:
        return 0.25


class LockGraph:
    """Aggregated acquisition-order graph; thread-safe, process-global."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # held-site -> {acquired-site -> count}
        self.edges: dict[str, dict[str, int]] = {}
        self.acquires: dict[str, int] = {}
        # (site, seconds) for holds over the threshold, bounded.
        self.long_holds: list[tuple[str, float]] = []
        self._tls = threading.local()

    # -- recording (called from WatchedLock) ----------------------------

    def _held_stack(self) -> list[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def note_acquire_attempt(self, site: str) -> None:
        held = self._held_stack()
        if not held:
            return
        with self._mu:
            for h in held:
                if h != site:
                    d = self.edges.setdefault(h, {})
                    d[site] = d.get(site, 0) + 1

    def note_acquired(self, site: str) -> None:
        self._held_stack().append(site)
        with self._mu:
            self.acquires[site] = self.acquires.get(site, 0) + 1

    def note_released(self, site: str, held_s: float) -> None:
        held = self._held_stack()
        # Remove the most recent entry for this site (locks are usually,
        # but not necessarily, released LIFO).
        for i in range(len(held) - 1, -1, -1):
            if held[i] == site:
                del held[i]
                break
        if held_s >= _hold_threshold_s():
            with self._mu:
                if len(self.long_holds) < 1024:
                    self.long_holds.append((site, held_s))

    # -- reporting ------------------------------------------------------

    def cycles(self) -> list[list[str]]:
        """Elementary cycles in the site graph (DFS; the graph is tiny).
        A cycle means two code paths acquire the same locks in opposite
        orders — a potential deadlock even if this run got lucky."""
        with self._mu:
            adj = {k: sorted(v) for k, v in self.edges.items()}
        out: list[list[str]] = []
        seen_cycles: set[tuple[str, ...]] = set()
        nodes = sorted(set(adj) | {n for vs in adj.values() for n in vs})
        for start in nodes:
            stack = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in adj.get(node, []):
                    if nxt == start:
                        cyc = path[:]
                        # Canonicalize rotation so A->B->A == B->A->B.
                        i = cyc.index(min(cyc))
                        key = tuple(cyc[i:] + cyc[:i])
                        if key not in seen_cycles:
                            seen_cycles.add(key)
                            out.append(list(key) + [key[0]])
                    elif nxt not in path and len(path) < 16:
                        stack.append((nxt, path + [nxt]))
        return out

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "edges": {k: dict(v) for k, v in self.edges.items()},
                "acquires": dict(self.acquires),
                "long_holds": list(self.long_holds),
            }

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.acquires.clear()
            self.long_holds.clear()


GRAPH = LockGraph()


class WatchedLock:
    """``threading.Lock``-shaped wrapper that records into :data:`GRAPH`.
    Also works as the lock of a ``threading.Condition`` — the Condition's
    wait() releases through :meth:`release` and re-acquires through
    :meth:`acquire`, so wait-windows drop out of the held stack exactly
    like the real lock does."""

    def __init__(self, site: str, inner=None):
        self.site = site
        self._inner = inner if inner is not None else threading.Lock()
        self._t0 = 0.0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            GRAPH.note_acquire_attempt(self.site)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            GRAPH.note_acquired(self.site)
            self._t0 = time.perf_counter()
        return ok

    def release(self) -> None:
        held_s = time.perf_counter() - self._t0
        self._inner.release()
        GRAPH.note_released(self.site, held_s)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "WatchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"WatchedLock({self.site!r}, {self._inner!r})"


def make_lock(site: str) -> threading.Lock | WatchedLock:
    """A lock for ``site`` (stable dotted name, e.g. ``"pool._lock"``).
    Plain ``threading.Lock`` unless ``OCM_LOCKWATCH=1``."""
    if not enabled():
        return threading.Lock()
    return WatchedLock(site)


def make_rlock(site: str) -> threading.RLock | WatchedLock:
    if not enabled():
        return threading.RLock()
    return WatchedLock(site, inner=threading.RLock())


def cycles() -> list[list[str]]:
    return GRAPH.cycles()


def assert_acyclic() -> None:
    cyc = GRAPH.cycles()
    if cyc:
        pretty = "; ".join(" -> ".join(c) for c in cyc)
        raise AssertionError(f"lock-order cycles detected: {pretty}")


def snapshot() -> dict:
    return GRAPH.snapshot()


def reset() -> None:
    GRAPH.reset()
