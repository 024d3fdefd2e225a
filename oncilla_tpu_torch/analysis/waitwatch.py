"""Runtime unified wait-for graph (``OCM_WAITWATCH=1``).

The lockwatch watchdog models *locks*; the deadlocks this codebase has
actually shipped lived in the wider resource graph — a bounded worker
pool waiting on another bounded pool, a lock held across an RPC
round-trip so the reverse edge ran through a peer's handler. This module is the dynamic twin of the static analysis in
``analysis/rpcgraph.py``: with ``OCM_WAITWATCH=1`` it fuses locks, pool
slots, worker-pool admission, and RPC round-trips into the SAME
site-level order graph (:data:`lockwatch.GRAPH`), so the existing cycle
check extends across resource kinds without a second graph to merge.

Node vocabulary (mirrors rpcgraph's pseudo-nodes):

- lock sites — recorded automatically by :class:`lockwatch.WatchedLock`
  (``OCM_WAITWATCH=1`` implies lock instrumentation; see
  ``lockwatch.enabled``), including the pool's per-connection
  ``pool.entry`` lease lock, which doubles as slot occupancy.
- ``rpc:daemon`` — the serve side *holds* it for the duration of a
  dispatch (:func:`slot` around ``Daemon._dispatch_guarded``); the
  client side *waits* on it per round-trip (:func:`note_wait` in
  ``PeerPool.request``). A cycle through this node is the dynamic form
  of the static ``lock-across-rpc`` finding.
- ``pool.slot`` — waited on when a lease blocks at the per-peer cap.
- ``daemon.mux_slot`` — held while a tagged op occupies a mux
  worker-pool thread; an edge ``daemon.mux_slot -> pool.slot`` (or back
  through ``rpc:daemon``) is the ``pool-stratification`` class.

Waits and holds are different verbs on purpose: a pure wait (RPC
round-trip, cap wait) records held→site edges but never occupies the
site, so a request that merely *passes through* a daemon cannot fabricate
a hold-side edge. Everything is a no-op unless ``OCM_WAITWATCH=1``.
"""

from __future__ import annotations

import contextlib
import os
import time

from oncilla_tpu_torch.analysis import lockwatch

__all__ = [
    "enabled", "RPC_DAEMON", "POOL_SLOT", "MUX_SLOT",
    "note_wait", "note_holding", "note_done", "slot",
    "cycles", "assert_acyclic", "snapshot", "reset",
]

RPC_DAEMON = "rpc:daemon"
POOL_SLOT = "pool.slot"
MUX_SLOT = "daemon.mux_slot"


def enabled() -> bool:
    return os.environ.get("OCM_WAITWATCH", "") not in ("", "0")


def note_wait(site: str) -> None:
    """This thread is about to block on ``site`` without occupying it
    afterwards (an RPC round-trip, a pool-cap wait): records
    held-site → ``site`` edges only, never a hold."""
    if enabled():
        lockwatch.GRAPH.note_acquire_attempt(site)


def note_holding(site: str) -> None:
    """Push ``site`` onto this thread's held stack (explicit form of
    :func:`slot` for acquire/release pairs that straddle functions)."""
    if enabled():
        lockwatch.GRAPH.note_acquire_attempt(site)
        lockwatch.GRAPH.note_acquired(site)


def note_done(site: str) -> None:
    """Pop the most recent :func:`note_holding` of ``site``. Safe to call
    when the matching hold was never recorded (env flipped mid-flight):
    the release path tolerates a missing stack entry."""
    if enabled():
        lockwatch.GRAPH.note_released(site, 0.0)


@contextlib.contextmanager
def slot(site: str):
    """Occupy ``site`` for the duration — a bounded worker-pool slot, a
    serve slot. Anything this thread blocks on inside the body gains a
    ``site -> blocked-on`` edge, which is exactly the stratification
    direction the static pool rule checks."""
    if not enabled():
        yield
        return
    g = lockwatch.GRAPH
    g.note_acquire_attempt(site)
    g.note_acquired(site)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        g.note_released(site, time.perf_counter() - t0)


def cycles() -> list[list[str]]:
    return lockwatch.GRAPH.cycles()


def assert_acyclic() -> None:
    cyc = lockwatch.GRAPH.cycles()
    if cyc:
        pretty = "; ".join(" -> ".join(c) for c in cyc)
        raise AssertionError(f"wait-for cycles detected: {pretty}")


def snapshot() -> dict:
    return lockwatch.GRAPH.snapshot()


def reset() -> None:
    lockwatch.GRAPH.reset()
