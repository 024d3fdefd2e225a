"""The port's copy of ``oncilla_tpu/resilience/timebudget.py``, line for
line; the serving engine's step budget is its ``Budget``.

Time-bounded data plane: deadlines, clamped backoffs, circuit
breakers, and the hedge-delay policy.

"The Tail at Scale" (Dean & Barroso, CACM 2013) names the production
disciplines a latency-sensitive consumer needs from a distributed
runtime; this module is their shared mechanics:

- :class:`Budget` — one op's remaining time, held as an ABSOLUTE
  monotonic deadline so "decrement by observed elapsed time" is free:
  whoever asks for ``remaining_ms()`` later gets less. On the wire the
  budget is a u32 milliseconds data-tail prefix behind
  ``FLAG_DEADLINE`` (capability ``FLAG_CAP_DEADLINE``, offered at
  CONNECT and declined-by-silence like every other bit): the SENDER
  encodes its remainder at send time, the receiver re-anchors it on its
  own clock — no cross-host clock sync, only monotonic local clocks.
- the ambient thread-local budget (the obs/trace.py shape): a daemon
  installs the stripped budget around dispatch so every forwarded hop
  (REQ_ALLOC relay, DO_REPLICA provisioning, migration legs) re-attaches
  the decremented remainder without threading a parameter through forty
  call sites.
- :func:`backoff_sleep` — the one capped-jittered pause every retry
  ladder shares (CONNECT, BUSY, failover), now clamped to the remaining
  budget: a ladder may never sleep past its op's deadline.
- :class:`CircuitBreaker` — per-peer CLOSED -> OPEN -> HALF_OPEN state:
  consecutive transport/deadline failures flip a peer OPEN and further
  attempts fail fast (typed :class:`OcmBreakerOpen`) instead of eating
  every tenant's budget on a sick-but-not-DEAD peer; after
  ``probe_ms`` one trial request is admitted (half-open) and a success
  closes the breaker — the client-side twin of the failure detector's
  SUSPECT/DEAD escalation.
- :func:`hedge_delay_s` — when to fire a hedged replica read:
  ``OCM_HEDGE_MS`` pins it, ``-1`` derives it from the client's own
  observed dcn_get p99 (hedge only the tail, not the median).

Stdlib-only by design (struct/threading/time + the journal), so the
client, daemon and mux runtime can all import it without cycles.
"""

from __future__ import annotations

import struct
import threading
import time

from oncilla_tpu_torch.analysis.lockwatch import make_lock
from oncilla_tpu_torch.core.errors import OcmBreakerOpen, OcmDeadlineExceeded
from oncilla_tpu_torch.obs import journal as obs_journal

# Wire encoding of one budget tail: remaining milliseconds as a u32
# (49 days of budget is plenty; 0 means "already expired — refuse me").
_BUD = struct.Struct("<I")
BUDGET_BYTES = _BUD.size  # 4


class Budget:
    """One op's time budget as an absolute monotonic deadline."""

    __slots__ = ("deadline", "total_ms")

    def __init__(self, deadline: float, total_ms: int):
        self.deadline = deadline
        self.total_ms = total_ms

    @classmethod
    def from_ms(cls, ms: int | float) -> "Budget":
        """A fresh budget of ``ms`` milliseconds starting NOW — both the
        client-side op entry point and the daemon-side re-anchor of a
        received wire tail."""
        ms = max(0, int(ms))
        return cls(time.monotonic() + ms / 1e3, ms)

    def remaining_ms(self) -> int:
        return max(0, int((self.deadline - time.monotonic()) * 1e3))

    def remaining_s(self) -> float:
        return max(0.0, self.deadline - time.monotonic())

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self.deadline

    def check(self, what: str) -> None:
        """Raise typed DEADLINE_EXCEEDED when the budget ran out."""
        if self.expired:
            raise OcmDeadlineExceeded(
                f"{what}: time budget of {self.total_ms} ms exhausted"
            )

    def __repr__(self) -> str:
        return f"Budget({self.remaining_ms()}ms/{self.total_ms}ms)"


def budget_from(deadline_ms: int | float | None, config=None) -> Budget | None:
    """The per-op budget: an explicit ``deadline_ms`` wins, else the
    config default (``OCM_DEADLINE_MS``), else None (unbudgeted — every
    pre-existing behavior byte-for-byte)."""
    if deadline_ms is not None:
        return Budget.from_ms(deadline_ms)
    if config is not None and getattr(config, "deadline_ms", 0) > 0:
        return Budget.from_ms(config.deadline_ms)
    return None


# -- the ambient budget (the obs/trace.py thread-local shape) ------------

_tls = threading.local()


def current() -> Budget | None:
    """The thread's active budget (None outside any budgeted op)."""
    return getattr(_tls, "budget", None)


class use:
    """Install ``budget`` as the thread's ambient budget (None is a
    no-op so call sites need no branch). Re-entrant: restores whatever
    was active before."""

    __slots__ = ("budget", "_saved")

    def __init__(self, budget: Budget | None):
        self.budget = budget

    def __enter__(self) -> Budget | None:
        if self.budget is not None:
            self._saved = getattr(_tls, "budget", None)
            _tls.budget = self.budget
        return self.budget

    def __exit__(self, *exc) -> None:
        if self.budget is not None:
            _tls.budget = self._saved


# -- wire helpers (message-object level; the obs/trace.attach shape) -----


def attach(msg, budget: Budget, flag: int):
    """Prefix ``msg``'s data tail with the budget's REMAINING
    milliseconds and set ``flag`` (FLAG_DEADLINE) — in place; returns
    ``msg`` for chaining. The caller has already checked the peer
    granted FLAG_CAP_DEADLINE. A bulk payload becomes the vectored
    ``[tail, payload]`` form send_msg scatter-gathers — never a
    concatenating copy. An expired budget encodes as 0: the receiver
    refuses it typed, which is exactly the contract."""
    msg.flags |= flag
    head = _BUD.pack(min(budget.remaining_ms(), 0xFFFFFFFF))
    if isinstance(msg.data, (list, tuple)):
        msg.data = [head, *msg.data]
    elif len(msg.data) >= 4096:
        msg.data = [head, msg.data]
    else:
        msg.data = head + bytes(msg.data) if len(msg.data) else head
    return msg


def split(data) -> tuple[int | None, object]:
    """Strip the u32 remaining-ms prefix off a data tail. A tail shorter
    than the prefix is malformed-but-tolerated (receivers must not die
    on a confused peer): returns (None, data) unchanged. The rest comes
    back as a VIEW — no payload copy on the per-frame strip path."""
    if len(data) < BUDGET_BYTES:
        return None, data
    ms = _BUD.unpack_from(data, 0)[0]
    rest = (data if isinstance(data, memoryview)
            else memoryview(data))[BUDGET_BYTES:]
    return ms, rest


# -- the shared clamped backoff ------------------------------------------


def backoff_sleep(step_s: float, budget: Budget | None = None) -> float:
    """One capped-backoff pause with jitter (uniform in [0.5, 1.0] of
    the step — a herd of clients never re-dials a saturated daemon in
    lockstep), CLAMPED to the remaining budget: a retry ladder may sleep
    at most as long as its op has left to live, never its own cap.
    Returns the seconds actually slept (0.0 when the budget is already
    spent — the caller's next attempt or raise surfaces the expiry)."""
    import random

    dur = step_s * (0.5 + random.random() / 2)
    if budget is not None:
        dur = min(dur, budget.remaining_s())
    if dur > 0:
        time.sleep(dur)
    return max(0.0, dur)


# -- per-peer circuit breakers -------------------------------------------

_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Per-key (peer address) failure breaker. ``threshold`` consecutive
    transport/deadline failures flip a key OPEN; while OPEN,
    :meth:`check` raises :class:`OcmBreakerOpen` IMMEDIATELY — the
    fail-fast typed error that keeps a sick-but-not-DEAD peer from
    eating every tenant's budget. After ``probe_ms`` of OPEN, exactly
    one caller is admitted as the half-open probe (the others keep
    failing fast); its success closes the breaker, its failure re-opens
    the window. ``threshold=0`` disables the whole machine (every
    method a no-op) — the default, so un-configured deployments keep
    the pre-breaker behavior exactly.

    Thread-safe; journal events ``breaker_open`` / ``breaker_close``
    carry the peer address for the obs timeline."""

    def __init__(self, threshold: int = 0, probe_ms: int = 1000):
        self.threshold = max(0, int(threshold))
        self.probe_s = max(1, int(probe_ms)) / 1e3
        self._lock = make_lock("timebudget.breaker._lock")
        # key -> [state, consecutive fails, opened_at, probe_taken]
        self._peers: dict[object, list] = {}
        self.counters = {"opens": 0, "closes": 0, "fast_fails": 0,
                         "probes": 0}

    @property
    def enabled(self) -> bool:
        return self.threshold > 0

    def _row(self, key) -> list:
        row = self._peers.get(key)
        if row is None:
            row = self._peers[key] = [_CLOSED, 0, 0.0, False]
        return row

    def check(self, key) -> None:
        """Gate one attempt toward ``key``: raises OcmBreakerOpen while
        the breaker is OPEN (except the single half-open probe once the
        probe window elapsed)."""
        if not self.enabled:
            return
        with self._lock:
            row = self._peers.get(key)
            if row is None or row[0] == _CLOSED:
                return
            if row[0] == _OPEN:
                if time.monotonic() - row[2] >= self.probe_s:
                    row[0] = _HALF_OPEN
                    row[3] = True  # this caller IS the probe
                    self.counters["probes"] += 1
                    return
            elif row[0] == _HALF_OPEN and not row[3]:
                row[3] = True
                self.counters["probes"] += 1
                return
            self.counters["fast_fails"] += 1
        raise OcmBreakerOpen(
            f"circuit breaker OPEN for peer {key}: "
            f"{self.threshold} consecutive failures; probing every "
            f"{self.probe_s * 1e3:.0f} ms"
        )

    def ok(self, key) -> None:
        """A successful exchange with ``key``: closes an open breaker
        (journaled) and zeroes the failure streak."""
        if not self.enabled:
            return
        reopened = False
        with self._lock:
            row = self._peers.get(key)
            if row is None:
                return
            if row[0] != _CLOSED:
                reopened = True
                self.counters["closes"] += 1
            row[0], row[1], row[3] = _CLOSED, 0, False
        if reopened:
            obs_journal.record("breaker_close", peer=str(key))

    def fail(self, key) -> None:
        """One transport/deadline failure toward ``key``. At
        ``threshold`` consecutive failures the breaker opens
        (journaled); a failed half-open probe re-opens the window."""
        if not self.enabled:
            return
        opened = False
        with self._lock:
            row = self._row(key)
            row[1] += 1
            if row[0] == _HALF_OPEN or (
                row[0] == _CLOSED and row[1] >= self.threshold
            ):
                if row[0] != _OPEN:
                    opened = True
                    self.counters["opens"] += 1
                row[0], row[2], row[3] = _OPEN, time.monotonic(), False
        if opened:
            obs_journal.record(
                "breaker_open", peer=str(key), fails=self.threshold,
            )

    def state(self, key) -> str:
        with self._lock:
            row = self._peers.get(key)
            return row[0] if row is not None else _CLOSED

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "peers": {str(k): r[0] for k, r in self._peers.items()
                          if r[0] != _CLOSED},
                **self.counters,
            }


def breaker_from(config) -> CircuitBreaker:
    """The client's breaker, shaped by OCM_BREAKER_THRESHOLD /
    OCM_BREAKER_PROBE_MS (threshold 0 = disabled no-op)."""
    return CircuitBreaker(
        getattr(config, "breaker_threshold", 0),
        getattr(config, "breaker_probe_ms", 1000),
    )


# -- hedge policy ---------------------------------------------------------


def hedge_delay_s(config, tracer=None) -> float:
    """How long a replicated get waits on the primary before firing the
    hedge to the next chain member. ``OCM_HEDGE_MS > 0`` pins it;
    ``-1`` derives it from this client's OWN observed dcn_get p99 (the
    Tail-at-Scale discipline: hedge only the tail — a hedge at the
    median doubles load for nothing), floored so a cold histogram never
    hedges instantly; ``0`` disables hedging entirely (returns 0.0,
    the caller's gate)."""
    ms = getattr(config, "hedge_ms", 0)
    if ms == 0:
        return 0.0
    if ms > 0:
        return ms / 1e3
    p99 = 0.0
    if tracer is not None:
        try:
            p99 = tracer.stats("dcn_get").p99_s
        except Exception:  # noqa: BLE001 — a cold/absent histogram
            p99 = 0.0
    return max(p99, 0.01)  # 10 ms floor: never hedge a cold histogram at 0
