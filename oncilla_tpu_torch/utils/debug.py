"""Env-gated logging and per-op span counters.

``printd`` prints only under ``OCM_VERBOSE`` (the reference's debug.h:22
contract). ``Tracer.span(op, nbytes)`` times an op on the host clock and
keeps count / bytes / a ring of latencies per op name, from which p50/p99
and Gbit/s are read — the counters ``core.context`` (alloc, put, get, copy)
and ``models.kv_paging`` (kv_store_page, kv_fetch_pages) feed. A span
around a device op measures its enqueue unless the op synchronises.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

_logger = logging.getLogger("oncilla_tpu_torch")
_VERBOSE = bool(os.environ.get("OCM_VERBOSE"))
if _VERBOSE:
    logging.basicConfig(
        level=logging.DEBUG,
        format="%(asctime)s %(process)d/%(threadName)s %(name)s "
        "%(filename)s:%(lineno)d %(message)s",
    )
    _logger.setLevel(logging.DEBUG)


def printd(msg: str, *args) -> None:
    """Debug print, active only under ``OCM_VERBOSE``."""
    if _VERBOSE:
        _logger.debug(msg, *args)


@dataclass
class OpStats:
    count: int = 0
    total_s: float = 0.0
    total_bytes: int = 0
    samples_s: "deque[float]" = field(default_factory=deque)

    def _quantile(self, q: float) -> float:
        if not self.samples_s:
            return 0.0
        s = sorted(self.samples_s)
        return s[min(int(len(s) * q), len(s) - 1)]

    @property
    def p50_s(self) -> float:
        return self._quantile(0.5)

    @property
    def p99_s(self) -> float:
        return self._quantile(0.99)

    @property
    def gbps(self) -> float:
        """GigaBITS per second, the unit of every ``gbps`` key."""
        return (
            self.total_bytes * 8 / self.total_s / 1e9 if self.total_s else 0.0
        )


class _Span:
    __slots__ = ("tracer", "op", "nbytes", "t0")

    def __init__(self, tracer: "Tracer", op: str, nbytes: int):
        self.tracer = tracer
        self.op = op
        self.nbytes = nbytes

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.tracer._span_close(
            self.op, self.nbytes, time.perf_counter() - self.t0
        )


class Tracer:
    """Per-op timing registry: ``with tracer.span("put", nbytes=n): ...``;
    ``tracer.stats("put")`` reports count / p50 / Gbit/s."""

    def __init__(self, max_samples: int = 4096):
        self._stats: dict[str, OpStats] = {}
        self._lock = threading.Lock()
        self._max_samples = max_samples

    def _get_locked(self, op: str) -> OpStats:
        st = self._stats.get(op)
        if st is None:
            st = self._stats[op] = OpStats(
                samples_s=deque(maxlen=self._max_samples)
            )
        return st

    def span(self, op: str, nbytes: int = 0) -> _Span:
        return _Span(self, op, nbytes)

    def _span_close(self, op: str, nbytes: int, dt: float) -> None:
        with self._lock:
            st = self._get_locked(op)
            st.count += 1
            st.total_s += dt
            st.total_bytes += nbytes
            st.samples_s.append(dt)
        printd("op=%s nbytes=%d dt_us=%.1f", op, nbytes, dt * 1e6)

    def stats(self, op: str) -> OpStats:
        """A consistent snapshot of the op's stats."""
        with self._lock:
            st = self._get_locked(op)
            return OpStats(st.count, st.total_s, st.total_bytes,
                           deque(st.samples_s))

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {
                k: {
                    "count": v.count,
                    "p50_us": v.p50_s * 1e6,
                    "p99_us": v.p99_s * 1e6,
                    "gbps": v.gbps,
                    "total_bytes": v.total_bytes,
                }
                for k, v in self._stats.items()
            }


GLOBAL_TRACER = Tracer()
