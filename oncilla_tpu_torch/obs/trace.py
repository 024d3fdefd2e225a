"""Trace context: the (trace_id, span_id) pair that crosses processes.

Dapper-model propagation: the process that starts a logical op mints a
64-bit trace_id plus a span_id for its root span; every child span (same
process or across a protocol hop) keeps the trace_id and mints a fresh
span_id, recording its parent's. On the wire the context is a fixed
16-byte little-endian prefix on a message's data tail, sent only after a
``FLAG_CAP_TRACE`` capability exchange (see runtime/protocol.py) so
un-upgraded v2 peers and the native C++ daemon never see it.

Stdlib-only on purpose: ``utils.debug`` imports this at module level,
possibly while the package root is still mid-import (see
``obs/__init__``).
"""

from __future__ import annotations

import os
import random
import struct
import threading
from dataclasses import dataclass

# Wire encoding of one context: trace_id u64 | span_id u64 (little-endian,
# like every other field of the OCM1 frame). protocol.py's codec never
# sees this — the prefix is opaque data-tail bytes to the frame layer.
_CTX = struct.Struct("<QQ")
CTX_BYTES = _CTX.size  # 16


@dataclass(frozen=True)
class TraceCtx:
    """One hop's view of a trace: which trace, and which span is current.

    ``parent_span_id`` never crosses the wire (the receiver's spans parent
    onto ``span_id`` itself); it exists so in-process child spans can
    journal their parent edge.
    """

    trace_id: int
    span_id: int
    parent_span_id: int = 0

    def encode(self) -> bytes:
        return _CTX.pack(self.trace_id, self.span_id)


def decode(buf) -> TraceCtx:
    trace_id, span_id = _CTX.unpack(bytes(buf[:CTX_BYTES]))
    return TraceCtx(trace_id=trace_id, span_id=span_id)


# Per-THREAD RNG for ids: ``random.getrandbits`` is ~100 ns — cheap
# enough for the span hot path — and non-crypto is fine (ids only need to
# be collision-unlikely within a trace's lifetime). One Random per thread
# (seeded from urandom, so forked workers and sibling threads do not mint
# identical id streams) keeps the hot path lock-free: every span mints
# 1-2 ids, and a process-wide lock here was measurable under the mux
# runtime's small-op load.
_rng_tls = threading.local()


def _new_id() -> int:
    rng = getattr(_rng_tls, "rng", None)
    if rng is None:
        rng = _rng_tls.rng = random.Random(os.urandom(8))
    return rng.getrandbits(64) or 1  # 0 means "absent" on the wire


def mint() -> TraceCtx:
    """A fresh root context: new trace, new root span."""
    return TraceCtx(trace_id=_new_id(), span_id=_new_id())


def child(parent: TraceCtx) -> TraceCtx:
    """A child span context inside ``parent``'s trace."""
    return TraceCtx(
        trace_id=parent.trace_id,
        span_id=_new_id(),
        parent_span_id=parent.span_id,
    )


# -- the ambient context -------------------------------------------------

_tls = threading.local()


def current() -> TraceCtx | None:
    """The thread's active trace context (None outside any span)."""
    return getattr(_tls, "ctx", None)


class use_ctx:
    """Context manager installing ``ctx`` as the thread's active context
    (``None`` is a no-op, so call sites need no branch). Re-entrant:
    restores whatever was active before."""

    __slots__ = ("ctx", "_saved")

    def __init__(self, ctx: TraceCtx | None):
        self.ctx = ctx

    def __enter__(self) -> TraceCtx | None:
        if self.ctx is not None:
            self._saved = getattr(_tls, "ctx", None)
            _tls.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc) -> None:
        if self.ctx is not None:
            _tls.ctx = self._saved


def swap(ctx: TraceCtx | None) -> TraceCtx | None:
    """Install ``ctx`` as the thread's active context, returning the
    previous one — the raw pair use_ctx is built from, exposed for hot
    paths (Tracer._Span) that cannot afford a context-manager object per
    span. Always pair with :func:`restore`."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


def restore(prev: TraceCtx | None) -> None:
    _tls.ctx = prev


def enabled() -> bool:
    """Context minting/propagation is always-on (the Dapper premise: ids
    are too cheap to gate) unless ``OCM_TRACE=0`` opts the process out."""
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Test hook; also honors runtime re-decisions of the env knob."""
    global _ENABLED
    _ENABLED = bool(on)


_ENABLED = os.environ.get("OCM_TRACE", "1") not in ("0", "")


# -- wire helpers (message-object level, used by client and daemon) ------


def attach(msg, ctx: TraceCtx, flag: int):
    """Prefix ``msg``'s data tail with ``ctx`` and set ``flag``
    (FLAG_TRACE_CTX) — in place; returns ``msg`` for chaining. The caller
    has already checked the peer granted the capability. A bulk payload
    (a DATA_PUT chunk) becomes the vectored ``[prefix, payload]`` form
    the codec scatter-gathers — never a concatenating copy of the
    payload."""
    msg.flags |= flag
    head = ctx.encode()
    if isinstance(msg.data, (list, tuple)):
        msg.data = [head, *msg.data]
    elif len(msg.data) >= 4096:
        msg.data = [head, msg.data]
    else:
        msg.data = head + bytes(msg.data) if len(msg.data) else head
    return msg


def split(data) -> tuple[TraceCtx | None, object]:
    """Strip a 16-byte context prefix off a data tail. A tail shorter than
    the prefix is malformed-but-tolerated (receivers must not die on a
    confused peer): returns (None, data) unchanged. The rest is a VIEW —
    no payload copy on the per-frame strip path; Message.data consumers
    treat it as a read-only buffer already."""
    if len(data) < CTX_BYTES:
        return None, data
    rest = (data if isinstance(data, memoryview)
            else memoryview(data))[CTX_BYTES:]
    return decode(data), rest
