"""Error types for the PyTorch port.

The reference signals errors with -1 returns and ``BUG()``/``ABORT()`` crash
macros (reference inc/debug.h:32-48). Here errors are typed exceptions,
the same hierarchy as ``oncilla_tpu.core.errors`` for the arms this package
serves and the wire errors its daemon client raises.
"""

from __future__ import annotations


class OcmError(Exception):
    """Base class for all oncilla errors."""


class OcmOutOfMemory(OcmError):
    """Arena cannot satisfy the requested allocation."""


class OcmBoundsError(OcmError):
    """A put/get would run outside the allocation, analogue of the bounds
    checks in post_send (reference src/rdma.c:55-59)."""


class OcmInvalidHandle(OcmError):
    """Handle is freed, unknown, or of the wrong kind for the operation."""


class OcmProtocolError(OcmError):
    """Malformed or unexpected control-plane message (transport-level: the
    connection can no longer be trusted)."""


class OcmRemoteError(OcmProtocolError):
    """A peer replied with a well-formed ERROR message. The connection
    remains in sync and reusable; ``code`` is the wire ErrCode value.
    ``remote_error`` adds the attributes of a code's data tail
    (``retry_after_ms`` of a BUSY reply, ``moved_to_rank``, ...)."""

    def __init__(self, code: int, detail: str):
        super().__init__(detail)
        self.code = code
        self.detail = detail


class OcmConnectError(OcmError):
    """Could not reach the local daemon or a peer daemon."""


class OcmPlacementError(OcmError):
    """The placement policy could not site the allocation."""


class OcmQuotaExceeded(OcmError):
    """The app's byte or handle quota cannot admit this allocation
    (wire: ErrCode.QUOTA_EXCEEDED, not retryable until the app frees)."""


class OcmAdmissionDenied(OcmError):
    """Admission control refused the app outright, e.g. the daemon's
    concurrent-app cap is reached (wire: ErrCode.ADMISSION_DENIED)."""


class OcmBusy(OcmError):
    """Back-pressure: the arena crossed its high watermark and the daemon
    asks the client to retry later (wire: ErrCode.BUSY, retryable;
    ``retry_after_ms`` is the server-suggested back-off)."""

    def __init__(self, detail: str, retry_after_ms: int = 0):
        super().__init__(detail)
        self.retry_after_ms = int(retry_after_ms)


class OcmDeviceError(OcmError):
    """The requested device is not there: CUDA was asked for (explicitly or
    by default) on a machine without it. Never answered by falling back to
    the CPU."""


class OcmReplicaUnavailable(OcmError):
    """A replicated write could not reach a replica that is not (yet)
    declared DEAD — the primary refuses to ack a put it cannot make
    durable on the chain (wire: ErrCode.REPLICA_UNAVAILABLE, retryable)."""


class OcmNotPrimary(OcmError):
    """A replica holder refused a client data op because it still
    believes its primary alive (wire: ErrCode.NOT_PRIMARY, retryable —
    the failover window closes when the death verdict lands)."""


class OcmMoved(OcmError):
    """The allocation was live-migrated off this rank (elastic/): the
    source holds a forwarding tombstone naming the new owner (wire:
    ErrCode.MOVED, retryable; ``rank`` rides as an i64 data tail on the
    ERROR frame and clients repoint their handle at it)."""

    def __init__(self, detail: str, rank: int):
        super().__init__(detail)
        self.rank = int(rank)


class OcmDeadlineExceeded(OcmError):
    """The op's time budget ran out (resilience/timebudget.py) — locally
    (a retry ladder clamped to zero remaining) or remotely (a daemon
    refused already-expired work; wire: ErrCode.DEADLINE_EXCEEDED). Not
    retryable: the budget is the caller's own contract, and surfacing it
    typed is the whole point — a decode step that misses its token
    budget sheds instead of hanging the batch."""


class OcmBreakerOpen(OcmConnectError):
    """A per-peer circuit breaker is OPEN (resilience/timebudget.py):
    consecutive transport/deadline failures flipped the peer and this
    attempt failed FAST instead of eating the op's budget. A subclass of
    OcmConnectError on purpose — failover ladders treat it exactly like
    an unreachable peer and walk to the next candidate; half-open probes
    re-admit the peer once it answers again."""
