"""Error types for the PyTorch port.

The reference signals errors with -1 returns and ``BUG()``/``ABORT()`` crash
macros (reference inc/debug.h:32-48). Here errors are typed exceptions,
the same hierarchy as ``oncilla_tpu.core.errors`` for the arms this package
serves.
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


class OcmConnectError(OcmError):
    """Could not reach the local daemon or a peer daemon (this package has
    no control plane yet, so every remote arm raises it)."""


class OcmDeviceError(OcmError):
    """The requested device is not there: CUDA was asked for (explicitly or
    by default) on a machine without it. Never answered by falling back to
    the CPU."""
