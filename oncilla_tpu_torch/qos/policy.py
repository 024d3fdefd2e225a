"""Priority classes, the port's copy of ``oncilla_tpu/qos/policy.py:42-43``.

The classes and the wire profile are ported: the serving engine admits
and seats higher classes first, the tiered page store maps its tiers onto
them, and a client with a non-default profile declares it at CONNECT
(``pack_profile``). Admission control itself is the daemon's.
"""

from __future__ import annotations

import struct

# Keep the numeric order meaningful: victims sort ascending.
PRIO_LOW, PRIO_NORMAL, PRIO_HIGH = 0, 1, 2
PRIO_NAMES = {PRIO_LOW: "low", PRIO_NORMAL: "normal", PRIO_HIGH: "high"}

# The CONNECT profile tail: priority u8 | quota_bytes u64 | quota_handles u32.
PROFILE_TAIL = struct.Struct("<BQI")


def pack_profile(priority: int, quota_bytes: int, quota_handles: int) -> bytes:
    return PROFILE_TAIL.pack(priority, quota_bytes, quota_handles)
