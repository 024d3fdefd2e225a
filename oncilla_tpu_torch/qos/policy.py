"""Priority classes, the port's copy of ``oncilla_tpu/qos/policy.py:42-43``.

Only the classes are ported: the serving engine admits and seats higher
classes first, and the tiered page store maps its tiers onto them. Quotas,
admission control and the wire profile wait for the wire client.
"""

from __future__ import annotations

# Keep the numeric order meaningful: victims sort ascending.
PRIO_LOW, PRIO_NORMAL, PRIO_HIGH = 0, 1, 2
PRIO_NAMES = {PRIO_LOW: "low", PRIO_NORMAL: "normal", PRIO_HIGH: "high"}
