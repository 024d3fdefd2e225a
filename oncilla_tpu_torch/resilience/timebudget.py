"""A time budget as an absolute monotonic deadline, the port's copy of
``Budget`` in ``oncilla_tpu/resilience/timebudget.py``: the serving
engine's per-step budget (``OCM_STEP_BUDGET_MS``) bounds how long a step
waits on a straggling prefetch. Wire deadlines, hedges and cancels wait for
the wire client."""

from __future__ import annotations

import time


class Budget:
    """One step's time budget."""

    __slots__ = ("deadline",)

    def __init__(self, deadline: float):
        self.deadline = deadline

    @classmethod
    def from_ms(cls, ms: int | float) -> "Budget":
        """A budget of ``ms`` milliseconds starting now."""
        return cls(time.monotonic() + max(0, int(ms)) / 1e3)

    def remaining_s(self) -> float:
        return max(0.0, self.deadline - time.monotonic())

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self.deadline
