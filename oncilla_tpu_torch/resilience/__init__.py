"""Resilience, the port's copies of ``oncilla_tpu/resilience``: the
daemon-to-daemon failure detector (:mod:`.detector`), the leader's failover
coordinator (:mod:`.failover`), the seeded fault-injection harness at the
connection-pool seam (:mod:`.chaos`) and the time budgets, breakers and
hedge policy (:mod:`.timebudget`; the serving engine's step budget is its
``Budget``). The client's failover ladders live in ``runtime/client.py``.
"""

from oncilla_tpu_torch.resilience.chaos import (  # noqa: F401
    ChaosController,
    ChaosSchedule,
    Fault,
    corrupt_file,
)
from oncilla_tpu_torch.resilience.detector import (  # noqa: F401
    FailureDetector,
    PeerState,
    probe,
)
from oncilla_tpu_torch.resilience.failover import FailoverCoordinator  # noqa: F401
from oncilla_tpu_torch.resilience.timebudget import (  # noqa: F401
    Budget,
    CircuitBreaker,
    backoff_sleep,
)
