"""Elastic membership, the port's copy of ``oncilla_tpu/elastic``'s
server side: the leader's capacity-weighted :class:`Rebalancer`, which
drives live migrations between daemons. The JOIN/LEAVE handlers and the
migration state machine live in ``runtime/daemon.py``; the joiner-side
helper (``elastic/join.py``) is not ported.
"""

from oncilla_tpu_torch.elastic.rebalance import Rebalancer  # noqa: F401
