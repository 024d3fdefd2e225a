"""Runtime analysis hooks the daemon carries, the port's copies of
``oncilla_tpu/analysis``: the lock-order watchdog (:mod:`.lockwatch`,
``OCM_LOCKWATCH=1``), the unified wait-for graph (:mod:`.waitwatch`,
``OCM_WAITWATCH=1``) and the allocation ledger (:mod:`.alloctrace`,
``OCM_ALLOCTRACE=1``). The static passes (lint, lifecycle, conformance,
rpcgraph) are not ported.
"""
