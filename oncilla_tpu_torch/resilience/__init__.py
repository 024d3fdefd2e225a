"""Resilience, the port's copies of ``oncilla_tpu/resilience``: the
daemon-to-daemon failure detector (:mod:`.detector`), the leader's failover
coordinator (:mod:`.failover`) and the time budgets, breakers and hedge
policy (:mod:`.timebudget`; the serving engine's step budget is its
``Budget``). The chaos harness and the client's failover ladders are not
ported.
"""
