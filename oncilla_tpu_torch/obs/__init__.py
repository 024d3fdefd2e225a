"""Observability, the port's copies of ``oncilla_tpu/obs``: the
per-process event journal (:mod:`.journal`), its crash-safe twin the flight
recorder (:mod:`.flightrec`, ``OCM_FLIGHTREC=dir``: CRC-framed segment
files that a killed daemon leaves on disk), the post-mortem auditor that
checks cross-rank invariants over those segments (:mod:`.audit`, ``python
-m oncilla_tpu_torch.obs.audit <dir>``), trace contexts (:mod:`.trace`), the
slow-op watchdog (:mod:`.watchdog`) and the Prometheus text the daemon
serves in band (:mod:`.prom`). The exporters and the status CLI are not
ported.

Stdlib-only: :mod:`..utils.debug` imports these at module level.
"""
