"""Observability, the port's copies of ``oncilla_tpu/obs``: the
per-process event journal (:mod:`.journal`), trace contexts (:mod:`.trace`),
the slow-op watchdog (:mod:`.watchdog`) and the Prometheus text the daemon
serves in band (:mod:`.prom`). The flight recorder, the exporters and the
CLI are not ported.

Stdlib-only: :mod:`..utils.debug` imports these at module level.
"""
