"""Observability: the per-process event journal (:mod:`.journal`)."""
