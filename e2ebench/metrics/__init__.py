"""One reader a per-layer metric, found by the metric's name in
``BENCHMARK.json``: ``metrics/<name>.py`` with ``read(r)``, which takes the
run's readings (:class:`e2ebench.run.Readings`) and returns the value, or
None when the run has nothing to read for it (the metric is then left out
of the line)."""
