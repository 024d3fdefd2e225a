"""Mean milliseconds of the engine's batched step (the program's
``serve_batch_step`` span, which ends at the step's own sync) over the
window."""

from e2ebench.metrics._span import mean_ms


def read(r):
    return mean_ms(r, "serve_batch_step")
