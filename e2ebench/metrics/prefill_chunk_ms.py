"""Mean milliseconds of one chunked-prefill page (the program's
``serve_prefill_chunk`` span) over the window."""

from e2ebench.metrics._span import mean_ms


def read(r):
    return mean_ms(r, "serve_prefill_chunk")
