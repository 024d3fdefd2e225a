"""Mean milliseconds of one refetch of the paged context (the program's
``kv_fetch_pages`` span) over the window."""

from e2ebench.metrics._span import mean_ms


def read(r):
    return mean_ms(r, "kv_fetch_pages")
