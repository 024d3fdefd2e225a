"""Shared by the readers of the program's host-clock spans."""


def mean_ms(r, op: str):
    """Mean milliseconds of span ``op`` over the window, or None."""
    c0, s0 = r.start["spans"][op]
    c1, s1 = r.end["spans"][op]
    return (s1 - s0) / (c1 - c0) * 1e3 if c1 > c0 else None
