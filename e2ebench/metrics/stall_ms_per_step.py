"""Milliseconds the engine waited on page fetches (``ServingStats``
``stall_s``) per batched step of the window."""


def read(r):
    a, b = r.start["stats"], r.end["stats"]
    steps = b["batch_steps"] - a["batch_steps"]
    return (b["stall_s"] - a["stall_s"]) / steps * 1e3 if steps else None
