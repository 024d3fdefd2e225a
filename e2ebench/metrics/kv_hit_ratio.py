"""Share of the page-residency lookups of the window that found the page
on the card (the engine's ``ServingStats`` hits over lookups), in %."""


def read(r):
    a, b = r.start["stats"], r.end["stats"]
    lookups = b["lookups"] - a["lookups"]
    return 100.0 * (b["hits"] - a["hits"]) / lookups if lookups else None
