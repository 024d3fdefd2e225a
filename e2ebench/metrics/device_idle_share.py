"""Share of the traced stretch in which no kernel, copy or fill ran on
the device, in % (``torch.profiler``)."""


def read(r):
    t = r.trace
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1 - t["busy_s"] / t["window_s"])
