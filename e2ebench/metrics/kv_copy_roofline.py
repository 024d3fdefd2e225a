"""The page copy kernels' share of the HBM roofline, in %: K1
(``ocm_write_rows``) and K2 (``ocm_read_rows``) run one kernel,
``bulk_copy_kernel``; each launch reads and writes one page, so the bytes
are 2 x page bytes a launch, over the launches' summed device time in the
traced stretch times the card's HBM rate."""

KERNEL = "bulk_copy_kernel"


def read(r):
    t = r.trace
    if t is None:
        return None
    n, secs = 0, 0.0
    for name, (count, s) in t["kernels"].items():
        if KERNEL in name:
            n, secs = n + count, secs + s
    if not n or secs <= 0:
        return None
    return 100.0 * 2 * r.page_bytes * n / (secs * r.peak_hbm)
