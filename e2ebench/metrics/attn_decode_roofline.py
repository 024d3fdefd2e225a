"""The paged decode attention kernel's share of the HBM roofline, in %.

Each token step runs the kernel once a layer (``attn_decode_kernel``, and
``attn_decode_combine_kernel`` where the context is split), reading K and
V of every valid key of every row once: 2 x batch x KV heads x head size x
itemsize bytes a key, at the traced stretch's mean context (reckoned as
``step_hbm_share`` reckons it: the context before each page plus its tail
through the step's token). The bytes of every launch of the first kernel
over the summed device time of both, times the card's HBM rate. None
where no such kernel ran (a program whose attention is not that kernel)."""

KERNEL = "attn_decode"
MAIN = "attn_decode_kernel"
ITEMSIZE = 2  # the cells' K/V are bf16


def read(r):
    t = r.trace
    if t is None:
        return None
    n, secs = 0, 0.0
    for name, (count, s) in t["kernels"].items():
        if KERNEL in name:
            secs += s
            if MAIN in name:
                n += count
    pages = [(c, k) for end, c, k in r.pages if r.stretch[0] < end <= r.stretch[1]]
    if not n or secs <= 0 or not pages:
        return None
    steps = sum(k for _, k in pages)
    ctx = sum((c + (k + 1) / 2) * k for c, k in pages) / steps
    per_launch = 2 * r.batch * r.d["kv_heads"] * r.d["head_dim"] * ITEMSIZE * ctx
    return 100.0 * per_launch * n / (secs * r.peak_hbm)
