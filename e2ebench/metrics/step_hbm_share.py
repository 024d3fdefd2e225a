"""A batched token step's share of the HBM bound, in %: the bytes a step
must read (the family's ``step_bytes``; Mixtral's is
``yardstick.moe_step_bytes``: the weights its tokens' experts use, all of
them at this batch, and the KV history at the stretch's mean context) over
the device time of a step in the traced stretch (its busy time over its
token steps) times the card's HBM rate. The memory bound applies: a MoE
step's FLOPs at batch 32 take a tenth of its bytes' time. None for a
family with no ``step_bytes``."""


def read(r):
    t = r.trace
    step_bytes = getattr(r.family, "step_bytes", None)
    if t is None or t["busy_s"] <= 0 or step_bytes is None:
        return None
    pages = [(c, n) for end, c, n in r.pages if r.stretch[0] < end <= r.stretch[1]]
    if not pages:
        return None
    steps = sum(n for _, n in pages)
    ctx = sum((c + (n + 1) / 2) * n for c, n in pages) / steps
    need = step_bytes(r.d, r.batch, ctx)
    return 100.0 * need / (t["busy_s"] / steps * r.peak_hbm)
