"""The whole step's share of the card's bf16 peak, in %: the model FLOPs
of every token position the window computed (prompt positions included,
prefix-cache hits not; the MoE family's top-k experts, not the dense
dispatch; the family's ``flops``, ``yardstick.flops`` for Mistral and
Mixtral) over the window's seconds times the peak."""


def read(r):
    f = r.family.flops(r.d, r.computed)
    return 100.0 * f / (r.window_s * r.peak_flops) if f else None
