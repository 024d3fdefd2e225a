"""A family hook, bound into the captured step by ``runner``."""


def scaled_mlp(x):
    peak = x.abs().max().item()  # FINDING: a hook runs inside the capture
    return x / peak
