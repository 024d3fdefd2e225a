"""The benchmark's own arithmetic, frozen here so that no change to the
system can move it: operation and byte counts computed from the model's
shapes, and the published peaks of the card.

The FLOP count of a token is the matmul work of one decoder forward at one
position (2·m·n·k a product; norms and elementwise work left out), as the
system's ``benchmarks/mfu.forward_flops`` counts a whole sequence: the
projections, attention over the keys the token sees (the sliding window
caps them), the feed-forward (the MoE family: the router and its top-k
experts only, not the dense dispatch) and the vocabulary head.
"""

from __future__ import annotations

# Published dense rates of the card's SXM, PCIe and NVL parts: bf16
# tensor-core FLOP/s without sparsity, and HBM bytes/s. The rates assume
# the card's full power limit; each run prints the limit beside them.
PEAKS = (
    ("H100 NVL", 835e12, 3.9e12),
    ("H100 PCIe", 756e12, 2.0e12),
    ("H100", 989e12, 3.35e12),
)


def peaks(kind: str) -> tuple[float, float]:
    """(bf16 FLOP/s, HBM bytes/s) of the card named ``kind``."""
    for key, flops, hbm in PEAKS:
        if key in kind:
            return flops, hbm
    raise ValueError(f"no published peaks for the card {kind!r}")


def _attended(p0: int, n: int, window: int | None) -> int:
    """Keys seen, summed over the n tokens at positions p0 .. p0+n-1 (the
    token at position p sees p + 1 keys, at most ``window``)."""
    total = 0
    a, b = p0 + 1, p0 + n          # keys seen by the first and last token
    if window is None or b <= window:
        return (a + b) * n // 2
    if a >= window:
        return window * n
    total = (a + window) * (window - a + 1) // 2
    return total + window * (b - window)


def token_flops(d: dict) -> tuple[int, int]:
    """(FLOPs of one token outside attention over its keys, FLOPs per
    attended key), for the sizes ``d`` (:func:`weights.dims`)."""
    D, H, KV, Hd, F, V, L = (d["dim"], d["heads"], d["kv_heads"], d["head_dim"],
                             d["ffn"], d["vocab"], d["layers"])
    proj = 2 * D * H * Hd + 2 * 2 * D * KV * Hd + 2 * H * Hd * D
    if d["experts"]:
        ffn = 2 * D * d["experts"] + d["top_k"] * 3 * 2 * D * F
    else:
        ffn = 3 * 2 * D * F
    return L * (proj + ffn) + 2 * D * V, L * 2 * 2 * H * Hd


def flops(d: dict, runs) -> int:
    """FLOPs of the tokens in ``runs`` [(first position, count)]."""
    fixed, per_key = token_flops(d)
    return sum(fixed * n + per_key * _attended(p, n, d["window"])
               for p, n in runs)


def moe_step_bytes(d: dict, batch: int, context: float, itemsize: int = 2) -> float:
    """Bytes one batched MoE token step must read: every layer's attention
    weights, router, norms and the experts the batch's tokens chose (with
    ``batch`` * top_k picks over the experts each is chosen in practically
    every step, so all of them), an embedding row a token, the head, and
    the KV history of ``context`` positions of every row."""
    L, D, H, KV, Hd, F, V, E = (d["layers"], d["dim"], d["heads"], d["kv_heads"],
                                d["head_dim"], d["ffn"], d["vocab"], d["experts"])
    weights = (L * D * (2 * H + 2 * KV) * Hd * itemsize + L * D * E * itemsize
               + (2 * L + 1) * D * 4 + batch * D * itemsize + D * V * itemsize
               + L * E * 3 * D * F * itemsize)
    kv = 2 * L * batch * KV * context * Hd * itemsize
    return weights + kv
