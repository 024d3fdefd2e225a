"""The comparison that decides ``correct``: the served tokens of a sample
of finished requests against the plain reference.

For a request of prompt ``p`` (n ids) that served ``out`` (m ids), the
reference runs once over ``p + out[:-1]``; served token j was chosen from
the logits at position n - 1 + j. Its gap is how far its reference logit
lies below the reference's best there (0 when the reference picks it too).
The number compared is the mean gap over the sample's served tokens; the
widest gap is printed beside it. The widest is set by the one token whose
reference margin happened to be widest among those that rounding flipped
(a near-tie of two logits, or of two experts' router weights), so it
swings from sample to sample as much as the control's does; the mean
counts every flip and keeps the two apart (PERF.md).

Both sides are the configuration's family's reference (``logits_at`` of
:mod:`e2ebench.families`). The control reads the same positions with the
reference in float8 (``precision="float8"``) in the program's place: the
gap of the token the float8 forward puts first.
"""

from __future__ import annotations

import torch

from e2ebench import families


def _positions(prompt, out):
    n = len(prompt)
    return list(prompt) + list(out[:-1]), list(range(n - 1, n - 1 + len(out)))


def gaps(params, cfg, prompt, out) -> torch.Tensor:
    """The reference gap of every served token of one request."""
    ids, wanted = _positions(prompt, out)
    ref = families.of(cfg).logits_at(params, cfg, ids, wanted)
    tok = torch.tensor(out, device=ref.device)
    return (ref.max(-1).values - ref.gather(1, tok[:, None])[:, 0]).cpu()


def control_gaps(params, cfg, prompt, out):
    """(reference gaps of the served tokens, reference gaps of the tokens
    the float8 forward puts first, the reference's narrowest router margin
    over the layers at every position that feeds them; the last None
    without experts) at the same positions."""
    ids, wanted = _positions(prompt, out)
    logits_at = families.of(cfg).logits_at
    margins = []
    ref = logits_at(params, cfg, ids, wanted, margins=margins)
    low = logits_at(params, cfg, ids, wanted, precision="float8")
    best = ref.max(-1).values
    tok = torch.tensor(out, device=ref.device)
    served = best - ref.gather(1, tok[:, None])[:, 0]
    ctrl = best - ref.gather(1, low.argmax(-1)[:, None])[:, 0]
    narrow = (torch.stack(margins).amin(0)[wanted].cpu() if margins
              else None)
    return served.cpu(), ctrl.cpu(), narrow


def _summary(g: torch.Tensor) -> dict:
    q = torch.quantile(g.double(), torch.tensor([0.5, 0.9, 0.99],
                                                dtype=torch.float64))
    return {"widest": float(g.max()), "mean": float(g.mean()),
            "p50": float(q[0]), "p90": float(q[1]), "p99": float(q[2]),
            "share_off": float((g > 0).double().mean())}


def compare(sample, params, cfg, control: bool = False) -> dict:
    """The mean and widest gap over ``sample`` [(prompt, out)], and their
    count; with ``control`` also the summaries of both sides' gaps at the
    same positions (and, with experts, the router margins there)."""
    worst, total, n = 0.0, 0.0, 0
    cal = {"served": [], "control": [], "margin": []}
    for prompt, out in sample:
        if control:
            g, c, m = control_gaps(params, cfg, prompt, out)
            cal["served"].append(g)
            cal["control"].append(c)
            if m is not None:
                cal["margin"].append(m)
        else:
            g = gaps(params, cfg, prompt, out)
        worst = max(worst, float(g.max()))
        total += float(g.double().sum())
        n += g.numel()
    got = {"mean_gap": total / n if n else 0.0, "widest_gap": worst,
           "tokens": n, "requests": len(sample)}
    if control and n:
        g, c = torch.cat(cal["served"]), torch.cat(cal["control"])
        got["served"], got["control"] = _summary(g), _summary(c)
        if cal["margin"]:
            # The router margin at the served tokens' widest gaps, against
            # its median over every position: where routing is near a tie,
            # a rounding flips an expert.
            m = torch.cat(cal["margin"])
            worst5 = g.topk(min(5, g.numel())).indices
            got["margin_median"] = float(m.median())
            got["margin_at_widest"] = [float(x) for x in m[worst5]]
            got["gap_widest5"] = [float(x) for x in g[worst5]]
    return got
