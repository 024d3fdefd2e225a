"""Seeded weights, made by the benchmark and handed to both the system and
the reference: the leaves of the decoder the configuration describes (its
family's ``leaves``), in the layout the system's parameter dict takes
(layers stacked on a leading axis, weights ``(in, out)``), drawn on the
device by one generator in one call a leaf, in the dtype they are served
in. Norm gains are float32 ones. ``dims`` and ``leaves`` here are those of
the Mistral and Mixtral families.
"""

from __future__ import annotations

import math

import torch

from e2ebench import families


def dims(cfg: dict) -> dict:
    """The sizes the benchmark's modules read (a family's ``dims``), from a
    Mistral or Mixtral configuration file (Hugging Face ``config.json``
    keys)."""
    d = {
        "vocab": cfg["vocab_size"], "dim": cfg["hidden_size"],
        "layers": cfg["num_hidden_layers"], "heads": cfg["num_attention_heads"],
        "kv_heads": cfg["num_key_value_heads"], "ffn": cfg["intermediate_size"],
        "rope_theta": float(cfg["rope_theta"]), "eps": float(cfg["rms_norm_eps"]),
        "window": cfg.get("sliding_window"),
        "experts": cfg.get("num_local_experts"),
        "top_k": cfg.get("num_experts_per_tok"),
    }
    d["head_dim"] = d["dim"] // d["heads"]
    return d


def leaves(cfg: dict) -> dict:
    """{name: (shape, scale)}; scale None is a float32 norm gain of ones.
    Inputs are drawn at 1/sqrt(dim), outputs at 1/sqrt(2 * layers * dim),
    the embedding at 1."""
    d = dims(cfg)
    L, D, H, KV, Hd, F, V = (d["layers"], d["dim"], d["heads"], d["kv_heads"],
                             d["head_dim"], d["ffn"], d["vocab"])
    s_in, s_out = 1 / math.sqrt(D), 1 / math.sqrt(2 * L * D)
    out = {
        "embed": ((V, D), 1.0),
        "wq": ((L, D, H * Hd), s_in), "wk": ((L, D, KV * Hd), s_in),
        "wv": ((L, D, KV * Hd), s_in), "wo": ((L, H * Hd, D), s_out),
        "ln_attn": ((L, D), None), "ln_mlp": ((L, D), None),
        "ln_out": ((D,), None), "lm_head": ((D, V), s_in),
    }
    if d["experts"]:
        E = d["experts"]
        out.update({"w_router": ((L, D, E), s_in),
                    "w_gate_e": ((L, E, D, F), s_in),
                    "w_up_e": ((L, E, D, F), s_in),
                    "w_down_e": ((L, E, F, D), s_out)})
    else:
        out.update({"w_gate": ((L, D, F), s_in), "w_up": ((L, D, F), s_in),
                    "w_down": ((L, F, D), s_out)})
    return out


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        abs(int(seed)) % (1 << 63))


def make(cfg: dict, seed: int, device) -> dict:
    """Every leaf of ``cfg``'s decoder, as its family lists them
    (:mod:`e2ebench.families`), in its ``torch_dtype``."""
    shapes = families.of(cfg).leaves(cfg)
    dtype = getattr(torch, cfg["torch_dtype"])
    g = generator(seed, device)
    out = {}
    for name, (shape, scale) in shapes.items():
        if scale is None:
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            t = torch.randn(shape, generator=g, dtype=dtype, device=device)
            out[name] = t.mul_(scale)
    return out
