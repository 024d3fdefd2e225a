"""Mixtral-8x7B (``model_type`` ``mixtral``): Mistral's attention; the
feed-forward a router over ``num_local_experts`` SwiGLU experts of width
``intermediate_size``, the top ``num_experts_per_tok`` renormalised. The
system runs it as ``oncilla_tpu_torch.models.moe``; ``capacity_factor``
is the system's own setting, which the configuration file states."""

from __future__ import annotations

from e2ebench import weights, yardstick
from e2ebench.reference.decoder import logits_at  # noqa: F401

dims = weights.dims
leaves = weights.leaves
flops = yardstick.flops
step_bytes = yardstick.moe_step_bytes


def port_config(cfg: dict):
    from oncilla_tpu_torch.models.moe import MoeConfig

    d = dims(cfg)
    return MoeConfig(vocab=d["vocab"], dim=d["dim"], n_layers=d["layers"],
                     n_heads=d["heads"], n_kv_heads=d["kv_heads"],
                     ffn_hidden=d["ffn"], max_seq=cfg["max_position_embeddings"],
                     rope_theta=d["rope_theta"], norm_eps=d["eps"],
                     dtype=cfg["torch_dtype"], window=d["window"],
                     n_experts=d["experts"], top_k=d["top_k"],
                     capacity_factor=float(cfg["capacity_factor"]))


def paged_hooks(pcfg) -> dict:
    from oncilla_tpu_torch.models import moe

    return moe.paged_hooks(pcfg)
