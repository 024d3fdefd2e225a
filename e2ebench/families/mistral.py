"""Mistral-7B (``model_type`` ``mistral``): dense grouped-query attention
with at most one sliding window, shared by every layer; a SwiGLU
feed-forward. The system runs it as ``oncilla_tpu_torch.models.llama``."""

from __future__ import annotations

from e2ebench import weights, yardstick
from e2ebench.reference.decoder import logits_at  # noqa: F401

dims = weights.dims
leaves = weights.leaves
flops = yardstick.flops


def port_config(cfg: dict):
    from oncilla_tpu_torch.models.llama import LlamaConfig

    d = dims(cfg)
    return LlamaConfig(vocab=d["vocab"], dim=d["dim"], n_layers=d["layers"],
                       n_heads=d["heads"], n_kv_heads=d["kv_heads"],
                       ffn_hidden=d["ffn"], max_seq=cfg["max_position_embeddings"],
                       rope_theta=d["rope_theta"], norm_eps=d["eps"],
                       dtype=cfg["torch_dtype"], window=d["window"])


def paged_hooks(pcfg) -> dict:
    return {}
