"""Model-side public surface: the Llama and MoE families, KV paging,
training on one device or a mesh and the checkpoint, mirroring
``oncilla_tpu/models/__init__.py``'s exports for what the port has.

Attribute access is lazy (PEP 562); submodules (``models.llama``,
``models.moe``, ``models.kv_paging``, ``models.graphs``, ``models.optim``,
``models.train``, ``models.checkpoint``) stay importable directly.
"""

from __future__ import annotations

_EXPORTS = {
    "LlamaConfig": "llama",
    "init_params": "llama",
    "init_from_spec": "llama",
    "init_params_host": "llama",
    "params_from_jax": "llama",
    "forward": "llama",
    "forward_hidden": "llama",
    "loss_fn": "llama",
    "blocked_cross_entropy": "llama",
    "causal_mask": "llama",
    "decode_step": "llama",
    "decode_loop": "llama",
    "generate": "llama",
    "make_kv_cache": "llama",
    "sample_token": "llama",
    "MoeConfig": "moe",
    "init_moe_params": "moe",
    "paged_hooks": "moe",
    "adamw": "optim",
    "opt_state_from_jax": "optim",
    "make_train_state": "train",
    "make_train_state_host": "train",
    "make_train_step": "train",
    "make_mesh": "train",
    "make_moe_mesh": "train",
    "make_pp_mesh": "train",
    "make_moe_train_state": "train",
    "make_moe_train_step": "train",
    "make_pp_train_state": "train",
    "make_pp_train_step": "train",
    "make_moe_pp_train_state": "train",
    "make_moe_pp_train_step": "train",
    "make_eval_step": "train",
    "evaluate": "train",
    "sample_batch": "train",
    "PagedKVCache": "kv_paging",
    "PagedDecoder": "kv_paging",
    "BucketedPagedDecoder": "kv_paging",
    "paged_decode_step": "kv_paging",
    "paged_token_step": "kv_paging",
    "paged_decode_batch_step": "kv_paging",
    "paged_decode_page": "kv_paging",
    "paged_generate_page": "kv_paging",
    "hooked_step": "kv_paging",
    "StepGraphs": "graphs",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
