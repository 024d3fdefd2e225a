"""Model-side public surface: the Llama family and KV paging, mirroring
``oncilla_tpu/models/__init__.py``'s exports for what the port has.

Attribute access is lazy (PEP 562); submodules (``models.llama``,
``models.kv_paging``, ``models.graphs``) stay importable directly.
"""

from __future__ import annotations

_EXPORTS = {
    "LlamaConfig": "llama",
    "init_params": "llama",
    "params_from_jax": "llama",
    "decode_step": "llama",
    "make_kv_cache": "llama",
    "sample_token": "llama",
    "PagedKVCache": "kv_paging",
    "PagedDecoder": "kv_paging",
    "BucketedPagedDecoder": "kv_paging",
    "paged_decode_step": "kv_paging",
    "paged_token_step": "kv_paging",
    "paged_decode_batch_step": "kv_paging",
    "paged_decode_page": "kv_paging",
    "paged_generate_page": "kv_paging",
    "StepGraphs": "graphs",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
