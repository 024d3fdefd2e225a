"""Disaggregated LLM serving over the port's data plane, the counterpart of
``oncilla_tpu/serving``: a continuous-batching decode engine
(:mod:`.engine`) whose paged KV cache tiers across device HBM, host DRAM and
a cold tier (:mod:`.tiers`), with identical prompt prefixes deduplicated
across tenants into shared refcounted extents (:mod:`.prefix`).

Attribute access is lazy (PEP 562): :mod:`.metrics` stays importable
without the model stack.
"""

from __future__ import annotations

_EXPORTS = {
    "ServingStats": "metrics",
    "Tier": "tiers",
    "TIER_PRIORITY": "tiers",
    "Page": "tiers",
    "TieredPageStore": "tiers",
    "PrefixCache": "prefix",
    "SharedExtent": "prefix",
    "Request": "engine",
    "SessionResult": "engine",
    "Prefetcher": "engine",
    "ServingEngine": "engine",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
