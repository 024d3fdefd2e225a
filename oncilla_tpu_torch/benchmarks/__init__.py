"""Measurement entry points, the names of ``oncilla_tpu.benchmarks``:

- :mod:`.sweep` — size-doubling one-sided read/write bandwidth sweep over
  any handle kind, plus the all-links SPMD ring sweep.
- :mod:`.gups` — GUPS random-access benchmark over the arena fabric.
- :mod:`.mfu` — single-card MFU on the flagship model (exact per-matmul
  FLOP accounting; forward and train step).
- :mod:`.kv_decode` — OCM-paged KV decode tokens/s.

Attribute access is lazy (PEP 562): importing one submodule (the bench's
``python -m`` entry points) does not import the others.
"""

from __future__ import annotations

_EXPORTS = {
    "SweepPoint": "sweep",
    "forward_flops": "mfu",
    "gups_mesh": "gups",
    "gups_single": "gups",
    "mfu_forward": "mfu",
    "mfu_train": "mfu",
    "size_sweep": "sweep",
    "spmd_ring_sweep": "sweep",
    "train_flops": "mfu",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
