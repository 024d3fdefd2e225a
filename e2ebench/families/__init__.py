"""One module a model family, found by the configuration's ``model_type``:
``families/<model_type>.py``. A family is everything of the benchmark that
reads the configuration's Hugging Face keys, so a new architecture joins
the benchmark as one new file here (with its reference beside the others
under ``reference/``) and edits nothing that is already there.

A family module provides:

- ``dims(cfg)``: the sizes the adapters and the per-layer readers read
  (``vocab``, ``dim``, ``layers``, ``heads``, ``kv_heads``, ``head_dim``,
  ``ffn``, ``window``, ``experts``, ``top_k``, ...).
- ``leaves(cfg)``: ``{name: (shape, scale)}`` of the weights, in the order
  they are drawn (:func:`e2ebench.weights.make`); scale None is a float32
  norm gain of ones.
- ``logits_at(params, cfg, ids, wanted, precision="float32", margins=None)``:
  the plain reference's float32 logits at the positions ``wanted``
  (``precision="float8"`` is the control).
- ``flops(d, runs)``: the model FLOPs of the token runs
  [(first position, count)] at the sizes ``d``.
- ``step_bytes(d, batch, context)``, optional: the bytes one batched token
  step must read; a reader that needs it reads nothing without it.
- ``port_config(cfg)``: the system's config object for the model.
- ``paged_hooks(pcfg)``: the keyword arguments the paged decoders of
  ``oncilla_tpu_torch.models.kv_paging`` take for this family.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def of(cfg: dict):
    """The family module of ``cfg``; SystemExit, naming the file that is
    missing, where there is none."""
    name = cfg.get("model_type")
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise SystemExit(f"model_type {name!r} names no model family "
                         f"(one module under {HERE})")
    module = f"{__name__}.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise SystemExit(f"no model family {name!r}: {HERE / (name + '.py')} "
                         "does not exist") from None
