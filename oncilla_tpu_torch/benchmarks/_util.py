"""Shared benchmark plumbing (the port's copy of
``oncilla_tpu.benchmarks._util``)."""

from __future__ import annotations

import torch


def fence(x) -> None:
    """Wait for the work queued on the device of tensor ``x``: a
    ``torch.cuda.synchronize`` for a CUDA tensor, nothing for a CPU tensor
    (or None), whose work is already done when the call returns."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)
