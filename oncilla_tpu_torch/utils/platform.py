"""Device selection: CUDA unless the caller asks for the CPU.

Every entry point of the package takes a ``device`` argument and resolves it
here. ``None`` means the first CUDA device; on a machine without CUDA that
raises :class:`OcmDeviceError` — it never falls back to the CPU, which would
hide the device a measurement claims to run on. The CPU is used only when
asked for by name (``device="cpu"``), as the tests do.

:func:`hbm_rate` is the card's datasheet memory rate, the yardstick of
every copy's bound; :func:`peak_flops` its datasheet dense bf16 rate, the
yardstick of MFU.
"""

from __future__ import annotations

import os

import torch

from oncilla_tpu_torch.core.errors import OcmDeviceError


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise OcmDeviceError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise OcmDeviceError(f"unsupported device {dev}")
    return dev


# Datasheet HBM rates (bytes/s), most specific name first.
_HBM_RATE = (
    ("H200", 4.8e12),
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
    ("H100", 3.35e12),  # H100 SXM5 80GB HBM3
)


def hbm_rate(name: str) -> float:
    """Datasheet memory rate (bytes/s) of the card ``name``
    (``torch.cuda.get_device_name``)."""
    for key, rate in _HBM_RATE:
        if key in name:
            return rate
    raise OcmDeviceError(f"no datasheet HBM rate for card {name!r}")


# Datasheet dense bf16 tensor-core rates (FLOP/s, without sparsity: the
# datasheets' 1979 TFLOP/s for the SXM part is with it), most specific name
# first.
_BF16_PEAK = (
    ("H200", 989e12),
    ("H100 NVL", 835e12),
    ("H100 PCIe", 756e12),
    ("H100", 989e12),  # H100 SXM5
)


def peak_flops(name: str) -> float:
    """Datasheet dense bf16 FLOP/s of the card ``name``; ``OCM_PEAK_TFLOPS``
    (TFLOP/s) overrides it, as in the JAX package."""
    override = os.environ.get("OCM_PEAK_TFLOPS")
    if override:
        return float(override) * 1e12
    for key, rate in _BF16_PEAK:
        if key in name:
            return rate
    raise OcmDeviceError(f"no datasheet bf16 rate for card {name!r}")
