"""Configuration: the subset of ``oncilla_tpu.utils.config.OcmConfig`` that
the single-node data plane reads, with the same env-var overrides.

The control-plane fields (``nodefile``, ``rank``) are kept so a caller who
sets them hears about it: this package has no daemon client yet, so
:func:`~oncilla_tpu_torch.core.context.ocm_init` raises ``OcmConnectError``
when either is set instead of silently running single-node.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


@dataclass
class OcmConfig:
    host_arena_bytes: int = field(
        default_factory=lambda: _env_int("OCM_HOST_ARENA_BYTES", 256 << 20)
    )
    device_arena_bytes: int = field(
        default_factory=lambda: _env_int("OCM_DEVICE_ARENA_BYTES", 128 << 20)
    )
    # 4096 = the copy kernels' block: extents aligned to it are eligible
    # for the hand-written DMA kernels (ops/dma.py).
    alignment: int = 4096
    nodefile: str | None = field(
        default_factory=lambda: os.environ.get("OCM_NODEFILE")
    )
    rank: int | None = None
