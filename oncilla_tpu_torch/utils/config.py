"""Configuration: the subset of ``oncilla_tpu.utils.config.OcmConfig`` that
the port's data planes read, with the same env-var overrides.

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

    # Chunked chip-to-chip copies (``ops.ici.IciDataPlane.copy``): chunk
    # size, and how many staged chunks may exist at once (the reference's
    # 2-posted-commands limit, extoll.c:44-51). The JAX package's values.
    chunk_bytes: int = field(
        default_factory=lambda: _env_int("OCM_CHUNK_BYTES", 16 << 20)
    )
    inflight_ops: int = field(default_factory=lambda: _env_int("OCM_INFLIGHT", 2))

    def __post_init__(self) -> None:
        # A 0-byte chunk never advances a chunked copy, and a window of 0
        # never issues one.
        if self.chunk_bytes <= 0:
            raise ValueError(f"chunk_bytes must be > 0 (got {self.chunk_bytes})")
        if self.inflight_ops <= 0:
            raise ValueError(
                f"inflight_ops must be > 0 (got {self.inflight_ops})"
            )
