"""Configuration: the subset of ``oncilla_tpu.utils.config.OcmConfig`` that
the port's data planes and its daemon client read, with the same names,
defaults and env-var overrides.

``nodefile`` (or ``OCM_NODEFILE``) makes
:func:`~oncilla_tpu_torch.core.context.ocm_init` attach to the cluster it
names; ``rank`` picks the app's daemon (None: detected from the nodefile).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


# The wire's frame cap (protocol.MAX_PAYLOAD) less slack for a frame's
# fixed fields: a DATA_PUT chunk is fields + payload in one frame, so a
# larger chunk_bytes would encode to a frame the peer rejects mid-transfer.
MAX_CHUNK_BYTES = (64 << 20) - 4096


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

    # Striping of large wire transfers: up to ``dcn_stripes`` contiguous
    # byte ranges, each pipelined over its own pooled connection, and
    # never a stripe below ``dcn_stripe_min_bytes``.
    dcn_stripes: int = field(
        default_factory=lambda: _env_int("OCM_DCN_STRIPES", 4)
    )
    dcn_stripe_min_bytes: int = field(
        default_factory=lambda: _env_int("OCM_DCN_STRIPE_MIN_BYTES", 8 << 20)
    )

    # Liveness: the daemon reaps an app's allocations after ``lease_s``
    # without a heartbeat; the client beats every ``heartbeat_s``.
    lease_s: float = 30.0
    heartbeat_s: float = 5.0

    # QoS profile the client declares at CONNECT when it is not the
    # default (priority 1, no quotas): 0 low, 1 normal, 2 high.
    quota_bytes: int = field(
        default_factory=lambda: _env_int("OCM_QUOTA_BYTES", 0)
    )
    quota_handles: int = field(
        default_factory=lambda: _env_int("OCM_QUOTA_HANDLES", 0)
    )
    priority: int = field(default_factory=lambda: _env_int("OCM_PRIORITY", 1))
    # BUSY back-off: capped exponential with jitter, seeded by the
    # daemon's suggested delay.
    busy_retries: int = field(
        default_factory=lambda: _env_int("OCM_BUSY_RETRIES", 4)
    )
    busy_backoff_ms: int = field(
        default_factory=lambda: _env_int("OCM_BUSY_BACKOFF_MS", 50)
    )
    # CONNECT retry ladder: a restarting daemon refuses connections for a
    # beat; the client retries with capped exponential back-off + jitter.
    connect_retries: int = field(
        default_factory=lambda: _env_int("OCM_CONNECT_RETRIES", 4)
    )
    connect_backoff_s: float = field(
        default_factory=lambda: _env_int("OCM_CONNECT_BACKOFF_MS", 50) / 1e3
    )
    connect_backoff_cap_s: float = 2.0

    def __post_init__(self) -> None:
        # A 0-byte chunk never advances a chunked transfer, one above the
        # frame cap encodes to a frame the peer rejects, and a window of 0
        # never issues a request.
        if not 0 < self.chunk_bytes <= MAX_CHUNK_BYTES:
            raise ValueError(
                f"chunk_bytes must be in (0, {MAX_CHUNK_BYTES}] "
                f"(got {self.chunk_bytes})")
        if self.inflight_ops <= 0:
            raise ValueError(
                f"inflight_ops must be > 0 (got {self.inflight_ops})"
            )
        if self.dcn_stripes <= 0:
            raise ValueError(f"dcn_stripes must be >= 1 (got {self.dcn_stripes})")
        if self.dcn_stripe_min_bytes <= 0:
            raise ValueError("dcn_stripe_min_bytes must be > 0 "
                             f"(got {self.dcn_stripe_min_bytes})")
        if self.connect_retries < 0 or self.connect_backoff_s < 0:
            raise ValueError("connect_retries/connect_backoff_s must be >= 0")
        if not 0 <= self.priority <= 2:
            raise ValueError("priority must be 0 (low), 1 (normal) or 2 "
                             f"(high) (got {self.priority})")
        if self.quota_bytes < 0 or self.quota_handles < 0:
            raise ValueError("quota_bytes/quota_handles must be >= 0 "
                             "(0 = unlimited)")
        if self.busy_retries < 0 or self.busy_backoff_ms < 0:
            raise ValueError("busy_retries/busy_backoff_ms must be >= 0")

    @property
    def qos_offer(self) -> bool:
        """Whether the client has a non-default QoS profile to declare at
        CONNECT; all-default keeps the CONNECT frame the plain one."""
        return (self.priority != 1 or self.quota_bytes > 0
                or self.quota_handles > 0)
