"""Allocation-kind taxonomy (``enum ocm_kind``,
reference inc/oncillamem.h:26-35), on a GPU host:

- ``LOCAL_HOST``    — host DRAM of this process (a pinned arena when the
  context's device is CUDA).
- ``LOCAL_DEVICE``  — HBM of a GPU attached to this host (reference
  ``OCM_LOCAL_GPU``).
- ``REMOTE_DEVICE`` — HBM of another GPU (an NVLink peer, or another row of
  the device fabric), served through a ``RemoteBackend`` and its
  ``ici_plane`` (``ops/ici.py``).
- ``REMOTE_HOST``   — DRAM of another host; needs the daemon's wire client,
  which the port does not have yet.
"""

from __future__ import annotations

import enum


class OcmKind(enum.Enum):
    LOCAL_HOST = "local_host"
    LOCAL_DEVICE = "local_device"
    REMOTE_DEVICE = "remote_device"
    REMOTE_HOST = "remote_host"

    @property
    def is_remote(self) -> bool:
        """True for remote arms (the reference's ``ocm_is_remote``,
        lib.c:461, without its operator-precedence bug)."""
        return self in (OcmKind.REMOTE_DEVICE, OcmKind.REMOTE_HOST)

    @property
    def is_device(self) -> bool:
        return self in (OcmKind.LOCAL_DEVICE, OcmKind.REMOTE_DEVICE)


class Fabric(enum.Enum):
    """Data-plane selector (``enum alloc_ation_type``,
    reference inc/alloc.h:32-42)."""

    LOCAL = "local"  # no fabric: same-process memory
    ICI = "ici"      # chip-to-chip interconnect (NVLink on a GPU host)
    DCN = "dcn"      # network between hosts (daemon TCP)
