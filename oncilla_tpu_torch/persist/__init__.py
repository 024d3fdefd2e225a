"""FROZEN tier — durable disk-backed extent store (ROADMAP item 5).

The fourth rung of the memory hierarchy, below COLD: under arena
pressure, eviction victims spill to disk (``tier_demote``) instead of
being destroyed, and a restarted daemon re-adopts its surviving extents
so the cluster boots warm. See ``docs/PERSIST.md`` for the tier state
machine, the on-disk format and the crash matrix.

Env knobs (all read through :class:`~oncilla_tpu_torch.utils.config.OcmConfig`):

- ``OCM_FROZEN_DIR``    — root directory for frozen extents (per-daemon
  subdirectory ``r<rank>``); unset = FROZEN tier off.
- ``OCM_FROZEN_MAX_BYTES`` — byte budget per store (0 = unbounded).
- ``OCM_FROZEN=0``      — hard off-switch: behavior (and wire) byte-
  identical to a build without this package.
"""

from oncilla_tpu_torch.persist.store import (  # noqa: F401
    FrozenStore,
    LostExtent,
    OcmFrozenCorrupt,
)
