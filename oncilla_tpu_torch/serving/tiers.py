"""Tiered KV page store: device HBM -> host DRAM -> the cold tier, the
port's copy of ``oncilla_tpu/serving/tiers.py``.

Fixed-size KV pages live in exactly one tier:

- ``HOT``  — an extent of the context's device arena (a LOCAL_DEVICE
  handle). On a CUDA context a page put is the ``write_rows`` kernel (K1)
  and a page get the ``read_rows`` kernel (K2) once the page is at least
  the 1 MiB kernel threshold. When the device arena cannot take a page the
  allocation degrades to WARM: that is the reference's *capacity* policy
  (``OcmOutOfMemory`` and the other ``OcmError`` s of an arena), never a
  catch of a CUDA or kernel error, which propagates.
- ``WARM`` — the context's host arena (LOCAL_HOST, pinned on CUDA).
- ``COLD`` — a ``cold_backend``: a daemon client
  (:class:`~oncilla_tpu_torch.runtime.client.ControlPlaneClient`) whose
  REMOTE_HOST pages live in another host's arena. A page leaves the card
  by a ``put`` of the device tensor and comes back into a pinned host
  buffer (the client's ``get_into``, the wire's stripes landing in it)
  before it is uploaded. Without a backend, COLD is a LOCAL_HOST stand-in
  flagged ``cold_sim`` so a measurement can never mistake it for a remote
  tier.
- ``FROZEN`` — disk, through an attached :class:`~oncilla_tpu_torch.
  persist.FrozenStore` (``frozen_backend``): watermark demotion spills COLD
  victims to CRC-trailed extent files instead of destroying them, and a
  persisted prefix cache restores from the same store on warm boot. A page
  reaches the disk from host memory (a HOT page comes down through K2
  first) and comes back as host bytes, which a promotion to HOT uploads
  through K1. No backend attached (the default) = the tier has zero
  capacity and the store is the three-tier one.

Page bytes are ``uint8`` tensors and stay where their tier is: a HOT page
read lands on the card (``get(out=)`` into a device tensor, K2), a WARM or
COLD read in a pinned host buffer; only a move between tiers crosses the
bus. Movement is watermark-driven (high/low per bounded tier, LRU victims,
never a pinned page nor a referenced shared one) and the tiers map onto
the QoS priority classes (``TIER_PRIORITY``), as in the JAX package.
"""

from __future__ import annotations

import enum
import itertools
import threading
from dataclasses import dataclass, field

import torch

from oncilla_tpu_torch.core.errors import (
    OcmError,
    OcmInvalidHandle,
    OcmOutOfMemory,
)
from oncilla_tpu_torch.core.handle import OcmAlloc
from oncilla_tpu_torch.core.hostmem import as_byte_tensor
from oncilla_tpu_torch.core.kinds import OcmKind
from oncilla_tpu_torch.obs import journal as obs_journal
from oncilla_tpu_torch.qos.policy import PRIO_HIGH, PRIO_LOW, PRIO_NORMAL
from oncilla_tpu_torch.serving.metrics import ServingStats
from oncilla_tpu_torch.utils.debug import printd


class Tier(enum.Enum):
    HOT = "hbm"
    WARM = "host"
    COLD = "remote"
    FROZEN = "frozen"


#: What priority class each tier's allocations declare: COLD and FROZEN
#: pages are the preferred victims everywhere.
TIER_PRIORITY = {
    Tier.HOT: PRIO_HIGH,
    Tier.WARM: PRIO_NORMAL,
    Tier.COLD: PRIO_LOW,
    Tier.FROZEN: PRIO_LOW,
}

_ORDER = (Tier.HOT, Tier.WARM, Tier.COLD, Tier.FROZEN)
_DOWN = {Tier.HOT: Tier.WARM, Tier.WARM: Tier.COLD}  # demotion targets


@dataclass(frozen=True)
class FrozenPageHandle:
    """Handle for a FROZEN-resident page: the store key of its extent
    file (no arena offset exists — disk is addressed by name)."""

    key: str


@dataclass
class Page:
    """One KV page: fixed-size bytes living in exactly one tier."""

    page_id: int
    nbytes: int
    tier: Tier
    handle: OcmAlloc
    last_use: int = 0
    pins: int = 0
    #: Prefix-cache references. A page with ``shared`` set and
    #: ``refs > 0`` is immutable and unevictable.
    shared: bool = False
    refs: int = 0
    #: Bumped on every rewrite or move: stale prefetched bytes are
    #: discarded on a version mismatch.
    version: int = 0
    freed: bool = field(default=False, compare=False)


class TieredPageStore:
    """Fixed-page-size store over the tiers with watermark demotion.

    Single-writer discipline: every tier *mutation* (alloc, promote,
    demote, free) happens on the engine thread; prefetch workers only read
    bytes of pages off the card (:meth:`fetch_bytes`), and the engine
    installs them. ``stats`` mutation is internally locked.

    ``io`` counts page puts and gets per tier (``io["hbm"]["put"]``, ...):
    on a CUDA context every HOT put is one launch of K1 and every HOT get
    one of K2, which is how a run shows that its pages went through the
    kernels.
    """

    def __init__(
        self,
        ctx,
        page_bytes: int,
        hot_capacity: int = 8,
        warm_capacity: int = 16,
        cold_backend=None,
        high_pct: int = 90,
        low_pct: int = 70,
        stats: ServingStats | None = None,
        frozen_backend=None,
        cold_capacity: int | None = None,
    ):
        self.ctx = ctx
        self.page_bytes = int(page_bytes)
        # COLD is unbounded in the three-tier store (it is the floor);
        # with a frozen backend attached it must be finite or nothing
        # would ever spill to disk. FROZEN with no backend has zero
        # capacity.
        if cold_capacity is None:
            cold_capacity = (
                (1 << 30) if frozen_backend is None
                else max(2 * int(warm_capacity), 1)
            )
        self.capacity = {Tier.HOT: int(hot_capacity),
                         Tier.WARM: int(warm_capacity),
                         Tier.COLD: int(cold_capacity),
                         Tier.FROZEN: (1 << 30) if frozen_backend is not None
                         else 0}
        self.high_pct = high_pct
        self.low_pct = low_pct
        self.cold_backend = cold_backend
        self.frozen_backend = frozen_backend
        #: True when COLD is simulated in the local host arena.
        self.cold_sim = cold_backend is None
        # Ephemeral frozen page keys continue past any leftover
        # ``page-N`` files from a prior run so a stale extent is never
        # silently overwritten by an unrelated page.
        frz_start = 0
        if frozen_backend is not None:
            for k in frozen_backend.keys():
                if k.startswith("page-"):
                    try:
                        frz_start = max(frz_start, int(k[5:]))
                    except ValueError:
                        pass
        self._frz_ids = itertools.count(frz_start + 1)
        self.stats = stats or ServingStats()
        self.pages: dict[int, Page] = {}
        self._ids = itertools.count(1)
        self._clock = itertools.count(1)
        self.device = ctx.device
        # The registered receive buffer for engine-thread reads off the
        # card: one page, pinned on CUDA, reused by every such read.
        self._recvbuf = torch.empty(self.page_bytes, dtype=torch.uint8,
                                    pin_memory=self.device.type == "cuda")
        self.io = {t.value: {"put": 0, "get": 0} for t in _ORDER}
        self._mu = threading.Lock()
        self._io_mu = threading.Lock()  # workers count their reads too

    # -- tier backends ----------------------------------------------------

    def _alloc_in(self, tier: Tier) -> OcmAlloc:
        if tier == Tier.HOT:
            return self.ctx.alloc(self.page_bytes, OcmKind.LOCAL_DEVICE)
        if tier == Tier.WARM:
            return self.ctx.alloc(self.page_bytes, OcmKind.LOCAL_HOST)
        if tier == Tier.FROZEN:
            if self.frozen_backend is None:
                raise OcmError("no frozen backend attached")
            if not self.frozen_backend.has_room(self.page_bytes):
                raise OcmOutOfMemory("frozen store budget exhausted")
            return FrozenPageHandle(f"page-{next(self._frz_ids)}")
        if self.cold_backend is not None:
            return self.cold_backend.alloc(self.page_bytes,
                                           OcmKind.REMOTE_HOST)
        return self.ctx.alloc(self.page_bytes, OcmKind.LOCAL_HOST)

    def _free_handle(self, tier: Tier, handle) -> None:
        if tier == Tier.FROZEN:
            self.frozen_backend.delete(handle.key)
        elif tier == Tier.COLD and self.cold_backend is not None:
            self.cold_backend.free(handle)
        else:
            self.ctx.free(handle)

    def _count(self, tier: Tier, op: str) -> None:
        with self._io_mu:
            self.io[tier.value][op] += 1

    def _put(self, tier: Tier, handle, data: torch.Tensor) -> None:
        self._count(tier, "put")
        if tier == Tier.FROZEN:
            # The disk takes host bytes: a page on the card comes down
            # first (a HOT page's bytes reach here through K2).
            self.frozen_backend.write(
                handle.key, data.cpu().numpy().tobytes(),
                meta={"kind": "page"})
        elif tier == Tier.COLD and self.cold_backend is not None:
            self.cold_backend.put(handle, data, 0)
            self.stats.note_remote(data.numel(), inbound=False)
        else:
            self.ctx.put(handle, data, 0)

    def _get(self, tier: Tier, handle, nbytes: int,
             out: torch.Tensor | None) -> torch.Tensor:
        """A page's bytes, landing in ``out`` when given (the registered
        receive path), else in a fresh tensor on the tier's side."""
        self._count(tier, "get")
        if tier == Tier.FROZEN:
            # A slow CRC-verified read; OcmFrozenCorrupt propagates
            # typed — a corrupt extent is refused, never served.
            raw = torch.frombuffer(
                bytearray(self.frozen_backend.read_bytes(handle.key)),
                dtype=torch.uint8)
            if out is not None:
                out[:nbytes].copy_(raw[:nbytes])
                return out[:nbytes]
            return raw[:nbytes]
        if tier == Tier.COLD and self.cold_backend is not None:
            if out is not None:
                # The registered receive path: the page lands in ``out``.
                got = self.cold_backend.get_into(handle, out[:nbytes], 0)
            else:
                got = as_byte_tensor(self.cold_backend.get(handle, nbytes, 0))
            self.stats.note_remote(nbytes, inbound=True)
            return got
        if out is not None:
            return self.ctx.get(handle, out=out[:nbytes])
        return self.ctx.get(handle, nbytes, 0)

    # -- occupancy --------------------------------------------------------

    def _live(self, tier: Tier) -> list[Page]:
        return [p for p in self.pages.values() if p.tier == tier]

    def occupancy(self) -> dict:
        out = {}
        for t in _ORDER:
            live = self._live(t)
            out[t.value] = {"pages": len(live),
                            "bytes": sum(p.nbytes for p in live)}
        return out

    def _sync_stats(self) -> None:
        occ = self.occupancy()
        self.stats.set_occupancy(
            {k: v["pages"] for k, v in occ.items()},
            {k: v["bytes"] for k, v in occ.items()},
        )

    # -- page lifecycle ---------------------------------------------------

    def touch(self, page: Page) -> None:
        page.last_use = next(self._clock)

    def _check_live(self, page: Page) -> None:
        if page.freed or page.page_id not in self.pages:
            raise OcmInvalidHandle(f"use of freed page {page.page_id}")

    def alloc_page(self, data, shared: bool = False,
                   prefer: Tier = Tier.HOT) -> Page:
        """Store one page of bytes (a tensor on any device, or an array),
        preferring ``prefer`` and degrading down-tier when the preferred
        arena is full, then enforce watermarks."""
        raw = as_byte_tensor(data)
        if raw.numel() != self.page_bytes:
            raise ValueError(
                f"page is {raw.numel()} B, store built for {self.page_bytes}")
        last_err: Exception | None = None
        for tier in _ORDER[_ORDER.index(prefer):]:
            # LRU residents demote to make room; if nothing is demotable
            # (all pinned or referenced-shared) the newcomer degrades.
            self._make_room(tier)
            if len(self._live(tier)) >= self.capacity[tier]:
                continue
            try:
                handle = self._alloc_in(tier)
            except OcmError as e:  # arena full: degrade a tier
                last_err = e
                printd("serving: %s tier alloc degraded: %s", tier.value, e)
                continue
            self._put(tier, handle, raw)
            page = Page(next(self._ids), self.page_bytes, tier, handle,
                        shared=shared)
            self.touch(page)
            self.pages[page.page_id] = page
            self.enforce_watermarks()
            self._sync_stats()
            return page
        raise OcmError(f"no tier can take a page (last error: {last_err})")

    def read_page(self, page: Page, out: torch.Tensor | None = None
                  ) -> torch.Tensor:
        """The page's bytes: into ``out`` when given; else a HOT page into a
        fresh tensor on the card, any other into the store's staging buffer
        (valid until the store's next such read)."""
        self._check_live(page)
        self.touch(page)
        if out is None and page.tier != Tier.HOT:
            out = self._recvbuf
        return self._get(page.tier, page.handle, page.nbytes, out)

    def read_host(self, page: Page) -> torch.Tensor:
        """The page's bytes in the store's pinned staging buffer (valid
        until the store's next such read): a HOT page comes down through
        K2. What the disk is written from."""
        return self.read_page(page, out=self._recvbuf)

    def write_page(self, page: Page, data) -> None:
        """Rewrite a page in place. Refused on a referenced shared page:
        that is what :meth:`cow` is for."""
        self._check_live(page)
        if page.shared and page.refs > 0:
            raise OcmInvalidHandle(
                f"write to shared page {page.page_id} with {page.refs} "
                "live reference(s); copy-on-write first")
        raw = as_byte_tensor(data)
        if raw.numel() != page.nbytes:
            raise ValueError(f"page write of {raw.numel()} B into "
                             f"{page.nbytes} B page")
        self._put(page.tier, page.handle, raw)
        page.version += 1
        self.touch(page)

    def cow(self, page: Page) -> Page:
        """Copy-on-write: a private copy of a (typically shared) page,
        placed by the normal tier policy; the original is untouched."""
        self._check_live(page)
        data = self.read_page(page)
        clone = self.alloc_page(data, shared=False)
        self.stats.note_cow()
        obs_journal.record("page_cow", src=page.page_id,
                           dst=clone.page_id, nbytes=page.nbytes)
        return clone

    def free_page(self, page: Page) -> None:
        if page.freed:
            return
        if page.shared and page.refs > 0:
            raise OcmInvalidHandle(
                f"free of shared page {page.page_id} with {page.refs} "
                "live reference(s)")
        del self.pages[page.page_id]
        page.freed = True
        self._free_handle(page.tier, page.handle)
        self._sync_stats()

    def close(self) -> None:
        """Free every live page (shared ones included: teardown)."""
        for page in list(self.pages.values()):
            page.refs = 0
            self.free_page(page)

    # -- movement ---------------------------------------------------------

    def _move(self, page: Page, to: Tier,
              data: torch.Tensor | None = None) -> None:
        """Relocate a page's bytes between tiers. ``data`` short-cuts the
        read when the caller already holds the current version."""
        if page.tier == to:
            return
        if data is None:
            data = (self.read_host(page) if to == Tier.FROZEN
                    else self.read_page(page))
        try:
            new_handle = self._alloc_in(to)
        except OcmError as e:
            # A full target arena cancels the move, never the page.
            printd("serving: move of page %d to %s declined: %s",
                   page.page_id, to.value, e)
            return
        self._put(to, new_handle, data)
        with self._mu:
            old_tier, old_handle = page.tier, page.handle
            page.tier, page.handle = to, new_handle
            # A worker mid-read of the old extent must fail its version
            # check at install time.
            page.version += 1
        self._free_handle(old_tier, old_handle)
        promote = _ORDER.index(to) < _ORDER.index(old_tier)
        self.stats.note_move(promote)
        obs_journal.record(
            "page_promote" if promote else "page_demote",
            page_id=page.page_id, src=old_tier.value, dst=to.value,
            nbytes=page.nbytes, shared=page.shared, refs=page.refs,
        )
        self._sync_stats()

    def promote(self, page: Page, to: Tier = Tier.HOT,
                data: torch.Tensor | None = None,
                version: int | None = None) -> None:
        """Move a page up-tier (the page-fault / prefetch-install path).
        ``data``+``version`` come from a prefetch; a version mismatch
        discards the stale bytes and re-reads."""
        self.promote_many([(page, data, version)], to)

    def promote_many(self, items, to: Tier = Tier.HOT) -> None:
        """Promote ``(page, data, version)`` items one at a time (single
        writer), with ONE watermark sweep at the end."""
        moved = False
        for page, data, version in items:
            self._check_live(page)
            if version is not None and version != page.version:
                data = None
            if _ORDER.index(to) >= _ORDER.index(page.tier):
                continue
            # Room first, so the promotion cannot bounce off a full tier.
            self._make_room(to)
            self._move(page, to, data=data)
            self.touch(page)
            moved = True
        if moved:
            self.enforce_watermarks()

    def demote(self, page: Page, to: Tier) -> None:
        self._check_live(page)
        if _ORDER.index(to) <= _ORDER.index(page.tier):
            return
        self._move(page, to)

    def pin(self, page: Page) -> None:
        page.pins += 1

    def unpin(self, page: Page) -> None:
        page.pins = max(0, page.pins - 1)

    # -- watermark eviction ----------------------------------------------

    def _victims(self, tier: Tier) -> list[Page]:
        """Demotion candidates, LRU first: never a pinned page, never a
        referenced shared extent."""
        return sorted(
            (p for p in self._live(tier)
             if p.pins == 0 and not (p.shared and p.refs > 0)),
            key=lambda p: p.last_use,
        )

    def _below(self, tier: Tier) -> Tier | None:
        """Where ``tier``'s victims demote to: COLD spills to disk only
        with a frozen backend attached (else it is the unbounded floor)."""
        if tier == Tier.COLD and self.frozen_backend is not None:
            return Tier.FROZEN
        return _DOWN.get(tier)

    def _make_room(self, tier: Tier) -> None:
        """Demote until ``tier`` has a free slot."""
        nxt = self._below(tier)
        if nxt is None:
            return
        while len(self._live(tier)) >= self.capacity[tier]:
            victims = self._victims(tier)
            if not victims:
                return  # everything pinned/referenced: overshoot allowed
            self._make_room(nxt)
            self._move(victims[0], nxt)

    def enforce_watermarks(self) -> None:
        """Past a bounded tier's high watermark, demote LRU victims down
        to its low watermark. With a frozen backend attached, COLD is
        bounded too and spills to disk."""
        for tier in (Tier.HOT, Tier.WARM, Tier.COLD):
            nxt = self._below(tier)
            if nxt is None:
                continue
            cap = self.capacity[tier]
            # Floor at one page: a tiny tier never reads "demote all".
            high = max(cap * self.high_pct // 100, 1)
            low = max(cap * self.low_pct // 100, 1)
            if len(self._live(tier)) <= high:
                continue
            for victim in self._victims(tier):
                if len(self._live(tier)) <= low:
                    break
                self._move(victim, nxt)

    # -- prefetch support -------------------------------------------------

    def fetch_bytes(self, page: Page, out: torch.Tensor) -> tuple[int, bool]:
        """Thread-safe read of an off-card page's bytes into the caller's
        host buffer (prefetch workers): returns (version, ok). A page on
        the card is not read (ok False): the engine reads it on its own
        thread and stream, so no kernel is launched from a worker."""
        with self._mu:
            if page.freed or page.tier == Tier.HOT:
                return (page.version, False)
            tier, handle, version = page.tier, page.handle, page.version
        try:
            self._get(tier, handle, page.nbytes, out)
        except OcmError:
            return (version, False)
        return (version, True)
