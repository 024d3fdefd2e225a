"""Offset-based arena suballocator: pure bookkeeping, no backing storage.

A first-fit free-list with coalescing over one fixed byte range, the same
algorithm as ``oncilla_tpu.core.arena`` line for line, so both packages hand
out identical offsets for the same sequence of requests (the parity tests
hold them to it). Backing storage lives in :mod:`.hbm` (device) and
:mod:`.hostmem` (host).
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass

from oncilla_tpu_torch.core.errors import (
    OcmBoundsError,
    OcmInvalidHandle,
    OcmOutOfMemory,
)


def _align_up(x: int, a: int) -> int:
    return (x + a - 1) // a * a


def check_bounds(extent: "Extent", offset: int, nbytes: int) -> None:
    """Shared bounds check for every arena arm, analogue of the checks in
    post_send (reference src/rdma.c:55-59)."""
    if offset < 0 or nbytes < 0 or offset + nbytes > extent.nbytes:
        raise OcmBoundsError(
            f"access [{offset}, {offset + nbytes}) outside extent of "
            f"{extent.nbytes} B"
        )


@dataclass(frozen=True)
class Extent:
    """A suballocated [offset, offset+nbytes) range inside an arena."""

    offset: int
    nbytes: int


class ArenaAllocator:
    """Thread-safe first-fit free-list allocator over a fixed byte range."""

    def __init__(self, capacity: int, alignment: int = 512):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        if alignment <= 0 or (alignment & (alignment - 1)):
            raise ValueError("alignment must be a positive power of two")
        self.capacity = capacity
        self.alignment = alignment
        self._lock = threading.Lock()
        # Sorted list of free (offset, nbytes) spans, coalesced.
        self._free: list[tuple[int, int]] = [(0, capacity)]
        # offset -> nbytes for live extents (for validation on free).
        self._live: dict[int, int] = {}

    @property
    def bytes_free(self) -> int:
        with self._lock:
            return sum(n for _, n in self._free)

    @property
    def bytes_live(self) -> int:
        with self._lock:
            return sum(self._live.values())

    @property
    def num_live(self) -> int:
        with self._lock:
            return len(self._live)

    def alloc(self, nbytes: int) -> Extent:
        if nbytes <= 0:
            raise ValueError("nbytes must be positive")
        need = _align_up(nbytes, self.alignment)
        with self._lock:
            for i, (off, span) in enumerate(self._free):
                if span >= need:
                    if span == need:
                        self._free.pop(i)
                    else:
                        self._free[i] = (off + need, span - need)
                    self._live[off] = need
                    return Extent(offset=off, nbytes=nbytes)
        raise OcmOutOfMemory(
            f"arena of {self.capacity} B cannot fit {nbytes} B "
            f"({self.bytes_free} B free, fragmented into {len(self._free)} spans)"
        )

    def free(self, extent: Extent) -> None:
        with self._lock:
            need = self._live.pop(extent.offset, None)
            if need is None:
                raise OcmInvalidHandle(
                    f"free of unknown or already-freed extent at offset {extent.offset}"
                )
            self._insert_free(extent.offset, need)

    def _insert_free(self, off: int, span: int) -> None:
        # Insert keeping sorted order, then coalesce with neighbors.
        i = bisect.bisect_left(self._free, (off, 0))
        self._free.insert(i, (off, span))
        if i + 1 < len(self._free):
            noff, nspan = self._free[i + 1]
            if off + span == noff:
                self._free[i] = (off, span + nspan)
                self._free.pop(i + 1)
                span += nspan
        if i > 0:
            poff, pspan = self._free[i - 1]
            if poff + pspan == off:
                self._free[i - 1] = (poff, pspan + span)
                self._free.pop(i)

    def reset(self) -> None:
        """Drop all live extents."""
        with self._lock:
            self._free = [(0, self.capacity)]
            self._live.clear()
