"""The port's copy of ``oncilla_tpu/core/arena.py``, line for line, so both
packages hand out identical offsets for the same sequence of requests.

Offset-based arena suballocator.

The reference "registers" one fixed buffer per allocation with the NIC
(ibv_reg_mr, reference src/rdma_server.c:109-118; rma2_register,
reference src/extoll_server.c:83) and addresses it with (va, rkey) or
(node, vpid, NLA). On TPU the analogue of registration is a single
pre-allocated **arena** per memory space (one jax.Array per chip's HBM, one
pinned host buffer per TPU-VM host) that peers may address by
``(node, device, offset, nbytes)``. This module is the pure bookkeeping:
a first-fit free-list suballocator with coalescing, no backing storage.

Backing storage lives in :mod:`oncilla_tpu_torch.core.hbm` (device) and
:mod:`oncilla_tpu_torch.core.hostmem` (host).
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass

from oncilla_tpu_torch.analysis import alloctrace
from oncilla_tpu_torch.core.errors import OcmBoundsError, OcmInvalidHandle, OcmOutOfMemory


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
    """First-fit free-list allocator over a fixed-size byte range.

    Thread-safe: the daemon serves concurrent allocation requests the way the
    reference served one thread per request (reference src/mem.c:437).
    """

    def __init__(self, capacity: int, alignment: int = 512):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        if alignment <= 0 or (alignment & (alignment - 1)):
            raise ValueError("alignment must be a positive power of two")
        self.capacity = capacity
        self.alignment = alignment
        # OCM_ALLOCTRACE ledger scope; extents are keyed by offset (unique
        # while live, exactly like the free-list's own bookkeeping).
        self._trace_scope = f"arena:{id(self):#x}"
        self._lock = threading.Lock()
        # Sorted list of free (offset, nbytes) spans, coalesced.
        self._free: list[tuple[int, int]] = [(0, capacity)]
        # offset -> nbytes for live extents (for validation on free).
        self._live: dict[int, int] = {}

    # -- queries ---------------------------------------------------------

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

    # -- alloc / free ----------------------------------------------------

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
                    alloctrace.note_alloc(self._trace_scope, off, nbytes)
                    return Extent(offset=off, nbytes=nbytes)
        raise OcmOutOfMemory(
            f"arena of {self.capacity} B cannot fit {nbytes} B "
            f"({self.bytes_free} B free, fragmented into {len(self._free)} spans)"
        )

    def reserve(self, offset: int, nbytes: int) -> Extent:
        """Claim a specific extent (snapshot restore): carve
        [offset, offset+aligned) out of the free list."""
        if nbytes <= 0:
            raise ValueError("nbytes must be positive")
        if offset % self.alignment:
            raise OcmInvalidHandle(f"offset {offset} not aligned")
        need = _align_up(nbytes, self.alignment)
        with self._lock:
            for i, (off, span) in enumerate(self._free):
                if off <= offset and offset + need <= off + span:
                    self._free.pop(i)
                    if off < offset:
                        self._free.insert(i, (off, offset - off))
                        i += 1
                    tail = (off + span) - (offset + need)
                    if tail:
                        self._free.insert(i, (offset + need, tail))
                    self._live[offset] = need
                    alloctrace.note_alloc(self._trace_scope, offset, nbytes)
                    return Extent(offset=offset, nbytes=nbytes)
        raise OcmInvalidHandle(
            f"cannot reserve [{offset}, {offset + need}): overlaps live extent"
        )

    def free(self, extent: Extent) -> None:
        with self._lock:
            need = self._live.pop(extent.offset, None)
            if need is None:
                raise OcmInvalidHandle(
                    f"free of unknown or already-freed extent at offset {extent.offset}"
                )
            self._insert_free(extent.offset, need)
        alloctrace.note_free(self._trace_scope, extent.offset)

    def _insert_free(self, off: int, span: int) -> None:
        # Insert keeping sorted order, then coalesce with neighbors.
        i = bisect.bisect_left(self._free, (off, 0))
        self._free.insert(i, (off, span))
        # Coalesce with next.
        if i + 1 < len(self._free):
            noff, nspan = self._free[i + 1]
            if off + span == noff:
                self._free[i] = (off, span + nspan)
                self._free.pop(i + 1)
                span += nspan
        # Coalesce with previous.
        if i > 0:
            poff, pspan = self._free[i - 1]
            if poff + pspan == off:
                self._free[i - 1] = (poff, pspan + span)
                self._free.pop(i)

    def reset(self) -> None:
        """Drop all live extents (daemon teardown path, analogue of
        dealloc-all at SIGINT, reference src/main.c:170-184)."""
        with self._lock:
            self._free = [(0, self.capacity)]
            self._live.clear()
        alloctrace.drop_scope(self._trace_scope)
