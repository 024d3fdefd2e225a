"""The daemon's host-DRAM arena: the JAX package's numpy ``HostArena``
(``oncilla_tpu/core/hostmem.py``) line for line, the storage a daemon
serves REMOTE_HOST from. A daemon holds no tensor: its bytes are numpy, and
its extents go to sockets and to the shared-memory fabric as memoryviews.
The apps' LOCAL_HOST arena is :class:`..core.hostmem.HostArena`, a tensor.

Host-DRAM arena: numpy-backed storage for the LOCAL_HOST / REMOTE_HOST arms.

Analogue of the reference's host arm, where the app-owned buffer comes from
``malloc`` (reference src/lib.c:222-233) and the daemon-side remote
buffer from ``calloc`` + NIC registration (reference src/alloc.c:171).
Here one pre-allocated byte buffer per host plays the role of the registered
region; suballocations are zero-copy memoryview slices of it.
"""

from __future__ import annotations

import numpy as np

from oncilla_tpu_torch.core.arena import ArenaAllocator, Extent, check_bounds


class HostArena:
    """A byte arena in host DRAM with offset-addressed read/write.

    ``backing`` lets a fabric provide the storage itself — the
    registered-region idiom (fabric/shm.py backs the arena with a named
    shared-memory segment so same-host peers put/get by memcpy; the
    reference registers the server buffer with the NIC the same way,
    alloc.c:171-176). It must be a writable C-contiguous uint8 array of
    at least ``capacity`` bytes, already zero-filled (the scrub-on-free
    contract assumes bytes start clean)."""

    def __init__(self, capacity: int, alignment: int = 512,
                 backing: np.ndarray | None = None):
        self.allocator = ArenaAllocator(capacity, alignment)
        if backing is not None:
            if backing.dtype != np.uint8 or backing.nbytes < capacity:
                raise ValueError(
                    "backing must be a uint8 array of >= capacity bytes "
                    f"(got {backing.dtype}, {backing.nbytes} B)"
                )
            self._buf = backing[:capacity]
        else:
            self._buf = np.zeros(capacity, dtype=np.uint8)

    @property
    def capacity(self) -> int:
        return self.allocator.capacity

    @property
    def buffer(self) -> np.ndarray:
        """The registerable backing buffer — what a fabric advertises
        (and what :meth:`view` windows into)."""
        return self._buf

    def alloc(self, nbytes: int) -> Extent:
        return self.allocator.alloc(nbytes)

    def free(self, extent: Extent) -> None:
        # Scrub on free: the next tenant of these bytes must read zeros,
        # as the reference's calloc'd server buffers guarantee
        # (reference src/alloc.c:171) — freed data never leaks
        # across allocations.
        self._buf[extent.offset: extent.offset + extent.nbytes] = 0
        self.allocator.free(extent)

    def write(self, extent: Extent, data: np.ndarray, offset: int = 0) -> None:
        """One-sided put into the arena (bounds-checked like post_send,
        reference src/rdma.c:55-59)."""
        raw = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        check_bounds(extent, offset, raw.nbytes)
        start = extent.offset + offset
        self._buf[start : start + raw.nbytes] = raw

    def read(self, extent: Extent, nbytes: int, offset: int = 0) -> np.ndarray:
        """One-sided get; returns a copy of the bytes."""
        check_bounds(extent, offset, nbytes)
        start = extent.offset + offset
        return self._buf[start : start + nbytes].copy()

    def view(self, extent: Extent) -> np.ndarray:
        """Zero-copy window over the live extent (``ocm_localbuf`` analogue,
        reference src/lib.c:425)."""
        return self._buf[extent.offset : extent.offset + extent.nbytes]
