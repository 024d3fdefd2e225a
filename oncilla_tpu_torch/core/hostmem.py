"""Host-DRAM arena for the LOCAL_HOST arm: one CPU ``uint8`` tensor.

The reference mallocs the host arm (reference src/lib.c:222-233) and
registers the daemon's buffer with the NIC (alloc.c:171). On a GPU host the
registration analogue is page-locking: with ``pinned=True`` the arena is
pinned memory, so copies between it and the card run at the DMA engines'
rate without a bounce through pageable memory.
"""

from __future__ import annotations

import numpy as np
import torch

from oncilla_tpu_torch.core.arena import ArenaAllocator, Extent, check_bounds


def as_byte_tensor(data) -> torch.Tensor:
    """Any bytes-like, numpy array or tensor as a flat uint8 tensor (a view
    where possible, on the data's own device)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        if not arr.flags.writeable:
            arr = arr.copy()
        return torch.from_numpy(arr)
    if isinstance(data, torch.Tensor):
        return data.contiguous().reshape(-1).view(torch.uint8)
    return as_byte_tensor(np.asarray(data))


class HostArena:
    """A byte arena in host DRAM with offset-addressed read/write."""

    def __init__(self, capacity: int, alignment: int = 512,
                 pinned: bool = False):
        self.allocator = ArenaAllocator(capacity, alignment)
        self._buf = torch.zeros(capacity, dtype=torch.uint8, pin_memory=pinned)

    @property
    def capacity(self) -> int:
        return self.allocator.capacity

    @property
    def buffer(self) -> torch.Tensor:
        return self._buf

    def alloc(self, nbytes: int) -> Extent:
        return self.allocator.alloc(nbytes)

    def free(self, extent: Extent) -> None:
        # Scrub on free: the next tenant reads zeros (calloc parity,
        # reference src/alloc.c:171).
        self._buf[extent.offset: extent.offset + extent.nbytes] = 0
        self.allocator.free(extent)

    def write(self, extent: Extent, data, offset: int = 0) -> None:
        """One-sided put; ``data`` may lie on the card (copied down)."""
        raw = as_byte_tensor(data)
        check_bounds(extent, offset, raw.numel())
        start = extent.offset + offset
        self._buf[start: start + raw.numel()].copy_(raw)

    def read(self, extent: Extent, nbytes: int, offset: int = 0) -> torch.Tensor:
        """One-sided get; returns a copy of the bytes."""
        check_bounds(extent, offset, nbytes)
        start = extent.offset + offset
        return self._buf[start: start + nbytes].clone()

    def read_into(self, extent: Extent, out: torch.Tensor, offset: int = 0) -> None:
        """One-sided get into the caller's uint8 tensor (any device)."""
        n = out.numel()
        check_bounds(extent, offset, n)
        start = extent.offset + offset
        out.view(-1).copy_(self._buf[start: start + n])

    def view(self, extent: Extent) -> torch.Tensor:
        """Zero-copy window over the live extent (``ocm_localbuf``)."""
        return self._buf[extent.offset: extent.offset + extent.nbytes]
