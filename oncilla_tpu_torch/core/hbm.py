"""Device-HBM arena: one pre-allocated flat ``uint8`` tensor per GPU.

The reference ``cudaMalloc``s device buffers (reference src/lib.c:240)
and registers host buffers with the NIC; here each device owns one flat
arena and an allocation is an (offset, nbytes) extent inside it.

Unlike the JAX package (functional arrays, donated buffers rebound after
every update, a blocked ``(nblocks, 4096)`` layout to keep traced offsets in
int32), a tensor is updated in place and PyTorch indexes with int64, so one
flat layout serves arenas of any size.

Aligned transfers of at least ``_PALLAS_IO_MIN`` on a CUDA arena go through
the hand-written copy kernels (:mod:`oncilla_tpu_torch.ops.dma`): put ->
``write_rows``, get -> ``read_rows``, same-device copy -> ``local_copy``.
Smaller or unaligned transfers, and every transfer on a CPU arena, use
plain tensor slicing, as the JAX package uses ``lax`` slices there.
"""

from __future__ import annotations

import math
import threading

import torch

from oncilla_tpu_torch.core.arena import ArenaAllocator, Extent, check_bounds
from oncilla_tpu_torch.core.hostmem import as_byte_tensor
from oncilla_tpu_torch.ops import dma
from oncilla_tpu_torch.utils.platform import resolve_device

_BLOCK = dma.BLOCK
# Aligned extents at/above this size take the copy kernels; below it one
# slice copy costs no more than a kernel launch (hbm.py:43-48 in the JAX
# package, same value).
_PALLAS_IO_MIN = 1 << 20


def to_bytes(x) -> torch.Tensor:
    """Flatten any tensor to a uint8 byte vector (a bitcast view, no copy
    for contiguous input)."""
    return as_byte_tensor(x)


def from_bytes(raw: torch.Tensor, shape, dtype: torch.dtype) -> torch.Tensor:
    """Reinterpret a uint8 byte vector as (shape, dtype) (a view)."""
    return raw.reshape(-1).view(dtype).reshape(shape)


class DeviceArena:
    """An HBM arena on one device (or on the CPU, when asked for)."""

    def __init__(self, capacity: int, device=None, alignment: int = 512):
        self.allocator = ArenaAllocator(capacity, alignment)
        self.device = resolve_device(device)
        self._mu = threading.Lock()
        self._buf = torch.zeros(capacity, dtype=torch.uint8, device=self.device)

    @property
    def capacity(self) -> int:
        return self.allocator.capacity

    def alloc(self, nbytes: int) -> Extent:
        return self.allocator.alloc(nbytes)

    def free(self, extent: Extent) -> None:
        # Scrub on free (calloc parity, reference src/alloc.c:171):
        # the next tenant reads zeros, never a previous allocation's bytes.
        self.fill_zero(extent)
        self.allocator.free(extent)

    def fill_zero(self, extent: Extent, nbytes: int | None = None,
                  offset: int = 0) -> None:
        """Zero a byte range of the extent with a device-side fill."""
        n = extent.nbytes - offset if nbytes is None else nbytes
        check_bounds(extent, offset, n)
        start = extent.offset + offset
        with self._mu:
            self._buf[start:start + n].zero_()

    def _dma_eligible(self, start: int, nbytes: int) -> bool:
        """Aligned, large, and the arena on a CUDA device."""
        return (
            self._buf.is_cuda
            and start % _BLOCK == 0
            and nbytes % _BLOCK == 0
            and nbytes >= _PALLAS_IO_MIN
            and self.capacity % _BLOCK == 0
        )

    def write(self, extent: Extent, data, offset: int = 0) -> None:
        """One-sided put of raw bytes (or any tensor, bitcast to bytes)."""
        raw = to_bytes(data).to(self.device)
        n = raw.numel()
        check_bounds(extent, offset, n)
        start = extent.offset + offset
        with self._mu:
            if self._dma_eligible(start, n):
                if raw.data_ptr() % 16:
                    raw = raw.clone()  # a fresh allocation is aligned
                dma.write_rows(self._buf, raw, start)
            else:
                self._buf[start:start + n] = raw

    def read(self, extent: Extent, nbytes: int, offset: int = 0) -> torch.Tensor:
        """One-sided get; returns a fresh uint8 tensor of ``nbytes``."""
        check_bounds(extent, offset, nbytes)
        start = extent.offset + offset
        if self._dma_eligible(start, nbytes):
            return dma.read_rows(self._buf, start, nbytes)
        return self._buf[start:start + nbytes].clone()

    def read_into(self, extent: Extent, out: torch.Tensor,
                  offset: int = 0) -> torch.Tensor:
        """One-sided get into ``out`` (contiguous uint8, any device): on the
        arena's device through ``read_rows(out=)`` when eligible, so a page
        lands where the caller keeps it with no second copy."""
        n = out.numel()
        check_bounds(extent, offset, n)
        start = extent.offset + offset
        if out.device == self.device and self._dma_eligible(start, n):
            return dma.read_rows(self._buf, start, n, out=out.view(-1))
        return out.view(-1).copy_(self.read(extent, n, offset))

    def read_as(self, extent: Extent, shape, dtype: torch.dtype,
                offset: int = 0) -> torch.Tensor:
        nbytes = math.prod(shape) * dtype.itemsize
        return from_bytes(self.read(extent, nbytes, offset), shape, dtype)

    def move(
        self, src: Extent, dst: Extent, nbytes: int, src_offset: int = 0,
        dst_offset: int = 0,
    ) -> None:
        """On-device extent-to-extent copy (no host hop)."""
        check_bounds(src, src_offset, nbytes)
        check_bounds(dst, dst_offset, nbytes)
        s, d = src.offset + src_offset, dst.offset + dst_offset
        no_overlap = s + nbytes <= d or d + nbytes <= s
        with self._mu:
            if self._dma_eligible(s, nbytes) and d % _BLOCK == 0 and no_overlap:
                dma.local_copy(self._buf, s, d, nbytes)
            elif no_overlap:
                self._buf[d:d + nbytes] = self._buf[s:s + nbytes]
            else:
                # Read the whole source before writing, as the JAX
                # slice-then-update does.
                self._buf[d:d + nbytes] = self._buf[s:s + nbytes].clone()

    @property
    def buffer(self) -> torch.Tensor:
        """The live arena tensor, shape ``(capacity,)``."""
        with self._mu:
            return self._buf

    def swap_buffer(self, new_buf: torch.Tensor) -> None:
        """Rebind the arena to another tensor of the same shape and type."""
        assert new_buf.shape == (self.capacity,) and new_buf.dtype == torch.uint8
        assert new_buf.device == self.device
        with self._mu:
            self._buf = new_buf

    def update(self, fn) -> None:
        """``self._buf = fn(self._buf)`` under the arena lock."""
        with self._mu:
            self._buf = fn(self._buf)

    def block_until_ready(self) -> None:
        """Wait for the work queued on the arena's device stream."""
        if self._buf.is_cuda:
            torch.cuda.current_stream(self.device).synchronize()
