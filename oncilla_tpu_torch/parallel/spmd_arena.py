"""The fabric's arena: one row per mesh entry, moved row to row.

The counterpart of ``oncilla_tpu.parallel.spmd_arena``. There the arena is
one ``(D, arena_bytes)`` array sharded one row per chip, every function
returns a new arena, and callers thread it through their jitted steps. Here
it is a :class:`~oncilla_tpu_torch.ops.fabric.FabricRows`: one contiguous
uint8 row tensor per mesh entry, on that entry's device. **Every function
updates the rows in place and returns the same object**, so callers may keep
the JAX package's ``arena = f(arena, ...)`` idiom.

Transports of ``ici_copy``, with the JAX routing (spmd_arena.py:108-127):

- the one-sided kernel K4 (:func:`oncilla_tpu_torch.ops.fabric.onesided_copy`)
  when the copy is BLOCK-aligned and not an overlapping copy within a row —
  the default on CUDA rows (``use_kernel``, JAX's ``use_pallas``);
- otherwise slice-then-update, the counterpart of the ``ppermute`` path,
  which reads the whole source before writing and so handles overlap.

``host_put``/``host_get``/``fill_zero``/``ring_shift`` are plain tensor
code, as the JAX functions are plain jitted XLA (no Pallas).
"""

from __future__ import annotations

import math

import torch

from oncilla_tpu_torch.core.hbm import from_bytes
from oncilla_tpu_torch.core.hostmem import as_byte_tensor
from oncilla_tpu_torch.ops import fabric
from oncilla_tpu_torch.ops.dma import pallas_supported
from oncilla_tpu_torch.ops.fabric import FabricRows


def make_arena(mesh, arena_bytes: int) -> FabricRows:
    """One zeroed row of ``arena_bytes`` on each mesh entry's device. Rows
    on different cards get peer access to each other (raises where the
    cards cannot)."""
    fabric.enable_peer_access(mesh)
    return FabricRows(torch.zeros(arena_bytes, dtype=torch.uint8, device=d)
                      for d in mesh)


def _span(arena: FabricRows, dev: int, offset: int, nbytes: int) -> torch.Tensor:
    row = arena.rows[dev]
    if offset < 0 or nbytes < 0 or offset + nbytes > row.numel():
        raise ValueError(f"[{offset}, {offset + nbytes}) is outside row {dev} "
                         f"of {row.numel()} B")
    return row[offset:offset + nbytes]


def host_put(arena: FabricRows, dev: int, data, offset) -> FabricRows:
    """Write ``data`` (bitcast to bytes, from any device) into row ``dev``
    at ``offset``."""
    raw = as_byte_tensor(data)
    _span(arena, dev, int(offset), raw.numel()).copy_(raw)
    return arena


def host_get(arena: FabricRows, dev: int, nbytes: int, offset) -> torch.Tensor:
    """A fresh copy of row ``dev``'s ``[offset, offset+nbytes)``, on the
    row's device."""
    return _span(arena, dev, int(offset), nbytes).clone()


def fill_zero(arena: FabricRows, dev: int, offset, nbytes: int) -> FabricRows:
    """Zero ``nbytes`` of row ``dev`` at ``offset`` with a device-side fill
    (the scrub behind allocations reading as zeros, reference
    src/alloc.c:171)."""
    _span(arena, dev, int(offset), int(nbytes)).zero_()
    return arena


def ici_copy(arena: FabricRows, src_dev: int, dst_dev: int, src_off, dst_off,
             nbytes: int, *, use_kernel: bool | None = None) -> FabricRows:
    """One-sided row-to-row copy: row ``src_dev``'s ``[src_off,
    src_off+nbytes)`` -> row ``dst_dev`` at ``dst_off``. The bytes go from
    row to row, never through the host."""
    src_off, dst_off = int(src_off), int(dst_off)
    if use_kernel is None:
        use_kernel = arena.rows[src_dev].is_cuda
    # A raw copy within one row may read bytes it already overwrote; the
    # slice-then-update path reads the whole source first.
    overlap = src_dev == dst_dev and not (
        src_off + nbytes <= dst_off or dst_off + nbytes <= src_off
    )
    if use_kernel and not overlap and pallas_supported(src_off, dst_off, nbytes):
        return fabric.onesided_copy(arena, src_dev, dst_dev, src_off, dst_off,
                                    nbytes)
    chunk = _span(arena, src_dev, src_off, nbytes).clone()
    _span(arena, dst_dev, dst_off, nbytes).copy_(chunk)
    return arena


def ring_shift(arena: FabricRows, offset, nbytes: int, *,
               reverse: bool = False) -> FabricRows:
    """Every row sends ``[offset, offset+nbytes)`` to its ring neighbour
    (the next row, or the previous one with ``reverse``) at the same
    offset. Every chunk is staged before any is written, as ``ppermute``
    reads all sources before it writes. With rows on two or more cards, the
    sends run at once (:func:`_concurrent_sends`)."""
    offset, d = int(offset), len(arena)
    staged = [_span(arena, i, offset, nbytes).clone() for i in range(d)]
    step = -1 if reverse else 1
    sends = [(chunk, _span(arena, (i + step) % d, offset, nbytes))
             for i, chunk in enumerate(staged)]
    devices = {r.device for r in arena.rows}
    if len(devices) > 1 and all(dev.type == "cuda" for dev in devices):
        _concurrent_sends(sends, arena.side)
    else:
        for chunk, dst in sends:
            dst.copy_(chunk)
    return arena


def _concurrent_sends(sends, side: dict) -> None:
    """Every ``dst.copy_(src)`` at once, across cards. A copy between two
    cards runs on the source card's current stream after the destination
    card's, and then holds the destination card's current stream until it
    has landed; on the cards' default streams a ring of such copies runs
    one send after another (on four H100s, 90 GB/s a row at 256 MiB where
    the links carry 300 at once). Here each copy runs between a send
    stream of its source card and a receive stream of its destination card
    (kept in ``side``), which first wait for everything queued on their
    cards; each card's current stream then waits for both."""

    def stream(dev: torch.device, role: str) -> torch.cuda.Stream:
        if (dev, role) not in side:
            side[dev, role] = torch.cuda.Stream(device=dev)
        return side[dev, role]

    cards = {t.device for pair in sends for t in pair}
    ready = {dev: torch.cuda.current_stream(dev).record_event() for dev in cards}
    for src, dst in sends:
        send, recv = stream(src.device, "send"), stream(dst.device, "recv")
        send.wait_event(ready[src.device])
        recv.wait_event(ready[dst.device])
        with torch.cuda.stream(send), torch.cuda.stream(recv):
            dst.copy_(src)
    for dev in cards:
        cur = torch.cuda.current_stream(dev)
        for role in ("send", "recv"):
            if (dev, role) in side:
                cur.wait_stream(side[dev, role])


def read_typed(arena: FabricRows, dev: int, shape, dtype: torch.dtype, offset):
    """Row ``dev``'s bytes at ``offset`` as a fresh ``(shape, dtype)``
    tensor."""
    nbytes = math.prod(shape) * dtype.itemsize
    return from_bytes(host_get(arena, dev, nbytes, offset), shape, dtype)
