"""The one-sided device fabric: K4, a copy from any row of the fabric into
any row, issued by the one process that holds them all.

=================  =======================================  ==========================
wrapper            replaces (Pallas TPU)                    CUDA entry points
=================  =======================================  ==========================
onesided_copy      pallas_ici_copy (ops/pallas_ici.py:266,  ocm_onesided_local,
                   pallas_call :145); K5                    ocm_onesided_send,
                   _cached_window_copy (:191) with it       ocm_onesided_wait
                                                            (csrc/fabric.cu)
=================  =======================================  ==========================

A fabric is a :class:`FabricRows`: one flat uint8 row tensor per mesh entry
(:mod:`oncilla_tpu_torch.parallel.spmd_arena` makes them), and beside each
row its sync words, the counterpart of the TPU kernel's semaphore scratch.
Rows may share a device: that is how one card (or the CPU) hosts several
rows, as the JAX package's virtual CPU devices do.

``onesided_copy`` keeps the JAX function's contract and asserts: BLOCK-
aligned offsets and size (``pallas_supported``), and no overlap for a copy
within one row. On CUDA rows it launches the kernel: the local fast path for
a copy within one row, else the send/recv protocol described in the CUDA
source (``force_remote`` takes the protocol within one row too, the TPU
kernel's loopback). Both are TMA bulk copies planned by ``dma.bulk_plan``,
the send into any row; the recv wait is launched only for a row on another
card, whose stream is not the send's. On CPU rows it takes the plain version beside it
(slice-then-update); it never falls back to it on a CUDA row. Launches are
counted in ``onesided_copy.launches``; plain-version calls are not.
"""

from __future__ import annotations

import itertools

import torch

from oncilla_tpu_torch.core.errors import OcmError
from oncilla_tpu_torch.ops import dma
from oncilla_tpu_torch.ops.dma import CI, LL, VP, pallas_supported

_SIGNATURES = {
    "ocm_onesided_local": [CI, VP, LL, LL, LL, CI, LL, CI, VP],
    "ocm_onesided_send": [CI, VP, VP, LL, CI, LL, CI, VP, VP, LL, CI, VP],
    "ocm_onesided_wait": [CI, VP, LL, VP],
    "ocm_enable_peer": [CI, CI],
}

# Sync words beside each row (int64): the recv flag, which the last sender
# into the row raises to its transfer's sequence number, and the count of
# CTAs done in the current send out of the row (0 between sends).
RECV_FLAG, SEND_COUNT = 0, 1


class FabricRows:
    """The rows of a fabric and the sync words beside them.

    ``rows[d]`` is mesh entry d's flat uint8 row; ``sync[d]`` its two int64
    sync words on the same device; ``seq[d]`` the sequence number of the
    last transfer sent into row d (the value its recv flag reaches once that
    transfer has landed); ``side`` the side streams of ``ring_shift``'s
    sends across cards, by (card, "send" | "recv"), made at first use. Rows
    are updated in place."""

    def __init__(self, rows):
        self.rows = list(rows)
        self.sync = [torch.zeros(2, dtype=torch.int64, device=r.device)
                     for r in self.rows]
        self.seq = [0] * len(self.rows)
        self.side: dict = {}

    def __len__(self) -> int:
        return len(self.rows)


def enable_peer_access(devices) -> None:
    """Let every CUDA device among ``devices`` store into every other's
    memory. Raises :class:`OcmError` where the hardware cannot: the fabric
    never routes a copy through the host."""
    idx = sorted({d.index for d in devices if d.type == "cuda"})
    if len(idx) < 2:
        return
    lib = dma.library("fabric.cu", _SIGNATURES)
    for a, b in itertools.permutations(idx, 2):
        if not torch.cuda.can_device_access_peer(a, b):
            raise OcmError(f"cuda:{a} cannot access cuda:{b}'s memory as a "
                           "peer; the fabric does not route through the host")
        dma.check(lib, lib.ocm_enable_peer(a, b), "enable_peer_access")


def _check_copy(arena: FabricRows, src_dev: int, dst_dev: int, src_off: int,
                dst_off: int, nbytes: int) -> None:
    assert pallas_supported(int(src_off), int(dst_off), nbytes), (
        "onesided_copy needs BLOCK-aligned offsets/size; use spmd_arena."
        "ici_copy, which takes the plain path for the rest"
    )
    if src_dev == dst_dev:
        assert dst_off + nbytes <= src_off or src_off + nbytes <= dst_off, (
            "overlapping same-device extents are unsafe for onesided_copy; "
            "use DeviceArena.move"
        )
    assert src_off + nbytes <= arena.rows[src_dev].numel(), "read past the row's end"
    assert dst_off + nbytes <= arena.rows[dst_dev].numel(), "write past the row's end"


def onesided_copy_plain(arena: FabricRows, src_dev: int, dst_dev: int,
                        src_off: int, dst_off: int, nbytes: int, *,
                        force_remote: bool = False) -> FabricRows:
    del force_remote  # one route: slice, then update
    _check_copy(arena, src_dev, dst_dev, src_off, dst_off, nbytes)
    src = arena.rows[src_dev][src_off:src_off + nbytes]
    arena.rows[dst_dev][dst_off:dst_off + nbytes] = src.to(
        arena.rows[dst_dev].device)
    return arena


def onesided_copy(arena: FabricRows, src_dev: int, dst_dev: int, src_off: int,
                  dst_off: int, nbytes: int, *,
                  force_remote: bool = False) -> FabricRows:
    """Copy ``nbytes`` of row ``src_dev`` at ``src_off`` into row ``dst_dev``
    at ``dst_off``, in place; returns ``arena``. Offsets and size are
    BLOCK-aligned; within one row the extents must not overlap."""
    src, dst = arena.rows[src_dev], arena.rows[dst_dev]
    on_card = dma.route(src)
    if dma.route(dst) != on_card:
        raise ValueError(f"rows on {src.device} and {dst.device}: one copy "
                         "cannot join the CPU and a card")
    if not on_card:
        return onesided_copy_plain(arena, src_dev, dst_dev, src_off, dst_off,
                                   nbytes, force_remote=force_remote)
    _check_copy(arena, src_dev, dst_dev, src_off, dst_off, nbytes)
    dma.ptr16(src, dst)
    lib = dma.library("fabric.cu", _SIGNATURES)
    plan = dma.bulk_plan(nbytes, dma.sm_count(src))
    if src_dev == dst_dev and not force_remote:
        dma.check(lib, lib.ocm_onesided_local(
            src.get_device(), src.data_ptr(), src_off, dst_off, nbytes, *plan,
            dma.stream_of(src)), "onesided_copy")
    else:
        across = src.get_device() != dst.get_device()
        if across:
            # The send writes into the destination row from the source's
            # stream: order it after the work already queued on that row.
            torch.cuda.current_stream(src.device).wait_stream(
                torch.cuda.current_stream(dst.device))
        seq = arena.seq[dst_dev] + 1
        flag = arena.sync[dst_dev].data_ptr() + RECV_FLAG * 8
        dma.check(lib, lib.ocm_onesided_send(
            src.get_device(), src.data_ptr() + src_off,
            dst.data_ptr() + dst_off, nbytes, *plan,
            arena.sync[src_dev].data_ptr() + SEND_COUNT * 8, flag, seq,
            across, dma.stream_of(src)), "onesided_copy send")
        arena.seq[dst_dev] = seq
        if across:
            dma.check(lib, lib.ocm_onesided_wait(
                dst.get_device(), flag, seq, dma.stream_of(dst)),
                "onesided_copy recv")
    onesided_copy.launches += 1
    return arena


onesided_copy.launches = 0
