"""bench.py's copy loops: K9 (``copy_loop``) and K10 (``remote_loop``).

=============  ===============================  ==================================
wrapper        replaces (Pallas TPU)            CUDA entry point (csrc/copy_loops.cu)
=============  ===============================  ==================================
copy_loop      bench.py _pallas_copy_loop       ocm_copy_loop
               (pallas_call :150)
remote_loop    bench.py _pallas_remote_loop     ocm_remote_loop
               (pallas_call :223)
=============  ===============================  ==================================

Both run ``iters`` ping-pong copies over the first ``2*nbytes`` of a flat
uint8 buffer, in place, in one launch: ``streams`` independent segment
pairs, stream s copying ``[s*2q, s*2q+q)`` to ``[s*2q+q, s*2q+2q)`` on even
iterations and back on odd ones, ``q = nbytes / streams`` (bench.py:126-135).
``remote_loop`` is the schedule at 2 streams with every copy completed by
the fabric's send/recv protocol. The plain versions are the same schedule
as a Python loop of ``copy_`` on slices; at one stream that is also the
counterpart of bench.py's ``_xla_copy_loop``. A wrapper takes the plain
version only for a CPU buffer; launches are counted in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from oncilla_tpu_torch.ops import dma
from oncilla_tpu_torch.ops.dma import BLOCK, CI, LL, VP

_SIGNATURES = {
    "ocm_copy_loop": [CI, VP, LL, CI, CI, VP, VP],
    "ocm_remote_loop": [CI, VP, LL, CI, VP, VP, VP],
}


def _check_loop(buf: torch.Tensor, nbytes: int, iters: int) -> torch.Tensor:
    flat = dma.flat_arena(buf)
    assert nbytes % BLOCK == 0 and nbytes > 0, "nbytes must be BLOCK-aligned"
    assert 2 * nbytes <= flat.numel(), "the segment pairs exceed the buffer"
    assert iters >= 1
    return flat


def copy_loop_plain(buf: torch.Tensor, nbytes: int, iters: int,
                    streams: int = 2) -> torch.Tensor:
    flat = _check_loop(buf, nbytes, iters)
    q = nbytes // streams
    for i in range(iters):
        fwd = i % 2 == 0
        for s in range(streams):
            lo, hi = s * 2 * q, s * 2 * q + q
            src, dst = (lo, hi) if fwd else (hi, lo)
            flat[dst:dst + q].copy_(flat[src:src + q])
    return buf


def launch_copy_loop(buf: torch.Tensor, nbytes: int, iters: int, streams: int,
                     what: str) -> None:
    """One launch of ``ocm_copy_loop`` on a CUDA buffer, counted by the
    caller: K9's wrapper here, K7's in :mod:`.ceiling_loops`."""
    flat = _check_loop(buf, nbytes, iters)
    dma.ptr16(flat)
    arrive = torch.zeros(streams, dtype=torch.int64, device=buf.device)
    lib = dma.library("copy_loops.cu", _SIGNATURES)
    dma.check(lib, lib.ocm_copy_loop(
        buf.device.index, flat.data_ptr(), nbytes // streams, streams, iters,
        arrive.data_ptr(), dma.stream_of(buf)), what)


def copy_loop(buf: torch.Tensor, nbytes: int, iters: int,
              streams: int = 2) -> torch.Tensor:
    """K9: ``iters`` ping-pong copies of ``nbytes`` in ``streams`` streams
    (``nbytes`` splits into ``2*streams`` whole blocks, bench.py:119-121)."""
    assert (nbytes // BLOCK) % (2 * streams) == 0, "nbytes must split across streams"
    _check_loop(buf, nbytes, iters)
    if not dma.route(buf):
        return copy_loop_plain(buf, nbytes, iters, streams)
    launch_copy_loop(buf, nbytes, iters, streams, "copy_loop")
    copy_loop.launches += 1
    return buf


copy_loop.launches = 0


def remote_loop_plain(buf: torch.Tensor, nbytes: int, iters: int) -> torch.Tensor:
    return copy_loop_plain(buf, nbytes, iters, streams=2)


def remote_loop(buf: torch.Tensor, nbytes: int, iters: int) -> torch.Tensor:
    """K10: the 2-stream schedule of :func:`copy_loop`, every copy a
    loopback remote copy (``nbytes`` a whole number of block pairs,
    bench.py:182-184)."""
    assert (nbytes // BLOCK) % 2 == 0, "nbytes must split across 2 streams"
    flat = _check_loop(buf, nbytes, iters)
    if not dma.route(buf):
        return remote_loop_plain(buf, nbytes, iters)
    dma.ptr16(flat)
    arrive, flag = torch.zeros(2, 2, dtype=torch.int64, device=buf.device)
    lib = dma.library("copy_loops.cu", _SIGNATURES)
    dma.check(lib, lib.ocm_remote_loop(
        buf.device.index, flat.data_ptr(), nbytes // 2, iters,
        arrive.data_ptr(), flag.data_ptr(), dma.stream_of(buf)), "remote_loop")
    remote_loop.launches += 1
    return buf


remote_loop.launches = 0
