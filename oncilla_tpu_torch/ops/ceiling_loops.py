"""The HBM ceiling probes' kernels: K6 (``read_stream``), K7
(``copy_stream_loop``) and K8 (``vmem_roundtrip``).

================  =================================  ==============================
wrapper           replaces (Pallas TPU)              CUDA entry point
================  =================================  ==============================
read_stream       ceiling.py _read_stream_loop       ocm_read_stream
                  (pallas_call :91)                  (csrc/ceiling.cu)
copy_stream_loop  ceiling.py _copy_stream_loop       ocm_copy_loop, K9's kernel
                  (pallas_call :175)                 (csrc/copy_loops.cu)
vmem_roundtrip    ceiling.py _vmem_roundtrip_loop    ocm_vmem_roundtrip
                  (pallas_call :259)                 (csrc/ceiling.cu)
================  =================================  ==============================

Each works in place on a flat uint8 buffer and has the JAX function's
asserts (ceiling.py:65, 142-145, 225-226):

- ``read_stream(buf, chunk_bytes, iters)`` reads the whole buffer ``iters``
  times and writes nothing. Where the TPU kernel returns the untouched
  buffer, the wrapper returns the sum of the buffer's bytes (int64), taken
  by the kernel from the bytes it landed in the last sweep, so that a run
  shows the reads happened; the plain version is ``iters`` sums of the
  buffer.
- ``copy_stream_loop(buf, nbytes, iters, streams)`` is bench.py's copy loop
  (the two Pallas bodies are the same, ceiling.py:148-173 and
  bench.py:123-148) at 1, 2, 4 or 8 streams, with a launch count of its own.
- ``vmem_roundtrip(buf, nbytes, iters, chunk_bytes)`` is the one-stream
  ping-pong over ``buf[0, 2*nbytes)`` with every chunk staged through
  on-chip memory; the plain version stages each chunk through a scratch
  tensor.

A wrapper takes its plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel, or raises. Launches are counted in
``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from oncilla_tpu_torch.ops import copy_loops, dma
from oncilla_tpu_torch.ops.dma import BLOCK, CI, LL, VP

_SIGNATURES = {
    "ocm_read_stream": [CI, VP, LL, LL, CI, VP, VP],
    "ocm_vmem_roundtrip": [CI, VP, LL, CI, LL, VP],
}


def _lib():
    return dma.library("ceiling.cu", _SIGNATURES)


# -- K6: read-only stream ----------------------------------------------------


def _check_stream(buf: torch.Tensor, chunk_bytes: int, iters: int) -> torch.Tensor:
    flat = dma.flat_arena(buf)
    total = flat.numel()
    assert total % chunk_bytes == 0 and chunk_bytes % BLOCK == 0
    assert iters >= 1
    return flat


def read_stream_plain(buf: torch.Tensor, chunk_bytes: int,
                      iters: int) -> torch.Tensor:
    flat = _check_stream(buf, chunk_bytes, iters)
    for _ in range(iters):
        total = flat.sum(dtype=torch.int64)
    return total


def read_stream(buf: torch.Tensor, chunk_bytes: int, iters: int) -> torch.Tensor:
    """K6: ``iters`` sweeps reading ``buf`` chunk by chunk; returns the sum
    of its bytes as a 0-d int64 tensor on the buffer's device."""
    flat = _check_stream(buf, chunk_bytes, iters)
    if not dma.route(buf):
        return read_stream_plain(buf, chunk_bytes, iters)
    dma.ptr16(flat)
    total = torch.zeros((), dtype=torch.int64, device=buf.device)
    lib = _lib()
    dma.check(lib, lib.ocm_read_stream(
        buf.device.index, flat.data_ptr(), flat.numel(), chunk_bytes, iters,
        total.data_ptr(), dma.stream_of(buf)), "read_stream")
    read_stream.launches += 1
    return total


read_stream.launches = 0


# -- K7: copy streams --------------------------------------------------------


def _check_copy(buf: torch.Tensor, nbytes: int, streams: int) -> None:
    total = dma.flat_arena(buf).numel()
    assert (nbytes // BLOCK) % (2 * streams) == 0
    # The ping-pong segment pairs span 2*nbytes of the buffer.
    assert total >= 2 * nbytes, (total, nbytes)


def copy_stream_loop_plain(buf: torch.Tensor, nbytes: int, iters: int,
                           streams: int) -> torch.Tensor:
    _check_copy(buf, nbytes, streams)
    return copy_loops.copy_loop_plain(buf, nbytes, iters, streams)


def copy_stream_loop(buf: torch.Tensor, nbytes: int, iters: int,
                     streams: int) -> torch.Tensor:
    """K7: ``iters`` ping-pong copies of ``nbytes`` in ``streams`` streams,
    on K9's kernel."""
    _check_copy(buf, nbytes, streams)
    if not dma.route(buf):
        return copy_stream_loop_plain(buf, nbytes, iters, streams)
    copy_loops.launch_copy_loop(buf, nbytes, iters, streams, "copy_stream_loop")
    copy_stream_loop.launches += 1
    return buf


copy_stream_loop.launches = 0


# -- K8: the copy staged through on-chip memory ------------------------------


def _check_roundtrip(buf: torch.Tensor, nbytes: int, iters: int,
                     chunk_bytes: int) -> torch.Tensor:
    flat = dma.flat_arena(buf)
    assert chunk_bytes % BLOCK == 0 and chunk_bytes > 0
    assert (nbytes // BLOCK) % (2 * (chunk_bytes // BLOCK)) == 0
    assert flat.numel() >= 2 * nbytes, (flat.numel(), nbytes)
    assert nbytes % BLOCK == 0 and iters >= 1
    return flat


def vmem_roundtrip_plain(buf: torch.Tensor, nbytes: int, iters: int,
                         chunk_bytes: int = 2 << 20) -> torch.Tensor:
    flat = _check_roundtrip(buf, nbytes, iters, chunk_bytes)
    scratch = torch.empty(chunk_bytes, dtype=torch.uint8, device=buf.device)
    for i in range(iters):
        src, dst = (0, nbytes) if i % 2 == 0 else (nbytes, 0)
        for c in range(0, nbytes, chunk_bytes):
            scratch.copy_(flat[src + c:src + c + chunk_bytes])
            flat[dst + c:dst + c + chunk_bytes].copy_(scratch)
    return buf


def vmem_roundtrip(buf: torch.Tensor, nbytes: int, iters: int,
                   chunk_bytes: int = 2 << 20) -> torch.Tensor:
    """K8: ``iters`` ping-pong copies of ``buf[0, nbytes)`` <->
    ``buf[nbytes, 2*nbytes)``, each chunk staged through shared memory."""
    flat = _check_roundtrip(buf, nbytes, iters, chunk_bytes)
    if not dma.route(buf):
        return vmem_roundtrip_plain(buf, nbytes, iters, chunk_bytes)
    dma.ptr16(flat)
    lib = _lib()
    dma.check(lib, lib.ocm_vmem_roundtrip(
        buf.device.index, flat.data_ptr(), nbytes, iters, chunk_bytes,
        dma.stream_of(buf)), "vmem_roundtrip")
    vmem_roundtrip.launches += 1
    return buf


vmem_roundtrip.launches = 0
