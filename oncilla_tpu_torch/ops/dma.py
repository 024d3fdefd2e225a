"""Arena copy kernels: put (K1), get (K2) and same-device copy (K3).

The counterparts of the local half of ``oncilla_tpu/ops/pallas_ici.py``:

=============  ==========================  ===============================
wrapper        replaces (Pallas TPU)       CUDA entry point (csrc/dma.cu)
=============  ==========================  ===============================
write_rows     pallas_write_rows  (:537)   ocm_write_rows
read_rows      pallas_read_rows   (:464)   ocm_read_rows
local_copy     pallas_local_copy  (:396)   ocm_local_copy
=============  ==========================  ===============================

Each wrapper has the JAX function's signature and asserts (BLOCK-aligned
offsets and size; disjoint ranges for ``local_copy``) and a plain PyTorch
version beside it (slice assignment). A wrapper takes the plain version
only for a tensor on the CPU; for a CUDA tensor it launches the kernel, or
raises if the kernel cannot be built or refuses the launch. Each wrapper
counts its kernel launches in ``<wrapper>.launches`` (a plain int, reset
with :func:`reset_launches`); plain-version calls are not counted.

This module also builds the port's kernels: every source under ``csrc/``
is compiled at first use with ``nvcc`` into ``build/oncilla_tpu_torch/``
beside the package, one library with a plain C interface per source, loaded
with ``ctypes`` (:func:`library`), so a checkout needs nothing prebuilt. The
launch counters of every kernel of the port are read and reset here
(:func:`launches`, :func:`reset_launches`). What bounds each kernel and how
it is designed is noted in its CUDA source.

K1-K3 (and K4, :mod:`.fabric`) run ``csrc/copy.cuh``'s one-shot TMA bulk
copy, whose grid, tile and ring the wrapper plans (:func:`bulk_plan`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

BLOCK = 4096  # bytes per addressable block (one (32, 128) uint8 TPU tile)

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_SOURCES = tuple(sorted(p.name for p in _CSRC.glob("*.cu")))
_HEADERS = tuple(sorted(p.name for p in _CSRC.glob("*.cuh")))
_BUILD_DIR = _PKG.parent / "build" / "oncilla_tpu_torch"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
BUILD_LOG: dict[str, str] = {}


# The bulk copy's plan (csrc/copy.cuh): tiles of BULK_TILE bytes, a ring of
# BULK_SLOTS tiles a CTA, at most BULK_CTAS_PER_SM CTAs a SM. Chosen on an
# H100 at one cold 16 MiB page and at 1 GiB by
# ``python3 scripts/tune_bulk_plan.py`` (PERF.md).
BULK_TILE = 16 << 10
BULK_SLOTS = 8
BULK_CTAS_PER_SM = 1


class BulkPlan(NamedTuple):
    grid: int   # CTAs
    tile: int   # bytes a tile; the last tile of a copy may be shorter
    slots: int  # tiles in a CTA's shared-memory ring


@functools.lru_cache(maxsize=256)
def bulk_plan(nbytes: int, sms: int) -> BulkPlan:
    """The launch of a bulk copy of ``nbytes`` on a card of ``sms`` SMs: one
    CTA a tile up to ``BULK_CTAS_PER_SM`` CTAs a SM (cached: a caller moves
    pages of one size)."""
    tiles = -(-nbytes // BULK_TILE)
    return BulkPlan(min(tiles, BULK_CTAS_PER_SM * sms), BULK_TILE, BULK_SLOTS)


def bulk_tiles(nbytes: int, plan: BulkPlan):
    """Yields (CTA, byte offset, bytes) of every tile the kernel copies, by
    its formula: CTA b of G takes tiles b, b+G, b+2G, ... of the T tiles
    (dealt round robin), each ``plan.tile`` bytes but the last, which ends
    at ``nbytes``."""
    tiles = -(-nbytes // plan.tile)
    for b in range(plan.grid):
        for k in range(b, tiles, plan.grid):
            off = k * plan.tile
            yield b, off, min(plan.tile, nbytes - off)


_SMS: dict[int, int] = {}


def sm_count(t: torch.Tensor) -> int:
    """The SMs of the card CUDA tensor ``t`` lies on (cached)."""
    index = t.get_device()
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def pallas_supported(offset_a: int, offset_b: int, nbytes: int) -> bool:
    """Whether a transfer may take the kernels: BLOCK-aligned offsets and a
    positive BLOCK-multiple size (the JAX package's predicate, same name)."""
    return (
        offset_a % BLOCK == 0 and offset_b % BLOCK == 0 and
        nbytes % BLOCK == 0 and nbytes > 0
    )


# -- build -----------------------------------------------------------------


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); cannot build csrc/")


def _target(src: Path) -> Path:
    """The library of one source, named by a hash of the source, the shared
    headers it may include and the flags."""
    digest = hashlib.sha256(src.read_bytes())
    for h in _HEADERS:
        digest.update((_CSRC / h).read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:12]}.so"


def build() -> float:
    """Compile every source under ``csrc/`` that has no up-to-date library,
    one ``nvcc`` per source, all started together. Returns the seconds it
    took; raises with the compiler's output if any build fails. ptxas's
    register/spill report of each source lands in ``BUILD_LOG``."""
    t0 = time.perf_counter()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in _SOURCES:
        src = _CSRC / name
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


VP, LL, CI = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def library(source: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, building every source first
    if any is out of date. ``signatures`` maps each entry point to its
    ``argtypes``; every entry point returns a CUDA error code (int), and
    each library has ``ocm_error_string``."""
    lib = _libs.get(source)
    if lib is not None:  # built and loaded: no lock on the launch path
        return lib
    with _lib_lock:
        lib = _libs.get(source)
        if lib is None:
            build()
            lib = ctypes.CDLL(str(_target(_CSRC / source)))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = CI
            lib.ocm_error_string.argtypes = [CI]
            lib.ocm_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


_SIGNATURES = {
    "ocm_write_rows": [CI, VP, VP, LL, LL, CI, LL, CI, VP],
    "ocm_read_rows": [CI, VP, VP, LL, LL, CI, LL, CI, VP],
    "ocm_local_copy": [CI, VP, LL, LL, LL, CI, LL, CI, VP],
}


def _load() -> ctypes.CDLL:
    return library("dma.cu", _SIGNATURES)


def check(lib, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.ocm_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


# -- argument checks shared by the kernel and its plain version -------------


def flat_arena(buf: torch.Tensor) -> torch.Tensor:
    if buf.dtype != torch.uint8 or not buf.is_contiguous():
        raise ValueError("arena must be a contiguous uint8 tensor")
    assert buf.numel() % BLOCK == 0, "arena must be BLOCK-aligned"
    return buf if buf.dim() == 1 else buf.view(-1)


def route(t: torch.Tensor) -> bool:
    """True: launch the kernel (CUDA tensor); False: plain version (CPU)."""
    if t.is_cuda:
        return True
    if t.is_cpu:
        return False
    raise ValueError(f"no copy kernel for device {t.device}")


def ptr16(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("copy kernels need 16-byte aligned tensors")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream of CUDA tensor ``t``'s device
    (without building a ``torch.cuda.Stream``: a launch's host time at one
    KV page is comparable to the kernel's, PERF.md)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


# -- K1: put ----------------------------------------------------------------


def write_rows_plain(buf: torch.Tensor, raw: torch.Tensor, start: int) -> torch.Tensor:
    flat = buf.view(-1)
    flat[start:start + raw.numel()] = raw.reshape(-1)
    return buf


def write_rows(buf: torch.Tensor, raw: torch.Tensor, start: int) -> torch.Tensor:
    """One-sided put of flat uint8 ``raw`` (BLOCK-multiple size) into the
    arena at byte offset ``start``, in place; returns ``buf``."""
    flat = flat_arena(buf)
    nbytes = raw.numel()
    assert start % BLOCK == 0 and nbytes % BLOCK == 0 and nbytes > 0
    assert start + nbytes <= flat.numel(), "write past the arena's end"
    if raw.dtype != torch.uint8 or not raw.is_contiguous():
        raise ValueError("rows must be a contiguous uint8 tensor")
    if raw.device != buf.device:
        raise ValueError(f"rows on {raw.device}, arena on {buf.device}")
    if not route(buf):
        return write_rows_plain(buf, raw, start)
    ptr16(flat, raw)
    lib = _load()
    check(lib, lib.ocm_write_rows(
        buf.get_device(), flat.data_ptr(), raw.data_ptr(), start, nbytes,
        *bulk_plan(nbytes, sm_count(buf)), stream_of(buf)), "write_rows")
    write_rows.launches += 1
    return buf


write_rows.launches = 0


# -- K2: get ----------------------------------------------------------------


def read_rows_plain(buf: torch.Tensor, start: int, nbytes: int,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    src = buf.view(-1)[start:start + nbytes]
    return src.clone() if out is None else out.copy_(src)


def read_rows(buf: torch.Tensor, start: int, nbytes: int,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """One-sided get of a BLOCK-aligned extent as a flat uint8 tensor on the
    arena's device: a fresh one, or ``out`` (``nbytes`` contiguous uint8 on
    that device), which is returned."""
    flat = flat_arena(buf)
    assert start % BLOCK == 0 and nbytes % BLOCK == 0 and nbytes > 0
    assert start + nbytes <= flat.numel(), "read past the arena's end"
    if out is not None and (out.dtype != torch.uint8 or not out.is_contiguous()
                            or out.numel() != nbytes or out.device != buf.device):
        raise ValueError(f"out must be {nbytes} contiguous uint8 bytes on {buf.device}")
    if not route(buf):
        return read_rows_plain(buf, start, nbytes, out)
    if out is None:
        out = flat.new_empty(nbytes)
    ptr16(flat, out)
    lib = _load()
    check(lib, lib.ocm_read_rows(
        buf.get_device(), flat.data_ptr(), out.data_ptr(), start, nbytes,
        *bulk_plan(nbytes, sm_count(buf)), stream_of(buf)), "read_rows")
    read_rows.launches += 1
    return out


read_rows.launches = 0


def read_rows_loop(buf: torch.Tensor, start: int, nbytes: int, k: int) -> torch.Tensor:
    """``k`` back-to-back gets of the same extent (the counterpart of
    ``pallas_read_rows_loop``, pallas_ici.py:505-521): K2 launched ``k``
    times into one output tensor, which is returned. One output, as the
    JAX program lets XLA reuse the dead ones: k outputs of 1 GiB would
    hold k GiB."""
    assert k >= 1
    out = read_rows(buf, start, nbytes)
    for _ in range(k - 1):
        read_rows(buf, start, nbytes, out=out)
    return out


# -- K3: same-device extent copy --------------------------------------------


def local_copy_plain(buf: torch.Tensor, src_off: int, dst_off: int,
                     nbytes: int) -> torch.Tensor:
    flat = buf.view(-1)
    flat[dst_off:dst_off + nbytes] = flat[src_off:src_off + nbytes]
    return buf


def local_copy(buf: torch.Tensor, src_off: int, dst_off: int,
               nbytes: int) -> torch.Tensor:
    """In-place copy of arena bytes [src_off, +nbytes) to [dst_off, +nbytes)
    on one device. Offsets and size BLOCK-aligned; the ranges must not
    overlap. Returns ``buf``."""
    flat = flat_arena(buf)
    assert pallas_supported(int(src_off), int(dst_off), nbytes)
    assert (
        int(src_off) + nbytes <= int(dst_off)
        or int(dst_off) + nbytes <= int(src_off)
    ), "overlapping ranges are unsafe for a raw copy; use DeviceArena.move"
    assert max(src_off, dst_off) + nbytes <= flat.numel(), "copy past the arena's end"
    if not route(buf):
        return local_copy_plain(buf, src_off, dst_off, nbytes)
    ptr16(flat)
    lib = _load()
    check(lib, lib.ocm_local_copy(
        buf.get_device(), flat.data_ptr(), src_off, dst_off, nbytes,
        *bulk_plan(nbytes, sm_count(buf)), stream_of(buf)), "local_copy")
    local_copy.launches += 1
    return buf


local_copy.launches = 0


def kernels() -> tuple:
    """The wrapper of every kernel of the port, each with its ``launches``
    count: K1-K3 here, K4 in :mod:`.fabric`, K6-K8 in :mod:`.ceiling_loops`,
    K9/K10 in :mod:`.copy_loops`."""
    from oncilla_tpu_torch.ops import ceiling_loops, copy_loops, fabric

    return (write_rows, read_rows, local_copy, fabric.onesided_copy,
            ceiling_loops.read_stream, ceiling_loops.copy_stream_loop,
            ceiling_loops.vmem_roundtrip, copy_loops.copy_loop,
            copy_loops.remote_loop)


def reset_launches() -> None:
    for k in kernels():
        k.launches = 0


def launches() -> dict[str, int]:
    return {k.__name__: k.launches for k in kernels()}
