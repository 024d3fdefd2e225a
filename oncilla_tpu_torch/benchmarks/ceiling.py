"""The HBM ceiling probes on one card: the measured yardstick for every copy
number of the port (the counterpart of ``oncilla_tpu/benchmarks/ceiling.py``).

A copy reads and writes every byte, and the card's datasheet memory rate
(``utils/platform.hbm_rate``, 3.35 TB/s on an H100 SXM) describes neither a
copy's read/write turnaround nor a given copy scheme. Three probes, each
one kernel launch timed with CUDA events after two warm-up launches:

1. :func:`hbm_read_gbps` — a read-only stream, K6 (``read_stream``): every
   tile of the buffer bulk-loaded (TMA) into a ring of shared memory, nothing
   written back. It bounds everything else from above.
2. :func:`copy_gbps` — HBM-to-HBM ping-pong copies in 1, 2, 4 or 8
   streams, K7 (``copy_stream_loop``, K9's kernel): whether the stream
   count matters once the copy saturates memory.
3. :func:`vmem_roundtrip_gbps` — the same copy with every byte staged
   through shared memory by bulk loads and stores, K8 (``vmem_roundtrip``):
   against the direct copy, what the 16-byte register copy body costs.

The sizes are the JAX probes' defaults (256 MiB read 600 times; 128 MiB
buffers, 64 MiB copies, 2000 and 400 iterations), all larger than the
card's 50 MB L2. The accounting is the JAX probes': a copy is credited
2·nbytes of memory traffic (read + write), the read-only stream 1·nbytes.
Each probe takes ``device`` (CUDA unless ``"cpu"`` is asked for; without
CUDA it raises ``OcmDeviceError``) and ``timing``: without timing (and
always on the CPU) it runs its launches and returns None.

Run on a CUDA machine: ``python -m oncilla_tpu_torch.benchmarks.ceiling``
prints one JSON line.
"""

from __future__ import annotations

import time

import torch

from oncilla_tpu_torch.ops import ceiling_loops
from oncilla_tpu_torch.utils.platform import resolve_device

# Skip a later probe (-1) when less than this many seconds are left.
_SKIP_S = 45


def _seconds(run, buf: torch.Tensor, timing: bool) -> float | None:
    """Two warm-up launches of ``run(buf)``, then one timed launch."""
    run(buf)
    run(buf)
    if not timing:
        return None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(buf)
    end.record()
    torch.cuda.synchronize(buf.device)
    return start.elapsed_time(end) * 1e-3


def _fresh(total_bytes: int, device) -> tuple[torch.Tensor, bool]:
    device = resolve_device(device)
    return torch.zeros(total_bytes, dtype=torch.uint8, device=device), device.type == "cuda"


def hbm_read_gbps(total_bytes: int = 256 << 20, chunk_bytes: int = 2 << 20,
                  iters: int = 600, device=None, timing: bool = True) -> float | None:
    """Read-only HBM stream rate (GB/s of reads). 600 sweeps read 161 GB,
    about 48 ms at 3.35 TB/s."""
    buf, on_card = _fresh(total_bytes, device)
    dt = _seconds(lambda b: ceiling_loops.read_stream(b, chunk_bytes, iters),
                  buf, timing and on_card)
    return None if dt is None else total_bytes * iters / dt / 1e9


def copy_gbps(streams: int, total_bytes: int = 128 << 20, nbytes: int = 64 << 20,
              iters: int = 2000, device=None, timing: bool = True) -> float | None:
    """HBM-to-HBM copy traffic (2·nbytes per iteration) in ``streams``
    streams."""
    buf, on_card = _fresh(total_bytes, device)
    dt = _seconds(
        lambda b: ceiling_loops.copy_stream_loop(b, nbytes, iters, streams),
        buf, timing and on_card)
    return None if dt is None else 2.0 * nbytes * iters / dt / 1e9


def vmem_roundtrip_gbps(total_bytes: int = 128 << 20, nbytes: int = 64 << 20,
                        iters: int = 400, chunk_bytes: int = 2 << 20,
                        device=None, timing: bool = True) -> float | None:
    """Copy traffic (2·nbytes per iteration) with every byte staged through
    shared memory."""
    buf, on_card = _fresh(total_bytes, device)
    dt = _seconds(
        lambda b: ceiling_loops.vmem_roundtrip(b, nbytes, iters, chunk_bytes),
        buf, timing and on_card)
    return None if dt is None else 2.0 * nbytes * iters / dt / 1e9


def ceiling_probe(deadline: float | None = None, device=None, timing: bool = True,
                  read_kw: dict | None = None, copy_kw: dict | None = None,
                  roundtrip_kw: dict | None = None) -> dict:
    """All three probes, with the JAX keys. With ``deadline``
    (``time.monotonic()``) a probe after the first is skipped, as -1, once
    fewer than 45 s are left. ``*_kw`` override a probe's sizes."""
    device = resolve_device(device)
    out: dict = {}

    def left() -> float:
        return float("inf") if deadline is None else deadline - time.monotonic()

    out["read_only_gbps"] = hbm_read_gbps(device=device, timing=timing,
                                          **(read_kw or {}))
    out["copy_streams_gbps"] = {}
    for s in (1, 2, 4, 8):
        out["copy_streams_gbps"][str(s)] = (
            copy_gbps(s, device=device, timing=timing, **(copy_kw or {}))
            if left() >= _SKIP_S else -1.0)
    out["vmem_roundtrip_gbps"] = (
        vmem_roundtrip_gbps(device=device, timing=timing, **(roundtrip_kw or {}))
        if left() >= _SKIP_S else -1.0)
    return out


def main() -> None:
    import json

    print(json.dumps(ceiling_probe()), flush=True)


if __name__ == "__main__":
    main()
