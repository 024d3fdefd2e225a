"""The copy legs of ``bench.py`` on one card: alloc/free p50, the plain copy
loop, the copy-loop kernel K9 at 2 and 4 streams, the loopback remote loop
K10, the segment stamp-and-verify of each timed loop, and the one-sided
copy and DMA row kernel checks, at ``bench.py``'s sizes (arena 256 MiB, 64
MiB a copy, 2000 copies a timed run, 1000 for the remote loop).

Prints one JSON line. Each number is a rate of HBM traffic, 2 bytes a
copied byte (read + write), as ``bench.py`` credits it; its yardstick is the
card's datasheet HBM rate (``vs_hbm``), not a TPU's. As in ``bench.py`` a
failed stage zeroes its number and names its error under
``detail.errors``, and the headline never comes from a loop whose check
failed; the line then ends with ``"ok": false``.

Run on a CUDA machine: ``python -m oncilla_tpu_torch.benchmarks.copy_bench``.
Without CUDA it raises ``OcmDeviceError``. :func:`run` takes a device and
sizes, and with ``timing=False`` (on the CPU, say) runs every stage and its
checks with no timing: every rate is then ``None``.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

import oncilla_tpu_torch as ocm
from oncilla_tpu_torch import OcmKind
from oncilla_tpu_torch.ops import copy_loops
from oncilla_tpu_torch.ops.dma import BLOCK
from oncilla_tpu_torch.utils.platform import hbm_rate, resolve_device

ARENA = 256 << 20
NBYTES = 64 << 20   # per copy
ITERS = 2000        # copies per timed launch; the remote loop runs ITERS // 2
SEG_MULTS = (1, 3, 7, 11, 13, 17, 19, 23)


def bench_alloc_p50(ctx, n: int = 2000) -> tuple[float, float]:
    """p50 alloc and free latency (µs) of a 1 MiB LOCAL_DEVICE handle
    (bench.py:60-71; the reference's test 2 times the register/teardown
    pair)."""
    ta, tf = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        h = ctx.alloc(1 << 20, OcmKind.LOCAL_DEVICE)
        t1 = time.perf_counter()
        ctx.free(h)
        tf.append(time.perf_counter() - t1)
        ta.append(t1 - t0)
    return sorted(ta)[n // 2] * 1e6, sorted(tf)[n // 2] * 1e6


def _timed_gbps(loop, buf: torch.Tensor, nbytes: int, iters: int,
                timing: bool) -> float | None:
    """Two warm-up runs of ``loop(buf)``, then one timed run (CUDA events);
    GB/s of HBM traffic, or None without timing."""
    loop(buf)
    loop(buf)
    if not timing:
        return None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    loop(buf)
    end.record()
    torch.cuda.synchronize(buf.device)
    return 2.0 * nbytes * iters / (start.elapsed_time(end) * 1e-3) / 1e9


def _pattern(n: int, mult: int, mod: int = 251) -> np.ndarray:
    return (np.arange(n, dtype=np.uint64) * mult % mod).astype(np.uint8)


def check_onesided_copy(errors: dict, device) -> bool:
    """The one-sided copy K4 on a one-row fabric, local fast path and
    force_remote loopback, then a handle-level copy through
    ``SpmdIciPlane`` (bench.py:280-339, ``check_pallas_ici_copy``)."""
    from oncilla_tpu_torch.core.arena import Extent
    from oncilla_tpu_torch.core.handle import OcmAlloc
    from oncilla_tpu_torch.core.kinds import Fabric
    from oncilla_tpu_torch.ops import fabric
    from oncilla_tpu_torch.ops.ici import SpmdIciPlane
    from oncilla_tpu_torch.parallel import spmd_arena as sa

    try:
        mesh = [torch.device(device)]
        arena = sa.make_arena(mesh, 1 << 20)
        pat = _pattern(4 * BLOCK, 1, 249)
        sa.host_put(arena, 0, pat, 0)
        fabric.onesided_copy(arena, 0, 0, 0, 64 * BLOCK, 4 * BLOCK)
        fabric.onesided_copy(arena, 0, 0, 0, 128 * BLOCK, 4 * BLOCK,
                             force_remote=True)
        for off in (64 * BLOCK, 128 * BLOCK):
            got = sa.host_get(arena, 0, 4 * BLOCK, off).cpu().numpy()
            if not np.array_equal(got, pat):
                raise RuntimeError(f"mismatch at offset {off}")

        plane = SpmdIciPlane(ocm.OcmConfig(device_arena_bytes=1 << 20),
                             mesh=mesh, devices_per_rank=1)

        def handle(aid, off, n):
            return OcmAlloc(
                alloc_id=aid, kind=OcmKind.REMOTE_DEVICE, fabric=Fabric.ICI,
                nbytes=n, rank=0, device_index=0,
                extent=Extent(offset=off, nbytes=n), origin_rank=0,
            )

        n = 8 * BLOCK
        h_src, h_dst = handle(2, 0, n), handle(4, 128 * BLOCK, n)
        pat2 = _pattern(n, 1, 241)
        plane.put(h_src, pat2)
        plane.copy(h_dst, h_src, n)
        if not np.array_equal(plane.get(h_dst, n).cpu().numpy(), pat2):
            raise RuntimeError("handle-level one-sided copy mismatch")
        if plane.stats["ici_copies"] != 1:
            raise RuntimeError("handle copy did not ride ici_copy")
        return True
    except Exception as e:  # noqa: BLE001 — a failed check names its error
        errors["onesided_copy"] = f"{type(e).__name__}: {e}"
        return False


def check_dma_row_kernels(errors: dict, device) -> bool:
    """Put, get and same-device copy of >= 1 MiB extents through a
    LOCAL_DEVICE context: the paths of K1, K2 and K3 on a card
    (bench.py:342-366)."""
    try:
        dctx = ocm.ocm_init(ocm.OcmConfig(host_arena_bytes=1 << 20,
                                          device_arena_bytes=16 << 20),
                            device=device)
        try:
            hd = dctx.alloc(4 << 20, OcmKind.LOCAL_DEVICE)
            pat3 = _pattern(2 << 20, 1, 239)
            dctx.put(hd, pat3)
            if not np.array_equal(dctx.get(hd, 2 << 20).cpu().numpy(), pat3):
                raise RuntimeError("DMA row write/read mismatch")
            hd2 = dctx.alloc(2 << 20, OcmKind.LOCAL_DEVICE)
            dctx.copy(hd2, hd, 1 << 20)
            if not np.array_equal(dctx.get(hd2, 1 << 20).cpu().numpy(),
                                  pat3[:1 << 20]):
                raise RuntimeError("DMA row move mismatch")
        finally:
            dctx.tini()
        return True
    except Exception as e:  # noqa: BLE001
        errors["dma_row_kernels"] = f"{type(e).__name__}: {e}"
        return False


def run(device, arena_bytes: int = ARENA, nbytes: int = NBYTES,
        iters: int = ITERS, alloc_iters: int = 2000,
        timing: bool = True) -> dict:
    """Every copy leg on ``device``; returns the JSON object. The loops run
    over the first ``2 * nbytes`` of the context's device arena, through a
    handle that covers them, as ``bench.py`` runs them."""
    device = resolve_device(device)
    timing = timing and device.type == "cuda"
    detail: dict = {"copy_nbytes": nbytes, "iters": iters}
    out = {
        "metric": "ocm alloc+copy loop: one-card HBM arena copy bandwidth "
                  "(2x bytes, read+write)",
        "value": None, "unit": "GB/s", "vs_hbm": None,
        "device": torch.cuda.get_device_name(device) if timing else str(device),
        "detail": detail,
    }
    errors: dict[str, str] = {}
    stage_s = detail["stage_s"] = {}
    last = [time.monotonic()]

    def mark(name: str) -> None:
        now = time.monotonic()
        stage_s[name] = now - last[0]
        last[0] = now

    ctx = ocm.ocm_init(ocm.OcmConfig(host_arena_bytes=1 << 20,
                                     device_arena_bytes=arena_bytes),
                       device=device)
    try:
        try:
            alloc_us, free_us = bench_alloc_p50(ctx, alloc_iters)
        except Exception as e:  # noqa: BLE001 — never lose the other legs
            errors["alloc_p50"] = f"{type(e).__name__}: {e}"
            alloc_us = free_us = 0.0
        mark("alloc_p50")

        h = ctx.alloc(2 * nbytes, OcmKind.LOCAL_DEVICE)
        buf = ctx.device_arenas[0].buffer
        rates: dict[str, float | None] = {}

        def leg(name: str, loop, n_iters: int) -> None:
            try:
                rates[name] = _timed_gbps(loop, buf, nbytes, n_iters, timing)
            except Exception as e:  # noqa: BLE001
                errors[name] = f"{type(e).__name__}: {e}"
                rates[name] = 0.0
            mark(name)

        for streams in (2, 4):
            leg(f"copy_loop_s{streams}",
                lambda b, s=streams: copy_loops.copy_loop(b, nbytes, iters, s),
                iters)
        best = max((2, 4), key=lambda s: rates[f"copy_loop_s{s}"] or 0.0)
        leg("remote_loop", lambda b: copy_loops.remote_loop(b, nbytes, iters // 2),
            iters // 2)

        # Stamp 2S distinct segment patterns and re-run a loop: stream s
        # ping-pongs segments 2s <-> 2s+1, so afterwards each even segment
        # is intact and each odd one holds its partner's bytes — distinct
        # patterns catch aliased streams and dropped extents
        # (bench.py:514-562).
        def stamp_and_verify(nsegs: int, loop, label: str) -> None:
            seg = 2 * nbytes // nsegs
            pats = [_pattern(seg, m) for m in SEG_MULTS[:nsegs]]
            ctx.put(h, np.concatenate(pats), 0)
            loop(buf)
            probe = min(seg, 1 << 20)
            for i, pat in enumerate(pats):
                want = pat if i % 2 == 0 else pats[i - 1]
                got = ctx.get(h, probe, i * seg).cpu().numpy()
                if not np.array_equal(got, want[:probe]):
                    raise RuntimeError(f"{label} mismatch at segment {i}")

        checked = {}
        for name, nsegs, loop in (
            (f"copy_loop_s{best}", 2 * best,
             lambda b: copy_loops.copy_loop(b, nbytes, iters, best)),
            ("remote_loop", 4,
             lambda b: copy_loops.remote_loop(b, nbytes, iters // 2)),
        ):
            if name in errors:
                continue
            try:
                stamp_and_verify(nsegs, loop, name)
                checked[name] = True
            except Exception as e:  # noqa: BLE001 — drop the numbers, not the run
                errors[f"{name}_correctness"] = f"{type(e).__name__}: {e}"
                checked[name] = False
        if not checked.get(f"copy_loop_s{best}"):
            # Both stream counts ran the same kernel: none of its numbers
            # stand once its output is wrong.
            rates["copy_loop_s2"] = rates["copy_loop_s4"] = 0.0
        if not checked.get("remote_loop"):
            rates["remote_loop"] = 0.0
        mark("correctness")

        # The plain loop (bench.py's XLA leg, at ITERS // 4): one stream of
        # copy_ on slices, from a known first half.
        seg0 = _pattern(nbytes, 1)
        ctx.put(h, np.concatenate([seg0, np.zeros(nbytes, np.uint8)]), 0)
        leg("plain_loop",
            lambda b: copy_loops.copy_loop_plain(b, nbytes, iters // 4, 1),
            iters // 4)
        probe = min(nbytes, 1 << 20)
        if "plain_loop" not in errors and not np.array_equal(
                ctx.get(h, probe).cpu().numpy(), seg0[:probe]):
            errors["plain_loop_correctness"] = "plain loop mismatch"
            rates["plain_loop"] = 0.0
        ctx.free(h)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        ctx.tini()

    onesided_ok = check_onesided_copy(errors, device)
    mark("onesided_copy")
    dma_ok = check_dma_row_kernels(errors, device)
    mark("dma_rows")

    copy_best = rates[f"copy_loop_s{best}"]
    if timing:
        value = max(rates["plain_loop"], copy_best)
        out["value"] = value
        out["vs_hbm"] = value * 1e9 / hbm_rate(out["device"])
    detail.update({
        # bench.py's name for each field, where it differs:
        "plain_loop_gbps": rates["plain_loop"],             # xla_gbps
        "copy_loop_gbps": copy_best,                        # pallas_gbps
        "copy_loop_gbps_s2": rates["copy_loop_s2"],         # pallas_gbps_s2
        "copy_loop_gbps_s4": rates["copy_loop_s4"],         # pallas_gbps_s4
        "copy_loop_streams": best,                          # pallas_streams
        "remote_loop_gbps": rates["remote_loop"],           # pallas_remote_gbps
        "alloc_p50_us": alloc_us,
        "free_p50_us": free_us,
        "onesided_verified": onesided_ok,                   # pallas_ici_verified
        "dma_rows_verified": dma_ok,
        "hbm_gbps": hbm_rate(out["device"]) / 1e9 if timing else None,  # target_gbps
    })
    if errors:
        detail["errors"] = errors
    out["ok"] = not errors
    return out


def main() -> None:
    device = resolve_device(None)
    print(json.dumps(run(device)), flush=True)


if __name__ == "__main__":
    main()
