"""Size-doubling one-sided bandwidth sweep (the counterpart of
``oncilla_tpu/benchmarks/sweep.py``).

The measurement shape of the reference's integration benchmark
(``test/ocm_test.c:323-402``): allocate one region, then for each size 64 B,
128 B, ... max, a separate WRITE pass and a separate READ pass of N
iterations each, reporting GB/s per size. Two flavours:

- :func:`size_sweep` drives the public ``put``/``get`` path on a local
  handle kind, with an optional third leg on the device: the same get timed
  as ``k`` back-to-back launches of the get kernel K2
  (:func:`oncilla_tpu_torch.ops.dma.read_rows_loop`).
- :func:`spmd_ring_sweep` times the fabric's ``ring_shift``: every row
  ships its chunk to the next row at once.

Rates are host-clock times around work that ends in a device synchronise
(:func:`._util.fence`), as in the JAX module. With ``timing=False``, and
always on the CPU, every leg runs and the budget is kept, but each rate is
None: a CPU run gives no device rate.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from oncilla_tpu_torch.benchmarks._util import fence as _force
from oncilla_tpu_torch.core.kinds import OcmKind
from oncilla_tpu_torch.utils.debug import printd


@dataclass
class SweepPoint:
    nbytes: int
    iters: int
    # None = leg skipped (write capped by write_max_bytes, the amortized
    # read unavailable for this size/kind, or no timing).
    write_gbps: float | None
    read_gbps: float | None
    # The same get as k launches of the get kernel, timed together.
    read_amortized_gbps: float | None = None


@dataclass
class SweepResult:
    label: str
    points: list[SweepPoint] = field(default_factory=list)
    # Sizes dropped because the sweep's wall-clock budget ran out.
    dropped: list[int] = field(default_factory=list)
    # Per-leg failures/skips ("amortized:<nbytes>" -> reason).
    errors: dict[str, str] = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "label": self.label,
            "points": [vars(p) for p in self.points],
            "dropped": list(self.dropped),
            "errors": dict(self.errors),
        }


def _doubling_sizes(min_bytes: int, max_bytes: int) -> list[int]:
    sizes, n = [], min_bytes
    while n <= max_bytes:
        sizes.append(n)
        n *= 2
    return sizes


def _read_amortized_gbps(ctx, h, nbytes: int, k: int,
                         errors: dict[str, str]) -> float | None:
    """The get of ``nbytes`` as ``k`` launches of the get kernel, best of two
    timed runs after a warm-up. None when the extent does not take the
    kernel (unaligned, small, or a CPU arena). A failure is recorded in
    ``errors`` and reads as None, so that the points already measured stand."""
    # Outside the try: a drift in these lookups must fail loudly.
    arena = ctx.device_arenas[h.device_index or 0]
    start = h.extent.offset
    if not arena._dma_eligible(start, nbytes):
        return None
    from oncilla_tpu_torch.ops.dma import read_rows_loop

    buf = arena.buffer
    try:
        out = read_rows_loop(buf, start, nbytes, k)  # warm-up
        _force(out)
        best = 0.0
        for _ in range(2):
            t0 = time.perf_counter()
            out = read_rows_loop(buf, start, nbytes, k)
            _force(out)
            best = max(best, nbytes * k / (time.perf_counter() - t0) / 1e9)
        return best
    except Exception as exc:  # noqa: BLE001 — an optional leg must not discard the sweep
        errors[f"amortized:{nbytes}"] = f"{type(exc).__name__}: {exc}"
        printd("amortized read leg failed at %d B: %r", nbytes, exc)
        return None


def size_sweep(
    ctx,
    kind: OcmKind = OcmKind.LOCAL_HOST,
    min_bytes: int = 64,
    max_bytes: int = 1 << 20,
    iters: int = 8,
    device_index: int = 0,
    budget_s: float | None = None,
    write_max_bytes: int | None = None,
    amortize_k: int = 0,
    amortize_min_bytes: int = 32 << 20,
    descending: bool = False,
    timing: bool = True,
) -> SweepResult:
    """Alloc one ``max_bytes`` region of ``kind``; per size, a write pass then
    a read pass of ``iters`` one-sided ops each. With ``budget_s``, sizes
    whose turn comes after the budget is spent are skipped and listed in
    ``result.dropped``.

    For LOCAL_DEVICE the write leg puts host bytes (numpy) into the device
    extent, over the host link; the read leg gets the extent as a tensor on
    the card, an on-device read. ``descending`` visits sizes largest first,
    so that under budget pressure the large points bank first;
    ``result.points`` is ascending either way. ``write_max_bytes`` skips the
    write leg above that size (None). ``amortize_k`` > 0 adds the third leg
    for LOCAL_DEVICE sizes >= ``amortize_min_bytes``. ``timing=False``, or
    a context on the CPU, reports every rate as None.
    """
    timing = timing and ctx.device.type == "cuda"
    h = ctx.alloc(max_bytes, kind, device_index=device_index) \
        if kind == OcmKind.LOCAL_DEVICE else ctx.alloc(max_bytes, kind)
    res = SweepResult(label=f"size_sweep:{kind.name}")
    rng = np.random.default_rng(0xB0)
    t_start = time.perf_counter()
    sizes = _doubling_sizes(min_bytes, max_bytes)
    if descending:
        sizes = sizes[::-1]

    def rate(x: float | None) -> float | None:
        return x if timing else None

    try:
        for nbytes in sizes:
            if (budget_s is not None
                    and time.perf_counter() - t_start > budget_s):
                res.dropped.append(nbytes)
                continue
            write_gbps: float | None = None
            if write_max_bytes is None or nbytes <= write_max_bytes:
                data = rng.integers(0, 256, nbytes, dtype=np.uint8)
                ctx.put(h, data)  # warm-up
                _force(ctx.get(h, 8))
                t0 = time.perf_counter()
                for _ in range(iters):
                    ctx.put(h, data)
                _force(ctx.get(h, 8))  # fence the last write
                wt = time.perf_counter() - t0
                write_gbps = rate(nbytes * iters / wt / 1e9)

            out = ctx.get(h, nbytes)
            _force(out)
            t0 = time.perf_counter()
            for _ in range(iters):
                out = ctx.get(h, nbytes)
            _force(out)
            rt = time.perf_counter() - t0

            amortized: float | None = None
            if (amortize_k > 0 and nbytes >= amortize_min_bytes
                    and kind == OcmKind.LOCAL_DEVICE):
                # Re-check the budget: the leg reads 3·k·nbytes more.
                if (budget_s is not None
                        and time.perf_counter() - t_start > budget_s):
                    res.errors[f"amortized:{nbytes}"] = "skipped: budget"
                else:
                    amortized = rate(_read_amortized_gbps(
                        ctx, h, nbytes, amortize_k, res.errors))
            res.points.append(SweepPoint(
                nbytes=nbytes, iters=iters, write_gbps=write_gbps,
                read_gbps=rate(nbytes * iters / rt / 1e9),
                read_amortized_gbps=amortized,
            ))
    finally:
        ctx.free(h)
    res.points.sort(key=lambda p: p.nbytes)
    res.dropped.sort()
    return res


def spmd_ring_sweep(
    mesh=None,
    min_bytes: int = 1 << 10,
    max_bytes: int = 1 << 24,
    iters: int = 16,
    arena_bytes: int | None = None,
    timing: bool = True,
) -> SweepResult:
    """All-rows sweep on the fabric: per size, ``iters`` ring shifts (every
    row sends and receives ``nbytes``) timed end to end; reports GB/s per
    row (bytes each row sends / time). ``mesh`` is the rows' devices
    (:func:`oncilla_tpu_torch.parallel.mesh.node_mesh`, every CUDA device by
    default)."""
    from oncilla_tpu_torch.parallel import spmd_arena as sa
    from oncilla_tpu_torch.parallel.mesh import node_mesh

    mesh = node_mesh(mesh)
    timing = timing and all(d.type == "cuda" for d in mesh)
    if arena_bytes is None:
        arena_bytes = max_bytes
    if arena_bytes < max_bytes:
        raise ValueError(
            f"arena_bytes ({arena_bytes}) must hold the largest chunk "
            f"(max_bytes={max_bytes})"
        )
    arena = sa.make_arena(mesh, arena_bytes)

    def fence_rows() -> None:
        for row in arena.rows:
            _force(row)

    res = SweepResult(label=f"spmd_ring_sweep:{len(mesh)}dev")
    for nbytes in _doubling_sizes(min_bytes, max_bytes):
        arena = sa.ring_shift(arena, 0, nbytes)  # warm-up
        fence_rows()
        t0 = time.perf_counter()
        for _ in range(iters):
            arena = sa.ring_shift(arena, 0, nbytes)
        fence_rows()
        dt = time.perf_counter() - t0
        gbps = nbytes * iters / dt / 1e9 if timing else None
        res.points.append(
            SweepPoint(nbytes=nbytes, iters=iters, write_gbps=gbps, read_gbps=gbps)
        )
    return res


def main(argv=None) -> None:
    import argparse
    import json

    import oncilla_tpu_torch as ocm

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=["local", "ring"], default="local")
    ap.add_argument("--kind", default="LOCAL_DEVICE")
    ap.add_argument("--min-bytes", type=int, default=64)
    ap.add_argument("--max-bytes", type=int, default=1 << 24)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)

    if args.mode == "ring":
        res = spmd_ring_sweep(
            min_bytes=args.min_bytes, max_bytes=args.max_bytes, iters=args.iters
        )
    else:
        ctx = ocm.ocm_init(ocm.OcmConfig(
            host_arena_bytes=2 * args.max_bytes,
            device_arena_bytes=2 * args.max_bytes,
        ))
        try:
            res = size_sweep(ctx, OcmKind[args.kind], min_bytes=args.min_bytes,
                             max_bytes=args.max_bytes, iters=args.iters)
        finally:
            ocm.ocm_tini(ctx)
    print(json.dumps(res.as_dict()))


if __name__ == "__main__":
    main()
