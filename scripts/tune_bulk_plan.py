#!/usr/bin/env python3
"""The tuning table of the bulk copy's plan (``oncilla_tpu_torch/csrc/
copy.cuh`` bulk_copy, the body of every one-shot copy of the port: K1's put,
K2's get, K3's same-device copy and K4), on one CUDA card:

    python3 scripts/tune_bulk_plan.py

K2's kernel under every candidate plan in ``CANDIDATES`` (tile, ring slots,
CTAs a SM), each held byte for byte against ``Tensor.copy_`` at sizes that
end on a short tile at offsets off the tile grid, then timed at one cold
16 MiB page and at 1 GiB (``oncilla_tpu_torch.benchmarks.kernel_times``)
beside ``Tensor.copy_``. Prints one JSON line a row. The plan kept in
``ops/dma.py`` (``BULK_TILE``, ``BULK_SLOTS``, ``BULK_CTAS_PER_SM``) is the
row this table picked (PERF.md).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from oncilla_tpu_torch.benchmarks import kernel_times as kt  # noqa: E402
from oncilla_tpu_torch.ops import dma  # noqa: E402
from oncilla_tpu_torch.utils.platform import hbm_rate, resolve_device  # noqa: E402

KiB, MiB, GiB = 1 << 10, 1 << 20, 1 << 30
PAGE = 16 * MiB  # one Llama-3-8B KV page of 128 tokens

# (tile bytes, ring slots, CTAs a SM): tiles of at most 32 KiB, a ring of
# at least 2 slots and at most the 227 KB a CTA may hold, one or two CTAs
# a SM.
CANDIDATES = (
    (32 * KiB, 6, 1), (32 * KiB, 4, 1), (32 * KiB, 3, 2), (16 * KiB, 12, 1),
    (16 * KiB, 8, 1), (16 * KiB, 6, 2), (16 * KiB, 4, 2), (8 * KiB, 12, 2),
)


def tune(device=None, page: int = PAGE, big: int = GiB,
         check_sizes=(4 * KiB, 36 * KiB, MiB + 4 * KiB, PAGE, GiB + 4 * KiB)) -> list[dict]:
    """The table's rows. Raises if a candidate's bytes differ from
    ``copy_``'s."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("the tuning table is measured on a CUDA card")
    lib = dma.library("dma.cu", dma._SIGNATURES)
    rate = hbm_rate(torch.cuda.get_device_name(device))
    # Source and destination regions, each at a BLOCK-aligned offset that is
    # not a multiple of 32 KiB, each room for 8 pages or 1 GiB + 4 KiB.
    span = max(kt.rotation(page) * page, big + 4 * KiB)
    src0, dst0 = 12 * KiB, 12 * KiB + span + 20 * KiB
    arena = torch.empty(dst0 + span, dtype=torch.uint8, device=device)
    arena.random_(0, 256, generator=torch.Generator(device=device).manual_seed(5))
    base = arena.data_ptr()
    sms = dma.sm_count(arena)
    stream = torch.cuda.current_stream(device).cuda_stream

    def bulk(plan_of):
        def run(s, d, n):
            dma.check(lib, lib.ocm_read_rows(device.index, base + src0 + s,
                                             base + dst0 + d, 0, n, *plan_of(n),
                                             stream), "tune")
        return run

    def library(s, d, n):
        arena[dst0 + d:dst0 + d + n].copy_(arena[src0 + s:src0 + s + n])

    rows = [(f"bulk tile={t // KiB}KiB slots={k} ctas/SM={c}", bulk(
        lambda n, t=t, k=k, c=c: (min(-(-n // t), c * sms), t, k)), kt.BULK)
        for t, k, c in CANDIDATES]
    rows.append(("Tensor.copy_", library, kt.MEMCPY))
    out = []
    for name, run, names in rows:
        for n in check_sizes:
            arena[dst0:dst0 + n].zero_()
            run(0, 0, n)
            if not torch.equal(arena[dst0:dst0 + n], arena[src0:src0 + n]):
                raise AssertionError(f"{name} differs from its source at {n} B")
        rec = {"row": name}
        for label, n in (("page", page), ("1gib", big)):
            calls = [lambda i=i, n=n: run(i * n, i * n, n) for i in range(kt.rotation(n))]
            rec[f"{label}_ms"] = kt.cold_ms(calls)
            rec[f"{label}_device_ms"], rec[f"{label}_device_by"] = kt.device_ms(calls, names)
            rec[f"{label}_bound_ms"] = 2 * n / rate * 1e3
        out.append(rec)
    return out


if __name__ == "__main__":
    for rec in tune():
        print(json.dumps(rec), flush=True)
