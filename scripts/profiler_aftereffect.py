#!/usr/bin/env python3
"""Whether ``torch.profiler`` sessions slow the host's kernel launches after
they have ended, on one CUDA card:

    python3 scripts/profiler_aftereffect.py [--tokens 64]

Eager decode issues ~2635 kernels a token, so a few microseconds more a
launch show as tens of milliseconds a token. In one process this script
probes twice before and twice after ``chip_smoke.py``'s phase-3 timings
(which open the profiler sessions of ``kernel_times.device_ms``). A probe
is the host's issue time a call (``kernel_times.host_us``) of a one-kernel
PyTorch op on 4 KiB (``add_``) and of the K1 and K2 wrappers at 4 KiB, and
the tokens/s of unpaged Llama-3-8B decode (random weights from a seed,
batch 1, ``kv_decode.bench_plain`` over ``--tokens`` tokens). Prints one
JSON line with every probe and the card's ``nvidia-smi`` line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from oncilla_tpu_torch.benchmarks import kernel_times as kt  # noqa: E402
from oncilla_tpu_torch.benchmarks import kv_decode  # noqa: E402
from oncilla_tpu_torch.models import llama  # noqa: E402
from oncilla_tpu_torch.ops import dma  # noqa: E402

KiB, MiB, GiB = 1 << 10, 1 << 20, 1 << 30


def probe(arena, small, params, cfg, ids) -> dict:
    return {
        "host_us_add": kt.host_us(lambda: small.add_(1)),
        "host_us_write_rows": kt.host_us(lambda: dma.write_rows(arena, small, 0)),
        "host_us_read_rows": kt.host_us(lambda: dma.read_rows(arena, 0, small.numel())),
        "decode_tok_s": kv_decode.bench_plain(params, cfg, ids),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_aftereffect: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    gen = torch.Generator(device=device).manual_seed(1)
    ids = torch.randint(0, cfg.vocab, (1, args.tokens), generator=gen, device=device)
    arena = torch.zeros(MiB, dtype=torch.uint8, device=device)
    small = torch.zeros(4 * KiB, dtype=torch.uint8, device=device)

    out = {"before": [], "after": []}
    for _ in range(2):
        out["before"].append(probe(arena, small, params, cfg, ids))
        print(f"[before] {json.dumps(out['before'][-1])}", flush=True)
    chip_smoke.phase_kernels(device, 16 * GiB, (), base=5 * GiB + 12 * KiB,
                             copy_gap=4 * GiB + 4096, rate=card["hbm_rate"],
                             timed=(chip_smoke.PAGE, GiB))
    for _ in range(2):
        out["after"].append(probe(arena, small, params, cfg, ids))
        print(f"[after] {json.dumps(out['after'][-1])}", flush=True)
    print(json.dumps({"profiler_aftereffect": out, "tokens": args.tokens,
                      "card": card["smi"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
