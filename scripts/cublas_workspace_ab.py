#!/usr/bin/env python3
"""What ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (the fixed cuBLAS workspace that
bit-equal steps under ``torch.use_deterministic_algorithms`` need) costs the
host, on one CUDA card:

    python3 scripts/cublas_workspace_ab.py

Four processes in the order off, on, on, off (cuBLAS reads the variable
when a process makes its first handle, so each setting needs a process of
its own). Each runs the eager kv_decode modes ``plain`` and ``device`` of
the small config (256 tokens, pages of 128; host-bound: thousands of
launches a token) and times 2000 back-to-back 64x64 products, host-bound
too. Prints one JSON line a process and the card's ``nvidia-smi`` line.
``chip_smoke.py`` runs its phase 9 in a process of its own for what this
shows.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from oncilla_tpu_torch.benchmarks.kv_decode import run_bench
r = run_bench(tokens_n=256, page_tokens=128, modes=("plain", "device"), config="small")
a = torch.randn(64, 64, device="cuda")
torch.cuda.synchronize()
t = time.perf_counter()
for _ in range(2000):
    a = a @ a * 0.01
torch.cuda.synchronize()
print(json.dumps({"CUBLAS_WORKSPACE_CONFIG": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
                  "tok_s": r["tok_s"],
                  "mm_64_us": (time.perf_counter() - t) / 2000 * 1e6}))
"""


def main() -> int:
    for on in (False, True, True, False):
        env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
        if on:
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        out = subprocess.run([sys.executable, "-c", CHILD, str(ROOT)], env=env,
                             capture_output=True, text=True, check=True, timeout=600)
        print(out.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
