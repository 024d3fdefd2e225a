"""The readings a cell's limits are set from, on the card at the cell's
own size: for each seed, a whole run (set-up, a window at the cell's
load, the sample) whose served tokens are checked against the reference,
and the control (the reference in float8 in the program's place) read at
the same positions. One process for all the seeds.

    python3 e2ebench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 40

Prints one JSON line a seed: the program's widest gap, the control's, and
the tokens compared.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from e2ebench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    a = ap.parse_args(argv)
    for seed in (int(s) for s in a.seeds.split(",")):
        out = run.run(a.workload, seed, a.seconds, False,
                      t_start=time.perf_counter(), control=bool(a.control))
        if out is None:
            return 2
        print(json.dumps({"seed": seed, **out}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
