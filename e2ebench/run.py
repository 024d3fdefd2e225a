"""The end-to-end benchmark of ``oncilla_tpu_torch`` on one card.

    python3 e2ebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration file, the model family its ``model_type`` names
(``families/<model_type>.py``), its traffic mix (``traffic/<name>.json``),
the adapter the mix names (``adapters/<name>.py``), its limits
(``cells/<cell>.json``) and a reader a per-layer metric
(``metrics/<name>.py``). A run makes the weights and inputs from the seed,
sets the system up and warms every shape the traffic meets (``setup_s``),
measures for ``--seconds``, then checks a sample of what the window served
against the plain reference (``reference/``); a CUDA graph captured inside
the window is set-up work that leaked into it, and makes the run not
correct (``captures_in_window``, limit 0). The last line of standard
output is one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error and the line's last key. With
``--trace 1`` the line carries the per-layer metrics, read over the window
and, for the device's, over a profiled stretch of it.

It exits nonzero, with no result, without CUDA or with fewer cards than
the cell asks for, and when JAX or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Caches of anything the run may build, at fixed paths inside the checkout
# (the port builds its kernels into ROOT/build/oncilla_tpu_torch itself).
_CACHE = ROOT / "build" / "e2ebench"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"

import numpy as np  # noqa: E402
import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "oncilla_tpu")


def log(msg: str) -> None:
    print(f"[e2ebench] {msg}", file=sys.stderr, flush=True)


def load_cell(workload: str) -> dict:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return {
        "cell": cell,
        "cfg": json.loads((ROOT / conf["file"]).read_text()),
        "mix": json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((HERE / "cells" / f"{workload}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def loaded_forbidden() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (``oncilla_tpu_torch`` is not
    ``oncilla_tpu``)."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


class Readings:
    """What a per-layer metric's reader reads; ``d`` is the model's sizes
    (its family's ``dims``) and ``family`` the family module
    (:mod:`e2ebench.families`)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def end_to_end(name: str, s: dict, setup_s: float):
    from e2ebench.stats import percentile

    if name == "setup_s":
        return setup_s
    if name == "decode_tok_s":
        return s["tokens"] / s["seconds"]
    if name == "ttft_p90_s":
        return percentile(s["ttft_s"], 90)
    if name == "itl_p95_ms":
        p = percentile(s["itl_s"], 95)
        return None if p is None else p * 1e3
    raise KeyError(f"no end-to-end metric {name!r}")


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device=None, spec=None,
        t_start: float = T_START, control: bool = False) -> dict | None:
    """One run; returns the result line's object, or None after printing
    why there is none. ``device`` and ``spec`` (a cell as :func:`load_cell`
    gives it, here at tiny widths, or one no cell of ``BENCHMARK.json``
    drives yet) are the CPU rehearsal's (the tests'): a card run takes
    none. ``control`` also reads the control
    (``calibrate.py``); the benchmark's own runs never do."""
    from e2ebench import check, devtrace, families, weights, yardstick

    spec = spec or load_cell(workload)
    cfg, mix = spec["cfg"], spec["mix"]
    family = families.of(cfg)
    chips = spec["cell"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"needs {chips} CUDA card(s); torch sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return None
        device = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(device)
    else:
        device = torch.device(device)
        kind = "cpu"
    on_card = device.type == "cuda"

    params = weights.make(cfg, seed, device)
    adapter_mod = importlib.import_module(f"e2ebench.adapters.{mix['adapter']}")
    adapter = adapter_mod.Adapter(cfg, mix, seed, device, params, log)
    warm = adapter.warm_up()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; warm-up {json.dumps(warm)}")

    stretch = None
    if trace:
        tr = mix["trace"]
        stretch = devtrace.Stretch(device, tr["start_s"], tr["seconds"])
    win = adapter.run(seconds, stretch)
    samples = adapter.samples()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    inside = win["end"]["captured"] - win["start"]["captured"]
    log(f"window {samples['seconds']:.3f} s; graph captures inside it "
        f"{inside}; memory_peak_bytes {peak}; reserved "
        f"{torch.cuda.memory_reserved(device) if on_card else 0}")
    tsum = stretch.read() if stretch is not None else None
    d = family.dims(cfg)
    peak_flops, peak_hbm = yardstick.peaks(kind) if on_card else (None, None)

    e2e = {m["name"]: end_to_end(m["name"], samples, setup_s)
           for m in spec["end_to_end"]}
    log(f"end to end {json.dumps(e2e)} over {samples['tokens']} tokens, "
        f"{len(samples.get('ttft_s', []))} first tokens, "
        f"{len(samples.get('itl_s', []))} gaps")
    metrics = {}
    if not trace:
        for m in spec["end_to_end"]:
            if e2e[m["name"]] is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    elif on_card:
        r = Readings(d=d, family=family, start=win["start"], end=win["end"],
                     trace=tsum, computed=adapter.computed_tokens(),
                     window_s=samples["seconds"] - stretch.overhead_s,
                     peak_flops=peak_flops,
                     peak_hbm=peak_hbm, page_bytes=adapter.page_bytes,
                     pages=getattr(adapter, "pages", []),
                     stretch=(stretch.t0, stretch.t1),
                     batch=mix.get("batch", 0))
        for m in spec["per_layer"]:
            reader = importlib.import_module(f"e2ebench.metrics.{m['name']}")
            v = reader.read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    lim = spec["limits"]
    picked = adapter.sample(np.random.default_rng([abs(seed), 7]),
                            mix["check"]["sample_tokens"])
    short = adapter.short_answers()
    attempted = adapter.attempted()
    adapter.close()
    del adapter
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    t = time.perf_counter()
    got = check.compare(picked, params, cfg, control)
    log(f"reference over {got['requests']} requests, {got['tokens']} served "
        f"tokens: {time.perf_counter() - t:.3f} s")

    found = loaded_forbidden()
    if found:
        log(f"loaded after the window: {', '.join(found)}")
        return None
    checks = {
        "mean_gap": [got["mean_gap"], lim["mean_gap"]],
        "tokens_checked": [got["tokens"], mix["check"]["min_tokens"]],
        "short_answers": [short, 0],
        "captures_in_window": [inside, 0],
    }
    correct = (got["mean_gap"] <= lim["mean_gap"]
               and got["tokens"] >= mix["check"]["min_tokens"] and short == 0
               and inside == 0)
    log(f"widest gap {got['widest_gap']} (printed, not compared)")
    device_block = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                    "count": chips if on_card else 0,
                    "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": short, "metrics": metrics, "device": device_block}
    if trace and tsum is not None:
        device_block["busy_s"] = tsum["busy_s"]
        device_block["window_s"] = tsum["window_s"]
        out["breakdown"] = {
            "device_ops": devtrace.top({k: v[1] for k, v in tsum["kernels"].items()}),
            "idle_gaps": devtrace.top(tsum["idle"])}
    if on_card:
        log(f"card {power_limit()}; peaks {peak_flops} FLOP/s bf16, "
            f"{peak_hbm} B/s HBM")
    if control:
        out["calibration"] = got
    out["checks"] = {k: {"value": v, "limit": lm} for k, (v, lm) in checks.items()}
    for k, (v, lm) in checks.items():
        print(f"check {k} {v} limit {lm}", file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    out = run(a.workload, a.seed, a.seconds, bool(a.trace))
    if out is None:
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
