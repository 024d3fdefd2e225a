"""The oncilla bench on one card: ``bench.py``'s measurement path in the port.

Prints one JSON line in ``bench.py``'s shape: ``metric``, ``value`` (GB/s of
HBM traffic, 2 bytes a copied byte), ``unit``, ``vs_hbm`` (``value`` over the
card's datasheet memory rate, not a TPU's), ``device``, ``detail`` and, last,
``ok``. Its stages, in ``bench.py``'s order (``_run``, bench.py:411-752),
each within the run's budget (``OCM_BENCH_DEADLINE_S``, 840 s by default) and
each banking its own error under ``detail.errors`` so that a failed stage
costs only its own fields:

- the copy legs and their checks (:func:`.copy_bench.run`: alloc/free p50,
  the plain loop, K9 at 2 and 4 streams, K10, the segment checks, the
  one-sided and DMA-row checks), which give the headline;
- ``ceiling``: the HBM ceiling probes K6-K8 (:func:`.ceiling.ceiling_probe`);
- ``gb_sweep``: the size sweep over a 2 GiB + 256 MiB device arena, 128 MiB
  to 1 GiB largest first and then 1 KiB to 64 MiB, each point
  ``[write, read, read_amortized]`` (:func:`bench_gb_sweep`);
- ``mfu_forward`` and ``mfu_train`` (bench.py:672-694): the 1.1B decoder's
  forward MFU (``detail.mfu``, ``mfu_forward_tflops``) and the best train
  variant's (``detail.mfu_train``, ``mfu_train_tflops``,
  ``mfu_train_variants``) against the card's datasheet bf16 rate
  (:mod:`.mfu`);
- ``dcn_early`` (after ``gb_sweep``) and ``dcn_tail`` (last): the wire
  legs (:func:`bench_dcn`, :mod:`.dcn`): the stripe × window sweep over the
  native daemon pair (Python daemons where the native one cannot be built;
  ``native_daemons`` says which ran), the fabric sweep (tcp against shm) and
  the Python-against-native daemon sweep, at 256 MiB, every rate in Gbit/s.
  A verified fresh result replaces what is banked; an unverified one only
  fills an empty slot;
- ``gups`` (after ``mfu_train``): GUPS over an ocm handle's extent,
  :func:`.gups.gups_handle_best` at a 16 MiB table;
- ``serving``: the serving harness, ``python -m oncilla_tpu_torch.serving
  --bench`` in a subprocess on the bench's device, its JSON line under
  ``detail.serving`` (:func:`bench_serving`);
- ``kv_decode``: paged-KV decode tokens/s, the small config, 256 tokens in
  pages of 128.

``ok`` is true when ``detail.errors`` is empty: a stage skipped or failed
fails the line. Grade a line with :mod:`.check`.

Run on a CUDA machine: ``python -m oncilla_tpu_torch.benchmarks.bench``.
Without CUDA it raises ``OcmDeviceError``; there is no fallback to the CPU.
:func:`run` takes a device and sizes, and with ``timing=False`` (on the
CPU, say) runs every stage and its checks with every rate None.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

import oncilla_tpu_torch as ocm
from oncilla_tpu_torch import OcmKind
from oncilla_tpu_torch.benchmarks import copy_bench
from oncilla_tpu_torch.utils.platform import resolve_device

_REPO = Path(__file__).resolve().parents[2]

GB_ARENA = (2 << 30) + (256 << 20)
# (min, max, iters, share of the stage's seconds, write cap, descending):
# bench.py:880-883. The GB range runs first and largest first, its write
# legs capped at 256 MiB.
GB_RANGES = (
    (128 << 20, 1 << 30, 1, 0.65, 256 << 20, True),
    (1 << 10, 64 << 20, 4, 0.35, None, False),
)


def bench_gb_sweep(errors: dict, seconds: float = 205.0, device=None,
                   timing: bool = True, arena_bytes: int = GB_ARENA,
                   ranges=GB_RANGES) -> dict:
    """bench.py's ``bench_gb_sweep`` (bench.py:844-909): per size
    ``[write, read, read_amortized]`` GB/s; ``seconds`` bounds the stage and
    is split across the ranges; sizes left out are listed under
    ``dropped``."""
    from oncilla_tpu_torch.benchmarks.sweep import size_sweep

    try:
        ctx = ocm.ocm_init(ocm.OcmConfig(host_arena_bytes=1 << 20,
                                         device_arena_bytes=arena_bytes),
                           device=device)
        points, dropped = [], []
        try:
            for lo, hi, iters, share, wcap, desc in ranges:
                res = size_sweep(
                    ctx, OcmKind.LOCAL_DEVICE, min_bytes=lo, max_bytes=hi,
                    iters=iters, budget_s=share * seconds, write_max_bytes=wcap,
                    amortize_k=8, descending=desc, timing=timing,
                )
                points.extend(res.points)
                dropped.extend(res.dropped)
                for key, msg in res.errors.items():
                    errors[f"gb_sweep {key}"] = msg
        finally:
            ctx.tini()
        out = {str(p.nbytes): [p.write_gbps, p.read_gbps, p.read_amortized_gbps]
               for p in points}
        if dropped:
            out["dropped"] = sorted(dropped)
        return out
    except Exception as e:  # noqa: BLE001 — a failed stage costs its own fields
        errors["gb_sweep"] = f"{type(e).__name__}: {e}"
        return {}


def bench_dcn(errors: dict, nbytes: int = 256 << 20) -> dict:
    """bench.py's ``bench_dcn`` (bench.py:755-808): the stripe × window
    sweep over one daemon pair (the native daemon, else the Python one),
    its headline the best cell and ``single_*_gbps`` the single-stream
    baseline; then the fabric sweep (``fabric``) at ``nbytes`` and the
    Python-against-native daemon sweep (``native``). Every rate is Gbit/s.
    The wire carries host buffers: no card memory is touched."""
    from oncilla_tpu_torch.benchmarks.dcn import (
        dcn_daemon_sweep,
        dcn_fabric_sweep,
        dcn_stripe_sweep,
    )

    try:
        try:
            r = dcn_stripe_sweep(nbytes=nbytes, iters=1, native=True)
        except Exception:  # noqa: BLE001 — native daemon unavailable: measure anyway
            r = dcn_stripe_sweep(nbytes=nbytes, iters=1, native=False)
        out = {
            "put_gbps": round(r["put_gbps"], 3),
            "get_gbps": round(r["get_gbps"], 3),
            "single_put_gbps": round(r["single_put_gbps"], 3),
            "single_get_gbps": round(r["single_get_gbps"], 3),
            "striped_put_gbps": round(r["striped_put_gbps"], 3),
            "striped_get_gbps": round(r["striped_get_gbps"], 3),
            "unit": r.get("unit", "Gbit/s"),
            "best": r["best"],
            "cells": r["cells"],
            "nbytes": r["nbytes"],
            "native_daemons": r["native_daemons"],
            "verified": r["verified"],
        }
        try:
            out["fabric"] = dcn_fabric_sweep(sizes=(nbytes,), iters=1)
        except Exception as e:  # noqa: BLE001
            errors["dcn_fabric"] = f"{type(e).__name__}: {e}"
        try:
            out["native"] = dcn_daemon_sweep(nbytes=nbytes, iters=1)
        except Exception as e:  # noqa: BLE001
            errors["dcn_native"] = f"{type(e).__name__}: {e}"
        return out
    except Exception as e:  # noqa: BLE001
        errors["dcn"] = f"{type(e).__name__}: {e}"
        return {}


def bench_serving(errors: dict, timeout_s: float = 420.0, device=None) -> dict:
    """bench.py's ``bench_serving`` (bench.py:811-841): ``python -m
    oncilla_tpu_torch.serving --bench`` in a subprocess on ``device`` (the
    engine belongs on the card; the process keeps its cluster and graphs
    out of this one); its last stdout line, parsed."""
    if device is not None and device.type == "cuda":
        torch.cuda.empty_cache()  # the subprocess's engine needs the card
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_REPO), env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "oncilla_tpu_torch.serving", "--bench"]
    if device is not None:
        cmd += ["--device", str(device)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout_s, env=env)
        if r.returncode != 0:
            errors["serving"] = f"rc={r.returncode}: {r.stderr.strip()[-300:]}"
            return {}
        return json.loads(r.stdout.strip().splitlines()[-1])
    except subprocess.TimeoutExpired:
        errors["serving"] = f"timed out after {timeout_s:.0f}s"
        return {}
    except Exception as e:  # noqa: BLE001 — a failed stage costs its own fields
        errors["serving"] = f"{type(e).__name__}: {e}"
        return {}


def _rounded(x, digits: int):
    return None if x is None else round(x, digits)


def run(device=None, deadline_s: float = 840.0, timing: bool = True,
        copy_kw: dict | None = None, ceiling_kw: dict | None = None,
        gb_kw: dict | None = None, kv_kw: dict | None = None,
        mfu_kw: dict | None = None, dcn_kw: dict | None = None,
        gups_kw: dict | None = None, dcn_tail: bool = True) -> dict:
    """Every stage on ``device``; returns the JSON object. ``*_kw`` override
    a stage's sizes (the defaults are bench.py's); ``mfu_kw`` holds
    ``forward`` (:func:`.mfu.mfu_forward`'s arguments) and ``train``
    (:func:`.mfu.mfu_train_best`'s, ``variants`` among them). ``dcn_tail``
    False leaves out the wire's re-run at the end (``chip_smoke.py``, whose
    time limit the bench shares, keeps the early echo alone)."""
    from oncilla_tpu_torch.benchmarks import mfu
    from oncilla_tpu_torch.benchmarks.ceiling import ceiling_probe
    from oncilla_tpu_torch.benchmarks.gups import gups_handle_best
    from oncilla_tpu_torch.benchmarks.kv_decode import run_bench

    device = resolve_device(device)
    timing = timing and device.type == "cuda"
    deadline = time.monotonic() + deadline_s
    detail: dict = {}
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

    def time_left() -> float:
        return deadline - time.monotonic()

    def budgeted(name: str, seconds_needed: float) -> bool:
        if time_left() < seconds_needed:
            errors[name] = f"skipped: {time_left():.0f}s left of budget"
            return False
        return True

    # The copy legs bank the headline first; every later stage is optional.
    legs = copy_bench.run(device, timing=timing, **(copy_kw or {}))
    errors.update(legs["detail"].pop("errors", {}))
    detail["copy_stage_s"] = legs["detail"].pop("stage_s")
    detail.update(legs["detail"])
    out["value"], out["vs_hbm"] = legs["value"], legs["vs_hbm"]
    mark("copy_legs")

    if budgeted("ceiling", 150):
        try:
            detail["ceiling"] = ceiling_probe(
                deadline=time.monotonic() + min(300.0, time_left() - 60.0),
                device=device, timing=timing, **(ceiling_kw or {}))
        except Exception as e:  # noqa: BLE001
            errors["ceiling"] = f"{type(e).__name__}: {e}"
    mark("ceiling")

    if budgeted("gb_sweep", 60):
        detail["gb_sweep"] = bench_gb_sweep(
            errors, seconds=max(30.0, min(420.0, time_left() - 120.0)),
            device=device, timing=timing, **(gb_kw or {}))
    mark("gb_sweep")

    def bank_dcn() -> None:
        """A verified fresh result replaces whatever is banked (and clears
        a stale failure note); an unverified one only fills an empty slot
        (bench.py:651-660)."""
        fresh = bench_dcn(errors, **(dcn_kw or {}))
        if fresh.get("verified"):
            detail["dcn"] = fresh
            errors.pop("dcn", None)
        elif not detail.get("dcn"):
            detail["dcn"] = fresh

    # The wire early (bench.py:665-667), and again at the very end.
    if "dcn" not in detail and budgeted("dcn_early", 45):
        bank_dcn()
    mark("dcn_early")

    # The 1.1B decoder's MFU: bench.py's two stages, each within 240 s.
    mfu_kw = mfu_kw or {}
    if budgeted("mfu_forward", 240):
        try:
            fwd = mfu.mfu_forward(device=device, **mfu_kw.get("forward", {}))
            detail["mfu"] = _rounded(fwd["mfu"], 4) if timing else None
            detail["mfu_forward_tflops"] = (
                _rounded(fwd["tflops"], 2) if timing else None)
        except Exception as e:  # noqa: BLE001
            errors["mfu_forward"] = f"{type(e).__name__}: {e}"
    mark("mfu_forward")
    if budgeted("mfu_train", 240):
        try:
            trn = mfu.mfu_train_best(
                deadline=time.monotonic() + min(300.0, time_left() - 120.0),
                device=device, **mfu_kw.get("train", {}))
            detail["mfu_train"] = _rounded(trn["mfu"], 4) if timing else None
            detail["mfu_train_tflops"] = (
                _rounded(trn["tflops"], 2) if timing else None)
            detail["mfu_train_variants"] = [
                {**v, "mfu": v.get("mfu") if timing else None}
                for v in trn["variants"]]
        except Exception as e:  # noqa: BLE001
            errors["mfu_train"] = f"{type(e).__name__}: {e}"
    mark("mfu_train")

    # GUPS over a handle's extent (bench.py:701-710); conservation gates it.
    if budgeted("gups", 120):
        try:
            g = gups_handle_best(**{"words": 1 << 22, "batch": 1 << 20,
                                    "steps": 32, **(gups_kw or {}),
                                    "device": device})
            detail["gups"] = _rounded(g["gups"], 4) if timing else None
            detail["gups_method"] = g["mode"]
            detail["gups_updates"] = g["updates"]
            detail["gups_table_sum"] = g["table_sum"]
        except Exception as e:  # noqa: BLE001
            errors["gups"] = f"{type(e).__name__}: {e}"
    mark("gups")

    # The serving harness in a subprocess (bench.py:722-727).
    if budgeted("serving", 150):
        detail["serving"] = bench_serving(
            errors, timeout_s=min(420.0, max(time_left() - 90.0, 120.0)),
            device=device)
    mark("serving")

    if budgeted("kv_decode", 200):
        try:
            kv = run_bench(**{"tokens_n": 256, "page_tokens": 128,
                              **(kv_kw or {}), "device": device})
            detail["kv_decode_tok_s"] = (
                kv["tok_s"] if timing else dict.fromkeys(kv["tok_s"]))
            if timing and "paging_overhead" in kv:
                detail["kv_paging_overhead"] = kv["paging_overhead"]
        except Exception as e:  # noqa: BLE001
            errors["kv_decode"] = f"{type(e).__name__}: {e}"
    mark("kv_decode")

    # The wire again after the heavy stages (bench.py:750-751); a failed or
    # skipped tail never clobbers the early echo.
    if dcn_tail and budgeted("dcn_tail", 60):
        bank_dcn()
    mark("dcn_tail")

    detail["errors"] = errors
    out["ok"] = not errors
    return out


def main() -> None:
    try:
        budget = float(os.environ.get("OCM_BENCH_DEADLINE_S", "840"))
    except ValueError:
        budget = 840.0
    device = resolve_device(None)
    print(json.dumps(run(device, deadline_s=budget)), flush=True)


if __name__ == "__main__":
    main()
