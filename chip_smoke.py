#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives only ``oncilla_tpu_torch`` (no JAX), in phases; any failure exits
nonzero with a traceback and nothing ``ok`` is printed after it:

1. device  — the card's name and power limit (``nvidia-smi``).
2. build   — builds the CUDA kernels from ``oncilla_tpu_torch/csrc``.
3. kernels — each copy kernel (write_rows, read_rows, local_copy) against
   its plain PyTorch version, byte for byte, at 4 KiB .. 1 GiB at offsets
   above 4 GiB of a 16 GiB arena; times of the kernel, the plain version
   and one PyTorch ``copy_`` on the same slices (CUDA events), beside the
   bound 2*nbytes / datasheet HBM rate.
4. ocm_test loop — ``ocm_init`` on a 16 GiB device arena: alloc, put, get,
   copy and free at 4 KiB .. 1 GiB on LOCAL_DEVICE and LOCAL_HOST, the copy
   matrix, scrub-on-free, the typed errors, the alloc p50; the kernels'
   launch counters must rise.
5. serving — Llama-3-8B geometry (bf16, seeded random weights on the card):
   3 paged-decode requests through ``BucketedPagedDecoder`` (LOCAL_DEVICE
   pages of 128 tokens, refetch), each 512 teacher-forced prompt tokens
   then 128 greedy tokens; launch counts must show every page put and
   every page re-read went through the kernels; logits and greedy tokens
   are held against the unpaged ``decode_step``; tokens/s of the plain,
   device and host modes of the kv_decode harness; one ``torch.profiler``
   window of paged decode (device busy share, kernel time by name).

The last lines are one JSON object with every kernel's numbers, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

GiB = 1 << 30
MiB = 1 << 20
KiB = 1 << 10

# Datasheet HBM rates (bytes/s), most specific name first.
_HBM_RATE = (
    ("H200", 4.8e12),
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
    ("H100", 3.35e12),  # H100 SXM5 80GB HBM3
)

# Where each kernel's Pallas original is (file:line of its pallas_call).
_REPLACES = {
    "write_rows": "oncilla_tpu/ops/pallas_ici.py:552",
    "read_rows": "oncilla_tpu/ops/pallas_ici.py:481",
    "local_copy": "oncilla_tpu/ops/pallas_ici.py:418",
}

# Paged vs unpaged logits, bf16 weights and activations on both sides, are
# required to be equal bit for bit (tolerance 0). Both paths attend over
# the same slice of keys (positions [0, pos]) with the same shapes, so when
# every page comes back byte-exact they run the same kernels on the same
# bytes. Any looser bound would let a wrong page byte through: one bad bf16
# element of a 16 MiB page moves the logits by far less than a rounding
# step of their scale.
GREEDY_CHECK = 32
PAGE_TOKENS = 128
N_REQUESTS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def hbm_rate(name: str) -> float:
    for key, rate in _HBM_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no datasheet HBM rate for card {name!r}")


def event_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _byte_err(want: torch.Tensor, got: torch.Tensor, at: int, n: int) -> int:
    """Largest byte difference over [at, at+n); outside that range (the
    rest of an arena) the two must be equal outright."""
    if not (torch.equal(want[:at], got[:at])
            and torch.equal(want[at + n:], got[at + n:])):
        raise AssertionError(f"bytes outside [{at}, {at + n}) differ")
    return int((want[at:at + n].to(torch.int16)
                - got[at:at + n].to(torch.int16)).abs().max())


def iters_for(nbytes: int) -> int:
    return int(min(200, max(10, (4 * GiB) // nbytes)))


# -- phase 1 ----------------------------------------------------------------


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch: {name}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, count {torch.cuda.device_count()}")
    return {"smi": smi, "name": name, "hbm_rate": hbm_rate(name)}


# -- phase 2 ----------------------------------------------------------------


def phase_build() -> float:
    from oncilla_tpu_torch.ops import dma

    secs = dma.build()
    for src, text in dma.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {src}: {line.strip()}")
    log(f"[build] kernels built in {secs:.3f} s")
    return secs


# -- phase 3 ----------------------------------------------------------------


def phase_kernels(device, arena_bytes: int, sizes, base: int, copy_gap: int,
                  rate: float, timing: bool = True) -> dict:
    """Every kernel against its plain version at every size; times."""
    from oncilla_tpu_torch.ops import dma

    arena = torch.zeros(arena_bytes, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    arena.copy_(torch.randint(0, 256, (arena_bytes,), generator=gen,
                              dtype=torch.uint8, device=device))
    rows = {k: [] for k in _REPLACES}
    for n in sizes:
        raw = torch.randint(0, 256, (n,), generator=gen, dtype=torch.uint8,
                            device=device)
        src, dst = base, base + copy_gap
        out = torch.empty(n, dtype=torch.uint8, device=device)

        ref = arena.clone()
        dma.write_rows_plain(ref, raw, src)
        dma.write_rows(arena, raw, src)
        err_w = _byte_err(ref, arena, src, n)

        got = dma.read_rows(arena, src, n)
        err_r = _byte_err(dma.read_rows_plain(arena, src, n), got, 0, n)

        ref.copy_(arena)
        dma.local_copy_plain(ref, src, dst, n)
        dma.local_copy(arena, src, dst, n)
        err_c = _byte_err(ref, arena, dst, n)
        del ref, got
        errs = {"write_rows": err_w, "read_rows": err_r, "local_copy": err_c}
        for name, err in errs.items():
            if err != 0:
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at {n} B (max byte error {err})")

        fns = {
            "write_rows": (
                lambda: dma.write_rows(arena, raw, src),
                lambda: dma.write_rows_plain(arena, raw, src),
                lambda: arena[src:src + n].copy_(raw),
            ),
            "read_rows": (
                lambda: dma.read_rows(arena, src, n),
                lambda: dma.read_rows_plain(arena, src, n),
                lambda: out.copy_(arena[src:src + n]),
            ),
            "local_copy": (
                lambda: dma.local_copy(arena, src, dst, n),
                lambda: dma.local_copy_plain(arena, src, dst, n),
                lambda: arena[dst:dst + n].copy_(arena[src:src + n]),
            ),
        }
        for name, (kern, plain, lib) in fns.items():
            rec = {"nbytes": n, "src": src, "dst": dst,
                   "max_abs_err": float(errs[name]),
                   "bound_ms": 2 * n / rate * 1e3}
            if timing:
                it = iters_for(n)
                rec["ms"] = event_ms(kern, it)
                rec["plain_ms"] = event_ms(plain, it)
                rec["library_ms"] = event_ms(lib, it)
            rows[name].append(rec)
            log(f"[kernels] {name:10s} {n:>11d} B max_abs_err {rec['max_abs_err']:g} " + (
                f"ms={rec['ms']:.6f} plain_ms={rec['plain_ms']:.6f} "
                f"library_ms={rec['library_ms']:.6f} "
                f"bound_ms={rec['bound_ms']:.6f}" if timing else ""))
        del raw, out
    del arena
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rows


# -- phase 4 ----------------------------------------------------------------


def _expect(exc, fn, what: str) -> None:
    try:
        fn()
    except exc:
        return
    raise AssertionError(f"{what}: {exc.__name__} was not raised")


def phase_ocm_test(device, device_arena: int, host_arena: int, sizes,
                   copy_sizes, alloc_iters: int = 2000) -> dict:
    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch import OcmKind
    from oncilla_tpu_torch.utils.debug import GLOBAL_TRACER

    kinds = (OcmKind.LOCAL_DEVICE, OcmKind.LOCAL_HOST)
    gen = torch.Generator(device=device).manual_seed(1)

    def payload(n):
        return torch.randint(0, 256, (n,), generator=gen, dtype=torch.uint8,
                             device=device)

    ctx = ocm.ocm_init(ocm.OcmConfig(device_arena_bytes=device_arena,
                                     host_arena_bytes=host_arena),
                       device=device)
    t0 = time.perf_counter()
    # put / get round trips, every size, both local kinds.
    for kind in kinds:
        for n in sizes:
            h = ctx.alloc(n, kind)
            data = payload(n)
            ctx.put(h, data)
            back = ctx.get(h)
            if not torch.equal(back.to(device), data):
                raise AssertionError(f"{kind} put/get mismatch at {n} B")
            ctx.free(h)
    # the copy matrix, whole-extent and at block-aligned / unaligned offsets.
    for n in copy_sizes:
        for sk in kinds:
            for dk in kinds:
                s, d = ctx.alloc(n + 8192, sk), ctx.alloc(n + 8192, dk)
                data = payload(n)
                ctx.put(s, data, offset=4096)
                for so, do in ((4096, 0), (4096, 4096), (4096, 100)):
                    ctx.copy(d, s, nbytes=n, dst_offset=do, src_offset=so)
                    if not torch.equal(ctx.get(d, n, do).to(device), data):
                        raise AssertionError(
                            f"copy {sk}->{dk} {n} B at {so}->{do} mismatch")
                ctx.free(s)
                ctx.free(d)
    # scrub on free: a freed extent reads back as zeros when re-allocated.
    for kind in kinds:
        n = max(sizes)
        h = ctx.alloc(n, kind)
        ctx.put(h, payload(n))
        off = h.extent.offset
        ctx.free(h)
        h = ctx.alloc(n, kind)
        if h.extent.offset != off:
            raise AssertionError("first-fit did not reuse the freed extent")
        if int(torch.count_nonzero(ctx.get(h))) != 0:
            raise AssertionError(f"{kind}: freed bytes leaked to the next tenant")
        ctx.free(h)
    # typed errors.
    h = ctx.alloc(4096, OcmKind.LOCAL_DEVICE)
    _expect(ocm.OcmBoundsError, lambda: ctx.put(h, payload(8192)), "put past end")
    _expect(ocm.OcmBoundsError, lambda: ctx.get(h, 100, offset=4000), "get past end")
    ctx.free(h)
    _expect(ocm.OcmInvalidHandle, lambda: ctx.put(h, payload(16)), "use after free")
    _expect(ocm.OcmInvalidHandle, lambda: ctx.get(h), "get after free")
    _expect(ocm.OcmInvalidHandle, lambda: ctx.free(h), "double free")
    _expect(ocm.OcmOutOfMemory,
            lambda: ctx.alloc(device_arena + 4096, OcmKind.LOCAL_DEVICE), "oom")
    _expect(ocm.OcmConnectError,
            lambda: ctx.alloc(4096, OcmKind.REMOTE_DEVICE), "remote kind")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    loop_s = time.perf_counter() - t0
    # alloc latency (host side: the allocator's bookkeeping and the span).
    GLOBAL_TRACER.reset()
    for _ in range(alloc_iters):
        ctx.free(ctx.alloc(4096, OcmKind.LOCAL_DEVICE))
    p50_us = GLOBAL_TRACER.stats("alloc").p50_s * 1e6
    ctx.tini()
    del ctx
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[ocm_test] loop {loop_s:.3f} s, alloc p50 {p50_us:.3f} us "
        f"over {alloc_iters} allocs")
    return {"loop_s": loop_s, "alloc_p50_us": p50_us}


# -- phase 5 ----------------------------------------------------------------


def serve_request(params, cfg, ctx, prompt: torch.Tensor, n_gen: int,
                  page_tokens: int):
    """One decode request: teacher-forced prompt, then greedy tokens, all
    consumed, through paged KV. Returns (consumed ids, per-step logits)."""
    from oncilla_tpu_torch import OcmKind
    from oncilla_tpu_torch.models import llama
    from oncilla_tpu_torch.models.kv_paging import BucketedPagedDecoder

    dec = BucketedPagedDecoder(
        params, cfg, ctx, batch=1, page_tokens=page_tokens,
        kind=OcmKind.LOCAL_DEVICE, dtype=cfg.dtype, refetch=True,
    )
    ids = list(prompt.view(-1, 1))
    logits = []
    for t in range(prompt.numel() + n_gen):
        lg = dec.step(ids[t])
        logits.append(lg)
        if t + 1 >= prompt.numel() and len(ids) < prompt.numel() + n_gen:
            ids.append(llama.greedy(lg))
    npages = len(dec.cache.pages)
    dec.close()
    return torch.cat(ids), torch.cat(logits), npages


def reference_logits(params, cfg, ids: torch.Tensor) -> torch.Tensor:
    """The unpaged decode over one contiguous cache, teacher-forced on
    ``ids``."""
    from oncilla_tpu_torch.models import llama

    rcfg = dataclasses.replace(cfg, max_seq=ids.numel())
    kv = llama.make_kv_cache(rcfg, 1, device=ids.device)
    out = []
    for t in range(ids.numel()):
        lg, kv = llama.decode_step(params, ids[t:t + 1], t, kv, rcfg)
        out.append(lg)
    return torch.cat(out)


def profile_decode(params, cfg, ctx, ids: torch.Tensor, page_tokens: int,
                   steps: int = 16) -> dict:
    """Where a paged-decode token's time goes: ``steps`` tokens after the
    first page boundary under ``torch.profiler``. The device's busy share
    is the kernels' summed time over the window's wall time (one stream, so
    kernels do not overlap); the profiler's own cost is in the wall time,
    so the share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from oncilla_tpu_torch import OcmKind
    from oncilla_tpu_torch.models.kv_paging import BucketedPagedDecoder

    dec = BucketedPagedDecoder(params, cfg, ctx, batch=1,
                               page_tokens=page_tokens,
                               kind=OcmKind.LOCAL_DEVICE, dtype=cfg.dtype,
                               refetch=True)
    steps = min(steps, ids.numel() - page_tokens)
    for t in range(page_tokens):
        dec.step(ids[t:t + 1])
    device = ids.device
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for t in range(page_tokens, page_tokens + steps):
            dec.step(ids[t:t + 1])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    dec.close()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) * 1e-6
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    out = {
        "steps": steps, "ms_per_token": wall / steps * 1e3,
        "device_busy_ms_per_token": busy_s / steps * 1e3,
        "device_busy_share": busy_s / wall if kernels else None,
        "launches_per_token": sum(e.count for e in kernels) / steps,
        "top_kernels_ms_per_token": {
            e.key[:60]: e.self_device_time_total / steps * 1e-3 for e in top},
    }
    log(f"[serving] profile: {json.dumps(out)}")
    return out


def phase_serving(device, cfg, n_requests: int, prompt_len: int, n_gen: int,
                  page_tokens: int, bench_tokens: int,
                  check_launches: bool = True) -> dict:
    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch.benchmarks import kv_decode
    from oncilla_tpu_torch.models import llama
    from oncilla_tpu_torch.models.kv_paging import page_bytes
    from oncilla_tpu_torch.ops import dma

    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    page = page_bytes(cfg, page_tokens, cfg.dtype)
    npages = (prompt_len + n_gen) // page_tokens
    arena = max(64 * MiB, 2 * npages * page)
    ctx = ocm.ocm_init(ocm.OcmConfig(device_arena_bytes=arena,
                                     host_arena_bytes=arena), device=device)
    rng = np.random.default_rng(0)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab, prompt_len))
               .to(device) for _ in range(n_requests)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"[serving] {cfg.n_layers} layers dim {cfg.dim}, page {page} B, "
        f"set-up {time.perf_counter() - t0:.3f} s")

    # The main path: counts from 0 just before, read just after.
    dma.reset_launches()
    results, req_s = [], []
    for p in prompts:
        t1 = time.perf_counter()
        ids, logits, shipped = serve_request(params, cfg, ctx, p, n_gen,
                                             page_tokens)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        req_s.append(time.perf_counter() - t1)
        results.append((ids, logits))
        if shipped != npages:
            raise AssertionError(f"{shipped} pages shipped, want {npages}")
    launches = dma.launches()
    log(f"[serving] launches over {n_requests} requests: {launches}")
    want_k1 = n_requests * npages
    want_k2 = n_requests * npages * (npages + 1) // 2
    if check_launches and (launches["write_rows"] != want_k1
                           or launches["read_rows"] != want_k2):
        raise AssertionError(
            f"pages did not all go through the kernels: {launches}, want "
            f"write_rows={want_k1} read_rows={want_k2}")

    checks = []
    ng = min(GREEDY_CHECK, n_gen)
    for r, (ids, logits) in enumerate(results):
        ref = reference_logits(params, cfg, ids)
        if logits.shape != ref.shape or not torch.isfinite(logits).all():
            raise AssertionError("paged logits malformed")
        exact = torch.equal(logits, ref)
        err = float((logits - ref).abs().max())
        scale = float(ref.abs().max())
        ref_greedy = llama.greedy(ref[prompt_len - 1:prompt_len - 1 + ng])
        got_greedy = ids[prompt_len:prompt_len + ng]
        agree = int((ref_greedy == got_greedy).sum())
        # top-2 margin of the reference at the checked generated steps
        top2 = torch.topk(ref[prompt_len - 1:prompt_len - 1 + ng],
                          2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        checks.append({"request": r, "exact": exact, "max_abs_err": err,
                       "logit_scale": scale, "greedy_agree": agree,
                       "min_top2_margin": margin, "seconds": req_s[r]})
        log(f"[serving] request {r}: {req_s[r]:.3f} s, max|dlogit| {err:.6f} "
            f"of scale {scale:.4f}, greedy {agree}/{ng}, "
            f"min top-2 margin {margin:.6f}")
    for c in checks:
        if not c["exact"]:
            raise AssertionError(f"paged logits differ from the unpaged "
                                 f"decode: {c}")
        if c["greedy_agree"] != ng:
            raise AssertionError(f"greedy tokens disagree: {c}")

    bench_ids = torch.from_numpy(
        rng.integers(0, cfg.vocab, (1, bench_tokens))).to(device)
    tok_s = kv_decode.run_modes(params, cfg, bench_ids, ctx, page_tokens)
    prof = profile_decode(params, cfg, ctx, bench_ids[0], page_tokens)
    log(f"[serving] kv_decode tokens/s over {bench_tokens} tokens: {tok_s}")
    ctx.tini()
    del ctx, params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "requests": checks, "tok_s": tok_s,
            "profile": prof,
            "pages_per_request": npages}


# -- main -------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    from oncilla_tpu_torch.models import llama
    from oncilla_tpu_torch.models.kv_paging import page_bytes
    from oncilla_tpu_torch.ops import dma

    device = torch.device("cuda", 0)
    t_all = time.perf_counter()
    card = phase_device()
    build_s = phase_build()

    t = time.perf_counter()
    cfg = llama.LlamaConfig.llama3_8b()
    page = page_bytes(cfg, PAGE_TOKENS, cfg.dtype)  # the size every page move has
    sizes = (4 * KiB, 1 * MiB, page, 32 * MiB, 1 * GiB)
    kern = phase_kernels(device, 16 * GiB, sizes, base=5 * GiB,
                         copy_gap=4 * GiB + 4096, rate=card["hbm_rate"])
    log(f"[kernels] phase {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    dma.reset_launches()
    loop = phase_ocm_test(
        device, 16 * GiB, 4 * GiB,
        sizes=(4 * KiB, 64 * KiB, 1 * MiB, 32 * MiB, 256 * MiB, 1 * GiB),
        copy_sizes=(64 * KiB, 32 * MiB, 1 * GiB),
    )
    loop_launches = dma.launches()
    log(f"[ocm_test] launches: {loop_launches}; phase "
        f"{time.perf_counter() - t:.3f} s")
    if not all(loop_launches.values()):
        raise AssertionError(f"a kernel was not launched by the ocm_test "
                             f"loop: {loop_launches}")

    t = time.perf_counter()
    serving = phase_serving(
        device, cfg, n_requests=N_REQUESTS,
        prompt_len=512, n_gen=128, page_tokens=PAGE_TOKENS, bench_tokens=384,
    )
    log(f"[serving] phase {time.perf_counter() - t:.3f} s")

    line = []
    for name, rows in kern.items():
        at = next(r for r in rows if r["nbytes"] == page)
        line.append({
            "name": name, "route": "cuda",
            "source": "oncilla_tpu_torch/csrc/dma.cu",
            "replaces": _REPLACES[name],
            "launches": loop_launches[name] + serving["launches"][name],
            "launches_ocm_test": loop_launches[name],
            "launches_serving": serving["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": "bytes",
            "library_ms": at["library_ms"], "nbytes": page,
            "sizes": [{k: r[k] for k in ("nbytes", "ms", "plain_ms",
                                         "library_ms", "bound_ms")}
                      for r in rows],
        })
    summary = {
        "card": card["smi"], "build_s": build_s,
        "alloc_p50_us": loop["alloc_p50_us"], "tok_s": serving["tok_s"],
        "profile": serving["profile"],
        "requests": serving["requests"],
        "seconds": time.perf_counter() - t_all,
    }
    log("[summary] " + json.dumps(summary))
    print(json.dumps({"kernels": line}))
    print(card["smi"])
    # Every phase ran on cuda:0 alone: one card was driven.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
