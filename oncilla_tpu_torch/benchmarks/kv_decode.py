"""Decode throughput with an OCM-paged KV cache (BASELINE.md config 5), the
PyTorch counterpart of ``oncilla_tpu/benchmarks/kv_decode.py``.

Modes, with the JAX harness's accounting (tokens decoded over the wall time
of a warmed-up run that ends in a device synchronise):

- ``plain``: per-token :func:`llama.decode_step` over a contiguous cache
  sized to the run.
- ``device``: KV history paged through OCM into the device arena
  (``LOCAL_DEVICE``) by :class:`BucketedPagedDecoder` with
  ``refetch=True`` — every page put and every page re-read at each page
  boundary go through the one-sided data plane (the copy kernels on CUDA).
- ``host``: the same with pages in host DRAM (``LOCAL_HOST``).
- ``device_fused``: paged like ``device``, a page at a time
  (``BucketedPagedDecoder.step_page``): on CUDA one captured token step
  (:mod:`oncilla_tpu_torch.models.graphs`) replayed for each token of the
  page, the port's counterpart of the JAX harness's one compiled program
  per page; the page put and the refetch run between pages, outside the
  graph.
- ``fused``: unpaged, one captured token step over a contiguous cache sized
  to the run (the masked fixed-shape step of the JAX ``decode_step``),
  replayed for every token: the counterpart of the JAX harness's one
  compiled program per sequence.

Each fused mode captures in its warm-up run and replays in the timed run.

Run: ``python -m oncilla_tpu_torch.benchmarks.kv_decode [--config tiny]``
(CUDA by default; ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from oncilla_tpu_torch.core.kinds import OcmKind
from oncilla_tpu_torch.models import llama
from oncilla_tpu_torch.models.graphs import StepGraphs
from oncilla_tpu_torch.models.kv_paging import (
    BucketedPagedDecoder,
    page_bytes,
    paged_token_step,
)
from oncilla_tpu_torch.utils.platform import resolve_device

# The JAX harness's order: the fused modes last.
MODES = ("plain", "device", "host", "device_fused", "fused")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(run, device, n_tokens: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        run()
    _sync(device)
    t0 = time.perf_counter()
    run()
    _sync(device)
    return n_tokens / (time.perf_counter() - t0)


def bench_plain(params, cfg, tokens, warmup: int = 1) -> float:
    """Tokens/s of per-token decode over a contiguous cache sized to the run
    (so per-step attention work matches the paged arms)."""
    cfg = dataclasses.replace(cfg, max_seq=tokens.shape[1])
    device = tokens.device

    def run():
        kv = llama.make_kv_cache(cfg, tokens.shape[0], device=device)
        for i in range(tokens.shape[1]):
            _, kv = llama.decode_step(params, tokens[:, i], i, kv, cfg)

    return _timed(run, device, tokens.shape[1], warmup)


def bench_paged(params, cfg, tokens, ctx, kind, page_tokens,
                warmup: int = 1) -> float:
    """Tokens/s with KV history paged through OCM handles (refetch)."""

    def run():
        dec = BucketedPagedDecoder(
            params, cfg, ctx, batch=tokens.shape[0], page_tokens=page_tokens,
            kind=kind, dtype=cfg.dtype, refetch=True,
        )
        for i in range(tokens.shape[1]):
            dec.step(tokens[:, i])
        _sync(tokens.device)
        dec.close()

    return _timed(run, tokens.device, tokens.shape[1], warmup)


def bench_fused(params, cfg, tokens, warmup: int = 1) -> float:
    """Tokens/s of unpaged decode with one captured token step replayed
    every token, over a contiguous cache sized to the run: token i
    attends over cache slots 0..i (masked) and writes slot i."""
    B, n = tokens.shape
    device = tokens.device
    cfg = dataclasses.replace(cfg, max_seq=n)
    graphs = StepGraphs(params, cfg)
    i = torch.arange(n, device=device)
    zero = torch.zeros_like(i)
    metas = torch.stack([i, i, zero, zero], 1)[:, None, :].expand(n, B, 4)

    def run():
        k, v = llama.make_kv_cache(cfg, B, device=device)
        empty = k[:, :, :, :0]
        for t in range(n):
            graphs.run(paged_token_step,
                       (tokens[:, t], metas[t], empty, empty, k, v))

    try:
        return _timed(run, device, n, warmup)
    finally:
        graphs.close()


def bench_paged_fused(params, cfg, tokens, ctx, kind, page_tokens,
                      warmup: int = 1) -> float:
    """Tokens/s with KV history paged through OCM handles (refetch), a
    page at a time (``step_page``) through one captured token step."""
    n_pages = tokens.shape[1] // page_tokens
    graphs = StepGraphs(params, cfg)

    def run():
        dec = BucketedPagedDecoder(
            params, cfg, ctx, batch=tokens.shape[0], page_tokens=page_tokens,
            kind=kind, dtype=cfg.dtype, refetch=True, graphs=graphs,
        )
        for p in range(n_pages):
            dec.step_page(tokens[:, p * page_tokens:(p + 1) * page_tokens])
        _sync(tokens.device)
        dec.close()

    try:
        return _timed(run, tokens.device, n_pages * page_tokens, warmup)
    finally:
        graphs.close()


def run_modes(params, cfg, tokens, ctx, page_tokens: int,
              modes=MODES, warmup: int = 1) -> dict:
    """{mode: tokens/s} for ``params``/``tokens`` already on ``ctx``'s
    device."""
    out = {}
    for mode in modes:
        if mode == "plain":
            out[mode] = bench_plain(params, cfg, tokens, warmup)
        elif mode in ("device", "host"):
            kind = OcmKind.LOCAL_DEVICE if mode == "device" else OcmKind.LOCAL_HOST
            out[mode] = bench_paged(params, cfg, tokens, ctx, kind,
                                    page_tokens, warmup)
        elif mode == "device_fused":
            out[mode] = bench_paged_fused(params, cfg, tokens, ctx,
                                          OcmKind.LOCAL_DEVICE, page_tokens,
                                          warmup)
        elif mode == "fused":
            out[mode] = bench_fused(params, cfg, tokens, warmup)
        else:
            raise ValueError(f"unknown mode {mode!r}")
    return out


def run_bench(tokens_n: int = 384, page_tokens: int = 128, modes=MODES,
              config: str = "small", device=None, seed: int = 0) -> dict:
    """Tokens/s per mode plus the paged arms' overhead.
    ``config`` is "small" (``LlamaConfig()``), "tiny" or "llama3_8b"."""
    import oncilla_tpu_torch as ocm

    dev = resolve_device(device)
    cfg = {
        "small": llama.LlamaConfig(),
        "tiny": llama.LlamaConfig.tiny(),
        "llama3_8b": llama.LlamaConfig.llama3_8b(),
    }[config]
    params = llama.init_params(cfg, device=dev, seed=seed)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(1, tokens_n), dtype=np.int64)
    ).to(dev)
    page = page_bytes(cfg, page_tokens, cfg.dtype)
    arena = max(64 << 20, 2 * (tokens_n // page_tokens) * page)
    ctx = ocm.ocm_init(
        ocm.OcmConfig(host_arena_bytes=arena, device_arena_bytes=arena),
        device=dev,
    )
    try:
        tok_s = run_modes(params, cfg, tokens, ctx, page_tokens, modes)
    finally:
        ctx.tini()
    out = {"config": config, "tokens": tokens_n, "page_tokens": page_tokens,
           "device": str(dev), "tok_s": tok_s}
    # The paged arms' overhead against the fused ceiling (the per-token
    # loop when fused was not run), as the JAX harness reports it.
    base = "fused" if "fused" in tok_s else "plain"
    if base in tok_s:
        out["overhead_vs"] = base
        out["paging_overhead"] = {
            m: tok_s[base] / v - 1.0 for m, v in tok_s.items()
            if m in ("device", "host", "device_fused")
        }
    return out


def main() -> None:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tokens", type=int, default=384)
    ap.add_argument("--page-tokens", type=int, default=128)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--config", choices=["small", "tiny", "llama3_8b"],
                    default="small")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    print(json.dumps(run_bench(
        tokens_n=args.tokens, page_tokens=args.page_tokens,
        modes=tuple(m for m in args.modes.split(",") if m),
        config=args.config, device=args.device,
    )))


if __name__ == "__main__":
    main()
