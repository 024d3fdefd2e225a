"""Model FLOPs utilisation of the flagship decoder on one card: the
counterpart of ``oncilla_tpu/benchmarks/mfu.py``.

Achieved matmul FLOP/s (counted analytically, 2·m·n·k a matmul, so GQA
and the LM head are exact) over the card's datasheet dense bf16 rate
(:func:`~oncilla_tpu_torch.utils.platform.peak_flops`; 989 TFLOP/s for an
H100 SXM, ``OCM_PEAK_TFLOPS`` overrides it). N timed steps after a warm-up,
host clock around work that ends in a synchronise.

    python -m oncilla_tpu_torch.benchmarks.mfu

prints one JSON line: ``mfu_forward()`` and ``mfu_train_best()`` at the
JAX package's 1.1B geometry. On the CPU (``device="cpu"``) the functions
run, time the CPU and report ``mfu`` None: the CPU has no bf16 peak here.
"""

from __future__ import annotations

import gc
import json
import time

import numpy as np
import torch

from oncilla_tpu_torch.models.llama import LlamaConfig
from oncilla_tpu_torch.utils.platform import peak_flops, resolve_device


def forward_flops(cfg: LlamaConfig, batch: int, seq: int) -> int:
    """Exact matmul FLOPs of one forward pass (2mnk a matmul; elementwise
    work and norms are left out)."""
    b, s, d = batch, seq, cfg.dim
    hd = cfg.head_dim
    kv_dim = cfg.n_kv_heads * hd
    per_layer = (
        2 * b * s * d * d                 # Wq
        + 2 * 2 * b * s * d * kv_dim      # Wk, Wv
        + 2 * b * s * d * d               # Wo
        + 2 * 2 * b * cfg.n_heads * s * s * hd  # QK^T and PV
        + 3 * 2 * b * s * d * cfg.ffn_hidden    # gate, up, down
    )
    head = 2 * b * s * d * cfg.vocab
    return cfg.n_layers * per_layer + head


def train_flops(cfg: LlamaConfig, batch: int, seq: int) -> int:
    """A train step: the forward and twice its matmul work in backward."""
    return 3 * forward_flops(cfg, batch, seq)


def chip_filling_config() -> tuple[LlamaConfig, int, int]:
    """The JAX package's ~1.1B-parameter bf16 decoder with (batch, seq)."""
    cfg = LlamaConfig(
        vocab=32000, dim=2048, n_layers=16, n_heads=16, n_kv_heads=8,
        ffn_hidden=8192, max_seq=2048, dtype="bfloat16",
    )
    return cfg, 8, 1024


def train_sized_config() -> tuple[LlamaConfig, int, int]:
    """The same 1.1B geometry at the JAX package's training batch, 4."""
    cfg, _, _ = chip_filling_config()
    return cfg, 4, 1024


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rates(flops: int, steps: int, seconds: float, device: torch.device) -> dict:
    achieved = flops * steps / seconds
    peak = peak_flops(torch.cuda.get_device_name(device)) \
        if device.type == "cuda" else None
    return {"mfu": achieved / peak if peak else None,
            "tflops": achieved / 1e12, "steps": steps, "seconds": seconds,
            "device": torch.cuda.get_device_name(device)
            if device.type == "cuda" else str(device)}


def mfu_forward(cfg: LlamaConfig | None = None, batch: int | None = None,
                seq: int | None = None, steps: int = 10, device=None) -> dict:
    """Forward-pass MFU. The weights are drawn on the device from a seeded
    generator: their values do not matter to a FLOP/s figure."""
    from oncilla_tpu_torch.models import llama, train

    dev = resolve_device(device)
    if cfg is None:
        cfg, batch, seq = chip_filling_config()
    params = llama.init_params(cfg, device=dev, seed=0)
    tokens = train.sample_batch(np.random.default_rng(0), cfg, batch, seq, dev)
    with torch.no_grad():
        llama.forward(params, tokens, cfg)
        _sync(dev)  # warm-up excluded from timing
        t0 = time.perf_counter()
        for _ in range(steps):
            llama.forward(params, tokens, cfg)
        _sync(dev)
        dt = time.perf_counter() - t0
    flops = forward_flops(cfg, batch, seq)
    return {**_rates(flops, steps, dt, dev), "flops_per_step": flops}


def _dtype_label(dtype) -> str | None:
    return None if dtype is None else str(dtype).removeprefix("torch.")


def mfu_train(cfg: LlamaConfig | None = None, batch: int | None = None,
              seq: int | None = None, steps: int = 6, remat=False,
              ce_block: int | None = None, mu_dtype=None, fold: bool = False,
              device=None) -> dict:
    """Train-step MFU (forward, backward, AdamW) with the production
    optimizer (``adamw(3e-4, 0.01, mu_dtype)``). ``fold`` runs the timed
    steps as one folded step (``make_train_step(fold_steps=steps)``);
    ``remat``, ``ce_block`` and ``mu_dtype`` are the memory trades
    :func:`mfu_train_best` sweeps. One unfolded step warms up (cuBLAS
    heuristics, the allocator's pools): eager PyTorch compiles nothing."""
    from oncilla_tpu_torch.models import train

    dev = resolve_device(device)
    if cfg is None:
        cfg, batch, seq = train_sized_config()
    params, opt_state, tx = train.make_train_state(cfg, device=dev,
                                                   mu_dtype=mu_dtype)
    tokens = train.sample_batch(np.random.default_rng(0), cfg, batch, seq, dev)
    kw = {"remat": remat, "ce_block": ce_block}
    train.make_train_step(cfg, tx, **kw)(params, opt_state, tokens)
    step = train.make_train_step(cfg, tx, fold_steps=steps if fold else 0, **kw)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(1 if fold else steps):
        params, opt_state, loss = step(params, opt_state, tokens)
    _sync(dev)
    dt = time.perf_counter() - t0
    return {
        **_rates(train_flops(cfg, batch, seq), steps, dt, dev),
        "loss": float(loss), "batch": batch, "remat": str(remat),
        "ce_block": ce_block, "mu_dtype": _dtype_label(mu_dtype), "fold": fold,
    }


def train_variants() -> list[dict]:
    """The JAX package's sweep grid (the same eight, in its order), with
    bf16 µ as ``torch.bfloat16``."""
    _, batch4, _ = train_sized_config()
    bf16 = torch.bfloat16
    return [
        dict(batch=8, remat="dots", ce_block=None, mu_dtype=bf16, fold=True),
        dict(batch=8, remat="dots", ce_block=None, mu_dtype=bf16),
        dict(batch=16, remat="dots", ce_block=1024, mu_dtype=bf16, fold=True),
        dict(batch=batch4, remat=False, ce_block=None, mu_dtype=bf16, fold=True),
        dict(batch=16, remat="dots", ce_block=1024, mu_dtype=None),
        dict(batch=batch4, remat=False, ce_block=None, mu_dtype=None),
        dict(batch=8, remat="dots", ce_block=1024, mu_dtype=None),
        dict(batch=16, remat=True, ce_block=1024, mu_dtype=bf16),
    ]


def variant_label(v: dict) -> dict:
    """A grid entry as JSON: ``mu_dtype`` by name, ``fold`` always there."""
    return {**v, "mu_dtype": _dtype_label(v["mu_dtype"]),
            "fold": v.get("fold", False)}


def mfu_train_best(deadline: float | None = None, variants=None, device=None,
                   cfg: LlamaConfig | None = None, seq: int | None = None) -> dict:
    """Run the variants (``train_variants()`` by default) and keep the
    fastest: the FLOP count is the same for every variant, so wall time
    decides. With ``deadline`` (``time.monotonic()``), variants after it
    are skipped. A variant that runs out of device memory is recorded as
    data; any other error propagates, so a fault cannot pass for a skipped
    variant. ``cfg``/``seq`` default to :func:`train_sized_config`'s."""
    if cfg is None:
        cfg, _, seq = train_sized_config()
    dev = resolve_device(device)
    best, tried = None, []
    for v in train_variants() if variants is None else variants:
        label = variant_label(v)
        if deadline is not None and time.monotonic() > deadline:
            tried.append({**label, "skipped": "deadline"})
            continue
        try:
            r = mfu_train(cfg, v["batch"], seq, remat=v["remat"],
                          ce_block=v["ce_block"], mu_dtype=v["mu_dtype"],
                          fold=v.get("fold", False), device=dev)
        except torch.OutOfMemoryError as e:
            tried.append({**label, "error": type(e).__name__})
            r = None
        if r is None:
            # The failed variant's tensors die with its frames: give their
            # memory back before the next one.
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            continue
        tried.append({k: r[k] for k in
                      ("batch", "remat", "ce_block", "mu_dtype", "fold", "mfu")})
        if best is None or r["tflops"] > best["tflops"]:
            best = r
    if best is None:
        raise RuntimeError(f"every mfu_train variant failed: {tried}")
    best["variants"] = tried
    return best


def main() -> None:
    device = resolve_device(None)
    print(json.dumps({"forward": mfu_forward(device=device),
                      "train": mfu_train_best(device=device)}), flush=True)


if __name__ == "__main__":
    main()
