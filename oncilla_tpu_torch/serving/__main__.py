"""``python -m oncilla_tpu_torch.serving`` — the serving workload harness
(the port's copy of ``oncilla_tpu/serving/__main__.py``, function for
function). It runs on the card unless the caller passes ``--device cpu``;
without CUDA and without that flag it raises ``OcmDeviceError``.

``--smoke`` (in-process daemons) proves the whole scenario end to end on a
3-daemon ``inprocess_cluster`` with ``OCM_REPLICAS=2``:

- **paired cells**: the same tenant fleet (shared prompt prefix, two of
  them byte-identical) decodes once WITHOUT prefix sharing and once
  WITH it — outputs must be identical across the cells (sharing is a
  storage optimization, never a result change), the shared cell must
  show prefix hits, at least one copy-on-write adoption, a hit ratio no
  worse than the unshared cell, and strictly fewer remote bytes;
- **chaos leg**: the remote owner of the engine's cold pages is killed
  mid-decode under a seeded schedule; decode output must be byte-exact
  vs a chaos-free reference run, TWICE with the identical fault
  interleaving, each run wrapped in the flight-recorder invariant audit
  (``audit.recorded`` — zero findings);
- **warm-boot leg**: the prefix trie persisted into the FROZEN tier, every
  daemon restarted, and a warm arm that must beat a cold one on prefix hit
  ratio and mean TTFT, byte-exact;
- **drained ledger**: registries, arenas and the OCM_ALLOCTRACE ledger
  are empty on every surviving rank afterwards.

``--bench`` runs the measured cells at a slightly larger scale and
prints one JSON dict — the port's bench records it as ``detail.serving``
(tokens/s, cache-hit ratio, page-fault stall ms, per-tier occupancy,
paired shared-vs-noshare deltas, chaos outcome, warm boot). The model is
``LlamaConfig.tiny()`` in float32: with TF32 off (PyTorch's default) a card
product is a float32 product, so every token-identity assertion holds as
it does on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from oncilla_tpu_torch.utils.platform import resolve_device


def _tiny_model(device):
    from oncilla_tpu_torch.models import LlamaConfig, init_params_host

    cfg = LlamaConfig.tiny()
    return cfg, init_params_host(0, cfg, device=device)


def _prompts(seed: int, tenants: int, shared_tokens: int,
             suffix_tokens: int, vocab: int) -> list[list[int]]:
    """Tenant prompts with a common prefix: tenants 0 and 1 are
    byte-identical (the CoW pair), the rest diverge after the shared
    prefix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, shared_tokens).tolist()
    prompts = []
    for t in range(tenants):
        if t == 1:
            prompts.append(list(prompts[0]))
            continue
        suffix = rng.integers(1, vocab, suffix_tokens).tolist()
        prompts.append(shared + suffix)
    return prompts


def _cold_client(cl, rank: int = 0, mux: bool = False):
    from oncilla_tpu_torch.qos.policy import PRIO_LOW
    from oncilla_tpu_torch.runtime.client import ControlPlaneClient

    # The tier->QoS mapping: cold pages declare PRIO_LOW at
    # CONNECT, so daemon-side pressure eviction and the serving-side
    # evictor agree that cold serving pages go first.
    cfg = dataclasses.replace(cl.config, priority=PRIO_LOW, mux=mux)
    return ControlPlaneClient(cl.entries, rank, config=cfg)


def _build_engine(cfg, params, *, page_tokens: int, hot: int, warm: int,
                  cold_client, share: bool, name: str,
                  prefetch_workers: int, max_active: int = 4,
                  batched: bool | None = None,
                  max_batch: int | None = None,
                  frozen_backend=None, graphs=None):
    import oncilla_tpu_torch as ocm

    from oncilla_tpu_torch.serving.engine import ServingEngine
    from oncilla_tpu_torch.serving.metrics import ServingStats
    from oncilla_tpu_torch.serving.prefix import PrefixCache
    from oncilla_tpu_torch.serving.tiers import TieredPageStore

    page_bytes = ServingEngine.page_nbytes(cfg, page_tokens)
    slot = max(page_bytes, 4096)
    ctx = ocm.Ocm(config=ocm.OcmConfig(
        host_arena_bytes=max((warm + 4) * slot, 1 << 20),
        device_arena_bytes=max((hot + 4) * slot, 1 << 20),
    ), device=params["embed"].device)
    store = TieredPageStore(
        ctx, page_bytes, hot_capacity=hot, warm_capacity=warm,
        cold_backend=cold_client, stats=ServingStats(name),
        frozen_backend=frozen_backend,
    )
    prefix = PrefixCache(store, page_tokens) if share else None
    engine = ServingEngine(
        params, cfg, store, prefix, page_tokens=page_tokens,
        max_active=max_active, prefetch_workers=prefetch_workers,
        name=name, batched=batched, max_batch=max_batch,
    )
    if graphs is not None:
        engine.graphs = graphs or None  # shared across cells, or eager
    return ctx, store, engine


def _run_cell(cl, cfg, params, *, share: bool, prompts, new_tokens: int,
              page_tokens: int, hot: int, warm: int,
              prefetch_workers: int, name: str, mux: bool = False,
              max_active: int = 4, batched: bool | None = None,
              max_batch: int | None = None, frozen_backend=None,
              graphs=None) -> dict:
    """One measured cell: a tenant fleet decoded to completion through
    one engine on the device of ``params``. Returns outputs + the engine's
    metric snapshot. ``graphs`` picks how the engine steps on the card: by
    default through graphs it captures itself; a ``StepGraphs`` is a graph
    cache shared across cells, which outlives this one; ``False`` steps
    eagerly."""
    from oncilla_tpu_torch.serving.engine import Request

    cold = _cold_client(cl, 0, mux=mux) if cl is not None else None
    ctx, store, engine = _build_engine(
        cfg, params, page_tokens=page_tokens, hot=hot, warm=warm,
        cold_client=cold, share=share, name=name,
        prefetch_workers=prefetch_workers, max_active=max_active,
        batched=batched, max_batch=max_batch,
        frozen_backend=frozen_backend, graphs=graphs,
    )
    try:
        for t, toks in enumerate(prompts):
            engine.submit(Request(tenant=f"t{t}", tokens=toks,
                                  max_new_tokens=new_tokens))
        t0 = time.perf_counter()
        results = engine.run()
        dt = time.perf_counter() - t0
        meta = engine.metrics_meta()
        outs = {r.tenant: list(r.out_tokens) for r in results}
        decode_tokens = sum(len(v) for v in outs.values())
        reused = sum(r.prefix_tokens_reused for r in results)
        return {
            "share": share,
            "outputs": outs,
            "tok_s": round(decode_tokens / dt, 2) if dt else 0.0,
            "decode_tokens": decode_tokens,
            "wall_s": round(dt, 3),
            "hit_ratio": meta["hit_ratio"],
            "stall_ms": round(1e3 * meta["stall_s"], 3),
            "stalls": meta["stalls"],
            "tier_pages": meta["tier_pages"],
            "tier_bytes": meta["tier_bytes"],
            "remote_bytes": meta["remote_bytes"],
            "prefix": meta["prefix"],
            "prefetch": meta["prefetch"],
            "moves": meta["moves"],
            "prefix_tokens_reused": reused,
            "cold_sim": meta["cold_sim"],
            "batch": meta["batch"],
            "preempts": meta["preempts"],
            "ttft": meta["ttft"],
        }
    finally:
        if graphs is not None:
            engine.graphs = None  # a shared cache outlives this engine
        engine.close()
        store.close()
        ctx.tini()
        if cold is not None:
            cold.close()


def _cluster_cfg(**kw):
    from oncilla_tpu_torch.utils.config import OcmConfig

    base = dict(
        host_arena_bytes=32 << 20,
        device_arena_bytes=4 << 20,
        heartbeat_s=0.1,
        lease_s=5.0,
        replicas=2,
        detect_interval_s=0.05,
        suspect_after=1,
        dead_after=2,
        probe_timeout_s=0.25,
        dcn_stripes=1,
        chunk_bytes=256 << 10,
    )
    base.update(kw)
    return OcmConfig(**base)


def run_pair(seed: int, *, tenants: int = 6, shared_tokens: int = 28,
             suffix_tokens: int = 5, new_tokens: int = 16,
             page_tokens: int = 8, hot: int = 4, warm: int = 6,
             prefetch_workers: int = 2, mux: bool = False,
             device=None) -> dict:
    """The paired shared-vs-noshare cells on one fresh cluster."""
    from oncilla_tpu_torch.runtime.cluster import inprocess_cluster

    cfg, params = _tiny_model(resolve_device(device))
    prompts = _prompts(seed, tenants, shared_tokens, suffix_tokens,
                       cfg.vocab)
    with inprocess_cluster(3, config=_cluster_cfg()) as cl:
        noshare = _run_cell(
            cl, cfg, params, share=False, prompts=prompts,
            new_tokens=new_tokens, page_tokens=page_tokens, hot=hot,
            warm=warm, prefetch_workers=prefetch_workers,
            name="serve-noshare", mux=mux,
        )
        shared = _run_cell(
            cl, cfg, params, share=True, prompts=prompts,
            new_tokens=new_tokens, page_tokens=page_tokens, hot=hot,
            warm=warm, prefetch_workers=prefetch_workers,
            name="serve-shared", mux=mux,
        )
        drained = _assert_drained(cl)
    if shared["outputs"] != noshare["outputs"]:
        raise AssertionError(
            "prefix sharing changed decode output — cells must be "
            "byte-identical"
        )
    t0, t1 = shared["outputs"]["t0"], shared["outputs"]["t1"]
    if t0 != t1:
        raise AssertionError(
            "identical prompts decoded to different outputs "
            f"({t0} vs {t1})"
        )
    remote = (shared["remote_bytes"]["in"] + shared["remote_bytes"]["out"],
              noshare["remote_bytes"]["in"] + noshare["remote_bytes"]["out"])
    return {
        "seed": seed,
        "tenants": tenants,
        "prompt_tokens": [len(p) for p in prompts],
        "new_tokens": new_tokens,
        "page_tokens": page_tokens,
        "hot_capacity": hot,
        "warm_capacity": warm,
        "cells": {"shared": shared, "noshare": noshare},
        "hit_ratio_delta": round(
            shared["hit_ratio"] - noshare["hit_ratio"], 4
        ),
        "remote_bytes_shared": remote[0],
        "remote_bytes_noshare": remote[1],
        "drained_ranks": drained,
    }


def run_batched_pair(seed: int, *, tenants: int = 4,
                     shared_tokens: int = 20, suffix_tokens: int = 4,
                     new_tokens: int = 10, page_tokens: int = 8,
                     hot: int = 3, warm: int = 4,
                     prefetch_workers: int = 2, device=None) -> dict:
    """The batched-vs-interleaved correctness gate on one fresh cluster:
    the same seeded tenant fleet decodes once through the interleaved
    batch-of-1 loop and once through the fused batched tick loop —
    per-session outputs must be byte-identical (batching is a dispatch
    optimization, never a result change)."""
    from oncilla_tpu_torch.runtime.cluster import inprocess_cluster

    cfg, params = _tiny_model(resolve_device(device))
    prompts = _prompts(seed, tenants, shared_tokens, suffix_tokens,
                       cfg.vocab)
    with inprocess_cluster(3, config=_cluster_cfg()) as cl:
        inter = _run_cell(
            cl, cfg, params, share=True, prompts=prompts,
            new_tokens=new_tokens, page_tokens=page_tokens, hot=hot,
            warm=warm, prefetch_workers=prefetch_workers,
            name="serve-interleaved", batched=False,
        )
        bat = _run_cell(
            cl, cfg, params, share=True, prompts=prompts,
            new_tokens=new_tokens, page_tokens=page_tokens, hot=hot,
            warm=warm, prefetch_workers=prefetch_workers,
            name="serve-batched", batched=True,
        )
        drained = _assert_drained(cl)
    if bat["outputs"] != inter["outputs"]:
        diffs = [t for t in inter["outputs"]
                 if bat["outputs"].get(t) != inter["outputs"][t]]
        raise AssertionError(
            f"batched decode diverged from interleaved for {diffs}"
        )
    if bat["batch"]["steps"] == 0:
        raise AssertionError("batched cell never took a fused step")
    return {
        "seed": seed,
        "tenants": tenants,
        "cells": {"interleaved": inter, "batched": bat},
        "batch": bat["batch"],
        "preempts": bat["preempts"],
        "drained_ranks": drained,
    }


def run_batched_sweep(seed: int, *, tenants: int = 8,
                      shared_tokens: int = 20, suffix_tokens: int = 5,
                      new_tokens: int = 24, page_tokens: int = 8,
                      hot: int = 32, warm: int = 16,
                      sizes: tuple = (1, 2, 4, 8), device=None) -> dict:
    """Batched-vs-interleaved throughput sweep (no cluster — the cold
    tier runs its local stand-in so the axis isolates dispatch cost, not
    DCN): the same seeded fleet decodes through the interleaved loop and
    through the batched engine at max_batch in ``sizes``; every cell
    must produce identical outputs. Each config runs twice and reports
    the second (warm) cell — the first run pays the one-time costs of each
    shape bucket (on the card, its step graphs' captures). The hot tier
    is sized ABOVE the fleet's working set: a
    fused step needs every seated session resident at once, so an
    undersized hot tier measures tier thrash, not the dispatch
    amortization this sweep isolates (the churn axis is the smoke's
    paired cell, which runs both engines under the same tight caps)."""
    from oncilla_tpu_torch.models.graphs import StepGraphs

    cfg, params = _tiny_model(resolve_device(device))
    prompts = _prompts(seed, tenants, shared_tokens, suffix_tokens,
                       cfg.vocab)

    def cell(name, batched, max_batch=None):
        out = None
        # On the card the two runs share one graph cache (the counterpart
        # of XLA's process-wide compile cache), so the second is warm.
        graphs = (StepGraphs(params, cfg)
                  if params["embed"].device.type == "cuda" else None)
        try:
            for _ in range(2):  # the second run is the warm one
                out = _run_cell(
                    None, cfg, params, share=True, prompts=prompts,
                    new_tokens=new_tokens, page_tokens=page_tokens,
                    hot=hot, warm=warm, prefetch_workers=0, name=name,
                    max_active=max(sizes), batched=batched,
                    max_batch=max_batch, graphs=graphs,
                )
        finally:
            if graphs is not None:
                graphs.close()
        return out

    inter = cell("sweep-interleaved", batched=False)
    cells = {"interleaved": inter}
    for bs in sizes:
        c = cell(f"sweep-b{bs}", batched=True, max_batch=bs)
        if c["outputs"] != inter["outputs"]:
            raise AssertionError(
                f"batched@{bs} diverged from interleaved output"
            )
        cells[f"batched_{bs}"] = c
    for c in cells.values():
        c.pop("outputs")
    return {
        "seed": seed,
        "tenants": tenants,
        "new_tokens": new_tokens,
        "page_tokens": page_tokens,
        "sizes": list(sizes),
        "cells": cells,
        "tok_s": {k: c["tok_s"] for k, c in cells.items()},
        "speedup_vs_interleaved": {
            k: round(c["tok_s"] / inter["tok_s"], 3)
            for k, c in cells.items() if k != "interleaved"
            and inter["tok_s"]
        },
        "note": f"on {params['embed'].device}: the axis shows "
                "dispatch-overhead amortization at the tiny model's width; "
                "warm second runs",
    }


def _assert_drained(cl) -> list[int]:
    """Every rank's registry/arena empty + the alloctrace ledger clean
    (dead ranks' own scopes excepted — the qos-soak discipline)."""
    from oncilla_tpu_torch.analysis import alloctrace

    # Generous window over the FULL predicate (registries + arenas +
    # ledger): after an owner kill the failover coordinator may still be
    # streaming a re-replication repair copy when the app frees and
    # disconnects — that orphan is reclaimed by the lease reaper (the
    # runtime's documented backstop), which takes a lease period to fire.
    live = [d for d in cl.daemons if d._running.is_set()]
    dead_scopes = tuple(
        s for d in cl.daemons if not d._running.is_set()
        for s in (d._trace_scope, d.host_arena.allocator._trace_scope)
    )

    def leaked() -> list:
        if not alloctrace.enabled():
            return []
        return [
            r for r in alloctrace.live()
            if not any(r.scope.startswith(s) for s in dead_scopes)
        ]

    def drained() -> str | None:
        for d in live:
            if d.registry.live_count():
                return (f"rank {d.rank} registry not drained "
                        f"({d.registry.live_count()} live)")
            if d.host_arena.allocator.bytes_live:
                return f"rank {d.rank} arena not drained"
        rs = leaked()
        if rs:
            return ("alloctrace ledger leaked: "
                    f"{[r.describe() for r in rs]}")
        return None

    deadline = time.monotonic() + 30.0
    msg = drained()
    while msg is not None and time.monotonic() < deadline:
        time.sleep(0.2)
        msg = drained()
    if msg is not None:
        raise AssertionError(msg)
    return [d.rank for d in live]


def run_chaos(seed: int, *, new_tokens: int = 24, page_tokens: int = 8,
              hot: int = 2, warm: int = 2, device=None) -> dict:
    """The chaos leg: kill the remote owner of the engine's cold pages
    mid-decode (OCM_REPLICAS=2) — decode output must be byte-exact vs a
    chaos-free reference. Prefetch is OFF so the logical-op chaos clock
    (pool leases) replays identically across runs."""
    import numpy as np

    from oncilla_tpu_torch.resilience.chaos import (
        ChaosController,
        ChaosSchedule,
        Fault,
    )
    from oncilla_tpu_torch.runtime.cluster import inprocess_cluster
    from oncilla_tpu_torch.serving.engine import Request
    from oncilla_tpu_torch.serving.tiers import Tier

    cfg, params = _tiny_model(resolve_device(device))
    rng = np.random.default_rng(seed)
    prompt = rng.integers(1, cfg.vocab, 30).tolist()

    def decode(chaos: bool):
        from oncilla_tpu_torch.analysis import alloctrace

        # Each run is its own cluster: clear the process-global ledger
        # so a PREVIOUS run's killed daemon (whose scopes are not in
        # this cluster's dead set) cannot read as a leak here.
        alloctrace.reset()
        with inprocess_cluster(3, config=_cluster_cfg()) as cl:
            cold = _cold_client(cl, 0)
            ctx, store, engine = _build_engine(
                cfg, params, page_tokens=page_tokens, hot=hot, warm=warm,
                cold_client=cold, share=True, name="serve-chaos",
                prefetch_workers=0,
            )
            try:
                engine.submit(Request(tenant="t0", tokens=list(prompt),
                                      max_new_tokens=page_tokens))
                warmup = engine.run()[0].out_tokens
                cold_pages = [p for p in store.pages.values()
                              if p.tier == Tier.COLD]
                if chaos:
                    if not cold_pages:
                        raise AssertionError(
                            "no cold pages after warmup — shrink hot/warm"
                        )
                    owner = cold_pages[0].handle.rank
                    schedule = ChaosSchedule.kill_at(
                        seed, owner, op=4,
                        extra=(Fault(op=2, action="drop"),),
                    )
                    controller = ChaosController(
                        schedule, cl.entries, kill_fn=cl.kill
                    )
                else:
                    owner, schedule, controller = -1, None, None
                engine.submit(Request(tenant="t1", tokens=list(prompt),
                                      max_new_tokens=new_tokens))
                if controller is not None:
                    with controller.inject():
                        out = engine.run()[0].out_tokens
                    pending = controller.pending()
                    if pending:
                        raise AssertionError(
                            f"decode too short for schedule: {pending}"
                        )
                    log = list(controller.log)
                else:
                    out, log = engine.run()[0].out_tokens, []
                meta = engine.metrics_meta()
            finally:
                engine.close()
                store.close()
                ctx.tini()
                cold.close()
            if chaos:
                _assert_drained(cl)
        return {"warmup": list(warmup), "out": list(out), "owner": owner,
                "log": log, "schedule": schedule, "stalls": meta["stalls"]}

    ref = decode(chaos=False)
    r1 = decode(chaos=True)
    r2 = decode(chaos=True)
    if r1["out"] != ref["out"] or r1["warmup"] != ref["warmup"]:
        raise AssertionError(
            f"decode through owner kill is not byte-exact: "
            f"{r1['out']} vs {ref['out']}"
        )
    if (r1["log"], r1["schedule"], r1["out"]) != (
            r2["log"], r2["schedule"], r2["out"]):
        raise AssertionError(
            f"chaos replay diverged: {r1['log']} vs {r2['log']}"
        )
    return {
        "owner_killed": r1["owner"],
        "byte_exact": True,
        "deterministic_replay": True,
        "chaos_log": [list(t) for t in r1["log"]],
        "tokens": len(r1["out"]),
    }


def _warmboot_scenario(seed: int, cfg, params, prompts, *, new_tokens: int,
                       page_tokens: int, hot: int, warm: int,
                       prefetch_workers: int) -> dict:
    """One pass of :func:`run_warmboot`'s arms on one fresh cluster: ref,
    seeded, then a chaos ``restart`` of every daemon, then cold, a discarded
    warm-up pass and warm. The engines step eagerly: a captured graph costs
    its capture the first time its shapes are met, which the warm arm would
    pay for any batch the discarded pass did not seat alike (prefetch
    workers seat by their timing), and TTFT must measure the prefill work
    skipped, not a capture (the role of the JAX package's discarded jit-warm
    pass). Returns each arm's cell, the persisted extent count, the chaos
    log and the drained ranks."""
    import tempfile

    from oncilla_tpu_torch.analysis import alloctrace
    from oncilla_tpu_torch.persist import FrozenStore
    from oncilla_tpu_torch.resilience.chaos import ChaosController, ChaosSchedule
    from oncilla_tpu_torch.runtime.cluster import inprocess_cluster

    def cell(cl, name, frozen_dir):
        return _run_cell(
            cl, cfg, params, share=True, prompts=prompts,
            new_tokens=new_tokens, page_tokens=page_tokens, hot=hot,
            warm=warm, prefetch_workers=prefetch_workers, name=name,
            frozen_backend=FrozenStore(frozen_dir) if frozen_dir else None,
            graphs=False,
        )

    alloctrace.reset()
    with tempfile.TemporaryDirectory() as tmp:
        seed_dir = os.path.join(tmp, "seeded")
        with inprocess_cluster(3, config=_cluster_cfg()) as cl:
            ref = cell(cl, "serve-warmboot-ref", None)
            seeded = cell(cl, "serve-warmboot-seed", seed_dir)
            persisted = sum(
                1 for k in FrozenStore(seed_dir).keys()
                if k.startswith("prefix-")
            )
            if persisted == 0:
                raise AssertionError(
                    "seeding arm persisted no prefix extents"
                )
            controller = ChaosController(
                ChaosSchedule(seed=seed), cl.entries,
                restart_fn=cl.restart,
            )
            for r in range(len(cl.daemons)):
                controller.force("restart", r)
            coldarm = cell(cl, "serve-warmboot-cold", None)
            cell(cl, "serve-warmboot-warmup", seed_dir)  # discarded
            warmarm = cell(cl, "serve-warmboot-warm", seed_dir)
            drained = _assert_drained(cl)
    return {
        "ref": ref, "seeded": seeded, "cold": coldarm,
        "warm": warmarm, "persisted": persisted,
        "log": list(controller.log), "drained": drained,
    }


def run_warmboot(seed: int, *, tenants: int = 3, shared_tokens: int = 20,
                 suffix_tokens: int = 4, new_tokens: int = 8,
                 page_tokens: int = 8, hot: int = 12, warm: int = 8,
                 prefetch_workers: int = 2, device=None) -> dict:
    """The FROZEN-tier warm-boot cell: the same tenant fleet decodes
    through four arms on one cluster (:func:`_warmboot_scenario`) —

    - **ref**: no frozen backend, never restarted — the byte-exact
      reference (``OCM_FROZEN`` off must equal it too);
    - **seeded**: a frozen dir attached; engine close persists the
      prefix trie to disk;
    - chaos ``restart`` then hard-kills EVERY daemon and relaunches a
      fresh incarnation at the same address (no snapshot — only the
      disk manifest survives);
    - **cold**: post-restart, NO frozen backend — the baseline a
      restart without the persist/ subsystem would pay;
    - **warm**: post-restart, the seeded dir — the engine re-publishes
      the persisted extents at boot, so prefill rides pages computed by
      the previous incarnation. A discarded warm-up pass runs first
      (the batched-sweep discipline): resuming prefill mid-prefix is a
      shape the cold arms never run, and TTFT must measure skipped
      prefill work, not a one-time cost. For the same reason the hot
      tier is sized above the restored working set — a restored page
      that lands in the COLD tier pays a loopback-DCN fetch per hit,
      which on a tiny model dwarfs the prefill it skipped; the
      tier-churn axis belongs to the paired cells, not this one.

    Asserts every arm's decode is byte-exact vs ref, the warm arm's
    prefix hit ratio is STRICTLY higher and its mean TTFT STRICTLY
    lower than the cold arm's, and the whole scenario replays
    identically (chaos log + outputs) a second time."""
    cfg, params = _tiny_model(resolve_device(device))
    prompts = _prompts(seed, tenants, shared_tokens, suffix_tokens,
                       cfg.vocab)
    prompt_tokens = sum(len(p) for p in prompts)

    def phr(c) -> float:
        return round(c["prefix_tokens_reused"] / prompt_tokens, 4)

    def ttft_mean(c) -> float:
        t = c["ttft"]
        return round(t["sum_s"] / t["count"], 6) if t["count"] else 0.0

    kw = dict(new_tokens=new_tokens, page_tokens=page_tokens, hot=hot,
              warm=warm, prefetch_workers=prefetch_workers)
    r1 = _warmboot_scenario(seed, cfg, params, prompts, **kw)
    r2 = _warmboot_scenario(seed, cfg, params, prompts, **kw)
    for run in (r1, r2):
        for arm in ("seeded", "cold", "warm"):
            if run[arm]["outputs"] != run["ref"]["outputs"]:
                raise AssertionError(
                    f"{arm} arm decode is not byte-exact vs the "
                    f"never-restarted reference"
                )
        if phr(run["warm"]) <= phr(run["cold"]):
            raise AssertionError(
                f"warm boot did not raise the prefix hit ratio "
                f"({phr(run['warm'])} vs cold {phr(run['cold'])})"
            )
        if ttft_mean(run["warm"]) >= ttft_mean(run["cold"]):
            raise AssertionError(
                f"warm boot did not cut mean TTFT "
                f"({ttft_mean(run['warm'])}s vs cold "
                f"{ttft_mean(run['cold'])}s)"
            )
    if (r1["log"], {a: r1[a]["outputs"] for a in ("ref", "cold", "warm")}
            ) != (r2["log"],
                  {a: r2[a]["outputs"] for a in ("ref", "cold", "warm")}):
        raise AssertionError(
            f"warm-boot scenario replay diverged: {r1['log']} vs "
            f"{r2['log']}"
        )
    for arm in ("ref", "seeded", "cold", "warm"):
        r1[arm].pop("outputs")
    return {
        "seed": seed,
        "tenants": tenants,
        "prompt_tokens": prompt_tokens,
        "restarted_ranks": sorted({r for _, a, r in r1["log"]
                                   if a == "restart"}),
        "persisted_extents": r1["persisted"],
        "cells": {a: r1[a] for a in ("ref", "seeded", "cold", "warm")},
        "prefix_hit_ratio": {"cold": phr(r1["cold"]),
                             "warm": phr(r1["warm"])},
        "ttft_mean_s": {"cold": ttft_mean(r1["cold"]),
                        "warm": ttft_mean(r1["warm"])},
        "byte_exact": True,
        "deterministic_replay": True,
        "chaos_log": [list(t) for t in r1["log"]],
        "note": f"on {params['embed'].device}: TTFT deltas show prefill "
                "work skipped via restored extents, at the tiny model's "
                "width",
    }


def smoke(seed: int, mux: bool | None = None, device=None) -> int:
    from oncilla_tpu_torch.analysis import alloctrace
    from oncilla_tpu_torch.obs import audit as obs_audit
    from oncilla_tpu_torch.ops import dma

    device = resolve_device(device)
    os.environ.setdefault("OCM_ALLOCTRACE", "1")
    alloctrace.reset()

    print(f"serving smoke: seed={seed} device={device} paired "
          f"shared-vs-noshare cells ...")
    pair = run_pair(seed, tenants=4, shared_tokens=20, suffix_tokens=4,
                    new_tokens=10, hot=3, warm=4, device=device)
    sh, ns = pair["cells"]["shared"], pair["cells"]["noshare"]
    print(f"  noshare: {ns['tok_s']} tok/s, hit {ns['hit_ratio']:.2f}, "
          f"remote {pair['remote_bytes_noshare']} B, "
          f"stall {ns['stall_ms']} ms")
    print(f"  shared:  {sh['tok_s']} tok/s, hit {sh['hit_ratio']:.2f}, "
          f"remote {pair['remote_bytes_shared']} B, "
          f"stall {sh['stall_ms']} ms, prefix hits "
          f"{sh['prefix']['hits']}, cow {sh['prefix']['cow']}")
    if sh["prefix"]["hits"] == 0:
        print("serving smoke: FAIL — no prefix hits in the shared cell")
        return 1
    if sh["prefix"]["cow"] == 0:
        print("serving smoke: FAIL — identical-prompt pair never took "
              "the CoW path")
        return 1
    if sh["hit_ratio"] < ns["hit_ratio"]:
        print("serving smoke: FAIL — sharing made the hit ratio WORSE "
              f"({sh['hit_ratio']} vs {ns['hit_ratio']})")
        return 1
    if pair["remote_bytes_shared"] >= pair["remote_bytes_noshare"]:
        print("serving smoke: FAIL — sharing did not reduce remote "
              f"bytes ({pair['remote_bytes_shared']} vs "
              f"{pair['remote_bytes_noshare']})")
        return 1
    if sh["moves"]["demote"] == 0 or sh["moves"]["promote"] == 0:
        print("serving smoke: FAIL — tiering never moved a page "
              f"({sh['moves']})")
        return 1

    print("serving smoke: batched-vs-interleaved paired cell ...")
    bp = run_batched_pair(seed, tenants=4, shared_tokens=20,
                          suffix_tokens=4, new_tokens=10, hot=3, warm=4,
                          device=device)
    bb = bp["batch"]
    print(f"  batched: {bb['steps']} fused steps, max batch "
          f"{bb['size_max']}, {bb['prefill_chunks']} prefill chunks, "
          f"preempts {bp['preempts']}; outputs byte-identical")
    if bb["size_max"] < 2:
        print("serving smoke: FAIL — fused steps never batched more "
              f"than one session (max {bb['size_max']})")
        return 1

    if mux is None:
        mux = os.environ.get("OCM_SERVE_SMOKE_MUX", "1") not in ("", "0")
    if mux:
        print("serving smoke: mux leg (OCM_MUX cold tier, AsyncOcm "
              "prefetch) ...")
        mx = run_pair(seed, tenants=3, shared_tokens=20, suffix_tokens=4,
                      new_tokens=8, hot=3, warm=4, mux=True, device=device)
        mode = mx["cells"]["shared"]["prefetch"]["mode"]
        print(f"  prefetch mode: {mode}, hit "
              f"{mx['cells']['shared']['hit_ratio']:.2f}")
        if mode != "async":
            print("serving smoke: FAIL — mux cold tier did not ride "
                  f"AsyncOcm prefetch (mode={mode})")
            return 1

    print(f"serving smoke: chaos leg (kill cold-page owner mid-decode, "
          f"OCM_REPLICAS=2), seed={seed}, two audited runs ...")
    with obs_audit.recorded("serving-chaos") as rec:
        chaos = run_chaos(seed, new_tokens=16, hot=2, warm=2, device=device)
    print(f"  flight recorder: {rec.summary()}")
    print(f"  owner rank {chaos['owner_killed']} killed; "
          f"{chaos['tokens']} tokens byte-exact through failover; "
          f"chaos log {chaos['chaos_log']}")

    print(f"serving smoke: warm-boot leg (persist prefix trie, chaos "
          f"restart of every daemon, cold-vs-warm arms), seed={seed}, "
          f"two audited runs ...")
    with obs_audit.recorded("serving-warmboot") as rec:
        wb = run_warmboot(seed, device=device)
    print(f"  flight recorder: {rec.summary()}")
    print(f"  {wb['persisted_extents']} extents persisted; ranks "
          f"{wb['restarted_ranks']} restarted; prefix hit ratio "
          f"cold {wb['prefix_hit_ratio']['cold']} -> warm "
          f"{wb['prefix_hit_ratio']['warm']}; mean TTFT "
          f"cold {wb['ttft_mean_s']['cold']}s -> warm "
          f"{wb['ttft_mean_s']['warm']}s; byte-exact, replay identical")
    # The kernels' launches of this process (HOT page puts and gets, the
    # token steps' attention).
    print("serving smoke: launches " + json.dumps(dma.launches()))
    print("serving smoke: OK — paired cells byte-identical, sharing "
          "measurably cheaper, CoW exercised, chaos decode byte-exact "
          "with deterministic replay, warm boot beats cold restart, "
          "audit clean, ledger drained")
    return 0


def run_bench(seed: int = 1234, *, chaos: bool = True,
              batched: bool = True, device=None) -> dict:
    """The measured cells for the bench's ``detail.serving``; ``launches``
    counts the kernels' launches of this process."""
    from oncilla_tpu_torch.obs import audit as obs_audit
    from oncilla_tpu_torch.ops import dma

    device = resolve_device(device)
    # shared 28 + suffix 4 = a page-aligned 32-token prompt: the
    # identical t0/t1 pair then exercises the whole-page CoW adoption
    # in the measured cell, not just in the smoke.
    out = run_pair(seed, tenants=6, shared_tokens=28, suffix_tokens=4,
                   new_tokens=16, hot=4, warm=6, device=device)
    for cell in out["cells"].values():
        cell.pop("outputs")  # token ids are not a metric
    if batched:
        out["batched_sweep"] = run_batched_sweep(seed, device=device)
    if chaos:
        with obs_audit.recorded("serving-bench-chaos") as rec:
            out["chaos"] = run_chaos(seed, new_tokens=16, hot=2, warm=2,
                                     device=device)
        out["chaos"]["audit"] = rec.summary()
    with obs_audit.recorded("serving-bench-warmboot") as rec:
        out["warmboot"] = run_warmboot(seed, device=device)
    out["warmboot"]["audit"] = rec.summary()
    out["launches"] = dma.launches()
    out["note"] = (
        f"on {device}: tok/s of the tiny float32 model; the remote tier is "
        "three in-process daemons on loopback"
    )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m oncilla_tpu_torch.serving",
        description="disaggregated LLM serving harness (tiered paged KV "
                    "+ cross-tenant prefix sharing)",
    )
    ap.add_argument("--smoke", action="store_true",
                    help="end-to-end proof, in-process daemons")
    ap.add_argument("--bench", action="store_true",
                    help="measured paired cells + chaos leg, one JSON "
                         "dict on stdout")
    ap.add_argument("--no-chaos", action="store_true",
                    help="with --bench: skip the chaos leg")
    ap.add_argument("--no-mux", action="store_true",
                    help="with --smoke: skip the OCM_MUX/AsyncOcm leg")
    ap.add_argument("--batched", action="store_true",
                    help="run ONLY the batched-vs-interleaved throughput "
                         "sweep (batch 1/2/4/8), one JSON dict on stdout")
    ap.add_argument("--no-batched", action="store_true",
                    help="with --bench: skip the batched sweep axis")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu'; without CUDA and without "
                         "'cpu' the harness raises")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke(args.seed, mux=False if args.no_mux else None,
                     device=args.device)
    if args.batched:
        print(json.dumps(run_batched_sweep(args.seed, device=args.device)))
        return 0
    if args.bench:
        print(json.dumps(run_bench(args.seed, chaos=not args.no_chaos,
                                   batched=not args.no_batched,
                                   device=args.device)))
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
