"""The port's batched serving engine (one step per tick for every seated
session, chunked prefill, priority seating, the step budget), held against
its own interleaved engine and against the JAX package on the CPU.

Mirrors the five cases of ``tests/test_serving_batched.py``; the JAX jit
cache bound becomes a bound on the CUDA graphs the engine keeps (one per
step function and shape bucket; on the CPU a graphed step runs on its
static buffers without a capture, with the same bookkeeping). Then
``paged_decode_batch_step`` against ``paged_decode_batch_step_jit`` on the
same numpy inputs (logits and tails within 1e-5), and the engine against
the JAX engine on ``seeded_prompts(cfg, 11, n=5)``, batched and
interleaved.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oncilla_tpu as jocm
import oncilla_tpu_torch as tocm
from oncilla_tpu.models import kv_paging as jkv
from oncilla_tpu.models import llama as jllama
from oncilla_tpu.serving.engine import Request as JRequest
from oncilla_tpu.serving.engine import ServingEngine as JEngine
from oncilla_tpu.serving.metrics import ServingStats as JStats
from oncilla_tpu.serving.prefix import PrefixCache as JPrefix
from oncilla_tpu.serving.tiers import TieredPageStore as JStore
from oncilla_tpu_torch.models import kv_paging as tkv
from oncilla_tpu_torch.models import llama as tllama
from oncilla_tpu_torch.serving.engine import Request, ServingEngine
from oncilla_tpu_torch.serving.metrics import ServingStats
from oncilla_tpu_torch.serving.prefix import PrefixCache
from oncilla_tpu_torch.serving.tiers import Tier, TieredPageStore

P = 8  # page_tokens for every engine in this file
ATOL = 1e-5


@pytest.fixture(scope="module")
def tiny_model():
    """(JAX cfg, JAX params, port cfg, port params): the same weights."""
    jcfg = jllama.LlamaConfig.tiny()
    jp = jllama.init_params_host(0, jcfg)
    tp = tllama.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                device="cpu")
    return jcfg, jp, tllama.LlamaConfig.tiny(), tp


def build_engine(tiny_model, *, share=True, hot=3, warm=4, prefetch=0,
                 max_active=4, batched=True, max_batch=None,
                 step_budget_ms=None, graphs=False, name="t"):
    _, _, cfg, params = tiny_model
    ctx = tocm.Ocm(config=tocm.OcmConfig(
        host_arena_bytes=1 << 20, device_arena_bytes=1 << 20), device="cpu")
    store = TieredPageStore(ctx, ServingEngine.page_nbytes(cfg, P),
                            hot_capacity=hot, warm_capacity=warm,
                            stats=ServingStats(name))
    prefix = PrefixCache(store, P) if share else None
    eng = ServingEngine(params, cfg, store, prefix, page_tokens=P,
                        max_active=max_active, prefetch_workers=prefetch,
                        name=name, batched=batched, max_batch=max_batch,
                        step_budget_ms=step_budget_ms)
    if graphs:  # the card's graph cache, its bookkeeping run on the CPU
        eng.graphs = tkv.StepGraphs(params, cfg)
    return ctx, store, eng


def run_prompts(tiny_model, prompts, *, new_tokens=6, priorities=None,
                keep_graph_keys=None, **kw):
    ctx, store, eng = build_engine(tiny_model, **kw)
    try:
        for i, p in enumerate(prompts):
            req = Request(tenant=f"t{i}", tokens=list(p),
                          max_new_tokens=new_tokens)
            if priorities is not None:
                req.priority = priorities[i]
            eng.submit(req)
        results = eng.run()
        outs = {r.tenant: list(r.out_tokens) for r in results}
        order = [r.tenant for r in results]
        meta = eng.metrics_meta()
        if keep_graph_keys is not None:
            keep_graph_keys.extend(eng.graphs.steps)
    finally:
        eng.close()
        store.close()
        ctx.tini()
    return outs, meta, order


def run_jax(tiny_model, prompts, *, new_tokens, hot, warm, batched,
            max_active=4):
    cfg, params, _, _ = tiny_model
    ctx = jocm.Ocm(config=jocm.OcmConfig(
        host_arena_bytes=1 << 20, device_arena_bytes=1 << 20))
    store = JStore(ctx, JEngine.page_nbytes(cfg, P), hot_capacity=hot,
                   warm_capacity=warm, stats=JStats("j"))
    eng = JEngine(params, cfg, store, JPrefix(store, P), page_tokens=P,
                  max_active=max_active, prefetch_workers=0, name="j",
                  batched=batched)
    try:
        for i, p in enumerate(prompts):
            eng.submit(JRequest(tenant=f"t{i}", tokens=list(p),
                                max_new_tokens=new_tokens))
        return {r.tenant: list(r.out_tokens) for r in eng.run()}
    finally:
        eng.close()
        store.close()
        ctx.tini()


def seeded_prompts(cfg, seed, *, n=4, shared=20, suffix=4):
    """A shared prefix, one identical pair (t0/t1) and per-tenant
    suffixes (tests/test_serving_batched.py:77)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, cfg.vocab, shared).tolist()
    p0 = base + rng.integers(1, cfg.vocab, suffix).tolist()
    prompts = [p0, list(p0)]
    for _ in range(n - 2):
        prompts.append(base + rng.integers(1, cfg.vocab, suffix).tolist())
    return prompts


# -- 1. paired equality through tier churn + CoW adoption -------------------


def test_batched_matches_interleaved_through_churn_and_cow(tiny_model):
    cfg = tiny_model[2]
    prompts = seeded_prompts(cfg, 11, n=5, shared=20, suffix=4)
    kw = dict(share=True, hot=2, warm=2, new_tokens=8, max_active=4)
    outs_il, _, _ = run_prompts(tiny_model, prompts, batched=False, **kw)
    outs_b, meta_b, _ = run_prompts(tiny_model, prompts, batched=True, **kw)
    assert outs_b == outs_il
    assert outs_b["t0"] == outs_b["t1"]
    assert meta_b["batch"]["steps"] > 0
    assert meta_b["batch"]["size_max"] >= 2
    assert meta_b["moves"]["demote"] > 0
    assert meta_b["moves"]["promote"] > 0
    assert meta_b["prefix"]["hits"] > 0
    assert meta_b["prefix"]["cow"] >= 1


# -- 2. chunked prefill ----------------------------------------------------


def test_chunked_prefill_admits_long_prompt_in_slices(tiny_model):
    cfg = tiny_model[2]
    rng = np.random.default_rng(23)
    long = rng.integers(1, cfg.vocab, 6 * P).tolist()
    shorts = [rng.integers(1, cfg.vocab, 5).tolist() for _ in range(3)]
    prompts = [long] + shorts
    kw = dict(share=False, hot=6, warm=8, new_tokens=10, max_active=4)
    outs_il, meta_il, _ = run_prompts(tiny_model, prompts, batched=False, **kw)
    outs_b, meta_b, _ = run_prompts(tiny_model, prompts, batched=True, **kw)
    assert outs_b == outs_il
    b = meta_b["batch"]
    assert b["prefill_chunks"] >= 6
    assert b["steps"] >= kw["new_tokens"]
    assert b["size_max"] >= 2
    assert meta_b["tokens"]["prefill"] == sum(len(p) for p in prompts)
    assert meta_b["tokens"]["prefill"] == meta_il["tokens"]["prefill"]


# -- 3. admission-aware scheduler ------------------------------------------


def test_scheduler_prio_high_admitted_and_seated_first(tiny_model):
    from oncilla_tpu_torch.qos.policy import PRIO_HIGH, PRIO_NORMAL

    cfg = tiny_model[2]
    rng = np.random.default_rng(31)
    prompts = [rng.integers(1, cfg.vocab, 6).tolist() for _ in range(4)]
    prios = [PRIO_NORMAL, PRIO_NORMAL, PRIO_NORMAL, PRIO_HIGH]
    kw = dict(share=False, new_tokens=6, max_active=4, max_batch=2)
    outs_b, meta_b, order = run_prompts(tiny_model, prompts, priorities=prios,
                                        batched=True, **kw)
    assert order[0] == "t3"
    assert meta_b["preempts"].get("slot", 0) >= 1
    outs_il, _, _ = run_prompts(tiny_model, prompts, priorities=prios,
                                batched=False, share=False, new_tokens=6,
                                max_active=4)
    assert outs_b == outs_il


def test_scheduler_expired_budget_degrades_to_stall(tiny_model):
    cfg = tiny_model[2]
    rng = np.random.default_rng(37)
    prompt = rng.integers(1, cfg.vocab, 2 * P).tolist()
    ctx, store, eng = build_engine(tiny_model, share=False, hot=4, warm=4,
                                   prefetch=2, batched=True,
                                   step_budget_ms=20)
    try:
        eng.submit(Request(tenant="t0", tokens=list(prompt),
                           max_new_tokens=4))
        while not eng.active or any(eng._bulk_prefill(s) for s in eng.active):
            eng._tick()
        sess = eng.active[0]
        page = sess.entries[0].page
        store.demote(page, Tier.WARM)
        # A prefetch that never lands: the wait expires at the budget and
        # degrades to a synchronous fault, recorded as stall.
        eng.prefetcher._futures[page.page_id] = cf.Future()
        stalls0 = eng.stats.stalls
        eng._tick()
        assert eng.stats.stalls > stalls0
        assert eng.stats.stall_s > 0
        assert eng.stats.preempts.get("cold_page", 0) >= 1
        results = eng.run()
        outs = {r.tenant: list(r.out_tokens) for r in results}
    finally:
        eng.close()
        store.close()
        ctx.tini()
    clean, _, _ = run_prompts(tiny_model, [prompt], new_tokens=4,
                              share=False, hot=4, warm=4, batched=True)
    assert outs["t0"] == clean["t0"]


# -- 4. graphs bounded by shape buckets ------------------------------------


def test_batched_graphs_bounded_by_shape_buckets(tiny_model):
    cfg = tiny_model[2]
    rng = np.random.default_rng(41)
    prompts = [rng.integers(1, cfg.vocab, ln).tolist()
               for ln in (5, 9, 17, 25, 30)]

    def workload(keys):
        return run_prompts(tiny_model, prompts, new_tokens=12, share=False,
                           hot=8, warm=8, max_active=5, batched=True,
                           graphs=True, keep_graph_keys=keys)

    first_keys: list = []
    outs, meta, _ = workload(first_keys)
    batch_keys = [k for k in first_keys if k[0] is tkv.paged_decode_batch_step]
    tokens = sum(len(o) for o in outs.values()) + meta["tokens"]["prefill"]
    # B buckets {1,2,4,8} x page buckets {1,2,4}: nowhere near the tokens.
    assert meta["batch"]["steps"] > 0
    assert 0 < len(batch_keys) <= 8
    assert len(batch_keys) < tokens / 10
    for _, shapes in batch_keys:
        b, mp = shapes[4][0]  # the table's (B, MP)
        n = shapes[2][0][0]   # the pool's rows
        assert all(x & (x - 1) == 0 for x in (b, n)) and (mp & (mp - 1)) == 0
    # A second identical workload needs exactly the same graphs, and the
    # graphed steps emit the eager engine's tokens.
    second_keys: list = []
    outs2, _, _ = workload(second_keys)
    assert second_keys == first_keys
    assert outs2 == outs
    eager, _, _ = run_prompts(tiny_model, prompts, new_tokens=12, share=False,
                              hot=8, warm=8, max_active=5, batched=True)
    assert eager == outs


@pytest.mark.parametrize("batched", [False, True])
def test_page_graphs_bounded_by_context_buckets(tiny_model, batched):
    """A long prompt grows its context a page at a time, through chunked
    prefill (batched) or interleaved turns: the token-step graphs it leaves
    are one per power of two of context pages, not one per page, and the
    graphed steps emit the eager engine's tokens."""
    cfg = tiny_model[2]
    n_pages = 20
    prompt = np.random.default_rng(43).integers(1, cfg.vocab,
                                                n_pages * P + 3).tolist()
    kw = dict(new_tokens=2 * P, share=False, hot=8, warm=32, batched=batched)
    keys: list = []
    outs, _, _ = run_prompts(tiny_model, [prompt], graphs=True,
                             keep_graph_keys=keys, **kw)
    ctx_pages = [shapes[2][0][3] // P for fn, shapes in keys
                 if fn is tkv.paged_token_step]
    # At most 22 context pages (20 of prompt, 2 of decode): the empty
    # context and the powers of two up to 32, one graph each.
    assert sorted(ctx_pages) == [0, 1, 2, 4, 8, 16, 32]
    eager, _, _ = run_prompts(tiny_model, [prompt], **kw)
    assert outs == eager


# -- the batched step against the JAX jit ----------------------------------


@pytest.mark.parametrize("window", [None, 12])
def test_paged_decode_batch_step_matches_jax(tiny_model, window, rng):
    _, jp, _, tp = tiny_model
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), window=window)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), window=window)
    L, KV, Hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    N, MP, B = 4, 2, 4
    pool_k = rng.standard_normal((N, L, KV, P, Hd), dtype=np.float32)
    pool_v = rng.standard_normal((N, L, KV, P, Hd), dtype=np.float32)
    tail_k = rng.standard_normal((L, B, KV, P, Hd), dtype=np.float32)
    tail_v = rng.standard_normal((L, B, KV, P, Hd), dtype=np.float32)
    table = np.array([[2, 0], [1, 3], [3, 0], [0, 0]], np.int32)
    # [pos, tail_len, ctx_len, ctx_start]: two pages, one page, no page,
    # and a bucket-padded row (everything 0).
    meta = np.array([[19, 3, 16, 0], [13, 5, 8, 0], [2, 2, 0, 0],
                     [0, 0, 0, 0]], np.int32)
    toks = rng.integers(0, jcfg.vocab, B)
    jl, jtk, jtv = jkv.paged_decode_batch_step_jit(
        jp, jnp.asarray(toks, jnp.int32), jnp.asarray(meta),
        jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(table),
        jnp.asarray(tail_k), jnp.asarray(tail_v), jcfg)
    ttk, ttv = torch.from_numpy(tail_k.copy()), torch.from_numpy(tail_v.copy())
    tl, rk, rv = tkv.paged_decode_batch_step(
        tp, torch.from_numpy(toks), torch.from_numpy(meta).long(),
        torch.from_numpy(pool_k), torch.from_numpy(pool_v),
        torch.from_numpy(table).long(), ttk, ttv, tcfg)
    assert rk is ttk and rv is ttv  # in place, as the jit donates
    assert torch.isfinite(tl).all()  # the padded row too
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ttk.numpy(), np.asarray(jtk), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ttv.numpy(), np.asarray(jtv), rtol=0, atol=ATOL)


def test_batch_row_equals_the_single_row_step(tiny_model, rng):
    """A session's row of the padded batched step is the batch-of-1 step
    on the same page (the equality the batched engine leans on)."""
    _, _, cfg, tp = tiny_model
    L, KV, Hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    pool_k = torch.from_numpy(rng.standard_normal((2, L, KV, P, Hd), dtype=np.float32))
    pool_v = torch.from_numpy(rng.standard_normal((2, L, KV, P, Hd), dtype=np.float32))
    tail = torch.from_numpy(rng.standard_normal((L, 2, KV, P, Hd), dtype=np.float32))
    meta = torch.tensor([[11, 3, 8, 0], [0, 0, 0, 0]])
    toks = torch.tensor([7, 0])
    bl, bk, _ = tkv.paged_decode_batch_step(
        tp, toks, meta, pool_k, pool_v, torch.tensor([[1], [0]]),
        tail.clone(), tail.clone(), cfg)
    k1 = tail[:, :1].clone()
    sl, sk, _ = tkv.paged_token_step(
        tp, toks[:1], meta[:1], pool_k[1][:, None], pool_v[1][:, None], k1,
        k1.clone(), cfg)
    np.testing.assert_allclose(bl[:1].numpy(), sl.numpy(), rtol=0, atol=ATOL)
    assert torch.equal(bl[:1].argmax(-1), sl.argmax(-1))
    np.testing.assert_allclose(bk[:, :1].numpy(), sk.numpy(), rtol=0, atol=ATOL)


# -- the engine against the JAX engine -------------------------------------


@pytest.mark.parametrize("batched", [False, True])
def test_engine_matches_jax_engine_on_seeded_prompts(tiny_model, batched):
    prompts = seeded_prompts(tiny_model[2], 11, n=5)
    kw = dict(new_tokens=8, hot=2, warm=2, batched=batched)
    want = run_jax(tiny_model, prompts, **kw)
    got, meta, _ = run_prompts(tiny_model, prompts, share=True, **kw)
    assert got == want
    assert meta["moves"]["demote"] > 0 and meta["prefix"]["cow"] >= 1


# -- chip_smoke's engine phase, rehearsed on the CPU -----------------------


def test_chip_smoke_engine_phase_rehearsal_on_the_cpu(tiny_model):
    """Phase 5b at the tiny width: runs A-E, then checks a-f (launch
    counts aside: no kernel runs on the CPU). A wrong token, a first step
    that is not bit-equal, or a HOT get that missed its kernel launch must
    each fail the checks."""
    import chip_smoke

    _, _, cfg, params = tiny_model
    runs = tuple((n, b, w, g, 2 if hot == 8 else 64)
                 for n, b, w, g, hot in chip_smoke.ENGINE_RUNS)
    report = chip_smoke.phase_engine(torch.device("cpu"), cfg, params,
                                     page_tokens=P, runs=runs, shared=20,
                                     suffix=4, new_tokens=8, warm=2)
    chip_smoke.check_engine(report, check_launches=False)
    runs = report["runs"]
    assert runs["B"]["hot_io"]["put"] > 0 and runs["B"]["hot_io"]["get"] > 0
    assert report["batched_vs_interleaved"]["steps_held"] > 0
    # A-D fault synchronously; E is the engine as shipped (eager on a CPU).
    assert all(runs[n]["prefetch"]["mode"] == "off" for n in "ABCD")
    assert runs["E"]["shipped"] and runs["E"]["graphs"] is None
    assert runs["C"]["graphs"]["steps"] > 0
    runs["E"]["prefetch"]["mode"] = "off"
    with pytest.raises(AssertionError, match="prefetch not threaded"):
        chip_smoke.check_engine(report, check_launches=False)
    runs["E"]["prefetch"]["mode"] = "thread"

    runs["C"]["out"]["t2"] = runs["C"]["out"]["t2"][:-1] + [0]
    with pytest.raises(AssertionError, match="run C"):
        chip_smoke.check_engine(report, check_launches=False)
    runs["C"]["out"] = runs["B"]["out"]
    bucket = next(iter(runs["C"]["first"]))
    rows, logits = runs["C"]["first"][bucket]
    runs["C"]["first"][bucket] = (rows, logits + 1e-3)
    with pytest.raises(AssertionError, match="bit for bit"):
        chip_smoke.check_engine(report, check_launches=False)
    runs["C"]["first"][bucket] = (rows, logits)
    for r in runs.values():
        r["launches"] = {"write_rows": r["hot_io"]["put"],
                         "read_rows": r["hot_io"]["get"], "local_copy": 0}
    chip_smoke.check_engine(report)
    runs["B"]["launches"]["read_rows"] -= 1
    with pytest.raises(AssertionError, match="K1/K2 launches"):
        chip_smoke.check_engine(report)
