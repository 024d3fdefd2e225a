"""The port's serving engine with its COLD tier on a remote host, held
against the JAX engine with its cold client on the CPU.

The JAX engine's COLD tier is a ``ControlPlaneClient`` declaring PRIO_LOW
over the JAX package's in-process cluster (the serving harness's cold
client, ``oncilla_tpu/serving/__main__.py:65-73``); the port's is its own
client over two of the port's native daemons. Same weights, same prompts,
tiers small enough that pages demote to COLD and come back: the emitted
tokens must be equal (tolerance 0), ``cold_sim`` False, COLD puts and gets
above zero and equal to the client's wire transfers, and every daemon
drained after the store closes. The port runs with two prefetch workers,
which read COLD pages over the wire from their own threads; with a mux cold
client (``OCM_MUX=1``, the port's daemons in this process) the prefetcher
runs its AsyncOcm leg instead, coroutines on the client's event loop, and
the tokens are the JAX engine's all the same.
"""

import dataclasses

import numpy as np
import pytest
import torch

import oncilla_tpu as jocm
import oncilla_tpu_torch as tocm
from oncilla_tpu.models import llama as jllama
from oncilla_tpu.qos.policy import PRIO_LOW as J_PRIO_LOW
from oncilla_tpu.runtime.client import ControlPlaneClient as JClient
from oncilla_tpu.runtime.cluster import local_cluster as jax_cluster
from oncilla_tpu.serving.engine import Request as JRequest
from oncilla_tpu.serving.engine import ServingEngine as JEngine
from oncilla_tpu.serving.metrics import ServingStats as JStats
from oncilla_tpu.serving.prefix import PrefixCache as JPrefix
from oncilla_tpu.serving.tiers import TieredPageStore as JStore
from oncilla_tpu_torch.models import llama as tllama
from oncilla_tpu_torch.qos.policy import PRIO_LOW
from oncilla_tpu_torch.runtime.cluster import inprocess_cluster, local_cluster
from oncilla_tpu_torch.serving.engine import Request, ServingEngine
from oncilla_tpu_torch.serving.metrics import ServingStats
from oncilla_tpu_torch.serving.prefix import PrefixCache
from oncilla_tpu_torch.serving.tiers import TieredPageStore

PAGE_TOKENS, HOT, WARM, NEW = 8, 2, 2, 6


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = jllama.LlamaConfig.tiny()
    jp = jllama.init_params_host(0, jcfg)
    tp = tllama.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                device="cpu")
    return jcfg, jp, tllama.LlamaConfig.tiny(), tp


@pytest.fixture(scope="module")
def prompts(tiny_model):
    rng = np.random.default_rng(21)
    shared = rng.integers(1, tiny_model[2].vocab, 20).tolist()
    p0 = shared + rng.integers(1, tiny_model[2].vocab, 5).tolist()
    return [p0, list(p0)] + [shared + rng.integers(1, tiny_model[2].vocab, 3).tolist()
                             for _ in range(2)]


def run_jax(tiny_model, prompts, batched):
    cfg, params, _, _ = tiny_model
    ccfg = jocm.OcmConfig(host_arena_bytes=8 << 20, device_arena_bytes=1 << 20,
                          chunk_bytes=64 << 10, heartbeat_s=0.2)
    with jax_cluster(2, config=ccfg) as cl:
        cold = JClient(cl.entries, 0,
                       config=dataclasses.replace(ccfg, priority=J_PRIO_LOW))
        ctx = jocm.Ocm(config=jocm.OcmConfig(host_arena_bytes=1 << 20,
                                             device_arena_bytes=1 << 20))
        store = JStore(ctx, JEngine.page_nbytes(cfg, PAGE_TOKENS),
                       hot_capacity=HOT, warm_capacity=WARM, cold_backend=cold,
                       stats=JStats("j"))
        eng = JEngine(params, cfg, store, JPrefix(store, PAGE_TOKENS),
                      page_tokens=PAGE_TOKENS, max_active=4, prefetch_workers=0,
                      name="j", batched=batched)
        try:
            for i, p in enumerate(prompts):
                eng.submit(JRequest(tenant=f"t{i}", tokens=p, max_new_tokens=NEW))
            return {r.tenant: list(r.out_tokens) for r in eng.run()}
        finally:
            eng.close()
            store.close()
            ctx.tini()
            cold.close()


def run_port(tiny_model, prompts, batched, prefetch):
    _, _, cfg, params = tiny_model
    ccfg = tocm.OcmConfig(host_arena_bytes=1 << 20, device_arena_bytes=1 << 20,
                          chunk_bytes=64 << 10, heartbeat_s=0.2)
    with local_cluster(2, host_arena_bytes=8 << 20) as cl:
        cold = cl.client(0, config=dataclasses.replace(ccfg, priority=PRIO_LOW))
        ctx = tocm.Ocm(config=ccfg, device="cpu")
        store = TieredPageStore(ctx, ServingEngine.page_nbytes(cfg, PAGE_TOKENS),
                                hot_capacity=HOT, warm_capacity=WARM,
                                cold_backend=cold, stats=ServingStats("t"))
        eng = ServingEngine(params, cfg, store, PrefixCache(store, PAGE_TOKENS),
                            page_tokens=PAGE_TOKENS, max_active=4,
                            prefetch_workers=prefetch, name="t", batched=batched)
        try:
            for i, p in enumerate(prompts):
                eng.submit(Request(tenant=f"t{i}", tokens=p, max_new_tokens=NEW))
            out = {r.tenant: list(r.out_tokens) for r in eng.run()}
            meta = eng.metrics_meta()
        finally:
            eng.close()
            store.close()
            ctx.tini()
        drained = [cl.status(r)["live_allocs"] for r in range(2)]
        return out, meta, dict(store.io["remote"]), dict(cold.transfers), drained


@pytest.mark.parametrize("batched", [False, True])
def test_engine_over_a_remote_cold_tier_matches_jax(tiny_model, prompts, batched):
    want = run_jax(tiny_model, prompts, batched)
    got, meta, cold_io, transfers, drained = run_port(tiny_model, prompts,
                                                      batched, prefetch=2)
    assert got == want
    assert all(len(v) == NEW for v in got.values())
    assert meta["cold_sim"] is False
    assert meta["prefetch"]["mode"] == "thread"
    assert cold_io["put"] > 0 and cold_io["get"] > 0
    assert (cold_io["put"], cold_io["get"]) == (transfers["put"], transfers["get"])
    assert drained == [0, 0]


def run_port_mux(tiny_model, prompts, batched):
    """The port's engine with its COLD tier behind a PRIO_LOW mux client of
    the port's in-process daemons: (tokens, meta, COLD reads on the async
    leg, live allocations after close)."""
    _, _, cfg, params = tiny_model
    ccfg = tocm.OcmConfig(host_arena_bytes=8 << 20, device_arena_bytes=1 << 20,
                          chunk_bytes=64 << 10, heartbeat_s=0.2)
    with inprocess_cluster(2, config=ccfg) as cl:
        cold = cl.client(0, config=dataclasses.replace(
            ccfg, priority=PRIO_LOW, mux=True))
        ctx = tocm.Ocm(config=dataclasses.replace(ccfg, host_arena_bytes=1 << 20),
                       device="cpu")
        store = TieredPageStore(ctx, ServingEngine.page_nbytes(cfg, PAGE_TOKENS),
                                hot_capacity=HOT, warm_capacity=WARM,
                                cold_backend=cold, stats=ServingStats("m"))
        eng = ServingEngine(params, cfg, store, PrefixCache(store, PAGE_TOKENS),
                            page_tokens=PAGE_TOKENS, max_active=4,
                            prefetch_workers=2, name="m", batched=batched)
        try:
            assert eng.prefetcher.mode == "async"
            for i, p in enumerate(prompts):
                eng.submit(Request(tenant=f"t{i}", tokens=p, max_new_tokens=NEW))
            out = {r.tenant: list(r.out_tokens) for r in eng.run()}
            meta = eng.metrics_meta()
            async_gets = eng.prefetcher._aocm.tracer.transfers()
        finally:
            eng.close()
            store.close()
            ctx.tini()
        drained = sum(d.registry.live_count() for d in cl.daemons)
        return out, meta, [t for t in async_gets if t["fabric"] == "mux"], drained


@pytest.mark.parametrize("batched", [False, True])
def test_engine_over_a_mux_cold_tier_runs_async_and_matches_jax(
        tiny_model, prompts, batched):
    want = run_jax(tiny_model, prompts, batched)
    got, meta, mux_transfers, drained = run_port_mux(tiny_model, prompts,
                                                     batched)
    assert got == want
    assert meta["prefetch"]["mode"] == "async"
    assert meta["cold_sim"] is False
    assert meta["prefetch"]["issued"] > 0, "no COLD page was prefetched"
    assert any(t["op"] == "get" for t in mux_transfers), \
        "no COLD read rode the mux channel"
    assert drained == 0


def test_chip_smoke_wire_phase_rehearsal_on_the_cpu(tiny_model):
    """Phase 8 at tiny sizes on the CPU, runs F and G included against runs
    E and C of the same settings (launch counts aside: no kernel runs
    here), and check (f), the C library's device leg, on CPU rows; a run G
    whose tokens differ from C's must fail check (e)."""
    import chip_smoke

    _, _, cfg, params = tiny_model
    runs = (("C", True, 0, True, 2), ("E", True, 2, None, 2))
    kw = dict(shared=20, suffix=4, new_tokens=8, warm=2)
    cpu = torch.device("cpu")
    ref = chip_smoke.phase_engine(cpu, cfg, params, page_tokens=PAGE_TOKENS,
                                  runs=runs, **kw)["runs"]
    engine = {"cfg": cfg, "params": params, "page_tokens": PAGE_TOKENS,
              "runs": ref, "kw": kw}
    small = dict(row_bytes=1 << 20, host_bytes=(4 << 20, 16 << 20),
                 sizes=(4096, (1 << 20) + 4096, 3 << 20), matrix_bytes=64 << 10,
                 timed=(64 << 10,), reps=2, alloc_iters=10, placed=(64 << 10, 3),
                 libocm=(64 << 10, 256 << 10), concurrent=(256 << 10, 2),
                 check_launches=False)
    rep = chip_smoke.phase_wire(cpu, engine=engine, **small)
    conc = rep["concurrent"]  # (a2): CPU tensors take no staging buffer
    assert (conc["nbytes"], conc["rounds"], conc["peak_buffers"]) == (256 << 10, 2, 0)
    e = rep["engine"]
    assert e["g_vs_c_tokens_equal"] == e["tokens"] > 0
    assert e["f_vs_e"]["held_equal"] and e["cold_sim"] == [False, False]
    assert e["cold_io"]["F"]["put"] > 0 and e["cold_io"]["G"]["get"] > 0
    assert e["drained"] == [0, 0]
    assert e["cold_pages_checked"] == (e["cold_io"]["F"]["get"]
                                       + e["cold_io"]["G"]["get"])
    assert e["cold_pages_mismatched"] == 0
    assert rep["placed"]["relayed"]["PLANE_PUT"] >= 1
    lib = rep["libocm"]  # (f): the C library's device leg on CPU rows
    assert lib["demo"]["passes"] == 3 and lib["nbytes"] == 256 << 10
    assert lib["relayed"]["PLANE_PUT"] >= 1 and lib["relayed"]["PLANE_GET"] >= 1
    assert [r["nbytes"] for r in lib["rates"]] == [64 << 10, 256 << 10]
    assert set(rep["errors"]) == {"remote_host_past_end", "remote_device_past_end",
                                  "alloc_past_rank1_arena", "double_free",
                                  "use_after_tini"}
    ref["C"]["out"]["t0"] = ref["C"]["out"]["t0"][:-1] + [ref["C"]["out"]["t0"][-1] + 1]
    with pytest.raises(AssertionError, match="run G's tokens differ"):
        chip_smoke.phase_wire(cpu, engine=engine, **small)


_SOUND = {"rows": 40, "max_abs_logit_diff": 0.07, "steps_held": 20,
          "held_equal": True}


@pytest.mark.parametrize("bad", [
    None, {"held_equal": False}, {"max_abs_logit_diff": 0.3},
    {"steps_held": 9}, {"rows": 0, "steps_held": 0}])
def test_margin_rule_has_fixed_limits(bad):
    """The margin rule fails a token that differs where it decides, a
    largest logit difference past 0.25 and fewer than a quarter of the rows
    held, whatever rows it still holds."""
    import chip_smoke

    if bad is None:
        chip_smoke._hold_margin("sound", _SOUND)
        return
    with pytest.raises(AssertionError, match="margin"):
        chip_smoke._hold_margin("faulty", {**_SOUND, **bad})


def test_checked_cold_counts_a_wrong_page():
    """``CheckedCold`` compares every page a COLD client serves, on the
    thread that reads it, with the bytes put: a client that hands back a
    wrong byte is counted as mismatched."""
    import threading

    import chip_smoke

    class Client:
        transfers = {"put": 0, "get": 0}

        def __init__(self):
            self.blobs, self.flip = {}, False

        def alloc(self, nbytes, kind):
            h = tocm.OcmAlloc(alloc_id=len(self.blobs) * 2 + 2, kind=kind,
                              fabric=tocm.Fabric.LOCAL, nbytes=nbytes, rank=1,
                              device_index=0, extent=None, origin_rank=0)
            self.blobs[h.alloc_id] = torch.zeros(nbytes, dtype=torch.uint8)
            return h

        def free(self, h):
            del self.blobs[h.alloc_id]

        def put(self, h, data, offset):
            self.blobs[h.alloc_id][offset:offset + data.numel()] = data

        def get_into(self, h, out, offset):
            out.copy_(self.blobs[h.alloc_id][offset:offset + out.numel()])
            if self.flip:
                out[-1] ^= 1
            return out

    client = Client()
    cold = chip_smoke.CheckedCold(client)
    pages = [torch.from_numpy(np.random.default_rng(i).integers(
        0, 256, 4096, dtype=np.uint8)) for i in range(2)]
    hs = [cold.alloc(4096, tocm.OcmKind.REMOTE_HOST) for _ in pages]
    for h, p in zip(hs, pages):
        cold.put(h, p, 0)
    outs = [torch.empty(4096, dtype=torch.uint8) for _ in hs]
    readers = [threading.Thread(target=cold.get_into, args=(h, o, 0))
               for h, o in zip(hs, outs)]
    for t in readers:
        t.start()
    for t in readers:
        t.join()
    assert (cold.checked, cold.mismatched) == (2, 0)
    assert all(torch.equal(o, p) for o, p in zip(outs, pages))
    client.flip = True
    cold.get_into(hs[0], outs[0], 0)
    assert (cold.checked, cold.mismatched) == (3, 1)
    for h in hs:
        cold.free(h)
