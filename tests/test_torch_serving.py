"""The port's serving subsystem held against the JAX package on the CPU.

Mirrors every case of ``tests/test_serving.py`` that runs without a
cluster (tiered store, prefix cache, engine, metrics registry,
``fetch_pages(out=)``, package exports), on the port's own classes; then
holds the port's engine against the JAX engine on the same workloads
(emitted tokens equal, batched and interleaved), and the model pieces the
engine adds (masked attention, ``sample_token``, ``PagedDecoder``, the
page-fused decoder steps) against their JAX counterparts. JAX's parameters
are carried over with ``params_from_jax``; in float32 the frameworks differ
only in summation order, so logits agree to 1e-5 and greedy tokens are
equal.
"""

from __future__ import annotations

import dataclasses

import jax
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
from oncilla_tpu_torch.core.errors import OcmInvalidHandle
from oncilla_tpu_torch.models import kv_paging as tkv
from oncilla_tpu_torch.models import llama as tllama
from oncilla_tpu_torch.serving.engine import Request, ServingEngine
from oncilla_tpu_torch.serving.metrics import (
    ServingStats,
    colocated,
    publish,
    unpublish,
)
from oncilla_tpu_torch.serving.prefix import PrefixCache
from oncilla_tpu_torch.serving.tiers import TIER_PRIORITY, Tier, TieredPageStore

PB = 4096
ATOL = 1e-5


def make_store(hot=2, warm=3, **kw):
    ctx = tocm.Ocm(config=tocm.OcmConfig(
        host_arena_bytes=1 << 20, device_arena_bytes=1 << 20), device="cpu")
    store = TieredPageStore(ctx, PB, hot_capacity=hot, warm_capacity=warm,
                            stats=ServingStats("test"), **kw)
    return ctx, store


def page_data(seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, PB, dtype=np.uint8))


def same(got: torch.Tensor, want: torch.Tensor) -> bool:
    return torch.equal(got.cpu(), want)


# -- tiers -------------------------------------------------------------------


def test_alloc_prefers_hot_and_demotes_lru():
    ctx, store = make_store(hot=2, warm=2)
    datas = [page_data(i) for i in range(5)]
    pages = [store.alloc_page(d) for d in datas]
    occ = store.occupancy()
    assert occ["hbm"]["pages"] <= 2
    assert occ["host"]["pages"] <= 2
    assert occ["remote"]["pages"] >= 1
    assert pages[-1].tier == Tier.HOT
    assert pages[0].tier in (Tier.WARM, Tier.COLD)
    for p, d in zip(pages, datas):
        assert same(store.read_page(p), d), p.tier
    store.close()
    ctx.tini()


def test_promote_and_demote_roundtrip_byte_exact():
    ctx, store = make_store(hot=2, warm=2)
    d = page_data(7)
    p = store.alloc_page(d)
    store.demote(p, Tier.COLD)
    assert p.tier == Tier.COLD
    assert store.stats.demotes >= 1
    store.promote(p)
    assert p.tier == Tier.HOT
    assert store.stats.promotes >= 1
    assert same(store.read_page(p), d)
    store.close()
    ctx.tini()


def test_stale_prefetched_bytes_discarded_on_version_mismatch():
    ctx, store = make_store(hot=2, warm=2)
    d1, d2 = page_data(1), page_data(2)
    p = store.alloc_page(d1)
    store.demote(p, Tier.COLD)
    buf = torch.empty(PB, dtype=torch.uint8)
    version, ok = store.fetch_bytes(p, buf)
    assert ok and same(buf, d1)
    store.write_page(p, d2)  # rewrite after the fetch
    store.promote(p, data=buf, version=version)  # stale: re-read
    assert same(store.read_page(p), d2)
    store.close()
    ctx.tini()


def test_shared_referenced_page_never_victimized():
    ctx, store = make_store(hot=2, warm=2)
    shared = store.alloc_page(page_data(0), shared=True)
    shared.refs += 1
    others = [store.alloc_page(page_data(i + 1)) for i in range(6)]
    assert shared.tier == Tier.HOT
    with pytest.raises(OcmInvalidHandle):
        store.write_page(shared, page_data(9))
    with pytest.raises(OcmInvalidHandle):
        store.free_page(shared)
    shared.refs -= 1
    store.alloc_page(page_data(50))
    store.alloc_page(page_data(51))
    assert shared.tier != Tier.HOT
    for p in others:
        assert not p.freed
    store.close()
    ctx.tini()


def test_pinned_page_never_demoted():
    ctx, store = make_store(hot=1, warm=2)
    p = store.alloc_page(page_data(0))
    store.pin(p)
    store.alloc_page(page_data(1))
    assert p.tier == Tier.HOT
    store.unpin(p)
    store.close()
    ctx.tini()


def test_cow_private_copy_original_byte_exact():
    ctx, store = make_store()
    d = page_data(3)
    shared = store.alloc_page(d, shared=True)
    shared.refs += 1
    clone = store.cow(shared)
    assert clone.page_id != shared.page_id
    assert not clone.shared
    store.write_page(clone, page_data(4))
    assert same(store.read_page(shared), d)
    assert store.stats.cow_copies == 1
    store.close()
    ctx.tini()


def test_tier_priority_mapping_is_the_qos_ladder():
    from oncilla_tpu.qos import policy as jpolicy
    from oncilla_tpu_torch.qos.policy import (
        PRIO_HIGH,
        PRIO_LOW,
        PRIO_NAMES,
        PRIO_NORMAL,
    )

    assert TIER_PRIORITY[Tier.HOT] == PRIO_HIGH
    assert TIER_PRIORITY[Tier.WARM] == PRIO_NORMAL
    assert TIER_PRIORITY[Tier.COLD] == PRIO_LOW
    assert (PRIO_LOW, PRIO_NORMAL, PRIO_HIGH) == (
        jpolicy.PRIO_LOW, jpolicy.PRIO_NORMAL, jpolicy.PRIO_HIGH)
    assert PRIO_NAMES == jpolicy.PRIO_NAMES


def test_store_counts_io_and_keeps_kernels_off_workers():
    """Every HOT put/get is counted (one K1/K2 launch each on a CUDA
    context); a worker's fetch of a page on the card is refused, so no
    kernel launches from a prefetch thread."""
    ctx, store = make_store(hot=2, warm=2)
    p = store.alloc_page(page_data(5))
    store.read_page(p)
    assert store.io["hbm"] == {"put": 1, "get": 1}
    buf = torch.empty(PB, dtype=torch.uint8)
    assert store.fetch_bytes(p, buf) == (p.version, False)
    assert store.io["hbm"]["get"] == 1
    store.demote(p, Tier.WARM)  # one more HOT get, one WARM put
    assert store.io["hbm"]["get"] == 2 and store.io["host"]["put"] == 1
    assert store.fetch_bytes(p, buf) == (p.version, True)
    assert same(buf, page_data(5))
    store.close()
    ctx.tini()


# -- prefix cache ------------------------------------------------------------


def test_prefix_publish_match_and_dedup():
    ctx, store = make_store(hot=8, warm=8)
    cache = PrefixCache(store, page_tokens=4)
    toks = (1, 2, 3, 4)
    p1 = store.alloc_page(page_data(0))
    ext = cache.publish(None, toks, p1)
    assert ext.page is p1 and p1.shared
    p2 = store.alloc_page(page_data(0))
    ext2 = cache.publish(None, toks, p2)
    assert ext2 is ext
    assert p2.freed
    matched, n = cache.match((1, 2, 3, 4, 9, 9))
    assert matched == [ext] and n == 4
    assert cache.child(None, toks) is ext
    assert cache.child(ext, toks) is None
    store.close()
    ctx.tini()


def test_prefix_partial_and_chain_match():
    ctx, store = make_store(hot=8, warm=8)
    cache = PrefixCache(store, page_tokens=4)
    full = cache.publish(None, (1, 2, 3, 4), store.alloc_page(page_data(0)))
    part = cache.publish(full, (5, 6), store.alloc_page(page_data(1)))
    matched, n = cache.match((1, 2, 3, 4, 5, 6))
    assert matched == [full, part] and n == 6
    matched, n = cache.match((1, 2, 3, 4, 5, 7))
    assert matched == [full] and n == 4
    store.close()
    ctx.tini()


def test_prefix_chain_hashes_match_jax():
    from oncilla_tpu.serving.prefix import _chain_hash as jhash
    from oncilla_tpu_torch.serving.prefix import _chain_hash as thash

    key = ""
    for toks in ((1, 2, 3, 4), (5, 6), (70000, 0, 9)):
        assert thash(key, toks) == jhash(key, toks)
        key = thash(key, toks)


def test_prefix_refcount_churn_and_sweep():
    ctx, store = make_store(hot=8, warm=8)
    cache = PrefixCache(store, page_tokens=4)
    d0, d1 = page_data(0), page_data(1)
    root = cache.publish(None, (1, 2, 3, 4), store.alloc_page(d0))
    leaf = cache.publish(root, (5, 6, 7, 8), store.alloc_page(d1))
    for e in (root, leaf):
        cache.acquire(e)
        cache.acquire(e)
    assert root.refs == 2 and leaf.refs == 2
    for e in (root, leaf):
        cache.release(e)
    assert root.refs == 1 and leaf.refs == 1
    assert same(store.read_page(root.page), d0)
    assert same(store.read_page(leaf.page), d1)
    assert cache.sweep() == 0
    for e in (root, leaf):
        cache.release(e)
    assert cache.sweep() == 2
    assert root.page.freed and leaf.page.freed
    assert cache.match((1, 2, 3, 4)) == ([], 0)
    store.close()
    ctx.tini()


def test_prefix_shared_bytes_counts_dedup():
    ctx, store = make_store(hot=8, warm=8)
    cache = PrefixCache(store, page_tokens=4)
    ext = cache.publish(None, (1, 2, 3, 4), store.alloc_page(page_data(0)))
    assert cache.shared_bytes() == 0
    cache.acquire(ext)
    cache.acquire(ext)
    assert cache.shared_bytes() == PB
    store.close()
    ctx.tini()


# -- engine ------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_model():
    """(JAX cfg, JAX params, port cfg, port params): the same weights."""
    jcfg = jllama.LlamaConfig.tiny()
    jp = jllama.init_params_host(0, jcfg)
    tp = tllama.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                device="cpu")
    return jcfg, jp, tllama.LlamaConfig.tiny(), tp


def run_engine(tiny_model, share: bool, prompts, new_tokens=6, hot=3, warm=4,
               prefetch=0, batched=False, graphs=False):
    _, _, cfg, params = tiny_model
    ctx = tocm.Ocm(config=tocm.OcmConfig(
        host_arena_bytes=1 << 20, device_arena_bytes=1 << 20), device="cpu")
    store = TieredPageStore(ctx, ServingEngine.page_nbytes(cfg, 8),
                            hot_capacity=hot, warm_capacity=warm,
                            stats=ServingStats("t"))
    prefix = PrefixCache(store, 8) if share else None
    eng = ServingEngine(params, cfg, store, prefix, page_tokens=8,
                        max_active=4, prefetch_workers=prefetch, name="t",
                        batched=batched)
    if graphs:  # the card's graph cache, its bookkeeping run on the CPU
        eng.graphs = tkv.StepGraphs(params, cfg)
    try:
        for i, p in enumerate(prompts):
            eng.submit(Request(tenant=f"t{i}", tokens=p,
                               max_new_tokens=new_tokens))
        results = eng.run()
        outs = {r.tenant: list(r.out_tokens) for r in results}
        meta = eng.metrics_meta()
        reused = {r.tenant: r.prefix_tokens_reused for r in results}
    finally:
        eng.close()
        store.close()
        ctx.tini()
    assert ctx.device_arenas[0].allocator.bytes_live == 0
    assert ctx.host_arena.allocator.bytes_live == 0
    return outs, meta, reused


def run_jax_engine(tiny_model, prompts, *, new_tokens, hot, warm, batched,
                   share=True):
    cfg, params, _, _ = tiny_model
    ctx = jocm.Ocm(config=jocm.OcmConfig(
        host_arena_bytes=1 << 20, device_arena_bytes=1 << 20))
    store = JStore(ctx, JEngine.page_nbytes(cfg, 8), hot_capacity=hot,
                   warm_capacity=warm, stats=JStats("j"))
    eng = JEngine(params, cfg, store, JPrefix(store, 8) if share else None,
                  page_tokens=8, max_active=4, prefetch_workers=0, name="j",
                  batched=batched)
    try:
        for i, p in enumerate(prompts):
            eng.submit(JRequest(tenant=f"t{i}", tokens=p,
                                max_new_tokens=new_tokens))
        return {r.tenant: list(r.out_tokens) for r in eng.run()}
    finally:
        eng.close()
        store.close()
        ctx.tini()


@pytest.fixture(scope="module")
def shared_prompts(tiny_model):
    cfg = tiny_model[2]
    rng = np.random.default_rng(3)
    shared = rng.integers(1, cfg.vocab, 20).tolist()
    p0 = shared + rng.integers(1, cfg.vocab, 4).tolist()
    return [p0, list(p0), shared + rng.integers(1, cfg.vocab, 3).tolist()]


def test_engine_sharing_is_output_invariant(tiny_model, shared_prompts):
    outs_ns, meta_ns, _ = run_engine(tiny_model, False, shared_prompts)
    outs_sh, meta_sh, reused = run_engine(tiny_model, True, shared_prompts)
    assert outs_sh == outs_ns
    assert outs_sh["t0"] == outs_sh["t1"]
    assert meta_sh["prefix"]["hits"] > 0
    assert meta_sh["prefix"]["cow"] >= 1
    assert reused["t1"] > 0 and reused["t2"] > 0
    assert meta_ns["prefix"]["hits"] == 0
    assert all(len(v) == 6 for v in outs_sh.values())


def test_engine_deterministic_across_runs(tiny_model, shared_prompts):
    outs1, _, _ = run_engine(tiny_model, True, shared_prompts)
    outs2, _, _ = run_engine(tiny_model, True, shared_prompts)
    assert outs1 == outs2


def test_engine_threaded_prefetch_matches(tiny_model, shared_prompts):
    outs0, _, _ = run_engine(tiny_model, True, shared_prompts)
    outs2, meta2, _ = run_engine(tiny_model, True, shared_prompts,
                                 prefetch=2)
    assert outs0 == outs2
    assert meta2["prefetch"]["mode"] == "thread"


@pytest.mark.parametrize("batched", [False, True])
def test_engine_matches_jax_engine_on_shared_prompts(tiny_model,
                                                     shared_prompts, batched):
    want = run_jax_engine(tiny_model, shared_prompts, new_tokens=6, hot=3,
                          warm=4, batched=batched)
    got, meta, _ = run_engine(tiny_model, True, shared_prompts,
                              batched=batched)
    assert got == want
    assert meta["prefix"]["cow"] >= 1


def test_graphed_engine_bookkeeping_equals_eager_on_the_cpu(tiny_model,
                                                            shared_prompts):
    """The graph cache on the CPU runs each step on its static buffers with
    the same copies as on the card: the tokens must not notice."""
    for batched in (False, True):
        eager, _, _ = run_engine(tiny_model, True, shared_prompts,
                                 batched=batched, prefetch=2)
        graphed, meta, _ = run_engine(tiny_model, True, shared_prompts,
                                      batched=batched, prefetch=2,
                                      graphs=True)
        assert graphed == eager
        assert meta["graphs"]["steps"] > 0
        assert meta["graphs"]["captured"] == 0  # nothing captured on a CPU


# -- metrics -----------------------------------------------------------------


def test_colocated_publication_registry():
    st = ServingStats("pub-test")
    st.note_tokens(3)
    assert colocated() is None or all(
        e["engine"] != "pub-test" for e in colocated()["engines"])
    publish(st)
    try:
        metas = colocated()["engines"]
        assert any(e["engine"] == "pub-test"
                   and e["tokens"]["decode"] == 3 for e in metas)
    finally:
        unpublish(st)
    got = colocated()
    assert got is None or all(e["engine"] != "pub-test" for e in got["engines"])


def test_serving_stats_snapshot_matches_jax():
    """The same notes give the same snapshot in both packages."""
    snaps = []
    for cls in (ServingStats, JStats):
        st = cls("same")
        st.note_tokens(5, phase="prefill")
        st.note_tokens(7)
        st.note_lookup(True)
        st.note_lookup(False)
        st.note_move(True)
        st.note_cow()
        st.note_prefix_hit(PB)
        st.note_stall(0.003)
        st.note_batch_step(3, 0.002)
        st.note_ttft(0.2)
        st.note_preempt("slot")
        st.set_occupancy({"hbm": 1}, {"hbm": PB})
        snaps.append(st.snapshot())
    assert snaps[0] == snaps[1]


def test_journal_is_the_ports_own():
    from oncilla_tpu.obs import journal as jj
    from oncilla_tpu_torch.obs import journal as tj

    was = tj.enabled()
    tj.set_enabled(True)
    try:
        tj.clear()
        n_jax = len(jj.events())
        tj.record("page_cow", src=1, dst=2)
        tj.phase("step", 0.0015, priority=1)
        evts = tj.events()
        assert [e["ev"] for e in evts] == ["page_cow", "phase"]
        assert evts[1]["dur_us"] == 1500.0 and evts[0]["seq"] < evts[1]["seq"]
        assert len(jj.events()) == n_jax
        assert tj.dump_jsonl().count("\n") == 2
        tj.set_cap(1)
        assert [e["ev"] for e in tj.events()] == ["phase"]
    finally:
        tj.set_cap(8192)
        tj.clear()
        tj.set_enabled(was)


# -- PagedKVCache fetch_pages(out=) regression -------------------------------


class _RecordingBackend:
    """Host-kind backend double: stores bytes, takes ``get(out=)`` (the
    registered-receive idiom) and records every destination buffer."""

    device = torch.device("cpu")

    def __init__(self):
        self.blobs: dict[int, torch.Tensor] = {}
        self.next_id = 1
        self.out_gets = 0
        self.plain_gets = 0
        self.dest_ptrs: list[int] = []

    def alloc(self, nbytes, kind):
        from oncilla_tpu_torch.core.arena import Extent
        from oncilla_tpu_torch.core.handle import OcmAlloc
        from oncilla_tpu_torch.core.kinds import Fabric

        aid = self.next_id
        self.next_id += 1
        self.blobs[aid] = torch.zeros(nbytes, dtype=torch.uint8)
        return OcmAlloc(alloc_id=aid, kind=kind, fabric=Fabric.LOCAL,
                        nbytes=nbytes, rank=0, device_index=0,
                        extent=Extent(0, nbytes), origin_rank=0)

    def free(self, handle):
        del self.blobs[handle.alloc_id]

    def put(self, handle, data, offset):
        raw = data.reshape(-1).view(torch.uint8)
        self.blobs[handle.alloc_id][offset:offset + raw.numel()] = raw

    def get(self, handle, nbytes=None, offset=0, out=None):
        if out is None:
            self.plain_gets += 1
            return self.blobs[handle.alloc_id][offset:offset + nbytes].clone()
        self.out_gets += 1
        self.dest_ptrs.append(out.data_ptr())
        out.copy_(self.blobs[handle.alloc_id][offset:offset + out.numel()])
        return out

    def get_into(self, handle, out, offset=0):
        return self.get(handle, out.numel(), offset, out=out)


def test_fetch_pages_reuses_registered_buffer(tiny_model):
    cfg = tiny_model[2]
    backend = _RecordingBackend()
    cache = tkv.PagedKVCache(backend, cfg, batch=1, page_tokens=4,
                             kind=tocm.OcmKind.LOCAL_HOST, dtype="float32")
    rng = np.random.default_rng(0)
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, 4, cfg.head_dim)
    kpages = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
              for _ in range(2)]
    vpages = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
              for _ in range(2)]
    for k, v in zip(kpages, vpages):
        cache.store_page(k, v)
    ks, vs = cache.fetch_pages()
    assert backend.out_gets == 2 and backend.plain_gets == 0
    assert len(set(backend.dest_ptrs)) == 2
    buf1 = cache._recvbuf
    assert buf1 is not None
    ks2, vs2 = cache.fetch_pages()
    assert cache._recvbuf is buf1
    assert backend.out_gets == 4
    assert torch.equal(ks, ks2)
    assert torch.equal(ks, torch.cat(kpages, 3))
    assert torch.equal(vs2, torch.cat(vpages, 3))
    cache.free()


def test_cold_tier_rides_a_cold_backend():
    """With a ``cold_backend`` the COLD tier lives there: pages come back
    byte-exact, the remote traffic is counted, the store is not
    ``cold_sim``, and closing the store frees every remote page."""
    backend = _RecordingBackend()
    ctx, store = make_store(hot=1, warm=1, cold_backend=backend)
    assert not store.cold_sim
    pages = [store.alloc_page(page_data(i)) for i in range(4)]
    assert [p.tier for p in pages].count(Tier.COLD) >= 1
    assert backend.blobs
    for i, p in enumerate(pages):
        assert same(store.read_page(p), page_data(i))
    remote = store.stats.snapshot()["remote_bytes"]
    assert remote["out"] >= PB and remote["in"] >= PB
    store.close()
    assert not backend.blobs
    ctx.tini()


def test_step_budget():
    from oncilla_tpu_torch.resilience.timebudget import Budget

    assert Budget.from_ms(0).expired
    fresh = Budget.from_ms(60_000)
    assert not fresh.expired and 59.0 < fresh.remaining_s() <= 60.0


def test_models_package_exports():
    import oncilla_tpu_torch.models as m
    import oncilla_tpu_torch.serving as s
    from oncilla_tpu import serving as js

    for mod in (m, s):
        for name in mod.__all__:
            assert getattr(mod, name) is not None
        with pytest.raises(AttributeError):
            mod.not_a_symbol
    assert s.__all__ == js.__all__
    for name in ("PagedKVCache", "PagedDecoder", "BucketedPagedDecoder",
                 "paged_decode_step", "sample_token", "LlamaConfig"):
        assert name in m.__all__


# -- model pieces the engine adds --------------------------------------------


def test_masked_grouped_attention_matches_jax(rng):
    q = rng.standard_normal((3, 4, 2, 16), dtype=np.float32)
    k = rng.standard_normal((3, 2, 9, 16), dtype=np.float32)
    v = rng.standard_normal((3, 2, 9, 16), dtype=np.float32)
    per_row = rng.random((3, 2, 9)) < 0.6
    per_row[1] = False  # a fully masked (bucket-padded) row
    shared = rng.random((2, 9)) < 0.6
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for mask in (per_row, shared):
        got = tllama.grouped_attention(tq, tk, tv, torch.from_numpy(mask))
        want = np.asarray(jllama.grouped_attention(
            *map(jnp.asarray, (q, k, v)), jnp.asarray(mask)))
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=ATOL)
    # Masked keys weigh exactly 0: dropping them changes nothing beyond
    # rounding; the fully masked row is the uniform mean of v.
    keep = per_row[0, 0]
    got = tllama.grouped_attention(tq[:1, :, :1], tk[:1], tv[:1],
                                   torch.from_numpy(per_row[:1, :1]))
    ref = tllama.grouped_attention(tq[:1, :, :1], tk[:1, :, keep],
                                   tv[:1, :, keep])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    got = tllama.grouped_attention(tq, tk, tv, torch.from_numpy(per_row))
    mean = tv[1].mean(1)  # (KV, D)
    np.testing.assert_allclose(got[1, :, 0].numpy(),
                               mean.repeat_interleave(2, 0).numpy(),
                               rtol=1e-5, atol=ATOL)
    # No mask: unchanged, bit for bit, from the unmasked call.
    assert torch.equal(tllama.grouped_attention(tq, tk, tv),
                       tllama.grouped_attention(tq, tk, tv, None))


def test_sample_token_seeded_and_distributed():
    logits = torch.from_numpy(
        np.random.default_rng(5).standard_normal((1, 16), dtype=np.float32))
    draws = logits.expand(4000, 16)

    def sample(seed):
        return tllama.sample_token(draws, 0.7,
                                   torch.Generator().manual_seed(seed))

    a, b = sample(9), sample(9)
    assert torch.equal(a, b)
    assert not torch.equal(a, sample(10))
    freq = torch.bincount(a, minlength=16).double() / 4000
    want = torch.softmax(logits[0].double() / 0.7, -1)
    assert float((freq - want).abs().max()) < 0.03
    assert torch.equal(tllama.sample_token(logits, 0.0), logits.argmax(-1))


def _page_inputs(jcfg, rng, C, B=2, P=8):
    shape_c = (jcfg.n_layers, B, jcfg.n_kv_heads, C, jcfg.head_dim)
    shape_t = (jcfg.n_layers, B, jcfg.n_kv_heads, P, jcfg.head_dim)
    k, v = (rng.standard_normal(shape_c, dtype=np.float32) for _ in range(2))
    tk, tv = (rng.standard_normal(shape_t, dtype=np.float32) for _ in range(2))
    return k, v, tk, tv


@pytest.mark.parametrize("window", [None, 12])
def test_paged_decode_page_matches_jax(tiny_model, window, rng):
    _, jp, _, tp = tiny_model
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), window=window)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), window=window)
    k, v, tk, tv = _page_inputs(jcfg, rng, C=16)
    toks = rng.integers(0, jcfg.vocab, (2, 8))
    meta = (16, 0)
    jl, jtk, jtv = jkv.paged_decode_page_jit(
        jp, jnp.asarray(toks, jnp.int32), jnp.asarray(meta, jnp.int32),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(tk), jnp.asarray(tv), jcfg)
    ttk, ttv = torch.from_numpy(tk.copy()), torch.from_numpy(tv.copy())
    tl, ttk2, _ = tkv.paged_decode_page(
        tp, torch.from_numpy(toks), meta, torch.from_numpy(k),
        torch.from_numpy(v), ttk, ttv, tcfg)
    assert ttk2 is ttk  # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(ttk.numpy(), np.asarray(jtk), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(ttv.numpy(), np.asarray(jtv), rtol=1e-5, atol=ATOL)
    assert torch.equal(tl.argmax(-1), torch.from_numpy(np.asarray(jl).argmax(-1)))
    # The page replayed through a step cache (the graphed path, run on the
    # CPU) gives the same bits as the eager page.
    gtk, gtv = torch.from_numpy(tk.copy()), torch.from_numpy(tv.copy())
    graphs = tkv.StepGraphs(tp, tcfg)
    gl, _, _ = tkv.paged_decode_page(
        tp, torch.from_numpy(toks), meta, torch.from_numpy(k),
        torch.from_numpy(v), gtk, gtv, tcfg, graphs=graphs)
    assert torch.equal(gl, tl) and torch.equal(gtk, ttk) and torch.equal(gtv, ttv)
    assert len(graphs.steps) == 1


def test_bucketed_context_matches_jax_unpadded(tiny_model, rng):
    """A context of 3 pages bucketed to 4 (zero keys past ``ctx_len``)
    decodes a page as the JAX jit does on the unpadded context."""
    jcfg, jp, tcfg, tp = tiny_model
    for pages, want in ((0, 0), (1, 1), (2, 2), (3, 4), (5, 8), (8, 8)):
        z = torch.zeros(1, 1, 1, pages * 8, 1)
        assert tkv.bucket_context(z, z, 8)[0].shape[3] == want * 8
    k, v, tk, tv = _page_inputs(jcfg, rng, C=24)
    toks = rng.integers(0, jcfg.vocab, (2, 8))
    jl, jtk, _ = jkv.paged_decode_page_jit(
        jp, jnp.asarray(toks, jnp.int32), jnp.asarray((24, 0), jnp.int32),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(tk), jnp.asarray(tv), jcfg)
    bk, bv = tkv.bucket_context(torch.from_numpy(k), torch.from_numpy(v), 8)
    assert bk.shape[3] == 32 and not bk[:, :, :, 24:].any()
    ttk = torch.from_numpy(tk.copy())
    tl, _, _ = tkv.paged_decode_page(
        tp, torch.from_numpy(toks), (24, 0), bk, bv, ttk,
        torch.from_numpy(tv.copy()), tcfg, ctx_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(ttk.numpy(), np.asarray(jtk), rtol=1e-5, atol=ATOL)
    assert torch.equal(tl.argmax(-1), torch.from_numpy(np.asarray(jl).argmax(-1)))


def test_paged_generate_page_matches_jax_greedy(tiny_model, rng):
    jcfg, jp, tcfg, tp = tiny_model
    k, v, tk, tv = _page_inputs(jcfg, rng, C=8)
    tok0 = rng.integers(0, jcfg.vocab, 2)
    meta = (8, 0)
    jids, jtk, _ = jkv.paged_generate_page_jit(
        jp, jnp.asarray(tok0, jnp.int32), jnp.asarray(meta, jnp.int32),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(tk), jnp.asarray(tv), jcfg,
        jax.random.key(0), temperature=0.0)
    ids, ttk, _ = tkv.paged_generate_page(
        tp, torch.from_numpy(tok0), meta, torch.from_numpy(k),
        torch.from_numpy(v), torch.from_numpy(tk.copy()),
        torch.from_numpy(tv.copy()), tcfg)
    assert ids.tolist() == np.asarray(jids).tolist()
    np.testing.assert_allclose(ttk.numpy(), np.asarray(jtk), rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("decoder", ["PagedDecoder", "step_page",
                                     "generate_page"])
def test_decoders_match_jax(tiny_model, decoder):
    """PagedDecoder step by step, BucketedPagedDecoder a page at a time
    (teacher-forced, then greedy sampling): the JAX classes' tokens."""
    jcfg, jp, tcfg, tp = tiny_model
    P = 8
    toks = np.random.default_rng(21).integers(0, jcfg.vocab, (1, 3 * P))
    kw = dict(host_arena_bytes=4 << 20, device_arena_bytes=4 << 20)
    jctx = jocm.ocm_init(jocm.OcmConfig(**kw))
    tctx = tocm.ocm_init(tocm.OcmConfig(**kw), device="cpu")
    try:
        if decoder == "PagedDecoder":
            jd = jkv.PagedDecoder(jp, jcfg, jctx, page_tokens=P,
                                  kind=jocm.OcmKind.LOCAL_DEVICE)
            td = tkv.PagedDecoder(tp, tcfg, tctx, page_tokens=P,
                                  kind=tocm.OcmKind.LOCAL_DEVICE)
            jl = np.stack([np.asarray(jd.step(jnp.asarray(toks[:, t], jnp.int32)))
                           for t in range(3 * P)])
            tl = torch.stack([td.step(torch.from_numpy(toks[:, t]))
                              for t in range(3 * P)]).numpy()
            np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=ATOL)
            assert (tl.argmax(-1) == jl.argmax(-1)).all()
        else:
            jd = jkv.BucketedPagedDecoder(jp, jcfg, jctx, page_tokens=P,
                                          kind=jocm.OcmKind.LOCAL_DEVICE,
                                          refetch=True)
            td = tkv.BucketedPagedDecoder(tp, tcfg, tctx, page_tokens=P,
                                          kind=tocm.OcmKind.LOCAL_DEVICE,
                                          refetch=True)
            if decoder == "step_page":
                for p in range(3):
                    page = toks[:, p * P:(p + 1) * P]
                    jl = np.asarray(jd.step_page(jnp.asarray(page, jnp.int32)))
                    tl = td.step_page(torch.from_numpy(page)).numpy()
                    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=ATOL)
                    assert (tl.argmax(-1) == jl.argmax(-1)).all()
            else:
                jt, tt = jnp.asarray(toks[:, 0], jnp.int32), torch.from_numpy(toks[:, 0])
                for _ in range(3):
                    jids = np.asarray(jd.generate_page(jt))
                    tids = td.generate_page(tt)
                    assert tids.tolist() == jids.tolist()
                    jt, tt = jnp.asarray(jids[:, -1]), tids[:, -1]
            with pytest.raises(ValueError):
                td.step(torch.from_numpy(toks[:, 0]))
                td.step_page(torch.from_numpy(toks[:, :P]))
        assert len(td.cache.pages) == len(jd.cache.pages) == 3
        td.close()
        jd.close()
        assert tctx.device_arenas[0].allocator.bytes_live == 0
    finally:
        jctx.tini()
        tctx.tini()
