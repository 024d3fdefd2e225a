"""The port's Llama decode and paged-KV decoder held against the JAX package.

Parameters come from the JAX package's ``init_params`` and are carried
across as numpy arrays (``params_from_jax``); token ids are drawn with
numpy. In float32 the two frameworks differ only in summation order, so
logits agree to rtol 1e-4 / atol 1e-5 and greedy tokens are equal.
"""

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
from oncilla_tpu_torch.benchmarks import kv_decode
from oncilla_tpu_torch.models import kv_paging as tkv
from oncilla_tpu_torch.models import llama as tllama
from oncilla_tpu_torch.ops import dma

RTOL, ATOL = 1e-4, 1e-5
PAGE = 8
PROMPT, GEN = 16, 8  # 24 tokens = 3 pages


def _cfgs(window=None):
    j = dataclasses.replace(jllama.LlamaConfig.tiny(), window=window)
    t = dataclasses.replace(tllama.LlamaConfig.tiny(), window=window)
    return j, t


@pytest.fixture(scope="module")
def params():
    j = jllama.init_params(jax.random.key(3), jllama.LlamaConfig.tiny())
    t = tllama.params_from_jax({k: np.asarray(v) for k, v in j.items()},
                               device="cpu")
    return j, t


def test_config_and_spec_match_jax():
    for name in ("tiny", "llama3_8b", "mistral_7b"):
        j, t = getattr(jllama.LlamaConfig, name)(), getattr(tllama.LlamaConfig, name)()
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert jllama.param_spec(j) == tllama.param_spec(t)


def test_init_params_shapes_and_seed():
    cfg = tllama.LlamaConfig.tiny()
    a = tllama.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = tllama.init_params(cfg, device="cpu", seed=5)
    for name, (shape, scale) in tllama.param_spec(cfg).items():
        assert tuple(a[name].shape) == shape
        assert torch.equal(a[name], b[name])
        if scale is not None:
            assert abs(float(a[name].float().std()) - scale) < 0.2 * scale


def test_params_from_jax_carries_bf16(params):
    x = jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4) / 7
    t = tllama.params_from_jax({"w": np.asarray(x)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))


def test_decode_step_matches_jax(params, rng):
    jp, tp = params
    jcfg, tcfg = _cfgs()
    tokens = rng.integers(0, jcfg.vocab, size=(2, 12))
    step = jax.jit(jllama.decode_step, static_argnames=("cfg",))
    jkvc = jllama.make_kv_cache(jcfg, 2, dtype="float32")
    tkvc = tllama.make_kv_cache(tcfg, 2, device="cpu")
    for i in range(tokens.shape[1]):
        jl, jkvc = step(jp, jnp.asarray(tokens[:, i]), jnp.int32(i), jkvc, jcfg)
        tl, tkvc = tllama.decode_step(tp, torch.from_numpy(tokens[:, i]), i,
                                      tkvc, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tkvc[0].numpy(), np.asarray(jkvc[0]),
                               rtol=RTOL, atol=ATOL)


def test_building_blocks_match_jax(rng):
    x = rng.standard_normal((2, 4, 5, 16), dtype=np.float32)
    pos = np.arange(3, 8)
    np.testing.assert_allclose(
        tllama.rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0).numpy(),
        np.asarray(jllama.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)),
        rtol=RTOL, atol=ATOL)
    q = rng.standard_normal((2, 4, 1, 16), dtype=np.float32)
    k = rng.standard_normal((2, 2, 9, 16), dtype=np.float32)
    v = rng.standard_normal((2, 2, 9, 16), dtype=np.float32)
    np.testing.assert_allclose(
        tllama.grouped_attention(*map(torch.from_numpy, (q, k, v))).numpy(),
        np.asarray(jllama.grouped_attention(*map(jnp.asarray, (q, k, v)))),
        rtol=RTOL, atol=ATOL)
    w = rng.standard_normal(16, dtype=np.float32)
    np.testing.assert_allclose(
        tllama.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jllama.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=RTOL, atol=ATOL)


def _serve_jax(params, cfg, ctx, kind, prompt):
    dec = jkv.BucketedPagedDecoder(params, cfg, ctx, batch=1, page_tokens=PAGE,
                                   kind=kind, dtype="float32", refetch=True)
    ids, logits = list(prompt), []
    for t in range(PROMPT + GEN):
        lg = np.asarray(dec.step(jnp.asarray([ids[t]], dtype=jnp.int32)))
        logits.append(lg[0])
        if t + 1 >= PROMPT and len(ids) < PROMPT + GEN:
            ids.append(int(lg[0].argmax()))
    npages = len(dec.cache.pages)
    dec.close()
    return ids, np.stack(logits), npages


def _serve_torch(params, cfg, ctx, kind, prompt):
    dec = tkv.BucketedPagedDecoder(params, cfg, ctx, batch=1, page_tokens=PAGE,
                                   kind=kind, dtype=cfg.dtype, refetch=True)
    ids, logits = list(prompt), []
    for t in range(PROMPT + GEN):
        lg = dec.step(torch.tensor([ids[t]]))
        logits.append(lg[0].float().numpy())
        if t + 1 >= PROMPT and len(ids) < PROMPT + GEN:
            ids.append(int(tllama.greedy(lg)[0]))
    npages = len(dec.cache.pages)
    dec.close()
    return ids, np.stack(logits), npages


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("kind", ["LOCAL_DEVICE", "LOCAL_HOST"])
def test_bucketed_paged_decoder_matches_jax(params, kind, window):
    jp, tp = params
    jcfg, tcfg = _cfgs(window)
    prompt = [int(x) for x in np.random.default_rng(11).integers(0, jcfg.vocab, PROMPT)]
    cfg_kw = dict(host_arena_bytes=4 << 20, device_arena_bytes=4 << 20)
    jctx = jocm.ocm_init(jocm.OcmConfig(**cfg_kw))
    tctx = tocm.ocm_init(tocm.OcmConfig(**cfg_kw), device="cpu")
    try:
        jids, jlog, jpages = _serve_jax(jp, jcfg, jctx, jocm.OcmKind[kind], prompt)
        dma.reset_launches()
        tids, tlog, tpages = _serve_torch(tp, tcfg, tctx, tocm.OcmKind[kind], prompt)
        assert dma.launches()["write_rows"] == 0  # CPU: plain versions only
        assert tctx.device_arenas[0].allocator.bytes_live == 0
        assert tctx.host_arena.allocator.bytes_live == 0
    finally:
        jctx.tini()
        tctx.tini()
    assert tpages == jpages == (PROMPT + GEN) // PAGE - (1 if window else 0)
    assert tids == jids
    np.testing.assert_allclose(tlog, jlog, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype,window", [("float32", None),
                                          ("bfloat16", None),
                                          ("bfloat16", 12)])
def test_paged_matches_unpaged_in_the_port(params, dtype, window):
    """Paged and unpaged decode attend over the same slice of keys, so
    they agree bit for bit, in bf16 too (the check chip_smoke.py makes on
    the card at full width)."""
    _, tp = params
    _, tcfg = _cfgs(window)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    dt = tllama.torch_dtype(dtype)
    tp = {k: v if k.startswith("ln_") else v.to(dt) for k, v in tp.items()}
    prompt = list(np.random.default_rng(12).integers(0, tcfg.vocab, PROMPT))
    ctx = tocm.ocm_init(tocm.OcmConfig(host_arena_bytes=4 << 20,
                                       device_arena_bytes=4 << 20), device="cpu")
    ids, logits, _ = _serve_torch(tp, tcfg, ctx, tocm.OcmKind.LOCAL_DEVICE, prompt)
    ctx.tini()
    rcfg = dataclasses.replace(tcfg, max_seq=len(ids))
    kv = tllama.make_kv_cache(rcfg, 1, device="cpu")
    for t, tok in enumerate(ids):
        lg, kv = tllama.decode_step(tp, torch.tensor([tok]), t, kv, rcfg)
        np.testing.assert_array_equal(logits[t], lg[0].numpy())


@pytest.mark.parametrize("batch,dtype", [(1, "bfloat16"), (3, "float32")])
def test_page_bytes_matches_the_page_layout(batch, dtype):
    cfg = tllama.LlamaConfig.llama3_8b()
    cache = tkv.PagedKVCache(None, cfg, batch, page_tokens=128, dtype=dtype)
    want = int(np.prod(cache.page_shape)) * tllama.torch_dtype(dtype).itemsize
    assert tkv.page_bytes(cfg, 128, dtype, batch) == cache.page_bytes == want
    if (batch, dtype) == (1, "bfloat16"):
        assert want == 16 << 20  # one Llama-3-8B page


def test_fetch_pages_roundtrip_host_and_device(rng):
    cfg = tllama.LlamaConfig.tiny()
    ctx = tocm.ocm_init(tocm.OcmConfig(host_arena_bytes=1 << 20,
                                       device_arena_bytes=1 << 20), device="cpu")
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, 4, cfg.head_dim)
    pages = [(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)),
              torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)))
             for _ in range(3)]
    for kind in (tocm.OcmKind.LOCAL_DEVICE, tocm.OcmKind.LOCAL_HOST):
        cache = tkv.PagedKVCache(ctx, cfg, 1, page_tokens=4, kind=kind)
        for k, v in pages:
            cache.store_page(k, v)
        fk, fv = cache.fetch_pages()
        assert torch.equal(fk, torch.cat([p[0] for p in pages], dim=3))
        assert torch.equal(fv, torch.cat([p[1] for p in pages], dim=3))
        cache.drop_oldest()
        assert cache.tokens_paged == 8
        cache.free()
    ctx.tini()


def test_kv_decode_harness_on_cpu():
    out = kv_decode.run_bench(tokens_n=16, page_tokens=8, config="tiny",
                              device="cpu")
    assert set(out["tok_s"]) == {"plain", "device", "host", "device_fused",
                                 "fused"}
    assert all(v > 0 for v in out["tok_s"].values())
    assert out["overhead_vs"] == "fused"
    assert set(out["paging_overhead"]) == {"device", "host", "device_fused"}


# -- KV pages on the port's daemons (counterparts of tests/test_kv_paging.py) --
#
# All on the port's in-process cluster (``InProcessCluster``: port daemons,
# port config, port client). Logits are held within the JAX test's
# atol = rtol = 2e-3 of the JAX package's ``reference_decode``, and bit for
# bit to the port's own LOCAL_DEVICE paged decode on the same inputs.

from test_kv_paging import CFG as JCFG  # noqa: E402
from test_kv_paging import reference_decode  # noqa: E402

from oncilla_tpu_torch.ops.ici import IciDataPlane as TIciPlane  # noqa: E402
from oncilla_tpu_torch.ops.ici import SpmdIciPlane as TSpmdPlane  # noqa: E402
from oncilla_tpu_torch.runtime.cluster import inprocess_cluster  # noqa: E402

TCFG = tllama.LlamaConfig.tiny()


def _port_params(seed):
    j = jllama.init_params(jax.random.key(seed), JCFG)
    return j, tllama.params_from_jax({k: np.asarray(v) for k, v in j.items()},
                                     device="cpu")


def _tokens(rng, n):
    return rng.integers(0, JCFG.vocab, size=(1, n), dtype=np.int32)


def _local_paged(tp, toks, make, **kw):
    """The port's own LOCAL_DEVICE paged decode of the same tokens."""
    ctx = tocm.ocm_init(tocm.OcmConfig(host_arena_bytes=32 << 20,
                                       device_arena_bytes=32 << 20),
                        device="cpu")
    try:
        dec = make(tp, TCFG, ctx, kind=tocm.OcmKind.LOCAL_DEVICE, **kw)
        out = [dec.step(torch.from_numpy(toks[:, i]))
               for i in range(toks.shape[1])]
        dec.close()
        return torch.stack(out)
    finally:
        ctx.tini()


def _rt_cfg(**kw):
    d = dict(host_arena_bytes=32 << 20, device_arena_bytes=32 << 20)
    d.update(kw)
    return tocm.OcmConfig(**d)


@pytest.mark.parametrize("kind", ["REMOTE_HOST", "REMOTE_DEVICE"])
def test_paged_decode_on_port_daemons_matches_reference(rng, kind):
    jp, tp = _port_params(3)
    toks = _tokens(rng, 24)
    want = reference_decode(jp, jnp.asarray(toks))
    cfg_rt = _rt_cfg()
    kind = tocm.OcmKind[kind]
    with inprocess_cluster(2, config=cfg_rt, ndevices=4) as cl:
        plane = TIciPlane(config=cfg_rt, devices=["cpu"] * 8,
                          devices_per_rank=4)
        ctx = cl.context(0, ici_plane=plane, device="cpu")
        dec = tkv.PagedDecoder(tp, TCFG, ctx, batch=1, page_tokens=8,
                               kind=kind)
        got = torch.stack([dec.step(torch.from_numpy(toks[:, i]))
                           for i in range(24)])
        # 24 tokens / page 8 => 2+ pages shipped to the daemons.
        assert len(dec.cache.pages) >= 2
        for h in dec.cache.pages:
            assert h.kind == kind and h.is_remote
        dec.close()
        assert sum(d.registry.live_count() for d in cl.daemons) == 0
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)
    local = _local_paged(tp, toks, tkv.PagedDecoder, batch=1, page_tokens=8)
    assert torch.equal(got, local)


def test_paged_decoder_frees_pages_on_port_daemons():
    _, tp = _port_params(4)
    with inprocess_cluster(2, config=_rt_cfg()) as cl:
        ctx = cl.context(0, device="cpu")
        dec = tkv.PagedDecoder(tp, TCFG, ctx, page_tokens=4,
                               kind=tocm.OcmKind.REMOTE_HOST)
        for i in range(9):
            dec.step(torch.tensor([i % TCFG.vocab]))
        assert cl.daemons[1].registry.live_count() == len(dec.cache.pages) > 0
        dec.close()
        assert cl.daemons[1].registry.live_count() == 0


@pytest.mark.parametrize("refetch,n", [(False, 21), (True, 20)])
def test_bucketed_decode_on_port_daemons_matches_reference(rng, refetch, n):
    jp, tp = _port_params(5 if not refetch else 6)
    toks = _tokens(rng, n)
    want = reference_decode(jp, jnp.asarray(toks))
    with inprocess_cluster(2, config=_rt_cfg()) as cl:
        ctx = cl.context(0, device="cpu")
        dec = tkv.BucketedPagedDecoder(tp, TCFG, ctx, batch=1, page_tokens=8,
                                       kind=tocm.OcmKind.REMOTE_HOST,
                                       refetch=refetch)
        got = torch.stack([dec.step(torch.from_numpy(toks[:, i]))
                           for i in range(n)])
        assert len(dec.cache.pages) == n // 8
        for h in dec.cache.pages:
            assert h.is_remote
        if refetch:  # REMOTE_HOST pages land in the registered receive slots
            assert dec.cache._recvbuf is not None
        dec.close()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)
    local = _local_paged(tp, toks, tkv.BucketedPagedDecoder, batch=1,
                         page_tokens=8, refetch=refetch)
    assert torch.equal(got, local)


def test_paged_decode_through_spmd_plane_on_port_daemons(rng):
    """REMOTE_DEVICE pages on a CPU ``SpmdIciPlane`` placed by the port's
    daemons: page stores are plane puts, fetches plane gets."""
    jp, tp = _port_params(5)
    toks = _tokens(rng, 16)
    want = reference_decode(jp, jnp.asarray(toks))
    cfg_rt = _rt_cfg(device_arena_bytes=64 << 10)
    with inprocess_cluster(2, config=cfg_rt, ndevices=4) as cl:
        plane = TSpmdPlane(config=cfg_rt, mesh=["cpu"] * 8, devices_per_rank=4)
        ctx = cl.context(0, ici_plane=plane, device="cpu")
        dec = tkv.PagedDecoder(tp, TCFG, ctx, batch=1, page_tokens=8,
                               kind=tocm.OcmKind.REMOTE_DEVICE)
        got = torch.stack([dec.step(torch.from_numpy(toks[:, i]))
                           for i in range(16)])
        assert len(dec.cache.pages) >= 1
        assert plane.stats["puts"] >= 1  # pages rode the fabric out
        ks, vs = dec.cache.fetch_pages()
        assert plane.stats["gets"] >= 1
        assert ks.shape[3] == dec.cache.tokens_paged
        dec.close()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)
    local = _local_paged(tp, toks, tkv.PagedDecoder, batch=1, page_tokens=8)
    assert torch.equal(got, local)


def test_default_kind_and_receive_slots_match_jax():
    """Each package's default-built cache and decoders name the same kind
    (REMOTE_DEVICE), and both give REMOTE_HOST pages receive slots."""
    jc = jkv.PagedKVCache(None, JCFG, 1)
    tc = tkv.PagedKVCache(None, TCFG, 1)
    assert jc.kind.name == tc.kind.name == "REMOTE_DEVICE"
    for name in ("PagedDecoder", "BucketedPagedDecoder"):
        import inspect

        jd = inspect.signature(getattr(jkv, name)).parameters["kind"].default
        td = inspect.signature(getattr(tkv, name)).parameters["kind"].default
        assert jd.name == td.name == "REMOTE_DEVICE"
    ctx = tocm.ocm_init(tocm.OcmConfig(host_arena_bytes=1 << 20,
                                       device_arena_bytes=1 << 20),
                        device="cpu")
    try:
        for kind in ("LOCAL_HOST", "REMOTE_HOST", "LOCAL_DEVICE",
                     "REMOTE_DEVICE"):
            j = jkv.PagedKVCache(None, JCFG, 1, page_tokens=4,
                                 kind=jocm.OcmKind[kind])
            t = tkv.PagedKVCache(ctx, TCFG, 1, page_tokens=4,
                                 kind=tocm.OcmKind[kind])
            assert (j._recv_slots(2) is None) == (t._recv_slots(2) is None)
            if t._recv_slots(2) is not None:
                assert t._recv_slots(2).numel() == j._recv_slots(2).nbytes
    finally:
        ctx.tini()
