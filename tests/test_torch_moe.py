"""The port's MoE family (``oncilla_tpu_torch/models/moe.py``) held against
the JAX package's ``oncilla_tpu/models/moe.py``.

Parameters come from the JAX package's ``init_moe_params`` and are carried
across as numpy arrays (``params_from_jax``); token ids and router logits
are drawn with numpy. In float32 the two frameworks differ in summation
order only: logits agree to rtol 1e-4 / atol 1e-5 and greedy tokens are
equal. The routing is discrete: ``dispatch`` must be equal exactly, every
case (ties included), ``combine`` and ``aux`` to rtol 1e-6. The JAX side
runs as ``tests/test_moe.py`` runs it (jitted or eager on the CPU).
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
from oncilla_tpu.models import moe as jmoe
from oncilla_tpu_torch.models import kv_paging as tkv
from oncilla_tpu_torch.models import llama as tllama
from oncilla_tpu_torch.models import moe as tmoe
from oncilla_tpu_torch.models.graphs import StepGraphs

RTOL, ATOL = 1e-4, 1e-5
# Ample capacity: no pick drops, so decode (T = 1 a step) and the
# teacher-forced forward route alike (moe.decode_step's docstring).
AMPLE = 64.0


def _cfgs(**kw):
    return (dataclasses.replace(jmoe.MoeConfig.tiny(), **kw),
            dataclasses.replace(tmoe.MoeConfig.tiny(), **kw))


def _params(seed, jcfg):
    j = jmoe.init_moe_params(jax.random.key(seed), jcfg)
    t = tllama.params_from_jax({k: np.asarray(v) for k, v in j.items()},
                               device="cpu")
    return j, t


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=kw.get("rtol", RTOL),
                               atol=kw.get("atol", ATOL))


# -- configuration and parameters -------------------------------------------


@pytest.mark.parametrize("name", ["tiny", "mixtral_8x7b"])
def test_config_and_spec_match_jax(name):
    j, t = getattr(jmoe.MoeConfig, name)(), getattr(tmoe.MoeConfig, name)()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert jmoe.moe_param_spec(j) == tmoe.moe_param_spec(t)
    for tokens in (1, 7, 32, 4096):
        assert jmoe.capacity(j, tokens) == tmoe.capacity(t, tokens)
    assert jmoe.MOE_LAYER_KEYS == tmoe.MOE_LAYER_KEYS


def test_init_moe_params_draws_a_layer_at_a_time():
    cfg = tmoe.MoeConfig.tiny()
    a = tmoe.init_moe_params(cfg, torch.Generator().manual_seed(5), "cpu")
    b = tmoe.init_moe_params(cfg, device="cpu", seed=5)
    for name, (shape, scale) in tmoe.moe_param_spec(cfg).items():
        assert tuple(a[name].shape) == shape
        assert torch.equal(a[name], b[name])
        if scale is not None:
            assert abs(float(a[name].float().std()) - scale) < 0.2 * scale
    # Every leaf of rank >= 3 is drawn one layer at a time, in spec order.
    gen = torch.Generator().manual_seed(5)
    for name, (shape, scale) in tmoe.moe_param_spec(cfg).items():
        if scale is None:
            continue
        parts = range(shape[0]) if len(shape) >= 3 else [None]
        for i in parts:
            s = shape[1:] if i is not None else shape
            want = torch.randn(s, generator=gen) * scale
            got = a[name][i] if i is not None else a[name]
            assert torch.equal(got, want), name
    # The dense family's init is init_from_spec of its spec.
    d = tllama.LlamaConfig.tiny()
    assert all(torch.equal(x, y) for x, y in zip(
        tllama.init_params(d, device="cpu", seed=2).values(),
        tllama.init_from_spec(tllama.param_spec(d), d.dtype, device="cpu",
                              seed=2).values()))


# -- routing ----------------------------------------------------------------


def _route_cases():
    rng = np.random.default_rng(7)
    seeded = rng.standard_normal((32, 4)).astype(np.float32)
    # test_route_overflow_drops_secondary_first: everyone wants 0 then 1.
    overflow = np.tile(np.float32([[3.0, 2.0, -5.0]]), (4, 1))
    # Exact ties inside a row: the lower expert must come first, as
    # jax.lax.top_k orders them.
    tied = np.float32([[1.0, 1.0, 0.0, 0.0], [0.0, 2.0, 2.0, 2.0],
                       [0.5, 0.5, 0.5, 0.5], [-1.0, 3.0, -1.0, 3.0],
                       [2.0, 0.0, 2.0, 1.0]] * 3)
    return {
        "seeded": (seeded, 2, 64),
        "seeded_tight": (seeded, 2, 5),
        "overflow": (overflow, 2, 2),
        "top1": (rng.standard_normal((16, 4)).astype(np.float32), 1, 64),
        "tied": (tied, 2, 64),
        "tied_tight": (tied, 2, 3),
    }


@pytest.mark.parametrize("case", sorted(_route_cases()))
def test_route_matches_jax(case):
    logits, k, cap = _route_cases()[case]
    jd, jc, ja = jmoe.route(jnp.asarray(logits), k, cap)
    td, tc, ta = tmoe.route(torch.from_numpy(logits), k, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)

    T = logits.shape[0]
    d, c = td.numpy(), tc.numpy()
    assert set(np.unique(d)) <= {0.0, 1.0}
    assert np.all(d.sum(0) <= 1.0)  # no slot double-booked
    if case == "seeded":  # test_route_invariants: aux at or above 1
        assert float(ta) >= 1.0 - 1e-5
    if cap >= k * T:  # ample: every pick placed, weights sum to 1
        assert np.all(d.reshape(T, -1).sum(-1) == k)
        np.testing.assert_allclose(c.reshape(T, -1).sum(-1), 1.0, rtol=1e-5)
    if case == "overflow":
        # Choice-major priority: tokens 0, 1 fill both experts; 2, 3 drop.
        assert d[:, 0].sum() == cap and d[:, 1].sum() == cap
        assert d[0, 0].sum() == 1 and d[1, 0].sum() == 1
        assert c[2].sum() < 1.0 and c[3].sum() < 1.0
    if case == "top1":
        assert np.all(d.sum(axis=2).argmax(axis=1) == logits.argmax(-1))


def test_route_drops_picks_past_capacity_as_zero_rows():
    """A dropped pick's slot index lies past the capacity: its one-hot is a
    row of zeros, as ``jax.nn.one_hot`` gives (``F.one_hot`` would raise)."""
    logits = torch.zeros(6, 2)
    d, c, _ = tmoe.route(logits, 2, 1)
    assert d.sum() == 2 and torch.equal(d.sum((1, 2))[2:], torch.zeros(4))


# -- the model functions ----------------------------------------------------


def test_moe_ffn_matches_jax_and_the_naive_loop(rng):
    jcfg, tcfg = _cfgs(capacity_factor=16.0)
    jp, tp = _params(0, jcfg)
    h = rng.standard_normal((2, 8, tcfg.dim)).astype(np.float32)
    for layer in range(tcfg.n_layers):
        jy, ja = jmoe.moe_ffn(jnp.asarray(h), jmoe.moe_layer_params(jp, layer),
                              jcfg)
        ty, ta = tmoe.moe_ffn(torch.from_numpy(h),
                              tmoe.moe_layer_params(tp, layer), tcfg)
        _close(ty, jy)
        np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)

    # Naive: per token, the sum of gate_k * SwiGLU_{expert_k}(x).
    lp = {k: v.double().numpy() for k, v in tmoe.moe_layer_params(tp, 0).items()}
    x = h.reshape(-1, tcfg.dim).astype(np.float64)
    p = np.exp(x @ lp["w_router"])
    p /= p.sum(-1, keepdims=True)
    want = np.zeros_like(x)
    for t in range(x.shape[0]):
        top = np.argsort(-p[t], kind="stable")[:tcfg.top_k]
        gv = p[t, top] / p[t, top].sum()
        for g, e in zip(gv, top):
            a, u = x[t] @ lp["w_gate_e"][e], x[t] @ lp["w_up_e"][e]
            want[t] += g * ((a / (1.0 + np.exp(-a)) * u) @ lp["w_down_e"][e])
    ty, _ = tmoe.moe_ffn(torch.from_numpy(h), tmoe.moe_layer_params(tp, 0), tcfg)
    np.testing.assert_allclose(ty.reshape(-1, tcfg.dim).numpy(), want,
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("variant", ["plain", "ce_block", "remat"])
def test_forward_and_loss_match_jax(rng, variant):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(1, jcfg)
    toks = rng.integers(0, tcfg.vocab, (2, 16)).astype(np.int32)
    kw = {"plain": {}, "ce_block": {"ce_block": 8},
          "remat": {"remat": True}}[variant]
    jl, ja = jmoe.forward(jp, jnp.asarray(toks), jcfg)
    tl, ta = tmoe.forward(tp, torch.from_numpy(toks), tcfg,
                          remat=kw.get("remat", False))
    _close(tl.detach(), jl)
    np.testing.assert_allclose(float(ta), float(ja), rtol=RTOL)
    want = float(jmoe.loss_fn(jp, jnp.asarray(toks), jcfg, **kw))
    got = tmoe.loss_fn(tp, torch.from_numpy(toks), tcfg, **kw)
    np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=ATOL)
    if variant == "remat":  # the checkpointed blocks give the plain grads
        grads = []
        for kw in ({}, {"remat": True}):
            leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
            tmoe.loss_fn(leaves, torch.from_numpy(toks), tcfg, **kw).backward()
            grads.append(leaves["w_gate_e"].grad)
        _close(grads[1], grads[0])


# -- decode -----------------------------------------------------------------


@pytest.mark.parametrize("top_k", [1, 2])
def test_decode_step_matches_jax(rng, top_k):
    jcfg, tcfg = _cfgs(capacity_factor=AMPLE, top_k=top_k)
    jp, tp = _params(8, jcfg)
    toks = rng.integers(0, tcfg.vocab, (1, 12)).astype(np.int32)
    step = jax.jit(jmoe.decode_step, static_argnames=("cfg",))
    jkvc = jllama.make_kv_cache(jcfg, 1, dtype="float32")
    tkvc = tllama.make_kv_cache(tcfg, 1, device="cpu")
    full, _ = tmoe.forward(tp, torch.from_numpy(toks), tcfg)
    for i in range(toks.shape[1]):
        jl, jkvc = step(jp, jnp.asarray(toks[:, i]), jnp.int32(i), jkvc, jcfg)
        tl, tkvc = tmoe.decode_step(tp, torch.from_numpy(toks[:, i]), i, tkvc,
                                    tcfg)
        _close(tl, jl)
        _close(tl, full[:, i].detach(), rtol=2e-3, atol=2e-3)


def test_generate_matches_jax(rng):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(9, jcfg)
    prompt = rng.integers(0, tcfg.vocab, (1, 6)).astype(np.int32)
    want, _ = jmoe.generate(jp, jnp.asarray(prompt),
                            jllama.make_kv_cache(jcfg, 1, dtype="float32"),
                            jcfg, 6)
    got, _ = tmoe.generate(tp, torch.from_numpy(prompt),
                           tllama.make_kv_cache(tcfg, 1, device="cpu"), tcfg, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mesh_and_sequence_axes_raise():
    """The mesh arguments shard the family over a process group
    (``tests/test_torch_moe_train.py``). A mesh without one (a layout)
    raises; the decode hooks refuse a mesh that splits the heads; an axis
    named without a mesh changes nothing, as in the JAX module."""
    from oncilla_tpu_torch.models import train

    cfg = tmoe.MoeConfig.tiny()
    params = tmoe.init_moe_params(cfg, device="cpu")
    toks = torch.zeros(1, 4, dtype=torch.long)
    h = torch.randn(1, 4, cfg.dim, generator=torch.Generator().manual_seed(0))
    lp = tmoe.moe_layer_params(params, 0)
    layout = train.make_moe_mesh(4, device="cpu")  # (1, 2, 2), no group
    dense = train.make_mesh(4, device="cpu")       # (1, 2, 2), no group
    for call in (lambda: tmoe.moe_ffn(h, lp, cfg, mesh=layout, ep_axis="ep"),
                 lambda: tmoe.forward(params, toks, cfg, mesh=layout, ep_axis="ep"),
                 lambda: tmoe.forward(params, toks, cfg, mesh=dense, seq_axis="sp")):
        with pytest.raises(RuntimeError, match="layout"):
            call()
    with pytest.raises(ValueError, match="tp"):
        tmoe.paged_hooks(cfg, mesh=layout, ep_axis="ep")
    y, aux = tmoe.moe_ffn(h, lp, cfg, ep_axis="ep")
    y0, aux0 = tmoe.moe_ffn(h, lp, cfg)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)


# -- the paged decoders -----------------------------------------------------

PAGE = 4
N_TOKENS = 12


def _ctx(which):
    conf = dict(host_arena_bytes=16 << 20, device_arena_bytes=16 << 20)
    if which == "jax":
        return jocm.ocm_init(jocm.OcmConfig(**conf))
    return tocm.ocm_init(tocm.OcmConfig(**conf), device="cpu")


@pytest.mark.parametrize("kind", ["LOCAL_HOST", "LOCAL_DEVICE"])
@pytest.mark.parametrize("decoder", ["BucketedPagedDecoder", "PagedDecoder"])
def test_paged_decoders_match_jax(rng, decoder, kind):
    jcfg, tcfg = _cfgs(capacity_factor=AMPLE, max_seq=32)
    jp, tp = _params(10, jcfg)
    toks = rng.integers(0, tcfg.vocab, (1, N_TOKENS)).astype(np.int32)
    out = {}
    for which, mod, ocm, params, cfg, hooks in (
            ("jax", jkv, jocm, jp, jcfg, jmoe.paged_hooks(jcfg)),
            ("port", tkv, tocm, tp, tcfg, tmoe.paged_hooks(tcfg))):
        ctx = _ctx(which)
        extra = {"refetch": True} if decoder == "BucketedPagedDecoder" else {}
        dec = getattr(mod, decoder)(params, cfg, ctx, batch=1, page_tokens=PAGE,
                                    kind=ocm.OcmKind[kind], dtype="float32",
                                    **extra, **hooks)
        step = (lambda i: dec.step(jnp.asarray(toks[:, i]))) if which == "jax" \
            else (lambda i: dec.step(torch.from_numpy(toks[:, i])))
        out[which] = [np.asarray(step(i)) for i in range(N_TOKENS)]
        assert len(dec.cache.pages) == N_TOKENS // PAGE
        dec.close()
        ctx.tini()
    for i, (t, j) in enumerate(zip(out["port"], out["jax"])):
        _close(t, j)
    # The port's paged decode is the unpaged decode, bit for bit.
    kv = tllama.make_kv_cache(tcfg, 1, device="cpu")
    for i in range(N_TOKENS):
        lg, kv = tmoe.decode_step(tp, torch.from_numpy(toks[:, i]), i, kv, tcfg)
        assert torch.equal(lg, torch.from_numpy(out["port"][i])), i


def test_step_page_matches_per_token_and_keeps_one_graph_a_bucket(rng):
    jcfg, tcfg = _cfgs(capacity_factor=AMPLE, max_seq=32)
    _, tp = _params(10, jcfg)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab, (1, N_TOKENS)))
    ctx = _ctx("port")
    kw = dict(batch=1, page_tokens=PAGE, kind=tocm.OcmKind.LOCAL_HOST,
              dtype="float32", **tmoe.paged_hooks(tcfg))
    ref = tkv.BucketedPagedDecoder(tp, tcfg, ctx, **kw)
    want = torch.stack([ref.step(toks[:, i])[0] for i in range(N_TOKENS)])
    ref.close()
    graphs = StepGraphs(tp, tcfg)  # the graph bookkeeping, on the CPU
    got = []
    for _ in range(2):  # a second decoder with equal hooks shares the graphs
        dec = tkv.BucketedPagedDecoder(tp, tcfg, ctx, graphs=graphs, **kw)
        got = torch.cat([dec.step_page(toks[:, p * PAGE:(p + 1) * PAGE])[0]
                         for p in range(N_TOKENS // PAGE)])
        dec.close()
        _close(got, want)
        # Contexts of 0, 1 and 2 pages: one bucket each, whatever the
        # token, the page or the decoder.
        assert len(graphs.steps) == 3
    ctx.tini()
    step = {fn for fn, _ in graphs.steps}
    assert len(step) == 1
    assert step == {tkv.hooked_step(tkv.paged_token_step,
                                    **tmoe.paged_hooks(tcfg))}
    assert step == {tkv.hooked_step(tkv.paged_token_step,
                                    *tmoe.paged_hooks(tcfg).values())}
    assert tkv.hooked_step(tkv.paged_token_step) is tkv.paged_token_step


def test_paged_decode_batch_step_matches_jax(rng):
    jcfg, tcfg = _cfgs(capacity_factor=AMPLE, max_seq=64)
    jp, tp = _params(11, jcfg)
    L, KV, Hd, P = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim, PAGE
    N, B, MP = 5, 3, 2
    f32 = np.float32
    pool_k = rng.standard_normal((N, L, KV, P, Hd)).astype(f32)
    pool_v = rng.standard_normal((N, L, KV, P, Hd)).astype(f32)
    table = np.int32([[1, 3], [4, 0], [2, 2]])
    # [pos, tail_len, ctx_len, ctx_start]: two pages, one page, no context.
    meta = np.int32([[10, 2, 8, 0], [5, 1, 4, 0], [3, 3, 0, 0]])
    tail_k = rng.standard_normal((L, B, KV, P, Hd)).astype(f32)
    tail_v = rng.standard_normal((L, B, KV, P, Hd)).astype(f32)
    toks = rng.integers(0, tcfg.vocab, B).astype(np.int32)
    jl, jtk, jtv = jkv.paged_decode_batch_step_jit(
        jp, jnp.asarray(toks), jnp.asarray(meta), jnp.asarray(pool_k),
        jnp.asarray(pool_v), jnp.asarray(table), jnp.asarray(tail_k),
        jnp.asarray(tail_v), jcfg, **jmoe.paged_hooks(jcfg))
    tk, tv = torch.from_numpy(tail_k.copy()), torch.from_numpy(tail_v.copy())
    tl, tk2, tv2 = tkv.paged_decode_batch_step(
        tp, torch.from_numpy(toks), torch.from_numpy(meta),
        torch.from_numpy(pool_k), torch.from_numpy(pool_v),
        torch.from_numpy(table).long(), tk, tv, tcfg, **tmoe.paged_hooks(tcfg))
    _close(tl, jl)
    _close(tk2, jtk)
    _close(tv2, jtv)


# -- chip_smoke.py phase 5m, rehearsed --------------------------------------


def test_phase_5m_on_the_cpu():
    """Phase 5m at tiny width: (a)'s references, (b) and (c) bit for bit
    against them, (d)'s eager page steps held to them, its graphed page
    steps (on the CPU: the graph bookkeeping) bit for bit against the eager
    ones with one graph a context bucket,
    and the plane's page stores and fetches equal to the pages each mode
    ships and re-reads (on the card each is one K1/K2 launch, which the
    phase then holds equal to them; the CPU runs the plain copies)."""
    import chip_smoke

    torch.manual_seed(0)
    cfg = tmoe.MoeConfig.tiny()
    params = tmoe.init_moe_params(cfg, torch.Generator().manual_seed(0), "cpu")
    r = chip_smoke.phase_moe(torch.device("cpu"), cfg, params, prompt_len=16,
                             n_gen=8, page_tokens=8, row_bytes=1 << 20,
                             check_launches=False)
    m = r["modes"]
    assert r["pages"] == 3
    assert m["paged"]["vs_unpaged"] == m["bucketed"]["vs_unpaged"] == "bits"
    assert (m["paged"]["page_stores"], m["paged"]["page_fetches"]) == (3, 0)
    for name in ("bucketed", "bucketed_pages", "bucketed_graphs"):
        assert (m[name]["page_stores"], m[name]["page_fetches"]) == (3, 6)
    rows = m["bucketed_pages"]["vs_unpaged"]
    assert rows["tokens_agree"] == rows["rows"] == 9
    assert m["bucketed_graphs"]["vs_bucketed_pages"] == "bits"
    g = m["bucketed_graphs"]["graphs"]
    assert g["keys"] == g["buckets"] == 3
    assert r["token_bytes"]["dense"] > r["token_bytes"]["sparse"]
