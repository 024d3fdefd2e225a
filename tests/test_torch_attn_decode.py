"""The paged decode attention kernel (``ops/attn.py``, ``csrc/attn_decode.cu``).

CPU cases: the wrapper's checks raise before the library is touched, the
split rule, the kernel's key selection and split merge modelled in PyTorch
against the plain path, ``paged_token_step`` on the CPU taking the plain
path with the results it had, and CUDA tensors always taking the kernel. Cases marked ``card`` hold the kernel against
the plain path on a CUDA card and skip without one; run them there with
``python -m pytest tests/test_torch_attn_decode.py --noconftest -q`` (this
file imports no JAX).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from oncilla_tpu_torch.models import kv_paging, llama
from oncilla_tpu_torch.models.graphs import StepGraphs
from oncilla_tpu_torch.ops import attn

B, P = 3, 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the attention kernel runs on the card alone")
    return torch.device("cuda", 0)


def _inputs(seed, *, B=B, KV=2, G=4, D=64, C=48, P=P, dtype=torch.float32,
            device="cpu", meta=None, garbage=0.0):
    """Random q/kn/vn/context/tails and a (B, 4) meta; context keys past
    each row's ctx_len and tail slots past tail_len hold ``garbage``."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(dtype)

    q, kn, vn = r(B, KV * G, 1, D), r(B, KV, 1, D), r(B, KV, 1, D)
    k_ctx, v_ctx = r(B, KV, C, D), r(B, KV, C, D)
    tail_k, tail_v = r(B, KV, P, D), r(B, KV, P, D)
    if meta is None:  # rows: full context, ragged, one with an empty tail
        meta = [[C + P - 1, P - 1, C, 0], [C // 2 + 5, 5, C // 2, 0],
                [C + 40, 0, C, 40]][:B]
    meta = torch.tensor(meta, dtype=torch.int64)
    for b, (_, tail_len, ctx_len, _) in enumerate(meta.tolist()):
        for t in (k_ctx, v_ctx):
            t[b, :, ctx_len:] = garbage
        for t in (tail_k, tail_v):
            t[b, :, tail_len:] = garbage
    ts = (q, kn, vn, k_ctx, v_ctx, tail_k, tail_v, meta)
    return tuple(t.to(device) for t in ts)


def _plain(q, kn, vn, k_ctx, v_ctx, tail_k, tail_v, meta, window):
    mask, slot = attn.decode_masks(meta, k_ctx.shape[2], tail_k.shape[2], window)
    return attn.attn_decode_plain(q, kn, vn, k_ctx, v_ctx, tail_k, tail_v, mask, slot)


# -- CPU: the wrapper's checks ----------------------------------------------


def _bad(case):
    """Arguments of attn_decode that it must refuse, CPU tensors but for
    the device case's."""
    t = list(_inputs(0))
    window = None
    if case == "device":
        pass  # every tensor on the CPU
    elif case == "dtype":
        t[:7] = [x.to(torch.float64) for x in t[:7]]
    elif case == "mixed_dtype":
        t[3] = t[3].to(torch.bfloat16)
    elif case == "head_dim":
        t = list(_inputs(0, D=32))
    elif case == "groups":
        t = list(_inputs(0, G=3))
    elif case == "group_of_8":
        t = list(_inputs(0, G=8))
    elif case == "shape":
        t[1] = t[1][:, :1]
    elif case == "queries":
        t[0] = torch.cat([t[0], t[0]], 2)
    elif case == "contiguity":
        t[5] = t[5].transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "meta":
        t[7] = t[7].to(torch.int32)
    return (*t, window)


@pytest.mark.parametrize("case", ["device", "dtype", "mixed_dtype", "head_dim",
                                  "groups", "group_of_8", "shape", "queries",
                                  "contiguity", "meta"])
def test_wrapper_raises_before_the_library(case, monkeypatch):
    def touched(*_):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(attn, "_load", touched)
    args = _bad(case)
    if case != "device":  # every check but the device's, as on a card
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    before = attn.attn_decode.launches
    with pytest.raises(ValueError, match="attn_decode"):
        attn.attn_decode(*args)
    assert attn.attn_decode.launches == before


@pytest.mark.parametrize("keys,pairs,want", [
    (1280, 256, 3), (2432, 256, 3), (16, 256, 1), (129, 1, 1),
    (2432, 4, 19), (100000, 1, 781), (4096, 1024, 1)])
def test_splits_follow_the_shapes(keys, pairs, want):
    # 396 resident CTAs: 3 a SM of an H100's 132, the cell's instantiation
    assert attn.splits(keys, pairs, 396) == want


# -- CPU: the kernel's scheme, modelled -------------------------------------


def _kernel_model(q, kn, vn, k_ctx, v_ctx, tail_k, tail_v, meta, window, nsplit):
    """csrc/attn_decode.cu's arithmetic in float64 PyTorch: each row's valid
    keys counted context then tail, cut into ``nsplit`` even shares, a
    (max, sum, acc) triple a share, merged. Writes the tail slot."""
    B, H, _, D = q.shape
    KV, P, C = tail_k.shape[1], tail_k.shape[2], k_ctx.shape[2]
    G = H // KV
    out = torch.empty(B, H, 1, D, dtype=torch.float64)
    for b, (pos, tail_len, ctx_len, ctx_start) in enumerate(meta.tolist()):
        tail_len, ctx_len = min(max(tail_len, 0), P - 1), min(max(ctx_len, 0), C)
        lo_c = lo_t = 0
        if window is not None:
            lo_c = min(max(pos - window + 1 - ctx_start, 0), ctx_len)
            lo_t = max(tail_len - window + 1, 0)
        n_ctx = ctx_len - lo_c
        n = n_ctx + tail_len - lo_t + 1
        tail_k[b, :, tail_len] = kn[b, :, 0]
        tail_v[b, :, tail_len] = vn[b, :, 0]
        keys = torch.cat([k_ctx[b, :, lo_c:ctx_len], tail_k[b, :, lo_t:tail_len + 1]], 1)
        vals = torch.cat([v_ctx[b, :, lo_c:ctx_len], tail_v[b, :, lo_t:tail_len + 1]], 1)
        assert keys.shape[1] == n
        qb = q[b, :, 0].double().reshape(KV, G, D)
        parts = []
        for s in range(nsplit):
            lo, hi = n * s // nsplit, n * (s + 1) // nsplit
            if lo == hi:
                continue
            sc = torch.einsum("hgd,hkd->hgk", qb, keys[:, lo:hi].double()) / np.sqrt(D)
            m = sc.amax(-1, keepdim=True)
            p = torch.exp(sc - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("hgk,hkd->hgd", p, vals[:, lo:hi].double())))
        mmax = torch.stack([m for m, _, _ in parts]).amax(0)
        l = sum(s * torch.exp(m - mmax) for m, s, _ in parts)
        o = sum(a * torch.exp(m - mmax) for m, _, a in parts)
        out[b, :, 0] = (o / l).reshape(H, D)
    return out.to(q.dtype)


_SCENES = {
    "full": dict(),
    "window_cuts_context": dict(window=20),
    "window_inside_tail": dict(window=3),
    "empty_context": dict(C=0, meta=[[4, 4, 0, 0], [0, 0, 0, 0], [15, 15, 0, 0]]),
    "ctx_len_0_and_C": dict(meta=[[48 + 3, 3, 48, 0], [2, 2, 0, 0], [48 + 15, 15, 48, 0]]),
    "padded_context": dict(C=64, meta=[[40, 8, 32, 0], [20, 0, 20, 0], [63, 15, 48, 0]]),
}


@pytest.mark.parametrize("scene", sorted(_SCENES))
@pytest.mark.parametrize("nsplit", [1, 3, 7])
def test_kernel_scheme_matches_the_plain_path(scene, nsplit):
    kw = dict(_SCENES[scene])
    window = kw.pop("window", None)
    t = _inputs(1, **kw)
    ref = list(t)
    ref[5], ref[6] = ref[5].clone(), ref[6].clone()
    want = _plain(*ref, window)
    got_t = [x.clone() for x in t]
    got = _kernel_model(*got_t, window, nsplit)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got_t[5], ref[5]) and torch.equal(got_t[6], ref[6])


# -- CPU: paged_token_step keeps the plain path -----------------------------


def _old_paged_token_step(params, tokens, meta, k_ctx, v_ctx, tail_k, tail_v, cfg):
    """paged_token_step as it was written before the kernel: the masks once
    a step, the tail written by torch.where, the context and tail
    concatenated and grouped_attention masked."""
    dev = tokens.device
    P, C = tail_k.shape[3], k_ctx.shape[3]
    pos, tail_len, ctx_len, ctx_start = meta.unbind(1)
    x = params["embed"][tokens][:, None, :].to(llama.torch_dtype(cfg.dtype))
    ar_c = torch.arange(C, device=dev)[None, :]
    ar_p = torch.arange(P, device=dev)[None, :]
    valid = torch.cat([ar_c < ctx_len[:, None], ar_p <= tail_len[:, None]], 1)
    if cfg.window is not None:
        gpos = torch.cat([ctx_start[:, None] + ar_c,
                          (pos - tail_len)[:, None] + ar_p], 1)
        valid &= gpos > (pos[:, None] - cfg.window)
    mask = valid[:, None, :]
    slot = (ar_p == tail_len[:, None])[:, None, :, None]
    for i in range(cfg.n_layers):
        def attend(q, kn, vn, i=i):
            tail_k[i] = torch.where(slot, kn.to(tail_k.dtype), tail_k[i])
            tail_v[i] = torch.where(slot, vn.to(tail_v.dtype), tail_v[i])
            k_all = torch.cat([k_ctx[i].to(q.dtype), tail_k[i].to(q.dtype)], 2)
            v_all = torch.cat([v_ctx[i].to(q.dtype), tail_v[i].to(q.dtype)], 2)
            return llama.grouped_attention(q, k_all, v_all, mask)

        x = llama.block(cfg, x, llama.layer_params(params, i), pos[:, None], attend)
    return llama.final_logits(params, x, cfg)[:, 0], tail_k, tail_v


@pytest.mark.parametrize("window", [None, 12])
def test_paged_token_step_on_the_cpu_is_unchanged(window, monkeypatch):
    monkeypatch.setattr(attn, "attn_decode", None)  # never called here
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), window=window)
    params = llama.init_params(cfg, device="cpu", seed=3)
    L, KV, Hd, C = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 32
    g = torch.Generator().manual_seed(4)
    k_ctx, v_ctx = (torch.randn(L, B, KV, C, Hd, generator=g) for _ in range(2))
    tail = torch.randn(L, B, KV, P, Hd, generator=g)
    tokens = torch.tensor([5, 77, 200])
    meta = torch.tensor([[C + 7, 7, C, 0], [20, 4, 16, 0], [C + 15, 15, C - 8, 8]])
    got_k, got_v, ref_k, ref_v = (tail.clone() for _ in range(4))
    got = kv_paging.paged_token_step(params, tokens, meta, k_ctx, v_ctx, got_k,
                                     got_v, cfg)[0]
    ref = _old_paged_token_step(params, tokens, meta, k_ctx, v_ctx, ref_k, ref_v, cfg)[0]
    assert torch.equal(got, ref)
    assert torch.equal(got_k, ref_k) and torch.equal(got_v, ref_v)


# The test model (head size 16, 2 query heads a KV head) and Mixtral's head
# size and grouping (128, 4) at a few layers.
CONFIGS = {"tiny": llama.LlamaConfig.tiny(),
           "grouped_128": llama.LlamaConfig(vocab=256, dim=512, n_layers=2, n_heads=4,
                                            n_kv_heads=1, ffn_hidden=64,
                                            dtype="float32")}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("window", [None, 12])
def test_cuda_tensors_always_take_the_kernel(config, window, monkeypatch):
    """On the card every layer's attention is the kernel, whatever the
    configuration (the test model's head size 16 and 2 query heads a KV
    head included): the plain path is the CPU's alone. The device is faked
    and the kernel stood in for by the plain path, so the step's result
    is the one it has on the CPU."""
    plain = attn.attn_decode_plain
    calls = []

    def kernel(q, kn, vn, k_ctx, v_ctx, tail_k, tail_v, meta, win):
        calls.append((q.shape[-1], q.shape[1] // kn.shape[1], win))
        mask, slot = attn.decode_masks(meta, k_ctx.shape[2], tail_k.shape[2], win)
        return plain(q, kn, vn, k_ctx, v_ctx, tail_k, tail_v, mask, slot)

    def no_plain(*_):
        raise AssertionError("the plain path ran on CUDA tensors")

    cfg = dataclasses.replace(CONFIGS[config], window=window)
    params = llama.init_params(cfg, device="cpu", seed=3)
    L, KV, Hd, C = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 32
    g = torch.Generator().manual_seed(4)
    k_ctx, v_ctx = (torch.randn(L, B, KV, C, Hd, generator=g) for _ in range(2))
    tail = torch.randn(L, B, KV, P, Hd, generator=g)
    tokens = torch.tensor([5, 77, 200])
    meta = torch.tensor([[C + 7, 7, C, 0], [20, 4, 16, 0], [C + 15, 15, C - 8, 8]])
    ref_k, ref_v, got_k, got_v = (tail.clone() for _ in range(4))
    ref = _old_paged_token_step(params, tokens, meta, k_ctx, v_ctx, ref_k, ref_v, cfg)[0]
    monkeypatch.setattr(attn, "attn_decode", kernel)
    monkeypatch.setattr(attn, "attn_decode_plain", no_plain)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    got = kv_paging.paged_token_step(params, tokens, meta, k_ctx, v_ctx, got_k,
                                     got_v, cfg)[0]
    assert calls == [(Hd, cfg.n_heads // KV, window)] * L
    assert torch.equal(got, ref)
    assert torch.equal(got_k, ref_k) and torch.equal(got_v, ref_v)


# -- the card ---------------------------------------------------------------


def _on_card_case(card, seed, dtype, window=None, **kw):
    t = _inputs(seed, dtype=dtype, device=card, **kw)
    ref = [x.clone() for x in t]
    got = [x.clone() for x in t]
    want = _plain(*ref, window)
    before = attn.attn_decode.launches
    out = attn.attn_decode(*got, window)
    torch.cuda.synchronize(card)
    assert attn.attn_decode.launches > before
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=2e-5)
    else:  # both round one float32 result: at most a step of the type apart
        torch.testing.assert_close(out.float(), want.float(), rtol=2 ** -7, atol=1e-3)
    assert torch.equal(got[5], ref[5]) and torch.equal(got[6], ref[6])
    return out


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("scene", sorted(_SCENES))
def test_kernel_matches_the_plain_path(card, dtype, D, G, scene):
    kw = dict(_SCENES[scene])
    window = kw.pop("window", None)
    _on_card_case(card, 2, dtype, window, D=D, G=G, **kw)


@pytest.mark.card
@pytest.mark.parametrize("C", [0, 128, 1152, 2304])
def test_kernel_at_the_cells_widths(card, C):
    B, P = 32, 128
    meta = [[C + j, j, C, 0] for j in range(0, 128, 4)]
    _on_card_case(card, 5, torch.bfloat16, B=B, KV=8, G=4, D=128, C=C, P=P, meta=meta)


@pytest.mark.card
def test_kernel_in_float16(card):
    _on_card_case(card, 6, torch.float16, D=128, G=4, window=20)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_garbage_past_the_valid_keys_changes_nothing(card, dtype):
    meta = [[60, 8, 32, 0], [20, 0, 20, 0], [63, 15, 48, 0]]
    clean = _inputs(7, C=64, dtype=dtype, device=card, meta=meta)
    dirty = _inputs(7, C=64, dtype=dtype, device=card, meta=meta, garbage=float("nan"))
    a = attn.attn_decode(*clean, None)
    b = attn.attn_decode(*dirty, None)
    assert torch.equal(a, b)
    for i in (5, 6):  # the written slots and everything before them agree
        for row, (_, tail_len, _, _) in enumerate(meta):
            assert torch.equal(clean[i][row, :, :tail_len + 1],
                               dirty[i][row, :, :tail_len + 1])


@pytest.mark.card
def test_strided_context_view(card):
    t = list(_inputs(8, C=96, dtype=torch.bfloat16, device=card, D=128,
                     meta=[[90, 10, 80, 0], [40, 3, 37, 0], [95, 15, 80, 0]]))
    ref = [x.clone() for x in t]
    t[3], t[4] = t[3][:, :, 16:], t[4][:, :, 16:]  # a page dropped: a view
    ref[3], ref[4] = ref[3][:, :, 16:].contiguous(), ref[4][:, :, 16:].contiguous()
    for m in (t[7], ref[7]):
        m[:, 2] -= 16
        m[:, 3] += 16
    assert not t[3].is_contiguous()
    torch.testing.assert_close(attn.attn_decode(*t, 50).float(),
                               _plain(*ref, 50).float(), rtol=2 ** -7, atol=1e-3)


@pytest.mark.card
@pytest.mark.parametrize("window", [None, 40])
def test_graphed_page_matches_eager(card, window):
    cfg = llama.LlamaConfig(vocab=512, dim=512, n_layers=2, n_heads=8,
                            n_kv_heads=2, ffn_hidden=256, max_seq=512,
                            window=window)
    params = llama.init_params(cfg, torch.Generator(device=card).manual_seed(0), card)
    L, KV, Hd, C, Pg = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 64, 32
    g = torch.Generator(device=card).manual_seed(1)
    shape = (L, B, KV, C, Hd)
    k_ctx, v_ctx = (torch.randn(shape, generator=g, device=card).to(torch.bfloat16)
                    for _ in range(2))
    tokens = torch.randint(0, cfg.vocab, (B, Pg), generator=g, device=card)
    tails = [torch.zeros(L, B, KV, Pg, Hd, dtype=torch.bfloat16, device=card)
             for _ in range(4)]
    page = functools.partial(kv_paging.paged_decode_page, params, tokens, (48, 0),
                             k_ctx, v_ctx, cfg=cfg, ctx_len=48)
    before = attn.attn_decode.launches
    eager = page(tail_k=tails[0], tail_v=tails[1])[0]
    graphs = StepGraphs(params, cfg)
    graphed = page(tail_k=tails[2], tail_v=tails[3], graphs=graphs)[0]
    torch.cuda.synchronize(card)
    assert graphs.captured == 1 and attn.attn_decode.launches > before
    assert torch.equal(eager, graphed)
    assert torch.equal(tails[0], tails[2]) and torch.equal(tails[1], tails[3])
    graphs.close()
