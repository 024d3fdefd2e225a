"""The port's Llama training surface held against the JAX package on the
CPU: the same numpy inputs through both.

Tolerances (float32 tiny config): logits and loss rtol 1e-5; gradients
rtol 1e-4 of each leaf's largest gradient; blocked CE rtol 1e-5 against
the JAX blocked CE and the plain loss; remat (True, "dots") equal to the
plain loss and grads; ``init_params_host`` byte for byte; greedy
``generate`` equal to stepwise decode and to the JAX package's tokens.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from oncilla_tpu.models import llama as jl
from oncilla_tpu_torch.models import llama as tl

CFG_J = jl.LlamaConfig.tiny()
CFG_T = tl.LlamaConfig.tiny()


def _tokens(seed=1, shape=(2, 16)):
    return np.random.default_rng(seed).integers(0, CFG_J.vocab, shape, dtype=np.int32)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params_host(0, CFG_J)
    return jp, tl.init_params_host(0, CFG_T, device="cpu")


def _grads(tp, tok, cfg=CFG_T, **kw):
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    loss = tl.loss_fn(leaves, torch.from_numpy(tok), cfg, **kw)
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_host_is_the_jax_draw_byte_for_byte(dtype):
    cj = dataclasses.replace(CFG_J, dtype=dtype)
    ct = dataclasses.replace(CFG_T, dtype=dtype)
    jp = jl.init_params_host(3, cj)
    tp = tl.init_params_host(3, ct, device="cpu")
    assert list(tp) == list(jp)
    for k in jp:
        want = np.asarray(jp[k])
        got = tp[k]
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, k
        assert got.view(torch.uint8).numpy().tobytes() == want.tobytes(), k


def test_forward_and_loss_match_jax(params):
    jp, tp = params
    tok = _tokens()
    want = np.asarray(jl.forward(jp, jnp.asarray(tok), CFG_J))
    got = tl.forward(tp, torch.from_numpy(tok), CFG_T).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 16, CFG_J.vocab)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(tl.loss_fn(tp, torch.from_numpy(tok), CFG_T)),
        float(jl.loss_fn(jp, jnp.asarray(tok), CFG_J)), rtol=1e-5)


def test_gradients_match_jax_grad(params):
    jp, tp = params
    tok = _tokens()
    jloss, jg = jax.value_and_grad(lambda p: jl.loss_fn(p, jnp.asarray(tok), CFG_J))(jp)
    loss, g = _grads(tp, tok)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(g) == set(jg)
    for k in jg:
        want = np.asarray(jg[k])
        np.testing.assert_allclose(g[k].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize("block", [5, 15])  # T = 15: both divide; T = 7: both pad
def test_blocked_cross_entropy_matches_jax_and_the_plain_loss(params, block):
    jp, tp = params
    for seq in (16, 8):
        tok = _tokens(seed=seq, shape=(2, seq))
        want = float(jl.loss_fn(jp, jnp.asarray(tok), CFG_J, ce_block=block))
        got = tl.loss_fn(tp, torch.from_numpy(tok), CFG_T, ce_block=block)
        plain = tl.loss_fn(tp, torch.from_numpy(tok), CFG_T)
        np.testing.assert_allclose(float(got), want, rtol=1e-5)
        np.testing.assert_allclose(float(got), float(plain), rtol=1e-5)
        _, g_blk = _grads(tp, tok, ce_block=block)
        _, g = _grads(tp, tok)
        for k in g:
            np.testing.assert_allclose(g_blk[k].numpy(), g[k].numpy(), rtol=0,
                                       atol=1e-4 * float(g[k].abs().max()), err_msg=k)


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_gives_the_plain_loss_and_grads(params, remat):
    _, tp = params
    tok = _tokens()
    loss, g = _grads(tp, tok)
    loss_r, g_r = _grads(tp, tok, remat=remat)
    assert float(loss_r) == float(loss)
    for k in g:
        torch.testing.assert_close(g_r[k], g[k], rtol=1e-6, atol=1e-7, msg=k)


class _OpCount(TorchDispatchMode):
    """Counts the aten ops run under it."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


def _backward_products(tp, tok, remat):
    """(mm, bmm) launched by backward, checkpoint recomputation included."""
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    loss = tl.loss_fn(leaves, torch.from_numpy(tok), CFG_T, remat=remat)
    with _OpCount() as ops:
        torch.autograd.grad(loss, list(leaves.values()))
    aten = torch.ops.aten
    return ops.n[aten.mm.default], ops.n[aten.bmm.default]


def test_dots_policy_saves_the_weight_products_only(params):
    """"dots" keeps the 2-D weight products (aten.mm) and recomputes the
    rest, the attention bmms among it, as JAX's
    dots_with_no_batch_dims_saveable does; full remat recomputes both.
    (Recomputation stops at the last saved value backward needs, so full
    remat redoes six of a block's seven products: not w_down's.)"""
    _, tp = params
    tok = _tokens()
    (mm0, bmm0), (mm_d, bmm_d), (mm_f, bmm_f) = (
        _backward_products(tp, tok, r) for r in (False, "dots", True))
    assert mm_d == mm0 and mm_f == mm0 + 6 * CFG_T.n_layers
    assert bmm_d == bmm_f == bmm0 + 2 * CFG_T.n_layers  # QK^T and PV again


def test_block_mlp_hook(params):
    _, tp = params
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, CFG_T.dim)).astype(np.float32))
    lp = tl.layer_params(tp, 0)
    pos = torch.arange(8)
    attend = tl.make_attend(8)
    dense = tl.block(CFG_T, x, lp, pos, attend)
    assert torch.equal(tl.block(CFG_T, x, lp, pos, attend, mlp=None), dense)
    zero = tl.block(CFG_T, x, lp, pos, attend, mlp=lambda h: torch.zeros_like(h))
    with_mlp = tl.block(
        CFG_T, x, lp, pos, attend,
        mlp=lambda h: (torch.nn.functional.silu(h @ lp["w_gate"]) * (h @ lp["w_up"]))
        @ lp["w_down"])
    assert torch.equal(with_mlp, dense) and not torch.equal(zero, dense)


def test_make_attend_refuses_a_sequence_axis():
    """A sequence axis runs ring attention over the mesh's process group
    (``tests/test_torch_ring_attention.py``): a mesh without one (a layout)
    refuses it, and an axis of size 1 is the dense attention."""
    from oncilla_tpu_torch.models import train

    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(1, 4, 8, 16, generator=g), torch.randn(1, 2, 8, 16, generator=g)
    attend = tl.make_attend(8, mesh=train.make_mesh(4, device="cpu"), seq_axis="sp")
    with pytest.raises(RuntimeError, match="layout"):
        attend(q, k, k)
    one = tl.make_attend(8, mesh=train.make_mesh(1, device="cpu"), seq_axis="sp")
    assert torch.equal(one(q, k, k), tl.make_attend(8)(q, k, k))


@pytest.mark.parametrize("sq,sk,window", [(5, 5, None), (3, 7, None), (6, 6, 2), (4, 9, 3)])
def test_causal_mask_matches_jax(sq, sk, window):
    want = np.asarray(jl.causal_mask(sq, sk, window))
    assert np.array_equal(tl.causal_mask(sq, sk, window).numpy(), want)


def test_sliding_window_forward_matches_jax(params):
    jp, tp = params
    tok = _tokens(seed=5)
    cj = dataclasses.replace(CFG_J, window=4)
    ct = dataclasses.replace(CFG_T, window=4)
    want = np.asarray(jl.forward(jp, jnp.asarray(tok), cj))
    got = tl.forward(tp, torch.from_numpy(tok), ct).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not np.allclose(got, tl.forward(tp, torch.from_numpy(tok), CFG_T).numpy())


def test_generate_greedy_matches_stepwise_decode_and_jax(params):
    jp, tp = params
    prompt = _tokens(seed=7, shape=(2, 5))
    steps = 6
    cache = tl.make_kv_cache(CFG_T, 2, device="cpu")
    got, cache = tl.generate(tp, torch.from_numpy(prompt), cache, CFG_T, steps)
    assert got.shape == (2, steps) and got.dtype == torch.int32
    # Stepwise: prefill then argmax a step, fresh cache.
    ref_cache = tl.make_kv_cache(CFG_T, 2, device="cpu")
    seq = torch.from_numpy(prompt)
    toks = []
    with torch.no_grad():
        for pos in range(prompt.shape[1] + steps - 1):
            tok = seq[:, pos] if pos < prompt.shape[1] else toks[-1]
            logits, ref_cache = tl.decode_step(tp, tok, pos, ref_cache, CFG_T)
            if pos >= prompt.shape[1] - 1:
                toks.append(torch.argmax(logits, -1).to(torch.int32))
    assert torch.equal(got, torch.stack(toks, 1))
    assert torch.equal(cache[0], ref_cache[0])
    jcache = jl.make_kv_cache(CFG_J, 2)
    want, _ = jl.generate(jp, jnp.asarray(prompt), jcache, CFG_J, steps)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_decode_loop_logits_match_the_forward(params):
    _, tp = params
    tok = _tokens(seed=9, shape=(2, 7))
    cache = tl.make_kv_cache(CFG_T, 2, device="cpu")
    with torch.no_grad():
        logits, _ = tl.decode_loop(tp, torch.from_numpy(tok), cache, CFG_T)
        want = tl.forward(tp, torch.from_numpy(tok), CFG_T)
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-5)
