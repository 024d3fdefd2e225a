"""The port's train step and AdamW held against the JAX package's
``make_train_step(cfg, make_mesh(1), tx, use_ring=False)`` and
``optax.adamw`` on the CPU, from the same state (carried across with
``params_from_jax`` and ``opt_state_from_jax``) and the same batches.

Tolerances: float32 params and loss within rtol 1e-5, atol 1e-5 after 3
steps at the production lr 3e-4 (Adam's first steps divide by sqrt(ν) +
1e-8, so a gradient near 1e-8 turns a 1e-9 difference in its summation
order into ~1e-6 of a parameter); Adam's µ within 1e-4 of its leaf's
largest |µ| (the gradients' agreement, as in test_torch_model), and with
µ in bf16 within one bf16 step (2^-7 of the leaf's largest |µ|) for each
step taken: a µ at a rounding boundary rounds the other way once the
gradients' last bits differ, and that carries into the next steps.

With bfloat16 weights the two forwards round differently (XLA keeps
float32 between fused ops, torch rounds each op's result), so the loss is
held to rtol 1e-3 (bf16's step is 2^-8), µ to 2 % of its norm, and each
weight's change over the 3 steps to 20 % of the norm of JAX's change: a
bf16 weight of 0.02 moves by one or two of its steps a step at lr 3e-4,
so one rounding the other way changes its move by half (measured 10 %);
a skipped or doubled update is 100 %.

On the same gradients, the optimizer alone keeps every state element
within one step of its dtype (2^-23 float32, 2^-7 bf16) for each update
taken, of the magnitude the update works at: the parameter's largest |p|
over the steps and the lr for p; |µ| and (1 - β1) of the largest |g| for
µ, where terms of opposite sign cancel; |ν| for ν, a sum of squares. A
skipped update misses that by 22 or more bf16 steps. Folded, offloaded
and plain steps of the port are held equal bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oncilla_tpu.models import train as jt
from oncilla_tpu.models.llama import LlamaConfig
from oncilla_tpu_torch.models import llama as tl
from oncilla_tpu_torch.models import optim, train

CFG_J = LlamaConfig.tiny()
CFG_T = tl.LlamaConfig.tiny()
LR = 3e-4


def _carried(mu_dtype=None, cfg=CFG_J):
    """The JAX package's state and the port's copy of it."""
    mesh = jt.make_mesh(1)
    jmu = jnp.bfloat16 if mu_dtype is not None else None
    jp, jo, jtx = jt.make_train_state_host(0, cfg, mesh, lr=LR, mu_dtype=jmu)
    tp = tl.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    to = optim.opt_state_from_jax(jax.tree.map(np.asarray, jo), "cpu")
    return (jp, jo, jtx, mesh), (tp, to, optim.adamw(LR, mu_dtype=mu_dtype))


def _batches(n=3, batch=4, seq=32, seed=0):
    rng = np.random.default_rng(seed)
    return [np.array(jt.sample_batch(rng, CFG_J, batch, seq)) for _ in range(n)]


def _within(got: torch.Tensor, want, tol: float, what: str) -> None:
    """|got - want| <= tol * max|want| over the leaf."""
    want = np.asarray(want).astype(np.float32)
    err = np.abs(got.float().numpy() - want).max(initial=0.0)
    assert err <= tol * np.abs(want).max(initial=0.0), (what, err)


def _assert_state_close(jp, tp, jo=None, to=None, mu_tol=1e-4):
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    if jo is not None:
        assert int(to[0].count) == int(jo[0].count)
        for k in jp:
            _within(to[0].mu[k], jo[0].mu[k], mu_tol, f"mu {k}")


def _norm_rel(got: torch.Tensor, want, what: str, tol: float, base=None) -> None:
    """||got - want|| <= tol * ||want - base||, in float32."""
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    base = 0.0 if base is None else base.float().numpy()
    err = np.linalg.norm(got - want) / np.linalg.norm(want - base)
    assert err <= tol, (what, err)


@pytest.mark.parametrize("dtype,mu_dtype", [
    ("float32", None), ("float32", torch.bfloat16), ("bfloat16", None)],
    ids=["fp32", "bf16_mu", "bf16_params"])
def test_three_steps_match_jax(dtype, mu_dtype):
    cfg_j = dataclasses.replace(CFG_J, dtype=dtype)
    (jp, jo, jtx, mesh), (tp, to, ttx) = _carried(mu_dtype, cfg_j)
    p0 = {k: v.clone() for k, v in tp.items()}
    jstep = jt.make_train_step(cfg_j, mesh, jtx, use_ring=False)
    tstep = train.make_train_step(dataclasses.replace(CFG_T, dtype=dtype), ttx)
    for tok in _batches():
        jp, jo, jloss = jstep(jp, jo, jnp.asarray(tok))
        tp, to, tloss = tstep(tp, to, torch.from_numpy(tok))
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=1e-5 if dtype == "float32" else 1e-3)
    wdt = tl.torch_dtype(dtype)
    assert tp["wq"].dtype == wdt and tp["ln_out"].dtype == torch.float32
    assert to[0].mu["wq"].dtype == (mu_dtype or wdt)
    assert to[0].nu["wq"].dtype == wdt
    if dtype == "float32":
        _assert_state_close(jp, tp, jo, to, mu_tol=3 * 2.0 ** -7 if mu_dtype else 1e-4)
        return
    assert int(to[0].count) == int(jo[0].count) == 3
    for k in jp:
        _norm_rel(tp[k], jp[k], f"change of {k}", 0.2, base=p0[k])
        _norm_rel(to[0].mu[k], jo[0].mu[k], f"mu {k}", 0.02)


def _ulps_within(got: torch.Tensor, want, scale, steps: int, what: str) -> None:
    """|got - want| <= steps * (one step of got's dtype at max(|want|,
    scale)), element by element."""
    want = np.asarray(want).astype(np.float32)
    mag = np.maximum(np.abs(want), scale).astype(np.float32)
    ulp = np.spacing(mag) * (2.0 ** 16 if got.dtype == torch.bfloat16 else 1.0)
    err = np.abs(got.float().numpy() - want) / ulp
    assert err.max(initial=0.0) <= steps, (what, err.max())


@pytest.mark.parametrize("param_dtype,mu_dtype", [
    (torch.float32, None), (torch.float32, torch.bfloat16),
    (torch.bfloat16, None), (torch.bfloat16, torch.bfloat16)])
def test_adamw_equals_optax_on_the_same_gradients(param_dtype, mu_dtype):
    """Three updates of ``optax.adamw`` (jitted, as the JAX step runs it)
    and of the port's AdamW on the same parameters and gradients, some of
    those near ε: every state element within one step of its dtype, at the
    magnitude its update works at, for each update."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    rng = np.random.default_rng(11)
    shapes = {"w": (64, 33), "norm": (7,), "stack": (3, 5, 9)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    jp = {k: jnp.asarray(v, jdt[param_dtype]) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(param_dtype) for k, v in p0.items()}
    jtx = optax.adamw(LR, weight_decay=0.01,
                      mu_dtype=None if mu_dtype is None else jnp.bfloat16)
    js = jtx.init(jp)
    ttx = optim.adamw(LR, mu_dtype=mu_dtype)
    ts = ttx.init(tp)
    p_mag = {k: np.abs(v) for k, v in p0.items()}  # largest |p| over the steps
    g_mag = {k: np.zeros(s, np.float32) for k, s in shapes.items()}  # largest |g|

    @jax.jit
    def update(g, s, p):
        u, s = jtx.update(g, s, p)
        return optax.apply_updates(p, u), s

    for _ in range(3):
        g0 = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-9, 0, s)).astype(np.float32)
              for k, s in shapes.items()}
        g = {k: torch.from_numpy(v).to(param_dtype) for k, v in g0.items()}
        jp, js = update({k: jnp.asarray(v, jdt[param_dtype]) for k, v in g0.items()}, js, jp)
        ttx.step(tp, g, ts)
        for k in shapes:
            p_mag[k] = np.maximum(p_mag[k], np.abs(np.asarray(jp[k]).astype(np.float32)))
            g_mag[k] = np.maximum(g_mag[k], g[k].float().abs().numpy())
    assert int(ts[0].count) == int(js[0].count) == 3
    for k in shapes:
        for what, got, want, scale in (
                ("param", tp[k], jp[k], np.maximum(p_mag[k], LR)),
                ("mu", ts[0].mu[k], js[0].mu[k], 0.1 * g_mag[k]),  # 1 - β1
                ("nu", ts[0].nu[k], js[0].nu[k], 0.0)):
            assert str(got.dtype).removeprefix("torch.") == np.asarray(want).dtype.name
            _ulps_within(got, want, scale, 3, f"{what} {k}")


def test_ce_block_with_dots_remat_matches_jax():
    (jp, jo, jtx, mesh), (tp, to, ttx) = _carried()
    jstep = jt.make_train_step(CFG_J, mesh, jtx, use_ring=False, remat="dots",
                               ce_block=8)
    tstep = train.make_train_step(CFG_T, ttx, remat="dots", ce_block=8)
    for tok in _batches(2, seq=21):  # T = 20: the last block of 8 pads 4
        jp, jo, jloss = jstep(jp, jo, jnp.asarray(tok))
        tp, to, tloss = tstep(tp, to, torch.from_numpy(tok))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _assert_state_close(jp, tp)


def _clone_state(state):
    params, opt = state
    adam = opt[0]
    return ({k: v.clone() for k, v in params.items()},
            (optim.ScaleByAdamState(adam.count.clone(),
                                    {k: v.clone() for k, v in adam.mu.items()},
                                    {k: v.clone() for k, v in adam.nu.items()}),
             *opt[1:]))


def _equal_states(a, b):
    (pa, oa), (pb, ob) = a, b
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert torch.equal(oa[0].count, ob[0].count)
    for k in pa:
        assert torch.equal(oa[0].mu[k], ob[0].mu[k])
        assert torch.equal(oa[0].nu[k], ob[0].nu[k])


def test_folded_equals_unfolded():
    params, opt, tx = train.make_train_state_host(0, CFG_T, lr=LR, device="cpu")
    tok = torch.from_numpy(_batches(1)[0])
    a = _clone_state((params, opt))
    b = _clone_state((params, opt))
    step = train.make_train_step(CFG_T, tx)
    for _ in range(3):
        *a, loss_a = step(*a, tok)
    *b, loss_b = train.make_train_step(CFG_T, tx, fold_steps=3)(*b, tok)
    assert torch.equal(loss_a, loss_b)
    _equal_states(a, b)
    assert int(a[1][0].count) == 3


def test_offload_opt_equals_plain():
    params, opt, tx = train.make_train_state_host(0, CFG_T, lr=LR, device="cpu")
    off_params, off_opt, _ = train.make_train_state_host(
        0, CFG_T, lr=LR, offload_opt=True, device="cpu")
    plain = train.make_train_step(CFG_T, tx)
    offload = train.make_train_step(CFG_T, tx, offload_opt=True, opt_state=off_opt)
    a, b = (params, opt), (off_params, off_opt)
    for tok in _batches(2):
        *a, loss_a = plain(*a, torch.from_numpy(tok))
        *b, loss_b = offload(*b, torch.from_numpy(tok))
        assert torch.equal(loss_a, loss_b)
    _equal_states(a, b)


def test_mismatched_offload_and_opt_state_raise():
    params, opt, tx = train.make_train_state_host(0, CFG_T, device="cpu")
    with pytest.raises(ValueError, match="offload_opt is False"):
        train.make_train_step(CFG_T, tx, opt_state=opt)
    with pytest.raises(ValueError, match="offload_opt needs opt_state"):
        train.make_train_step(CFG_T, tx, offload_opt=True)


def test_a_jax_trained_state_steps_on_in_the_port():
    """Two JAX steps, carried across, then one step in each package."""
    (jp, jo, jtx, mesh), _ = _carried()
    jstep = jt.make_train_step(CFG_J, mesh, jtx, use_ring=False)
    b0, b1, b2 = _batches()
    for tok in (b0, b1):
        jp, jo, _ = jstep(jp, jo, jnp.asarray(tok))
    tp = tl.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    to = optim.opt_state_from_jax(jax.tree.map(np.asarray, jo[0]), "cpu")
    assert int(to[0].count) == 2 and to[0].count.dtype == torch.int32
    jp, jo, jloss = jstep(jp, jo, jnp.asarray(b2))
    tp, to, tloss = train.make_train_step(CFG_T, optim.adamw(LR))(tp, to, torch.from_numpy(b2))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _assert_state_close(jp, tp, jo, to)


def test_evaluate_is_token_weighted_as_in_jax():
    params, _, _ = train.make_train_state_host(0, CFG_T, device="cpu")
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, CFG_T.vocab, (b, s), dtype=np.int32)
               for b, s in ((4, 32), (2, 9), (1, 5))]
    got = train.evaluate(params, (torch.from_numpy(b) for b in batches),
                         train.make_eval_step(CFG_T))
    want = jt.evaluate(jparams, (jnp.asarray(b) for b in batches),
                       jt.make_eval_step(CFG_J, jt.make_mesh(1), use_ring=False))
    assert got["batches"] == want["batches"] == 3
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=1e-5)
    per = [float(train.make_eval_step(CFG_T)(params, torch.from_numpy(b))) for b in batches]
    w = [b.shape[0] * (b.shape[1] - 1) for b in batches]
    assert got["loss"] == pytest.approx(np.dot(per, w) / sum(w), rel=1e-12)
    assert got["loss"] != pytest.approx(np.mean(per), rel=1e-6)
    with pytest.raises(ValueError, match="empty"):
        train.evaluate(params, [], train.make_eval_step(CFG_T))


def test_sample_batch_is_the_jax_draw():
    want = np.asarray(jt.sample_batch(np.random.default_rng(5), CFG_J, 3, 7))
    got = train.sample_batch(np.random.default_rng(5), CFG_T, 3, 7, device="cpu")
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_the_step_leaves_the_callers_tensors_plain():
    params, opt, tx = train.make_train_state_host(0, CFG_T, device="cpu")
    before = params["wq"].clone()
    params2, opt2, loss = train.make_train_step(CFG_T, tx)(
        params, opt, torch.from_numpy(_batches(1)[0]))
    assert params2 is params and opt2 is opt  # updated in place
    assert not params["wq"].requires_grad and not loss.requires_grad
    assert not torch.equal(params["wq"], before)


def test_chip_smoke_train_phase_rehearsal_on_the_cpu():
    """Phase 9 of chip_smoke.py at the tiny size on the CPU, in its own
    process as the script runs it: training on prefetched batches, the
    checkpoint round trips (REMOTE_HOST on two of the port's daemons), the
    resumed and offloaded steps bit for bit."""
    import os

    import chip_smoke

    r = chip_smoke.phase_train_isolated(CFG_T, 4, 32, device=torch.device("cpu"),
                                        steps=4, arena_bytes=64 << 20, timing=False,
                                        check_launches=False)
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ  # set for the child only
    assert len(r["losses"]) == 4 and r["losses"][-1] < r["losses"][0]
    assert set(r["checkpoint"]) >= {"LOCAL_DEVICE", "LOCAL_HOST", "REMOTE_HOST"}
    assert len(r["offload"]["plain_ms"]) == len(r["offload"]["offload_ms"]) == 2
    assert "mfu" not in r and r["train_flops"] > 0
