"""The port's sharded dense step on (dp, tp, sp) meshes of 4 gloo
processes held against the JAX package's ``make_train_step`` on a mesh of
the same shape over 4 of its virtual CPU devices, from the same numpy
weights (``make_train_state_host(0)``) and batches.

Tolerances, float32 on the tiny config, 3 steps at lr 3e-4 (as
``test_torch_train.py`` holds the one-device step): the loss within rtol
1e-5 and every parameter within atol 1e-5; Adam's µ within 1e-4 of its
leaf's largest |µ|, and with µ in bf16 within one bf16 step (2^-7 of it)
a step taken. The sharded sums (the tp row-split products, the sp and dp
gradient reductions, the vocab-parallel softmax) round in another order
than XLA's, which these bounds hold.

``offload_opt`` is held against the port's own plain sharded step (the
JAX package's offload cannot run on the CPU), bit for bit, as are
``fold_steps`` against the same steps unfolded and ``prefetch_to_mesh``'s
batches against the same batches cut by ``shard_batch``; a mesh of one
against the one-device step, bit for bit. One test runs 8 processes, the
(2, 2, 2) meshes the JAX tests use, dense and MoE.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as JP

from oncilla_tpu.models import moe as jmoe
from oncilla_tpu.models import train as jt
from oncilla_tpu.models.llama import LlamaConfig
from oncilla_tpu_torch.parallel.launch import spawn

CFG = LlamaConfig.tiny()
LR = 3e-4


def _batches(n=3, batch=4, seq=32, seed=0):
    rng = np.random.default_rng(seed)
    return [np.array(jt.sample_batch(rng, CFG, batch, seq)) for _ in range(n)]


B3 = _batches()
B2 = _batches(2, seed=1)
RUNS = [
    dict(name="p212", shape=(2, 1, 2), batches=B3),
    dict(name="p122", shape=(1, 2, 2), batches=B3, eval=_batches(2, 2, 32, 5)),
    dict(name="p221", shape=(2, 2, 1), batches=B3),
    dict(name="remat", shape=(1, 2, 2), batches=B3, kw={"remat": True}),
    dict(name="dots_ce", shape=(2, 1, 2), batches=_batches(2, seq=22),
         kw={"remat": "dots", "ce_block": 8}),
    dict(name="mu_bf16", shape=(2, 2, 1), batches=B3, kw={"mu_dtype": "bfloat16"}),
    dict(name="gathered", shape=(1, 2, 2), batches=B3, kw={"use_ring": False}),
    dict(name="offload", shape=(2, 2, 1), batches=B3, kw={"offload_opt": True}),
    dict(name="prefetch", shape=(2, 2, 1), batches=B3, prefetch=True),
    dict(name="fold", shape=(2, 1, 2), batches=B2, kw={"fold_steps": 2}),
    dict(name="unfold", shape=(2, 1, 2), batches=[B2[0], B2[0], B2[1], B2[1]]),
    dict(name="overfit", shape=(1, 2, 2), batches=B3[:1] * 8),
]


@pytest.fixture(scope="module")
def port():
    return spawn("_torch_dist:dense_runs", 4, args=(RUNS,), device="cpu",
                 timeout=240)[0]


def _jmesh(shape, names=("dp", "tp", "sp")):
    return JMesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                 names)


_RUNS_DONE = {}


def _jax_run(shape, batches, mu_dtype=None, **kw):
    key = (shape, id(batches), mu_dtype, tuple(sorted(kw.items())))
    if key not in _RUNS_DONE:
        _RUNS_DONE[key] = _jax_run_once(shape, batches, mu_dtype, **kw)
    return _RUNS_DONE[key]


def _jax_run_once(shape, batches, mu_dtype=None, **kw):
    mesh = _jmesh(shape)
    p, o, tx = jt.make_train_state_host(0, CFG, mesh, lr=LR, mu_dtype=mu_dtype)
    step = jt.make_train_step(CFG, mesh, tx, **kw)
    losses = []
    for b in batches:
        p, o, loss = step(p, o, jax.device_put(b, NamedSharding(mesh, jt.data_spec())))
        losses.append(float(loss))
    return losses, p, o, (mesh, step)


def _close(port_run, jax_run, mu_tol=1e-4):
    losses, p, o, _ = jax_run
    np.testing.assert_allclose(port_run["losses"], losses, rtol=1e-5)
    for k in p:
        np.testing.assert_allclose(port_run["params"][k], np.asarray(p[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
        want = np.asarray(o[0].mu[k]).astype(np.float32)
        err = np.abs(port_run["mu"][k] - want).max()
        assert err <= mu_tol * np.abs(want).max(), (k, err)
    assert port_run["count"] == int(o[0].count)


@pytest.mark.parametrize("name", ["p212", "p122", "p221"])
def test_sharded_step_matches_jax(port, name):
    r = next(r for r in RUNS if r["name"] == name)
    _close(port[name], _jax_run(r["shape"], r["batches"]))


@pytest.mark.parametrize("name,kw", [
    ("dots_ce", {"remat": "dots", "ce_block": 8}),
    ("gathered", {"use_ring": False}),
])
def test_memory_trades_and_attention_layouts_match_jax(port, name, kw):
    r = next(r for r in RUNS if r["name"] == name)
    _close(port[name], _jax_run(r["shape"], r["batches"], **kw))


def test_remat_is_the_plain_sharded_step(port):
    """remat recomputes each block in the backward, collectives included:
    the same step as the plain one (held to JAX above), bit for bit."""
    _same(port["remat"], port["p122"])


def test_mu_dtype_matches_jax(port):
    r = next(r for r in RUNS if r["name"] == "mu_bf16")
    _close(port["mu_bf16"], _jax_run(r["shape"], r["batches"], mu_dtype=jnp.bfloat16),
           mu_tol=3 * 2.0 ** -7)


def test_sharded_train_step_loss_decreases(port):
    """``test_model.py``'s: overfitting one batch for 8 steps at lr 3e-4
    must reduce the loss materially."""
    losses = port["overfit"]["losses"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.1, losses


def _same(a, b):
    assert a["losses"] == b["losses"]
    for k in a["params"]:
        assert np.array_equal(a["params"][k], b["params"][k]), k
        assert np.array_equal(a["mu"][k], b["mu"][k]), k


def test_offload_opt_equals_the_plain_sharded_step(port):
    _same(port["offload"], port["p221"])


def test_prefetch_to_mesh_feeds_the_sharded_step(port):
    _same(port["prefetch"], port["p221"])


def test_folded_equals_unfolded(port):
    fold, unfold = port["fold"], port["unfold"]
    assert fold["losses"] == unfold["losses"][1::2]
    for k in fold["params"]:
        assert np.array_equal(fold["params"][k], unfold["params"][k]), k
    assert fold["count"] == unfold["count"] == 4


def test_evaluate_matches_jax(port):
    r = next(r for r in RUNS if r["name"] == "p122")
    _, p, _, (mesh, _) = _jax_run(r["shape"], r["batches"])
    ev = jt.make_eval_step(CFG, mesh)
    want = jt.evaluate(p, [jax.device_put(b, NamedSharding(mesh, jt.data_spec()))
                           for b in r["eval"]], ev)
    got = port["p122"]["eval"]
    assert got["batches"] == want["batches"] == 2
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=1e-5)


def test_a_mesh_of_one_adds_nothing():
    """A mesh of one needs no process group: its step is the one-device
    step, bit for bit."""
    import _torch_dist

    assert _torch_dist.one_card_equivalence(B2)


MOE = jmoe.MoeConfig.tiny()


def _moe_case():
    mesh = _jmesh((2, 2, 2), ("dp", "ep", "tp"))
    p, o, tx = jt.make_moe_train_state(jax.random.key(2), MOE, mesh, lr=LR)
    return mesh, p, o, tx


def test_eight_processes_on_the_jax_tests_meshes():
    """make_mesh(8) = (2, 2, 2) and make_moe_mesh(8) = (2, 2, 2): 2 steps
    of each family against the JAX package's on its 8 devices."""
    batches = _batches(2)
    moe_batches = [np.asarray(np.random.default_rng(i).integers(
        0, MOE.vocab, (4, 32)), np.int32) for i in range(2)]
    mesh, p, o, tx = _moe_case()
    moe_run = dict(name="moe", shape=(2, 2, 2), cfg=dataclasses.asdict(MOE), lr=LR,
                   params={k: np.asarray(v) for k, v in p.items()},
                   batches=moe_batches)
    got = spawn("_torch_dist:eight", 8, args=(
        [dict(name="dense", shape=(2, 2, 2), batches=batches)], [moe_run]),
        device="cpu", timeout=240)[0]
    _close(got["dense"], _jax_run((2, 2, 2), batches))
    step = jt.make_moe_train_step(MOE, mesh, tx)
    losses = []
    for b in moe_batches:
        p, o, loss = step(p, o, jax.device_put(b, NamedSharding(mesh, JP("dp", None))))
        losses.append(float(loss))
    np.testing.assert_allclose(got["moe"]["losses"], losses, rtol=1e-5)
    for k in p:
        np.testing.assert_allclose(got["moe"]["params"][k], np.asarray(p[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
