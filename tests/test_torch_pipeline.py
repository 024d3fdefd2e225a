"""The port's GPipe executor (``parallel/pipeline.py``) and pipeline train
steps held against the JAX package's (``tests/test_pipeline.py`` whole),
in 4 gloo processes on (dp, pp) meshes of (2, 2) and (1, 4), the JAX side
on meshes of the same shapes over 4 virtual CPU devices.

- The toy stage (x -> 2x + w a layer): outputs equal the sequential stack
  within rtol 1e-6, gradients within rtol 1e-5, for every (pp, microbatch)
  combination that fits.
- The dense and MoE layer stacks through the pipeline equal the plain
  forwards (float32: 1e-5 dense, 2e-4 MoE, as the JAX tests hold them).
- The GPipe steps (dense; MoE, whose router aux crosses the pipeline),
  plain, with stage ``remat`` and with ``ce_block``, 3 steps at lr 3e-4:
  loss within rtol 1e-5 and params within 1e-4 of the JAX pipeline step's
  (the dense (1, 4) run against JAX's plain dense step: a pipeline step is
  the dense step). Remat and the blocked CE are held to JAX's plain run:
  they must not change the math.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as JP

from oncilla_tpu.models import llama as jl
from oncilla_tpu.models import moe as jmoe
from oncilla_tpu.models import train as jt
from oncilla_tpu_torch.parallel.launch import spawn

CFG4 = dataclasses.replace(jl.LlamaConfig.tiny(), n_layers=4)
MOE = jmoe.MoeConfig.tiny()
MOE_AMPLE = dataclasses.replace(MOE, capacity_factor=64.0)
LR = 3e-4

_rng = np.random.default_rng(1234)
W = _rng.standard_normal((4, 16)).astype(np.float32)
X = _rng.standard_normal((8, 16)).astype(np.float32)
COMBOS = [(pp, mb) for pp in (2, 4) for mb in (1, 2, 4) if (8 // (4 // pp)) % mb == 0]
TOKENS = _rng.integers(0, CFG4.vocab, (4, 16)).astype(np.int32)
BATCHES = [_rng.integers(0, CFG4.vocab, (8, 32)).astype(np.int32) for _ in range(3)]


def _np(p):
    return {k: np.asarray(v) for k, v in p.items()}


def _jmesh(shape):
    return JMesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                 ("dp", "pp"))


DENSE_P = jl.init_params(jax.random.key(1), CFG4)
MOE_P = jmoe.init_moe_params(jax.random.key(21), MOE)
FWD = [
    dict(cfg=dataclasses.asdict(CFG4), shape=(1, 4), mb=2, tokens=TOKENS,
         params=_np(jl.init_params(jax.random.key(0), CFG4))),
    dict(cfg=dataclasses.asdict(MOE_AMPLE), shape=(2, 2), mb=2, tokens=TOKENS,
         moe=True, params=_np(jmoe.init_moe_params(jax.random.key(20), MOE_AMPLE))),
]
RUNS = [
    dict(name="d22", shape=(2, 2), cfg=CFG4),
    dict(name="d14", shape=(1, 4), cfg=CFG4),
    dict(name="d22_remat", shape=(2, 2), cfg=CFG4, kw={"remat": True}),
    dict(name="d22_ce", shape=(2, 2), cfg=CFG4, kw={"ce_block": 8}),
    dict(name="m22", shape=(2, 2), cfg=MOE, moe=True),
    dict(name="m22_remat", shape=(2, 2), cfg=MOE, moe=True, kw={"remat": True}),
    dict(name="m22_ce", shape=(2, 2), cfg=MOE, moe=True, kw={"ce_block": 8}),
]


@pytest.fixture(scope="module")
def port():
    runs = [dict(r, cfg=dataclasses.asdict(r["cfg"]), lr=LR, batches=BATCHES,
                 params=_np(MOE_P if r.get("moe") else DENSE_P),
                 kw=dict(r.get("kw", {}), microbatches=2)) for r in RUNS]
    return spawn("_torch_dist:pipeline_all", 4, args=(W, X, COMBOS, FWD, runs),
                 device="cpu", timeout=240)[0]


def _seq(w, x):
    out, _ = jax.lax.scan(lambda c, wi: (2.0 * c + wi, None), x, w)
    return out


@pytest.mark.parametrize("i", range(len(COMBOS)),
                         ids=[f"pp{pp}-mb{mb}" for pp, mb in COMBOS])
def test_pipeline_matches_sequential_toy(port, i):
    got = port["toy"][i]
    np.testing.assert_allclose(got["y"], np.asarray(_seq(W, X)), rtol=1e-6)
    gw, gx = jax.grad(lambda w, x: jnp.sum(_seq(w, x) ** 2), argnums=(0, 1))(W, X)
    np.testing.assert_allclose(got["gw"], np.asarray(gw), rtol=1e-5)
    np.testing.assert_allclose(got["gx"], np.asarray(gx), rtol=1e-5)


def test_pipeline_llama_forward_matches_dense(port):
    c = FWD[0]
    params = {k: jnp.asarray(v) for k, v in c["params"].items()}
    want = jl.forward(params, jnp.asarray(TOKENS), CFG4)
    np.testing.assert_allclose(port["forward"][0]["logits"], np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_moe_pipeline_forward_matches_plain(port):
    c = FWD[1]
    params = {k: jnp.asarray(v) for k, v in c["params"].items()}
    want, _ = jmoe.forward(params, jnp.asarray(TOKENS), MOE_AMPLE)
    got = port["forward"][1]
    # aux: one O(1) term per (layer, microbatch) against plain's per layer.
    assert got["aux"] >= MOE.n_layers * 2 * (1.0 - 1e-4)
    np.testing.assert_allclose(got["logits"], np.asarray(want), atol=2e-4, rtol=2e-4)


_JAX = {}


def _jax_pp(name, shape, moe):
    if name not in _JAX:
        mesh = _jmesh(shape)
        cfg = MOE if moe else CFG4
        make = jt.make_moe_pp_train_state if moe else jt.make_pp_train_state
        p, o, tx = make(jax.random.key(21 if moe else 1), cfg, mesh, lr=LR)
        step = (jt.make_moe_pp_train_step if moe else jt.make_pp_train_step)(
            cfg, mesh, tx, microbatches=2)
        losses = []
        for b in BATCHES:
            p, o, loss = step(p, o, jax.device_put(b, NamedSharding(mesh, JP("dp", None))))
            losses.append(float(loss))
        _JAX[name] = (losses, _np(p))
    return _JAX[name]


def _held(got, want):
    losses, p = want
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for k in p:
        np.testing.assert_allclose(got["params"][k], p[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["d22", "d22_remat", "d22_ce"])
def test_pp_train_step_matches_jax(port, name):
    _held(port["runs"][name], _jax_pp("d22", (2, 2), False))
    assert port["runs"][name]["losses"][-1] < port["runs"][name]["losses"][0]


@pytest.mark.parametrize("name", ["m22", "m22_remat", "m22_ce"])
def test_moe_pp_train_step_matches_jax(port, name):
    _held(port["runs"][name], _jax_pp("m22", (2, 2), True))


def test_pp_train_matches_dense_train(port):
    """The (1, 4) GPipe steps against the JAX package's plain dense step
    from the same weights: a pipeline step is the dense step."""
    mesh = jt.make_mesh(1)
    p, o, tx = jt._sharded_state(jl.init_params(jax.random.key(1), CFG4),
                                 jt.param_specs(CFG4), mesh, LR)
    step = jt.make_train_step(CFG4, mesh, tx, use_ring=False)
    losses = []
    for b in BATCHES:
        p, o, loss = step(p, o, jnp.asarray(b))
        losses.append(float(loss))
    _held(port["runs"]["d14"], (losses, _np(p)))
