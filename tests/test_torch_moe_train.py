"""The port's MoE train steps held against the JAX package's: on one
device (the step on a mesh of one) and on (dp, ep, tp) meshes of 4 gloo
processes against ``make_moe_train_step`` on a mesh of the same shape over
4 virtual CPU devices, from the JAX package's initial weights (carried
across as numpy) and the same batches.

Tolerances, float32 on the tiny config, 3 steps at lr 3e-4: the loss
within rtol 1e-5, the parameters within rtol and atol 1e-4 (not 1e-5 as
the dense step: Adam divides each update by sqrt(ν), and an expert that
takes few tokens has gradients small enough that the sharded sums'
rounding order moves its update by up to ~1e-5 of a weight).

Routing is global under dp, as JAX's ``moe_ffn`` routes the global batch:
``dispatch`` of each process's rows, split over dp (and dp x sp), equals
JAX's ``route`` of the global router logits **exactly**, under capacity
overflow; so does ``combine``. Under the pipeline each dp shard's
microbatch routes alone, as in the JAX step: each stage's dispatch equals
JAX's route of the logits it routed, exactly, with the microbatch's own
capacity. MoE with ring attention over sp and experts over ep equals the
unsharded forward (``test_moe.py``'s, within 5e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as JP

from oncilla_tpu.models import moe as jmoe
from oncilla_tpu.models import train as jt
from oncilla_tpu_torch.models import llama as tl
from oncilla_tpu_torch.models import moe as tmoe
from oncilla_tpu_torch.models import train as tt
from oncilla_tpu_torch.parallel.launch import spawn

CFG = jmoe.MoeConfig.tiny()
LR = 3e-4


def _batches(n=3, batch=4, seq=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, (batch, seq)).astype(np.int32)
            for _ in range(n)]


B3 = _batches()


def _jmesh(shape, names=("dp", "ep", "tp")):
    return JMesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                 names)


def _jax_state(shape, cfg=CFG, pp=False):
    mesh = _jmesh(shape, ("dp", "pp") if pp else ("dp", "ep", "tp"))
    make = jt.make_moe_pp_train_state if pp else jt.make_moe_train_state
    p, o, tx = make(jax.random.key(2), cfg, mesh, lr=LR)
    return mesh, p, o, tx


def _np_params(p):
    return {k: np.asarray(v) for k, v in p.items()}


def _jax_losses(mesh, p, o, step, batches):
    losses = []
    for b in batches:
        p, o, loss = step(p, o, jax.device_put(b, NamedSharding(mesh, JP("dp", None))))
        losses.append(float(loss))
    return losses, p


RUNS = [
    dict(name="e212", shape=(2, 1, 2)),
    dict(name="e122", shape=(1, 2, 2)),
    dict(name="e221", shape=(2, 2, 1)),
    dict(name="remat", shape=(2, 2, 1), kw={"remat": True}),
    dict(name="ce", shape=(2, 2, 1), kw={"ce_block": 8}),
]


def _ring_case():
    params = jmoe.init_moe_params(jax.random.key(5), CFG)
    tokens = np.asarray(np.random.default_rng(1234).integers(0, CFG.vocab, (2, 32)),
                        np.int32)
    return params, tokens


def _pp_case():
    cfg = dataclasses.replace(CFG, capacity_factor=0.5)
    _, p, _, _ = _jax_state((2, 2), cfg, pp=True)
    return cfg, dict(name="pp", pp=True, shape=(2, 2), cfg=dataclasses.asdict(cfg),
                     lr=LR, params=_np_params(p), batches=B3[:1],
                     kw={"microbatches": 2})


@pytest.fixture(scope="module")
def world():
    """One gloo world of 4 for the whole file."""
    _, p, _, _ = _jax_state((1, 1, 1))
    runs = [dict(r, cfg=dataclasses.asdict(CFG), lr=LR, params=_np_params(p),
                 batches=B3) for r in RUNS]
    params, tokens = _ring_case()
    fwd = [dict(cfg=dataclasses.asdict(CFG), mesh={"ep": 2, "sp": 2},
                params=_np_params(params), tokens=tokens, seq_axis="sp",
                ep_axis="ep")]
    return spawn("_torch_dist:moe_all", 4, args=(runs, ROUTES, fwd, _pp_case()[1]),
                 device="cpu", timeout=240)


@pytest.fixture(scope="module")
def port(world):
    return world[0]["runs"]


def _held(got, losses, p):
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for k in p:
        np.testing.assert_allclose(got["params"][k], np.asarray(p[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", ["e212", "e122", "e221", "ce"])
def test_sharded_moe_step_matches_jax(port, name):
    r = next(r for r in RUNS if r["name"] == name)
    mesh, p, o, tx = _jax_state(r["shape"])
    kw = r.get("kw", {})
    step = jt.make_moe_train_step(CFG, mesh, tx, **kw)
    _held(port[name], *_jax_losses(mesh, p, o, step, B3))


def test_sharded_moe_remat_is_the_plain_step(port):
    """remat recomputes each block in the backward: the same step as the
    plain one on the same mesh (held to JAX above), bit for bit."""
    assert port["remat"]["losses"] == port["e221"]["losses"]
    for k, v in port["e221"]["params"].items():
        assert np.array_equal(port["remat"]["params"][k], v), k


def test_the_one_device_moe_step_is_the_step_on_a_mesh_of_one():
    mesh, p, o, tx = _jax_state((1, 1, 1))
    params = tl.params_from_jax(_np_params(p), "cpu")
    tp, to, ttx = tt.make_sharded_state(params, tt.moe_param_specs(CFG),
                                        tt.make_moe_mesh(1, device="cpu"), lr=LR)
    tstep = tt.make_moe_train_step(tmoe.MoeConfig.tiny(), ttx,
                                   mesh=tt.make_moe_mesh(1, device="cpu"))
    losses = []
    for b in B3:
        tp, to, loss = tstep(tp, to, torch.from_numpy(b))
        losses.append(float(loss))
    jl, jp = _jax_losses(mesh, p, o, jt.make_moe_train_step(CFG, mesh, tx), B3)
    _held({"losses": losses, "params": {k: v.numpy() for k, v in tp.items()}}, jl, jp)


ROUTE_CFG = dict(rows=4, seq=8, k=2, cap=5)


def _route_cases():
    logits = np.random.default_rng(3).standard_normal((4 * 8, 4)).astype(np.float32)
    # Skew every row toward expert 0, so its queue overflows the capacity.
    logits[:, 0] += 1.5
    base = dict(ROUTE_CFG, logits=logits)
    return [dict(base, name="dp", mesh={"dp": 2, "ep": 2}, axes=["dp"]),
            dict(base, name="dp_sp", mesh={"dp": 2, "sp": 2}, axes=["dp", "sp"],
                 seq_axis="sp")]


ROUTES = _route_cases()


@pytest.fixture(scope="module")
def routes(world):
    return [r["routes"] for r in world]


@pytest.mark.parametrize("i", range(len(ROUTES)), ids=[c["name"] for c in ROUTES])
def test_global_routing_under_dp_is_exact(routes, i):
    c = ROUTES[i]
    d, cm, aux = jmoe.route(jnp.asarray(c["logits"]), c["k"], c["cap"])
    d, cm = np.asarray(d), np.asarray(cm)
    # Overflow really happened: some (token, choice) got no slot.
    assert d.sum() < c["k"] * d.shape[0]
    td, tc, taux = tmoe.route(torch.from_numpy(c["logits"]), c["k"], c["cap"])
    for rank, got in enumerate(routes):
        np.testing.assert_array_equal(got[i]["dispatch"], d)
        np.testing.assert_array_equal(got[i]["combine"], tc.numpy())
        np.testing.assert_allclose(got[i]["combine"], cm, rtol=1e-6, atol=0)
        np.testing.assert_allclose(got[i]["aux"], float(aux), rtol=1e-6)


def test_moe_with_ring_attention_and_experts_matches_dense(world):
    """ep + sp in one program (``test_moe.py``): the MoE forward with the
    ring over sp and the experts over ep equals the unsharded forward."""
    params, tokens = _ring_case()
    want, want_aux = jmoe.forward(params, jnp.asarray(tokens), CFG)
    got = world[0]["forwards"][0]
    np.testing.assert_allclose(got["logits"], np.asarray(want), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(got["aux"], float(want_aux), rtol=1e-5)


def test_pipeline_routing_is_local_to_each_microbatch(world):
    cfg = _pp_case()[0]
    got = [r["pp"] for r in world]
    # Each dp shard (2 of 4 rows) routes 2 microbatches of 1 row x 32.
    local_cap = jmoe.capacity(cfg, 32)
    for r in got:
        assert r["seen"]
        for logits, d, c, cap in r["seen"]:
            assert cap == local_cap
            jd, jc, _ = jmoe.route(jnp.asarray(logits), cfg.top_k, cap)
            np.testing.assert_array_equal(d, np.asarray(jd))
            np.testing.assert_allclose(c, np.asarray(jc), rtol=1e-6, atol=0)
    assert any(np.asarray(d).sum() < cfg.top_k * d.shape[0]
               for r in got for _, d, _, _ in r["seen"])


def test_phase_9f_9g_on_the_cpu():
    """``chip_smoke.phase_train_sharded`` (phase 9 (f) and (g)) at a tiny
    size: the MoE step on a mesh of one over repeated batches (losses
    fall), the remat and ce_block steps against the plain step, the state
    through a LOCAL_DEVICE checkpoint bit for bit (no kernel on the CPU),
    and the dense step on ``make_mesh(1)`` bit for bit."""
    import chip_smoke

    cfg = dataclasses.replace(tmoe.MoeConfig.tiny(), n_layers=2)
    r = chip_smoke.phase_train_sharded(
        torch.device("cpu"), moe_cfg=cfg, moe_batch=(2, 64),
        dense=(tl.LlamaConfig.tiny(), 2, 32), timing=False, check_launches=False)
    f = r["moe_train"]
    assert f["losses"][-1] < f["losses"][0] and f["mfu"] is None
    assert f["trades"]["remat"]["update_rel"] <= 0.2
    assert f["checkpoint"]["state_bytes"] > 0
    assert r["mesh_of_one"]["bit_for_bit"]
