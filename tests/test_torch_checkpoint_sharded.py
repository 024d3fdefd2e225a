"""``models/checkpoint.save_sharded`` and ``load_sharded`` (the JAX
``load_sharded`` and ``test_checkpoint.py``'s resume and async tests) in 4
gloo processes.

A sharded dense train state on a (2, 2, 1) mesh is saved whole into one
LOCAL_HOST region on process 0 (each leaf gathered in turn, one put) and
restored with ``load_sharded`` (process 0 reads, the others receive each
leaf) on the same mesh and on two others: every restored shard equals the
saved state's slice bit for bit, the resumed run on the same mesh repeats
the live run's loss bit for bit, and on another mesh within rtol 1e-5 (the
sharded sums round in another order). ``save_async`` of each process's
shards snapshots them at the call while training goes on. The region is
the one ``save`` makes of the gathered tree, so the JAX package reads it.
"""

import numpy as np
import pytest
import torch

from oncilla_tpu.models import train as jt
from oncilla_tpu.models.llama import LlamaConfig
from oncilla_tpu_torch.parallel.launch import spawn

CFG = LlamaConfig.tiny()
SHAPES = [(2, 2, 1), (1, 2, 2), (2, 1, 2)]


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [np.array(jt.sample_batch(rng, CFG, 4, 32)) for _ in range(n)]


@pytest.fixture(scope="module")
def world():
    return spawn("_torch_dist:checkpoints", 4,
                 args=(_batches(4, 0), SHAPES, _batches(3, 1)), device="cpu",
                 timeout=180)


@pytest.fixture(scope="module")
def resumed(world):
    return [r["resume"] for r in world]


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_load_sharded_restores_every_shard_bit_for_bit(resumed, shape):
    for r in resumed:
        assert r["resumed"][str(shape)]["exact"]


def test_resume_on_the_same_mesh_repeats_the_live_run(resumed):
    for r in resumed:
        got = r["resumed"][str(SHAPES[0])]
        assert got["loss"] == r["live_loss"]
        assert got["count"] == 4


@pytest.mark.parametrize("shape", SHAPES[1:], ids=[str(s) for s in SHAPES[1:]])
def test_resume_on_another_mesh(resumed, shape):
    for r in resumed:
        got = r["resumed"][str(shape)]
        np.testing.assert_allclose(got["loss"], r["live_loss"], rtol=1e-5)
        assert got["count"] == 4


def test_save_async_of_shards_during_training(world):
    for r in world:
        assert r["async"]["snapshot"] and r["async"]["moved"]


def test_the_jax_package_reads_a_gathered_sharded_state():
    """``save_sharded``'s region is ``save``'s of the gathered tree: the
    JAX package's ``load`` restores it (a world of one process here)."""
    import oncilla_tpu as jocm
    from oncilla_tpu.models import checkpoint as jck

    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch.models import checkpoint as ck
    from oncilla_tpu_torch.models import train as tt

    mesh = tt.make_mesh(1, device="cpu")
    p, o, _ = tt.make_train_state_host(0, tt.llama.LlamaConfig.tiny(), mesh=mesh)
    state = {"params": p, "opt": o}
    shardings = tt.state_shardings(mesh, tt.param_specs(CFG))
    with ocm.ocm_init(ocm.OcmConfig(host_arena_bytes=16 << 20,
                                    device_arena_bytes=1 << 20), device="cpu") as ctx:
        h = ck.save_sharded(ctx, state, shardings, ocm.OcmKind.LOCAL_HOST)
        region = ctx.get(h, nbytes=h.nbytes).numpy().tobytes()
        assert region == ck._pack(state).numpy().tobytes()
        back = ck.load_sharded(ctx, h, ck.full_like(state, shardings), shardings)
        assert all(torch.equal(back["params"][k], p[k]) for k in p)
        wrong = ck.full_like({"params": {"wq": p["ln_out"]}}, {"params": {
            "wq": shardings["params"]["wq"]}})
        with pytest.raises(ValueError, match="mismatch"):
            ck.load_sharded(ctx, h, wrong, {"params": {"wq": shardings["params"]["wq"]}})
        ctx.free(h)
    jctx = jocm.ocm_init(jocm.OcmConfig(host_arena_bytes=16 << 20,
                                        device_arena_bytes=1 << 20))
    try:
        jh = jctx.alloc(len(region), jocm.OcmKind.LOCAL_HOST)
        jctx.put(jh, np.frombuffer(region, np.uint8))
        leaves = jck.load(jctx, jh)
        np.testing.assert_array_equal(np.asarray(leaves["['params']/['wq']"]),
                                      p["wq"].numpy())
        jctx.free(jh)
    finally:
        jctx.tini()
