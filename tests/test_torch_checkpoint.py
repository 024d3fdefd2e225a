"""The port's checkpoint (``oncilla_tpu_torch.models.checkpoint``) held
against the JAX package's on the CPU.

- The region the port writes is the JAX package's region byte for byte
  (read both back with ``get``), then zeros up to the copy kernels' 4096 B
  row; each package loads the other's.
- Every case of ``tests/test_checkpoint.py``: mixed dtypes, the device
  arena, no ``like``, not a checkpoint, a shape mismatch, resuming
  training, ``save_async`` during training, the fuzz; and REMOTE_HOST on
  two of the port's own native daemons.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oncilla_tpu as jocm
import oncilla_tpu_torch as tocm
from oncilla_tpu.models import checkpoint as jck
from oncilla_tpu.models import llama as jl
from oncilla_tpu_torch.models import checkpoint as ck
from oncilla_tpu_torch.models import llama as tl
from oncilla_tpu_torch.models import train

T = tocm.OcmKind
CFG = tl.LlamaConfig.tiny()


@pytest.fixture
def ctx():
    c = tocm.ocm_init(tocm.OcmConfig(host_arena_bytes=64 << 20,
                                     device_arena_bytes=64 << 20), device="cpu")
    yield c
    c.tini()


@pytest.fixture
def jctx():
    c = jocm.ocm_init(jocm.OcmConfig(host_arena_bytes=64 << 20,
                                     device_arena_bytes=64 << 20))
    yield c
    c.tini()


def _mixed(rng):
    """The same nested mixed-dtype tree in both packages."""
    a = rng.standard_normal((8, 16)).astype(np.float32)
    b = rng.standard_normal((4, 4)).astype(np.float32)
    ids = rng.integers(-100, 100, (3, 5)).astype(np.int8)
    jtree = {"a": jnp.asarray(a), "b": jnp.asarray(b, jnp.bfloat16),
             "nested": {"count": jnp.int32(7), "scale": jnp.float32(0.5)},
             "seq": [jnp.asarray(ids), jnp.zeros((2,), jnp.uint8)]}
    ttree = {"a": torch.from_numpy(a), "b": torch.from_numpy(b).to(torch.bfloat16),
             "nested": {"count": torch.tensor(7, dtype=torch.int32),
                        "scale": torch.tensor(0.5)},
             "seq": [torch.from_numpy(ids), torch.zeros(2, dtype=torch.uint8)]}
    return jtree, ttree


def _trees(name, rng):
    if name == "params":
        jp = jl.init_params_host(0, jl.LlamaConfig.tiny())
        return jp, tl.init_params_host(0, CFG, device="cpu")
    return _mixed(rng)


@pytest.mark.parametrize("kind", ["LOCAL_HOST", "LOCAL_DEVICE"])
@pytest.mark.parametrize("name", ["params", "mixed"])
def test_region_is_the_jax_region_byte_for_byte(ctx, jctx, rng, name, kind):
    jtree, ttree = _trees(name, rng)
    jh = jck.save(jctx, jtree, getattr(jocm.OcmKind, kind))
    th = ck.save(ctx, ttree, getattr(T, kind))
    want = np.asarray(jctx.get(jh))
    got = ctx.get(th).numpy()
    assert len(want) == jck.checkpoint_nbytes(jtree)
    assert len(got) == th.nbytes == ck.checkpoint_nbytes(ttree) == -(-len(want) // 4096) * 4096
    assert got[:len(want)].tobytes() == want.tobytes()
    assert not got[len(want):].any()


def test_each_package_loads_the_others_region(ctx, jctx, rng):
    jtree, ttree = _mixed(rng)
    # The JAX package's region, in a port allocation of its exact size.
    jreg = np.asarray(jctx.get(jck.save(jctx, jtree)))
    h = ctx.alloc(len(jreg), T.LOCAL_DEVICE)
    ctx.put(h, jreg)
    back = ck.load(ctx, h, like=ttree)
    for key in ("a", "b"):
        assert back[key].dtype == ttree[key].dtype
        assert torch.equal(back[key], ttree[key])
    assert int(back["nested"]["count"]) == 7 and back["seq"][0].dtype == torch.int8
    assert torch.equal(back["seq"][0], ttree["seq"][0])
    # The port's region, read by the JAX package.
    treg = ctx.get(ck.save(ctx, ttree)).numpy()
    jh = jctx.alloc(len(treg), jocm.OcmKind.LOCAL_HOST)
    jctx.put(jh, treg, 0)
    jback = jck.load(jctx, jh, like=jtree)
    for key in ("a", "b"):
        np.testing.assert_array_equal(jback[key], np.asarray(jtree[key]))
    assert int(jback["nested"]["count"]) == 7
    np.testing.assert_array_equal(jback["seq"][0], np.asarray(jtree["seq"][0]))


def test_a_jax_train_state_loads_into_the_port_state():
    """Same key paths for a whole train state: the optax state's structure
    is the port's."""
    from oncilla_tpu.models import train as jt

    jp, jo, _ = jt.make_train_state_host(0, jl.LlamaConfig.tiny(), jt.make_mesh(1))
    tp, to, _ = train.make_train_state_host(0, CFG, device="cpu")
    jkeys = [k for k, _ in jck._flatten({"params": jp, "opt": jo})[0]]
    tkeys = [k for k, _ in ck._flatten({"params": tp, "opt": to})]
    assert tkeys == jkeys and "['opt']/[0]/.mu/['embed']" in tkeys


def test_roundtrip_mixed_dtypes(ctx, rng):
    _, tree = _mixed(rng)
    h = ck.save(ctx, tree, T.LOCAL_HOST)
    assert h.nbytes == ck.checkpoint_nbytes(tree)
    back = ck.load(ctx, h, like=tree)
    for k in ("a", "b"):
        assert back[k].dtype == tree[k].dtype and torch.equal(back[k], tree[k])
    assert int(back["nested"]["count"]) == 7
    ctx.free(h)


def test_roundtrip_device_arena(ctx, rng):
    tree = {"w": torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32))}
    h = ck.save(ctx, tree, T.LOCAL_DEVICE)
    back = ck.load(ctx, h, like=tree, device="cpu")
    assert torch.equal(back["w"], tree["w"])
    ctx.free(h)


def test_load_without_like_returns_keyed_leaves(ctx):
    h = ck.save(ctx, {"x": torch.arange(10, dtype=torch.int32)})
    leaves = ck.load(ctx, h)
    assert list(leaves) == ["['x']"]
    assert torch.equal(leaves["['x']"], torch.arange(10, dtype=torch.int32))
    ctx.free(h)


def test_not_a_checkpoint_raises(ctx):
    h = ctx.alloc(1 << 10, T.LOCAL_HOST)
    ctx.put(h, np.zeros(1 << 10, np.uint8), 0)
    with pytest.raises(ValueError, match="not an OCM checkpoint"):
        ck.load(ctx, h)
    ctx.free(h)


def test_shape_mismatch_raises(ctx):
    h = ck.save(ctx, {"w": torch.zeros((4, 4))})
    with pytest.raises(ValueError, match="mismatch"):
        ck.load(ctx, h, like={"w": torch.zeros((8, 8))})
    with pytest.raises(ValueError, match="mismatch"):
        ck.load(ctx, h, like={"w": torch.zeros((4, 4), dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="missing leaf"):
        ck.load(ctx, h, like={"v": torch.zeros((4, 4))})
    ctx.free(h)


def test_legacy_v1_header_loads(ctx, rng):
    """OCMCKPT1: no data_start in the header; it is recomputed."""
    x = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32))
    manifest = json.dumps({"leaves": [{"key": "['x']", "shape": [5, 3], "dtype": "float32",
                                       "offset": 0, "nbytes": 60}]}, sort_keys=True).encode()
    data_start = -(-(8 + 8 + len(manifest)) // 128) * 128
    region = bytearray(data_start + 60)
    region[:16 + len(manifest)] = b"OCMCKPT1" + len(manifest).to_bytes(8, "little") + manifest
    region[data_start:] = x.numpy().tobytes()
    h = ctx.alloc(len(region), T.LOCAL_HOST)
    ctx.put(h, bytes(region))
    assert torch.equal(ck.load(ctx, h)["['x']"], x)


def _state_copy(params, opt):
    return ck._rebuild({"params": params, "opt": opt}, lambda k, t: t.clone())


def test_train_resume_equivalence(ctx):
    """Save a train state after 2 steps, take 2 more; restore it and take
    the same 2: the same loss and state, bit for bit."""
    params, opt, tx = train.make_train_state_host(0, CFG, lr=1e-2, device="cpu")
    step = train.make_train_step(CFG, tx)
    tokens = train.sample_batch(np.random.default_rng(0), CFG, 4, 32, device="cpu")
    for _ in range(2):
        params, opt, loss = step(params, opt, tokens)
    state = {"params": params, "opt": opt}
    h = ck.save(ctx, state, T.LOCAL_HOST)
    like = _state_copy(params, opt)
    for _ in range(2):
        params, opt, loss = step(params, opt, tokens)
    restored = ck.load(ctx, h, like=like)
    p2, o2 = restored["params"], restored["opt"]
    assert type(o2[0]).__name__ == "ScaleByAdamState" and int(o2[0].count) == 2
    for _ in range(2):
        p2, o2, loss2 = step(p2, o2, tokens)
    assert torch.equal(loss2, loss)
    assert all(torch.equal(p2[k], params[k]) for k in params)
    ctx.free(h)


def test_save_async_during_training(ctx):
    """save_async snapshots the state when called; the in-place steps taken
    while it ships do not reach the checkpoint."""
    params, opt, tx = train.make_train_state_host(40, CFG, lr=1e-2, device="cpu")
    step = train.make_train_step(CFG, tx)
    tokens = train.sample_batch(np.random.default_rng(1), CFG, 4, 32, device="cpu")
    snap_wq = params["wq"].clone()
    like = {k: v.clone() for k, v in params.items()}
    fut = ck.save_async(ctx, params, T.LOCAL_HOST)
    for _ in range(3):
        params, opt, loss = step(params, opt, tokens)
    h = fut.result(timeout=120)
    back = ck.load(ctx, h, like=like)
    assert torch.equal(back["wq"], snap_wq)
    assert not torch.equal(params["wq"], snap_wq)
    ctx.free(h)


def test_checkpoint_roundtrip_fuzz(ctx, rng):
    """Random trees of random shapes and dtypes round-trip bit for bit, and
    the region is the JAX package's layout."""
    dtypes = [np.float32, np.int32, np.uint8, np.float64, np.int8]
    for trial in range(10):
        tree = {}
        for i in range(int(rng.integers(1, 6))):
            shape = tuple(int(rng.integers(1, 9)) for _ in range(int(rng.integers(0, 4))))
            dt = dtypes[int(rng.integers(0, len(dtypes)))]
            if np.issubdtype(dt, np.floating):
                leaf = rng.standard_normal(shape).astype(dt)
            else:
                leaf = rng.integers(-100, 100, shape).astype(dt)
            tree[f"leaf{i}"] = leaf
        h = ck.save(ctx, tree, T.LOCAL_HOST)
        want = jck._layout(jck._flatten(tree)[0])
        assert ck._layout(ck._flatten(tree)) == want, trial
        back = ck.load(ctx, h, like=tree)
        for k, leaf in tree.items():
            got = back[k].numpy()
            assert got.dtype == leaf.dtype and got.shape == leaf.shape, (trial, k)
            np.testing.assert_array_equal(got, leaf, err_msg=f"{trial}/{k}")
        ctx.free(h)


def test_checkpoint_to_remote_host_on_the_ports_daemons(rng):
    """A checkpoint in a remote node's DRAM through two of the port's own
    native daemons (placement on rank 1, chunked wire puts and gets)."""
    from oncilla_tpu_torch.runtime.cluster import local_cluster

    cfg = tocm.OcmConfig(host_arena_bytes=8 << 20, device_arena_bytes=1 << 20,
                         chunk_bytes=64 << 10, heartbeat_s=0.2, lease_s=30.0,
                         dcn_stripe_min_bytes=256 << 10)
    tree = {
        "w": torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32))
        .to(torch.bfloat16),
        "opt": {"mu": torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32)),
                "count": torch.tensor(11, dtype=torch.int32)},
    }
    with local_cluster(2, host_arena_bytes=(1 << 20, 8 << 20), config=cfg) as cl:
        c = cl.context(0, device="cpu")
        h = ck.save(c, tree, T.REMOTE_HOST)
        assert h.is_remote and h.rank == 1
        back = ck.load(c, h, like=tree)
        assert torch.equal(back["w"], tree["w"])
        assert torch.equal(back["opt"]["mu"], tree["opt"]["mu"])
        assert int(back["opt"]["count"]) == 11
        c.free(h)
        assert cl.status(1)["live_allocs"] == 0
