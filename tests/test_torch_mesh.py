"""The port's training meshes held against the JAX package's.

``make_mesh``, ``make_moe_mesh`` and ``make_pp_mesh`` factor 1, 2, 4 and
8 processes as the JAX functions factor as many devices (the ports of
``test_model.py::test_mesh_factoring`` and the ep and pp factorings of
``test_moe.py`` and ``test_pipeline.py``); a mesh made without a process
group is its layout. In 4 gloo processes each mesh lays its ranks out
row-major over its axes, as ``np.reshape`` lays the JAX devices, and
``shard``/``gather`` take and rebuild each process's slice of a leaf as
the JAX ``NamedSharding`` places it (exactly: no arithmetic).
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding as JNamed
from jax.sharding import PartitionSpec as JP

from oncilla_tpu.models import train as jt
from oncilla_tpu.parallel import mesh as jmesh
from oncilla_tpu_torch.models import train as tt
from oncilla_tpu_torch.parallel import mesh as tmesh
from oncilla_tpu_torch.parallel.launch import spawn

SHAPES = [{"dp": 2, "tp": 1, "sp": 2}, {"dp": 1, "tp": 2, "sp": 2},
          {"dp": 2, "tp": 2, "sp": 1}, {"dp": 2, "pp": 2}, {"dp": 1, "pp": 4}]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_factoring(n):
    assert dict(tt.make_mesh(n, device="cpu").shape) == dict(jt.make_mesh(n).shape)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("n_experts", [None, 2, 4, 8])
def test_moe_mesh_factoring(n, n_experts):
    got = tt.make_moe_mesh(n, n_experts=n_experts, device="cpu").shape
    assert dict(got) == dict(jt.make_moe_mesh(n, n_experts=n_experts).shape)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("n_layers", [2, 4, 6, 32])
def test_pp_mesh_factoring(n, n_layers):
    got = tt.make_pp_mesh(n, n_layers=n_layers, device="cpu").shape
    assert dict(got) == dict(jt.make_pp_mesh(n, n_layers=n_layers).shape)


def test_the_jax_tests_mesh_shapes():
    """The shapes the JAX tests assert: (2, 2, 2) on 8, sp 2 on 4,
    (1, 2, 1) on 2; the ep mesh (2, 2, 2); the pp mesh (2, 4)."""
    assert tt.make_mesh(8, device="cpu").shape == {"dp": 2, "tp": 2, "sp": 2}
    assert tt.make_mesh(4, device="cpu").shape["sp"] == 2
    assert tt.make_mesh(2, device="cpu").shape == {"dp": 1, "tp": 2, "sp": 1}
    assert tt.make_mesh(1, device="cpu").size == 1
    assert tt.make_moe_mesh(8, device="cpu").shape == {"dp": 2, "ep": 2, "tp": 2}
    assert tt.make_moe_mesh(8, n_experts=8, device="cpu").shape == {
        "dp": 1, "ep": 8, "tp": 1}
    assert tt.make_pp_mesh(8, n_layers=4, device="cpu").shape == {"dp": 2, "pp": 4}


def test_explicit_shapes():
    assert tt.make_mesh(shape=(2, 1, 2), device="cpu").shape == {
        "dp": 2, "tp": 1, "sp": 2}
    assert tt.make_moe_mesh(shape=(1, 2, 2), device="cpu").shape == {
        "dp": 1, "ep": 2, "tp": 2}
    assert tt.make_pp_mesh(shape=(1, 4), device="cpu").shape == {"dp": 1, "pp": 4}


@pytest.mark.parametrize("family", ["param", "moe", "pp", "moe_pp"])
def test_partition_specs_are_the_jax_packages(family):
    from oncilla_tpu.models.llama import LlamaConfig
    from oncilla_tpu.models.moe import MoeConfig
    from oncilla_tpu_torch.models import llama as tl
    from oncilla_tpu_torch.models import moe as tm

    moe = family.startswith("moe")
    cfg_j = MoeConfig.tiny() if moe else LlamaConfig.tiny()
    cfg_t = tm.MoeConfig.tiny() if moe else tl.LlamaConfig.tiny()
    name = {"param": "param_specs", "moe": "moe_param_specs",
            "pp": "pp_param_specs", "moe_pp": "moe_pp_param_specs"}[family]
    want = getattr(jt, name)(cfg_j)
    got = getattr(tt, name)(cfg_t)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), k
    assert tuple(tt.data_spec()) == tuple(jt.data_spec())


def test_a_mesh_without_a_process_group_is_a_layout():
    m = tt.make_mesh(4, device="cpu")
    assert m.layout_only and m.axis_size("dp", "sp") == 2
    with pytest.raises(RuntimeError, match="layout"):
        m.group("sp")
    # Size-1 axes need no group on any mesh.
    assert m.group("dp") is None
    one = tt.make_mesh(1, device="cpu")
    assert not one.layout_only and one.group("dp", "tp", "sp") is None


def test_arena_sharding_and_replicated():
    a = tmesh.arena_sharding(tmesh.node_mesh(["cpu"] * 4))
    jm = jmesh.node_mesh(jax.devices()[:4])
    assert tuple(a.spec) == tuple(jmesh.arena_sharding(jm).spec)
    assert a.mesh.shape == {tmesh.NODE_AXIS: 4}
    r = tmesh.replicated(tt.make_mesh(1, device="cpu"))
    assert tuple(r.spec) == tuple(jmesh.replicated(jm).spec) == ()


def test_shard_layout_off_the_process_group():
    """``shard`` needs only the coordinates: each rank's slice of a leaf
    on a (dp, tp, sp) layout is the JAX ``NamedSharding``'s shard on the
    device at the same place of the reshaped device array."""
    full = np.arange(4 * 8 * 6, dtype=np.float32).reshape(4, 8, 6)
    jm = JMesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2), ("dp", "tp", "sp"))
    spec = ("dp", ("tp", "sp"), None)
    arr = jax.device_put(full, JNamed(jm, JP(*spec)))
    by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    import torch

    for rank, dev in enumerate(jm.devices.reshape(-1)):
        m = tmesh.Mesh({"dp": 2, "tp": 2, "sp": 2}, device="cpu", rank=rank)
        got = tmesh.shard(torch.from_numpy(full), m, tmesh.P(*spec))
        np.testing.assert_array_equal(got.numpy(), by_device[dev])


@pytest.fixture(scope="module")
def layouts():
    return spawn("_torch_dist:mesh_layout", 4, args=(SHAPES,), device="cpu",
                 timeout=120)


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_ranks_are_laid_row_major_over_the_axes(layouts, i):
    shape = SHAPES[i]
    names = list(shape)
    devs = np.arange(4).reshape(*shape.values())
    for rank, got in enumerate(layouts):
        where = {a: int(np.argwhere(devs == rank)[0][j]) for j, a in enumerate(names)}
        assert got[i]["coords"] == where
        for a in names:
            idx = tuple(slice(None) if b == a else where[b] for b in names)
            assert got[i]["ranks"][a] == list(devs[idx].reshape(-1))
        assert got[i]["round_trip"]


def test_shards_tile_the_leaf(layouts):
    """The four processes' shards of a (dp, (tp, sp)) leaf are distinct
    and tile it."""
    full = np.arange(4 * 8 * 6, dtype=np.float32).reshape(4, 8, 6)
    for i in range(3):
        parts = [r[i]["part"] for r in layouts]
        assert sum(p.size for p in parts) == full.size
        assert np.array_equal(np.sort(np.concatenate([p.ravel() for p in parts])),
                              full.ravel())
