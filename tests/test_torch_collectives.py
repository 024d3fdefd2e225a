"""The port's collectives (``parallel/collectives.py``) held against JAX's
inside ``shard_map`` on a 4-device mesh, forward and gradient, from the
same numpy inputs; the port runs in 4 gloo processes.

Each gradient is that of sum(out * w) under the port's convention: a
result ``psum`` leaves replicated is counted once (JAX: ``out_specs=P()``),
a replicated input that each process uses on its own (``copy``) is JAX's
``in_specs=P()``, and every other output is each process's own (JAX:
``out_specs=P("i")``), weighed by its index + 1. Exact: the data are
small integers in float32, so no sum rounds.

Also ``runtime.membership.torch_membership`` in the same world: the JAX
``jax_membership``'s errors for a missing host list and a wrong count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from oncilla_tpu_torch.parallel.launch import spawn

X = np.random.default_rng(0).integers(-8, 8, (4, 8, 12)).astype(np.float32)
W = (np.arange(4) + 1.0).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    return spawn("_torch_dist:collectives_and_membership", 4, args=(X, 7000),
                 device="cpu", timeout=120)


@pytest.fixture(scope="module")
def port(world):
    return [r["collectives"] for r in world]


def _sm(fn, in_spec, out_spec):
    jm = JMesh(np.asarray(jax.devices()[:4]), ("i",))
    return jax.shard_map(fn, mesh=jm, in_specs=(in_spec,), out_specs=out_spec)


def _weighted(f):
    """sum over devices of sum(out_i * w_i), each device's output its own."""
    def loss(a):
        y = f(a)
        return jnp.sum(y.reshape(4, -1) * W[:, None])
    return loss


VARYING = {
    "all_gather": lambda a: jax.lax.all_gather(a[0], "i", axis=0, tiled=True)[None],
    "ppermute": lambda a: jax.lax.ppermute(a, "i", [(i, (i + 1) % 4) for i in range(4)]),
    "ppermute_partial": lambda a: jax.lax.ppermute(a, "i", [(0, 2), (1, 3)]),
    "all_to_all": lambda a: jax.lax.all_to_all(a[0], "i", 0, 1, tiled=True)[None],
}


@pytest.mark.parametrize("name", sorted(VARYING))
def test_varying_collective_and_its_gradient(port, name):
    f = _sm(VARYING[name], P("i"), P("i"))
    y = np.asarray(f(X))
    gx = np.asarray(jax.grad(_weighted(f))(jnp.asarray(X)))
    per = y.reshape(4, -1, *y.shape[1:])[:, 0] if y.shape[0] == 4 else y
    for r in range(4):
        np.testing.assert_array_equal(port[r][name]["y"], per[r], err_msg=name)
        np.testing.assert_array_equal(port[r][name]["gx"], gx[r], err_msg=name)


def test_psum_is_replicated_and_passes_its_gradient(port):
    f = _sm(lambda a: jax.lax.psum(a, "i"), P("i"), P())
    y = np.asarray(f(X))
    gx = np.asarray(jax.grad(lambda a: jnp.sum(f(a) * 2.0))(jnp.asarray(X)))
    for r in range(4):
        np.testing.assert_array_equal(port[r]["psum"]["y"], y[0])
        np.testing.assert_array_equal(port[r]["psum"]["gx"], gx[r])


def test_copy_sums_the_gradients_of_a_replicated_input(port):
    f = _sm(lambda a: a[None] * (jax.lax.axis_index("i") + 1.0), P(), P("i"))
    gx = np.asarray(jax.grad(lambda a: jnp.sum(f(a)))(jnp.asarray(X[0])))
    for r in range(4):
        np.testing.assert_array_equal(port[r]["copy"]["y"], X[0])
        np.testing.assert_array_equal(port[r]["copy"]["gx"], gx)


def test_pmax(port):
    want = np.asarray(_sm(lambda a: jax.lax.pmax(a, "i"), P("i"), P())(X))[0]
    for r in range(4):
        np.testing.assert_array_equal(port[r]["pmax"], want)


@pytest.fixture(scope="module")
def membership(world):
    return [r["membership"] for r in world]


def test_membership_needs_hosts_in_a_world_of_more_than_one(membership):
    from oncilla_tpu.runtime.membership import jax_membership

    for rank, got in enumerate(membership):
        assert "needs hostnames" in got["no_hosts"]
        assert got["wrong_count"] == "got 2 hosts for 4 processes"
        entries, me = got["env"]
        assert me == rank
        assert entries == [(i, f"h{i}", 7000 + i) for i in range(4)]
    # The JAX package's, in its world of one process, for the same calls.
    with pytest.raises(Exception, match="got 2 hosts for 1 JAX processes"):
        jax_membership(7000, hosts=["a", "b"])


def test_membership_of_a_world_of_one():
    from oncilla_tpu.runtime.membership import jax_membership
    from oncilla_tpu_torch.core.errors import OcmError
    from oncilla_tpu_torch.runtime.membership import torch_membership

    got, rank = torch_membership(7100)
    want, jrank = jax_membership(7100)
    assert [(e.rank, e.host, e.port) for e in got] == \
        [(e.rank, e.host, e.port) for e in want] and rank == jrank == 0
    with pytest.raises(OcmError, match="got 2 hosts for 1 processes"):
        torch_membership(7100, hosts=["a", "b"])
