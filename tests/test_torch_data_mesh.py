"""``utils/data.prefetch_to_mesh`` and ``prefetch_sharded`` held against
the JAX package's (``tests/test_data.py`` whole).

Each process of a mesh receives its slice of every batch: here each rank
of an 8-process (2, 2, 2) layout (a mesh's coordinates need no process
group) gets exactly the shard the JAX ``NamedSharding`` puts on the device
at its place, batch by batch in order; the producer is pulled ``depth``
batches ahead of the consumer; and the prefetched slices feed the sharded
train step in 4 gloo processes (the losses fall).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from oncilla_tpu.models import train as jt
from oncilla_tpu.utils import data as jdata
from oncilla_tpu_torch.models import train as tt
from oncilla_tpu_torch.parallel.launch import spawn
from oncilla_tpu_torch.parallel.mesh import Mesh, NamedSharding as TNamed, P
from oncilla_tpu_torch.utils.data import prefetch_sharded, prefetch_to_mesh

SHAPE = {"dp": 2, "tp": 2, "sp": 2}


def _rank_mesh(rank):
    return Mesh(SHAPE, device="cpu", rank=rank)


def _jax_shard(arr, rank):
    """The shard of a JAX array on the device at mesh position ``rank``."""
    dev = jt.make_mesh(8).devices.reshape(-1)[rank]
    return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)


@pytest.mark.parametrize("rank", range(8))
def test_prefetch_values_and_sharding(rng, rank):
    batches = [rng.standard_normal((8, 16)).astype(np.float32) for _ in range(5)]
    jout = list(jdata.prefetch_to_mesh(iter(batches), jt.make_mesh(8), JP("dp", None)))
    out = list(prefetch_to_mesh(iter(batches), _rank_mesh(rank), P("dp", None)))
    assert len(out) == len(jout) == 5
    for got, want in zip(out, jout):
        assert isinstance(got, torch.Tensor) and got.shape == (4, 16)
        np.testing.assert_array_equal(got.numpy(), _jax_shard(want, rank))


def test_prefetch_pytree_batches(rng):
    batches = [{"x": rng.standard_normal((8, 4)).astype(np.float32),
                "y": rng.integers(0, 10, (8,)).astype(np.int32)} for _ in range(3)]
    jout = list(jdata.prefetch_to_mesh(iter(batches), jt.make_mesh(8), JP("dp")))
    for rank in range(8):
        out = list(prefetch_to_mesh(iter(batches), _rank_mesh(rank), P("dp")))
        for got, want in zip(out, jout):
            for k in ("x", "y"):
                np.testing.assert_array_equal(got[k].numpy(), _jax_shard(want[k], rank))


def test_prefetch_stays_ahead():
    """The producer is pulled ``depth`` batches ahead of the consumer."""
    pulled = []

    def producer():
        for i in range(6):
            pulled.append(i)
            yield np.full((8, 2), i, np.float32)

    it = prefetch_to_mesh(producer(), _rank_mesh(5), P("dp", None), depth=3)
    first = next(it)
    assert pulled == [0, 1, 2, 3]
    np.testing.assert_array_equal(first.numpy(), np.zeros((4, 2)))
    rest = list(it)
    assert len(rest) == 5 and pulled == list(range(6))
    assert [int(b[0, 0]) for b in rest] == [1, 2, 3, 4, 5]


def test_prefetch_mixed_shardings_per_leaf(rng):
    """``prefetch_sharded``'s per-leaf placement: different leaves under
    different specs in one batch, sequence and batch splits included."""
    jm = jt.make_mesh(8)
    batches = [{"x": rng.standard_normal((8, 4)).astype(np.float32),
                "y": rng.integers(0, 10, (8,)).astype(np.int32)} for _ in range(2)]
    jsh = {2: NamedSharding(jm, JP("dp", "sp")), 1: NamedSharding(jm, JP("dp"))}
    jout = list(jdata.prefetch_sharded(iter(batches), lambda leaf: jsh[leaf.ndim]))
    for rank in range(8):
        m = _rank_mesh(rank)
        tsh = {2: TNamed(m, P("dp", "sp")), 1: TNamed(m, P("dp"))}
        out = list(prefetch_sharded(iter(batches), lambda leaf: tsh[leaf.ndim]))
        for got, want in zip(out, jout):
            assert got["x"].shape == (4, 2) and got["y"].shape == (4,)
            for k in ("x", "y"):
                np.testing.assert_array_equal(got[k].numpy(), _jax_shard(want[k], rank))


def test_prefetch_short_stream_and_errors():
    out = list(prefetch_to_mesh(iter([np.ones((8, 2), np.float32)]), _rank_mesh(0),
                                P("dp", None), depth=4))
    assert len(out) == 1
    with pytest.raises(ValueError, match="depth"):
        prefetch_sharded(iter([]), lambda x: None, depth=0)


def test_prefetch_feeds_train_step(rng):
    """The prefetched slices feed the sharded step directly."""
    cfg = tt.llama.LlamaConfig.tiny()
    batches = [np.asarray(jt.sample_batch(rng, cfg, 4, 32)) for _ in range(4)]
    batches = [batches[0]] * 4  # one batch, so the losses must fall
    losses = spawn("_torch_dist:data_feeds_step", 4, args=(batches,), device="cpu",
                   timeout=120)
    assert all(lo == losses[0] for lo in losses)  # the global loss everywhere
    assert len(losses[0]) == 4 and np.isfinite(losses[0]).all()
    assert losses[0][-1] < losses[0][0]
