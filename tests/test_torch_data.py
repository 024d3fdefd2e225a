"""The port's input pipeline (``oncilla_tpu_torch.utils.data``) on the CPU
device: the six cases of ``tests/test_data.py``, one device in place of a
mesh (``prefetch_to_device`` for ``prefetch_to_mesh``, a device per leaf
for a sharding per leaf)."""

import numpy as np
import pytest
import torch

from oncilla_tpu_torch.models import llama, train
from oncilla_tpu_torch.utils.data import prefetch_sharded, prefetch_to_device

CPU = torch.device("cpu")


def test_prefetch_values_and_device(rng):
    batches = [rng.standard_normal((8, 16)).astype(np.float32) for _ in range(5)]
    out = list(prefetch_to_device(iter(batches), "cpu"))
    assert len(out) == 5
    for got, want in zip(out, batches):
        assert isinstance(got, torch.Tensor) and got.device == CPU
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.data_ptr() != want.ctypes.data  # a copy, never an alias


def test_prefetch_pytree_batches(rng):
    batches = [
        {"x": rng.standard_normal((8, 4)).astype(np.float32),
         "y": rng.integers(0, 10, (8,)).astype(np.int32)}
        for _ in range(3)
    ]
    out = list(prefetch_to_device(iter(batches), "cpu"))
    for got, want in zip(out, batches):
        np.testing.assert_array_equal(got["x"].numpy(), want["x"])
        np.testing.assert_array_equal(got["y"].numpy(), want["y"])
        assert got["y"].dtype == torch.int32


def test_prefetch_stays_ahead():
    """The producer is pulled ``depth`` batches ahead of the consumer: the
    latency-hiding contract."""
    pulled = []

    def producer():
        for i in range(6):
            pulled.append(i)
            yield np.full((8, 2), i, np.float32)

    it = prefetch_to_device(producer(), "cpu", depth=3)
    first = next(it)
    assert pulled == [0, 1, 2, 3]
    np.testing.assert_array_equal(first.numpy(), np.zeros((8, 2)))
    rest = list(it)
    assert len(rest) == 5
    assert pulled == list(range(6))


def test_prefetch_device_per_leaf(rng):
    """prefetch_sharded asks ``device_of`` for each leaf."""
    asked = []

    def device_of(leaf):
        asked.append(leaf.ndim)
        return "cpu"

    batches = [
        {"x": rng.standard_normal((8, 4)).astype(np.float32),
         "y": rng.integers(0, 10, (8,)).astype(np.int32)}
        for _ in range(2)
    ]
    out = list(prefetch_sharded(iter(batches), device_of))
    assert sorted(asked) == [1, 1, 2, 2]
    for got, want in zip(out, batches):
        np.testing.assert_array_equal(got["x"].numpy(), want["x"])
        np.testing.assert_array_equal(got["y"].numpy(), want["y"])


def test_prefetch_short_stream_and_errors():
    out = list(prefetch_to_device(iter([np.ones((8, 2), np.float32)]), "cpu", depth=4))
    assert len(out) == 1
    # depth is checked at construction, not at the first next().
    with pytest.raises(ValueError, match="depth"):
        prefetch_sharded(iter([]), lambda x: "cpu", depth=0)


def test_prefetch_feeds_train_step(rng):
    """End to end: the pipeline feeds the train step directly."""
    cfg = llama.LlamaConfig.tiny()
    params, opt_state, tx = train.make_train_state(cfg, lr=1e-2, device="cpu")
    step = train.make_train_step(cfg, tx)

    def batches():
        for _ in range(4):
            yield train.sample_batch(rng, cfg, 4, 32, device="cpu").numpy()

    losses = []
    for tokens in prefetch_to_device(batches(), "cpu"):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
