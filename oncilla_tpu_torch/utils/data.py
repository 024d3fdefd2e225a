"""Input pipeline: host batches -> device tensors, with the copies
overlapping the consumer's compute: the counterpart of
``oncilla_tpu/utils/data.py``.

While step N computes, step N+1's batch is already crossing the host ->
card link: up to ``depth`` batches are copied ahead of the one being
consumed. On a card, each leaf is copied from pinned memory with
``non_blocking=True`` on a side stream; the consumer's stream waits on an
event recorded after the copies, and each tensor is marked as used on the
consumer's stream (``record_stream``), so the allocator does not hand its
memory out again while the consumer's work on it is still queued. On the
CPU a leaf is copied into a tensor of its own.

On a mesh (:func:`prefetch_to_mesh`) each process receives its slice of
every batch under a ``PartitionSpec`` (``data_spec()``'s dp and sp, say):
the slice is cut on the host and only it crosses the link, where the JAX
package ``device_put``s the global batch under a ``NamedSharding``.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from oncilla_tpu_torch.utils.platform import resolve_device


def _map(batch, fn):
    """``fn`` over a batch's leaves: a tensor or array, or a dict, list or
    tuple of them."""
    if isinstance(batch, dict):
        return {k: _map(v, fn) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(v, fn) for v in batch)
    return fn(batch)


def _leaves(batch) -> list:
    out = []
    _map(batch, out.append)
    return out


def prefetch_to_device(batches: Iterable, device=None, depth: int = 2) -> Iterator:
    """Yield ``batches`` on ``device`` (CUDA unless the caller asks for
    the CPU), keeping up to ``depth`` copies in flight ahead of the
    consumer; depth=2 double-buffers."""
    dev = resolve_device(device)
    return prefetch_sharded(batches, lambda leaf: dev, depth=depth)


def prefetch_to_mesh(batches: Iterable, mesh, spec, depth: int = 2) -> Iterator:
    """Yield this process's slice of each of ``batches`` under ``spec``
    over ``mesh`` (a ``PartitionSpec`` of
    :mod:`oncilla_tpu_torch.parallel.mesh`), on the mesh's device, keeping
    up to ``depth`` transfers in flight ahead of the consumer. Every leaf
    gets the same spec (:func:`prefetch_sharded` takes one a leaf)."""
    from oncilla_tpu_torch.parallel.mesh import NamedSharding

    sharding = NamedSharding(mesh, spec)
    return prefetch_sharded(batches, lambda leaf: sharding, depth=depth)


def prefetch_sharded(batches: Iterable, device_of: Callable,
                     depth: int = 2) -> Iterator:
    """General form: ``device_of(leaf)`` picks each leaf's device, or its
    ``NamedSharding`` (the leaf's slice goes to the mesh's device).

    A plain function, not a generator, so ``depth`` is validated and the
    first copies start at construction, not at the first ``next()``."""
    from oncilla_tpu_torch.parallel.mesh import NamedSharding, shard

    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    queue: collections.deque = collections.deque()
    it = iter(batches)
    streams: dict[torch.device, torch.cuda.Stream] = {}

    def place(leaf):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(leaf))
        where = device_of(leaf)
        if isinstance(where, NamedSharding):
            t = shard(t, where.mesh, where.spec, device=t.device)
            where = where.mesh.device
        dev = torch.device(where)
        if dev.type != "cuda":
            return t.to(dev, copy=True)  # never an alias of the producer's
        if t.device.type == "cpu" and not t.is_pinned():
            t = t.pin_memory()
        side = streams.get(dev)
        if side is None:
            side = streams[dev] = torch.cuda.Stream(dev)
        with torch.cuda.stream(side):
            return t.to(dev, non_blocking=True)

    def enqueue() -> bool:
        try:
            batch = next(it)
        except StopIteration:
            return False
        placed = _map(batch, place)
        events = []
        for dev, side in streams.items():
            ev = torch.cuda.Event()
            ev.record(side)
            events.append((dev, ev))
        queue.append((placed, events))
        return True

    for _ in range(depth):
        if not enqueue():
            break

    def drain() -> Iterator:
        while queue:
            placed, events = queue.popleft()
            for dev, ev in events:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(ev)
                for t in _leaves(placed):
                    if t.device == dev:
                        t.record_stream(consumer)
            enqueue()
            yield placed

    return drain()
