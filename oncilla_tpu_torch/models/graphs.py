"""CUDA graphs of the decode steps: the port's counterpart of the JAX
package's jit.

Eager decode on the card is bound by the host: a Llama-3-8B token step is
a few thousand small kernels, each launched from Python. The JAX package
compiles each step once per shape bucket; here each step is captured once
per function and input shapes into a CUDA graph and replayed, one launch of
the whole graph per step.

:class:`StepGraphs` holds the graphs of one model (``params``, ``cfg``).
Every step function it serves has the signature
``fn(params, *args, cfg) -> (logits, tail_k, tail_v)`` and updates its tail
buffers, the last two of ``args``, in place (:mod:`.kv_paging`'s
``paged_token_step`` and ``paged_decode_batch_step``, or either bound to
a family's hooks by ``kv_paging.hooked_step``). The key holds ``fn`` by
identity, so a step must be one stable callable, not a partial made anew
at each call: each new callable would capture a new graph. A graph reads and
writes fixed ("static") buffers: :meth:`StepGraphs.run` copies each argument
into its static buffer, replays, and copies the tails back into the
caller's, so a graphed call has the eager call's effect. ``tags`` lets a
caller skip a copy whose bytes the static buffer already holds (a page pool
that changes at page boundaries only).

Capture happens on a side stream after one warm-up call, as
``torch.cuda.graph`` requires; the steps write each row's new K/V into its
own tail slot, so running one twice on the same inputs leaves the same
bytes, and the warm-up changes nothing the replay would not. A capture that
fails raises. Page moves (the copy kernels), ``Ocm`` allocations and host
transfers are never inside a capture: only the step function is.

On CPU tensors (the caller asked for the CPU) a step runs its function on
its static buffers at every call, with the same copies: the bookkeeping is
the same, only the capture is left out.
"""

from __future__ import annotations

import time

import torch


class CapturedStep:
    """``fn(*static)`` captured at the shapes of the first call's ``args``
    (on CUDA; run at every call on the CPU)."""

    def __init__(self, fn, args):
        self.fn = fn
        self.static = [a.clone() for a in args]
        self._tags: dict[int, object] = {}
        self.graph = None
        self.capture_s = 0.0
        dev = self.static[0].device
        if dev.type != "cuda":
            return
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn(*self.static)  # warm-up: lazy library set-up stays out
        main.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = fn(*self.static)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0

    def load(self, args, tags=None) -> None:
        """Copy ``args`` into the static buffers, skipping argument ``i``
        when ``tags[i]`` equals the tag it was last loaded with."""
        for i, (s, a) in enumerate(zip(self.static, args)):
            tag = None if tags is None else tags.get(i)
            if tag is not None and self._tags.get(i) == tag:
                continue
            if s.data_ptr() != a.data_ptr():
                s.copy_(a)
            self._tags[i] = tag

    def replay(self):
        if self.graph is None:
            return self.fn(*self.static)
        self.graph.replay()
        return self.out


class StepGraphs:
    """The captured steps of one model: one per step function and input
    shapes (the JAX package's shape buckets)."""

    def __init__(self, params: dict, cfg):
        self.params = params
        self.cfg = cfg
        self.steps: dict[tuple, CapturedStep] = {}

    @property
    def captured(self) -> int:
        return sum(s.graph is not None for s in self.steps.values())

    @property
    def capture_s(self) -> float:
        return sum(s.capture_s for s in self.steps.values())

    def run(self, fn, args, tags=None):
        """``fn(params, *args, cfg)`` through its graph: returns (logits,
        tail_k, tail_v), the tails being the caller's ``args[-2:]``, updated
        in place. The logits are the graph's output buffer, valid until the
        same graph runs again."""
        key = (fn, tuple((tuple(a.shape), a.dtype, a.device) for a in args))
        step = self.steps.get(key)
        if step is None:
            params, cfg = self.params, self.cfg
            step = self.steps[key] = CapturedStep(
                lambda *a: fn(params, *a, cfg), args)
        step.load(args, tags)
        logits = step.replay()[0]
        for a, s in zip(args[-2:], step.static[-2:]):
            if a.data_ptr() != s.data_ptr():
                a.copy_(s)
        return logits, args[-2], args[-1]

    def close(self) -> None:
        """Drop every graph and its buffers."""
        self.steps.clear()
