"""Pipeline parallelism: a GPipe-schedule stage executor over a ``pp``
mesh axis.

The counterpart of ``oncilla_tpu/parallel/pipeline.py``:

- Stages are the model's stacked layer axis sharded over ``pp`` (one
  :class:`~oncilla_tpu_torch.parallel.mesh.PartitionSpec`): each process
  holds ``n_layers / pp`` layers and ``stage_fn`` runs them.
- The schedule is GPipe's: ``M + n - 1`` ticks; at tick t stage s works on
  microbatch t - s, and the activations move to the next stage by a
  point-to-point exchange (:func:`~oncilla_tpu_torch.parallel.collectives.
  exchange`, the partial ``ppermute`` of the edges that carry a real
  microbatch at that tick). The backward is the same schedule reversed: the
  gradients move back by the inverse exchange, microbatch by microbatch.
- The last stage's outputs are replicated over ``pp`` (a broadcast, where
  the JAX body ``psum``s them with zeros elsewhere), so the head and the
  loss run replicated after it; the gradient of the input is stage 0's,
  replicated the same way, as JAX's transpose of a replicated input sums
  the stages' cotangents of which only stage 0's are not zero.
- ``with_aux``: the stage returns ``(mb, aux)``; the result's aux sums every
  real (stage, microbatch) pair over ``pp`` and averages over
  ``batch_axis`` (the MoE family's router loss crosses the pipeline so).

What differs by PyTorch idiom: the whole schedule is one
``torch.autograd.Function`` whose backward runs the reverse schedule with
``torch.autograd.grad`` a microbatch (the JAX package gets it from
``jax.grad`` of a ``lax.scan``); bubble ticks compute nothing (the JAX body
computes them on don't-care values to keep static control flow); and
``remat`` keeps only each microbatch's stage input and recomputes the stage
in the backward (``jax.checkpoint`` of the stage function).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from oncilla_tpu_torch.parallel.collectives import (
    all_reduce_,
    broadcast_,
    exchange,
    psum,
)


class _Run:
    """One pipeline call's settings and its forward and backward schedules
    on this process."""

    def __init__(self, stage_fn, names, mesh, axis, batch_axis, microbatches,
                 with_aux, remat):
        self.stage_fn, self.names, self.mesh = stage_fn, names, mesh
        self.axis, self.batch_axis = axis, batch_axis
        self.M, self.with_aux, self.remat = microbatches, with_aux, remat
        self.n = mesh.axis_size(axis)
        self.s = mesh.axis_index(axis)
        self.dp = mesh.axis_size(batch_axis) if batch_axis else 1

    def params(self, leaves):
        return leaves[0] if self.names is None else dict(zip(self.names, leaves))

    def stage(self, params, inp):
        res = self.stage_fn(params, inp)
        return res if self.with_aux else (res, None)

    def forward(self, x, leaves, needs_x: bool):
        n, s, M = self.n, self.s, self.M
        xs = x.detach().chunk(M)
        aliases = [t.detach().requires_grad_() for t in leaves]
        params = self.params(aliases)
        saved, outs = [None] * M, [None] * M
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        recv = None
        for t in range(M + n - 1):
            m, y = t - s, None
            if 0 <= m < M:
                inp = (xs[m] if s == 0 else recv).detach()
                inp.requires_grad_(s > 0 or needs_x)
                with torch.set_grad_enabled(not self.remat):
                    y, a = self.stage(params, inp)
                saved[m] = (inp, None, None) if self.remat else (inp, y, a)
                if a is not None:
                    aux = aux + a.detach().float()
                if s == n - 1:
                    outs[m] = y.detach()
            perm = [(i, i + 1) for i in range(n - 1) if 0 <= t - i < M]
            send = y.detach() if y is not None and s < n - 1 else None
            recv = exchange(send, self.mesh, self.axis, perm, like=xs[0])
        out = torch.cat(outs) if s == n - 1 else torch.empty_like(x)
        broadcast_(out, self.mesh.ranks(self.axis)[n - 1], self.mesh.group(self.axis))
        aux = self._aux_total(aux)
        return out, aux, (saved, aliases, params)

    def _aux_total(self, aux):
        all_reduce_(aux, self.mesh.group(self.axis))
        if self.dp > 1:
            aux = all_reduce_(aux, self.mesh.group(self.batch_axis)) / self.dp
        return aux

    def backward(self, state, g_out, g_aux, needs_x: bool):
        n, s, M = self.n, self.s, self.M
        saved, aliases, params = state
        g_outs = [g.contiguous() for g in g_out.chunk(M)]
        acc = [None] * len(aliases)
        gx = [None] * M
        g_recv = None
        for tau in reversed(range(M + n - 1)):
            m, g_inp = tau - s, None
            if 0 <= m < M:
                inp, y, a = saved[m]
                saved[m] = None
                if self.remat:
                    with torch.enable_grad():
                        y, a = self.stage(params, inp)
                outputs, grads = [y], [g_outs[m] if s == n - 1 else g_recv]
                if a is not None and g_aux is not None:
                    outputs.append(a)
                    grads.append((g_aux / self.dp).expand_as(a))
                inputs = ([inp] if inp.requires_grad else []) + aliases
                gs = list(torch.autograd.grad(outputs, inputs, grads,
                                              allow_unused=True))
                if inp.requires_grad:
                    g_inp = gs.pop(0)
                for i, g in enumerate(gs):
                    if g is not None:
                        acc[i] = g if acc[i] is None else acc[i] + g
                if s == 0:
                    gx[m] = g_inp
            perm = [(i, i - 1) for i in range(1, n) if 0 <= tau - i < M]
            send = g_inp if g_inp is not None and s > 0 else None
            g_recv = exchange(send, self.mesh, self.axis, perm, like=g_outs[0])
        g_x = None
        if needs_x:
            g_x = torch.cat(gx) if s == 0 else torch.empty_like(g_out)
            broadcast_(g_x, self.mesh.ranks(self.axis)[0], self.mesh.group(self.axis))
        g_leaves = [torch.zeros_like(t) if g is None else g
                    for g, t in zip(acc, aliases)]
        return g_x, g_leaves


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x, *leaves):
        ctx.run = run
        out, aux, ctx.state = run.forward(x, leaves, ctx.needs_input_grad[1])
        return out, aux

    @staticmethod
    def backward(ctx, g_out, g_aux):
        g_x, g_leaves = ctx.run.backward(ctx.state, g_out, g_aux,
                                         ctx.needs_input_grad[1])
        ctx.state = None
        return (None, g_x, *g_leaves)


def pipeline_stages_shard(stage_fn, stage_params, x_local, *, mesh,
                          axis_name: str, microbatches: int,
                          with_aux: bool = False, batch_axis: str | None = None,
                          remat: bool = False):
    """This process's GPipe over ``axis_name``: ``stage_fn(stage_params,
    mb) -> mb`` (``(mb, aux)`` with ``with_aux``) applies this stage's
    layers to one microbatch; ``x_local`` (B_local, ...) enters stage 0.
    Returns the last stage's outputs, replicated on every stage (and with
    ``with_aux`` the aux of every real (stage, microbatch) pair, summed over
    the stages and averaged over ``batch_axis``)."""
    B = x_local.shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} not divisible by {microbatches} microbatches")
    if isinstance(stage_params, dict):
        names, leaves = tuple(stage_params), list(stage_params.values())
    else:
        names, leaves = None, [stage_params]
    run = _Run(stage_fn, names, mesh, axis_name, batch_axis, microbatches,
               with_aux, remat)
    if run.n == 1:
        out, aux = _one_stage(run, stage_params, x_local)
    else:
        out, aux = _GPipe.apply(run, x_local, *leaves)
    return (out, aux) if with_aux else out


def _one_stage(run, params, x):
    """A pipeline of one stage: the microbatches in turn, no exchange."""
    outs = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for xm in x.chunk(run.M):
        if run.remat:
            y, a = checkpoint(run.stage, params, xm, use_reentrant=False)
        else:
            y, a = run.stage(params, xm)
        outs.append(y)
        if a is not None:
            aux = aux + a.float()
    if run.dp > 1:
        aux = psum(aux, run.mesh.group(run.batch_axis)) / run.dp
    return torch.cat(outs), aux


def pipeline_apply(stage_fn, params, x, *, mesh, axis_name: str = "pp",
                   batch_axis: str | None = None, microbatches: int,
                   with_aux: bool = False, remat: bool = False):
    """Run this process's ``x`` (its ``batch_axis`` shard, replicated over
    ``axis_name``) through the pp-sharded layer stack under GPipe.
    ``params``: this stage's shard of the stacked leaves (a tensor or a
    dict of them); see :func:`pipeline_stages_shard`."""
    return pipeline_stages_shard(
        stage_fn, params, x, mesh=mesh, axis_name=axis_name,
        microbatches=microbatches, with_aux=with_aux, batch_axis=batch_axis,
        remat=remat)
