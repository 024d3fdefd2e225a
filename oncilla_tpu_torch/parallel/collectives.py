"""Collectives over a :class:`~oncilla_tpu_torch.parallel.mesh.Mesh`'s
process groups, each with the gradient JAX gives its counterpart.

The JAX package writes collectives inside ``shard_map`` (``psum``,
``ppermute``) or lets GSPMD insert them from the shardings (all-gathers,
reduce-scatters, all-to-alls); ``jax.grad`` transposes each. Here each is
a ``torch.autograd.Function`` whose backward is that transpose, so autograd
carries gradients across processes.

The convention: a value that a collective leaves *replicated* over a group
is computed by every member from then on (the head, the loss), and the
global loss is that replicated value, counted once. Each process's backward
then gives its own contribution to the gradient of that one loss:

- :func:`psum` (forward all-reduce) passes the gradient through unchanged:
  every member already holds the whole gradient of the replicated result;
- :func:`copy` (forward identity) all-reduces the gradient: a replicated
  value that each member feeds into its own partial result (the Megatron
  f/g pair, ``copy`` before a column-split product, ``psum`` after a
  row-split one);
- :func:`all_gather` reduce-scatters the gradient, :func:`ppermute` sends
  it back along the inverse permutation, :func:`all_to_all` exchanges it
  back.

A leaf replicated over an axis whose members see different data (dp, sp)
ends its backward with a part of its gradient on each member; the train
step sums those over the data axes. Every function here is the identity
when its group is None (an axis of size 1), so a mesh of one adds nothing.
Every member of a group must call the same collectives in the same order,
forward and backward: the step's code is the same on every process.

:func:`traffic` counts the bytes this process hands to each collective, by
the mesh axes of its group and the operation (a dict increment a call;
``reset_traffic`` zeroes it): the payload, from which an algorithm's wire
bytes follow (a ring all-reduce of n bytes over g members sends
2·(g-1)/g·n from each).
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

_TRAFFIC: collections.Counter = collections.Counter()
_AXES: dict = {}


def name_group(group, axes) -> None:
    """Record the mesh axes a process group spans (for :func:`traffic`)."""
    _AXES[id(group)] = "+".join(axes)


def _count(group, op: str, t: torch.Tensor) -> None:
    _TRAFFIC[(_AXES.get(id(group), "world"), op)] += t.numel() * t.element_size()


def traffic() -> dict:
    """{"axes op": bytes} handed to collectives since the last reset."""
    return {f"{a} {op}": n for (a, op), n in sorted(_TRAFFIC.items())}


def reset_traffic() -> None:
    _TRAFFIC.clear()


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    _count(group, "all_reduce", t)
    dist.all_reduce(t, op=op, group=group)
    return t


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    _count(group, "all_gather", x)
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * moved.shape[0], *moved.shape[1:]), dtype=x.dtype,
                      device=x.device)
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, moved, group=group)
    return out.movedim(0, dim)


def _scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    _count(group, "reduce_scatter", x)
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // n, *moved.shape[1:]), dtype=x.dtype,
                      device=x.device)
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, moved, group=group)
    return out.movedim(0, dim)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.args = (split_dim, concat_dim, group)
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, group = ctx.args
        return _all_to_all(g, concat_dim, split_dim, group), None, None, None


def _all_to_all(x, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    _count(group, "all_to_all", x)
    n = dist.get_world_size(group)
    parts = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``, replicated on every member; the gradient passes
    through unchanged (the result is computed on by every member)."""
    return x if group is None else _Psum.apply(x, group)


def copy(x: torch.Tensor, group) -> torch.Tensor:
    """The identity, whose gradient is summed over ``group``: put before a
    replicated value enters each member's own partial computation."""
    return x if group is None else _Copy.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over ``group`` (no gradient: a softmax's shift)."""
    x = x.detach()
    return x if group is None else _all_reduce(x.clone(), group,
                                               dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim`` in group order; the
    gradient is reduce-scattered back."""
    return x if group is None else _AllGather.apply(x, dim, group)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group) -> torch.Tensor:
    """Member i's chunk j of ``x`` along ``split_dim`` goes to member j,
    which concatenates what it receives along ``concat_dim`` in member
    order; the gradient goes back by the inverse exchange."""
    return x if group is None else _AllToAll.apply(x, split_dim, concat_dim,
                                                   group)


def exchange(x: torch.Tensor | None, mesh, axis: str, perm, like: torch.Tensor
             ) -> torch.Tensor:
    """One round of point-to-point sends along ``axis`` with no gradient:
    ``perm`` lists (source, destination) indices along the axis; this
    process sends ``x`` where it is a source and returns what it receives
    where it is a destination, zeros shaped as ``like`` where it is not
    (``jax.lax.ppermute``'s partial permutation). Built on
    ``dist.batch_isend_irecv``."""
    me = mesh.axis_index(axis)
    group = mesh.group(axis)
    ranks = mesh.ranks(axis)
    out = torch.zeros(like.shape, dtype=like.dtype, device=like.device)
    ops = []
    for src, dst in perm:
        if src == me and x is not None:
            _count(group, "send", x)
            ops.append(dist.P2POp(dist.isend, x.contiguous(), ranks[dst], group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[src], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, perm)
        return exchange(x, mesh, axis, perm, like=x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, perm = ctx.args
        back = [(d, s) for s, d in perm]
        return exchange(g, mesh, axis, back, like=g), None, None, None


def ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """``jax.lax.ppermute`` along ``axis``: ``perm`` is a list of (source,
    destination) indices; a member no source sends to receives zeros. The
    gradient goes back along the inverse permutation."""
    if mesh.axis_size(axis) == 1:
        return x
    return _PPermute.apply(x, mesh, axis, tuple(perm))


def ring_perm(n: int) -> tuple:
    """Each member sends to the next, the last to the first."""
    return tuple((i, (i + 1) % n) for i in range(n))


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` with no gradient (the train step's
    gradient reduction); the identity when ``group`` is None."""
    return t if group is None else _all_reduce(t, group)


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """In place: ``t`` of global rank ``src`` on every member of ``group``
    (no gradient); the identity when ``group`` is None."""
    if group is not None:
        _count(group, "broadcast", t)
        dist.broadcast(t, src=src, group=group)
    return t
