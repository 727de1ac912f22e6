"""The collectives the sharded paths use, over one axis's process group,
and the two autograd rules of tensor parallelism.

``torch.distributed.nn.functional.all_reduce`` sums the gradient in its
backward. Where every rank of the axis computes the same cotangent (a sum
whose result is replicated downstream), that multiplies the gradient by the
axis size; :class:`SumOverAxis` (Megatron's "g": sum forward, identity
backward) and :class:`CopyToAxis` (its "f": identity forward, sum backward)
are the rules these paths need instead.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``[S * B, ...]``: every rank's ``x [B, ...]``, in rank order."""
    out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def reduce_scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``[B, ...]``: block ``rank`` of the sum over ranks of ``x [S * B, ...]``."""
    out = x.new_empty((x.shape[0] // dist.get_world_size(group), *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the group's ranks (a new tensor)."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class SumOverAxis(torch.autograd.Function):
    """Sum of ``x`` over the axis; the backward passes the (replicated)
    cotangent through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class CopyToAxis(torch.autograd.Function):
    """``x`` as it is; the backward sums the ranks' cotangents (each rank
    used a different part of the replicated ``x``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def average_gradients(params, group, divide: int) -> None:
    """Sum the gradients of ``params`` over ``group`` in one collective and
    divide them by ``divide``; a missing gradient counts as zeros."""
    params = list(params)
    if not params:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    if divide != 1:
        flat = flat / divide
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p).to(p.dtype)
        offset += n
