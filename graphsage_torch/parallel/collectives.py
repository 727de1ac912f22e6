"""The collectives the sharded paths use, over one axis's process group,
the two autograd rules of tensor parallelism and the two of request
routing.

``torch.distributed.nn.functional.all_reduce`` sums the gradient in its
backward. Where every rank of the axis computes the same cotangent (a sum
whose result is replicated downstream), that multiplies the gradient by the
axis size; :class:`SumOverAxis` (Megatron's "g": sum forward, identity
backward) and :class:`CopyToAxis` (its "f": identity forward, sum backward)
are the rules these paths need instead.

The compact exchange routes fixed-size buckets with :func:`all_to_all_rows`:
the request ids out (:class:`RouteIds`, no gradient) and the answer rows
back (:class:`RouteAnswers`, whose backward is the reverse all-to-all of the
cotangent).
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


def all_to_all_rows(x: torch.Tensor, group, extra_rows: int = 0) -> torch.Tensor:
    """``[S * cap + extra_rows, ...]`` from ``x [S, cap, ...]``: rows ``d *
    cap`` to ``(d + 1) * cap`` are rank ``d``'s block ``rank``, as JAX's
    ``all_to_all(split_axis=0, concat_axis=0)`` gives them. The
    ``extra_rows`` after them are left for the caller to fill. A bool
    payload travels as its bytes (``uint8``); gloo moves CUDA tensors too
    (probed on the H100 for int32, uint8, bool, f32 and bf16; it refuses
    int16)."""
    flat = x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]).contiguous()
    rows = flat.shape[0]
    out = flat.new_empty((rows + extra_rows, *flat.shape[1:]))
    if rows:
        wire = torch.uint8 if flat.dtype == torch.bool else flat.dtype
        dist.all_to_all_single(out[:rows].view(wire), flat.view(wire), group=group)
    return out


class RouteIds(torch.autograd.Function):
    """``apply(req [S, cap], group)``: the requests every rank sent this one,
    ``[S, cap]`` (:func:`all_to_all_rows`); ids carry no gradient."""

    @staticmethod
    def forward(ctx, req, group):
        out = all_to_all_rows(req, group).view(req.shape)
        ctx.mark_non_differentiable(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return None, None


class RouteAnswers(torch.autograd.Function):
    """``apply(answers [S, cap, F], group, tail)``: the answers to this
    rank's requests, ``[S * cap + T, F]``, block ``d`` from owner ``d``, and
    ``tail [T, F]`` (rows the requester holds itself, no gradient; ``None``
    for none) copied after them. The backward routes the cotangent of the
    ``S * cap`` routed rows back to their owners (the reverse all-to-all)."""

    @staticmethod
    def forward(ctx, answers, group, tail):
        extra = 0 if tail is None else tail.shape[0]
        out = all_to_all_rows(answers, group, extra)
        if extra:
            out[out.shape[0] - extra:] = tail
        ctx.group, ctx.shape, ctx.extra = group, answers.shape, extra
        return out

    @staticmethod
    def backward(ctx, g):
        routed = g[:g.shape[0] - ctx.extra].reshape(ctx.shape)
        return all_to_all_rows(routed, ctx.group).view(ctx.shape), None, None


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
