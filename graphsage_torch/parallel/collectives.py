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

The halo exchange (:mod:`graphsage_torch.parallel.halo`) moves rows with
three collectives, each an ``autograd.Function`` with its transpose:
:class:`AllGatherRows` (backward: the sum reduce-scatter),
:class:`AllToAllRows` (its own transpose) and :class:`PermuteRows` (one
ppermute round; backward: the inverse shift).
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
    ``extra_rows`` after them are left for the caller to fill. A bool or
    int8 payload travels as its bytes (``uint8``); gloo moves CUDA tensors
    too (probed on the H100 for int32, uint8, bool, f32 and bf16; it refuses
    int16)."""
    flat = x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]).contiguous()
    rows = flat.shape[0]
    out = flat.new_empty((rows + extra_rows, *flat.shape[1:]))
    if rows:
        wire = torch.uint8 if flat.dtype in (torch.bool, torch.int8) else flat.dtype
        dist.all_to_all_single(out[:rows].view(wire), flat.view(wire), group=group)
    return out


def permute_rows(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """``x`` sent to rank ``(r + shift) % S`` of the group; returns the rows
    rank ``(r - shift) % S`` sent (the same shape). Every rank calls it with
    the same ``shift`` and shape. One ``all_to_all_single`` with a single
    non-zero split each way, on every backend: gloo's point-to-point
    ``send``/``recv`` reads a CUDA tensor's device address as host memory
    (probed on the H100: ``writev ... Bad address``), its all-to-all copies
    through the host."""
    s, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    if shift % s == 0:
        return x.clone()
    out = torch.empty_like(x)
    m = x.shape[0]
    send = [m if d == (r + shift) % s else 0 for d in range(s)]
    recv = [m if d == (r - shift) % s else 0 for d in range(s)]
    dist.all_to_all_single(out, x, recv, send, group=group)
    return out


class AllGatherRows(torch.autograd.Function):
    """``apply(x [B, ...], group, replicated=False)``: every rank's ``x`` in
    rank order, ``[S * B, ...]``; the backward sums the cotangent's blocks
    over the ranks and returns block ``rank`` (reduce-scatter). With
    ``replicated`` the result feeds a computation every rank repeats (its
    cotangent is the same everywhere), and the backward takes block ``rank``
    of the rank's own cotangent instead."""

    @staticmethod
    def forward(ctx, x, group, replicated=False):
        ctx.group, ctx.replicated, ctx.rows = group, replicated, x.shape[0]
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.replicated:
            r = dist.get_rank(ctx.group)
            return g[r * ctx.rows:(r + 1) * ctx.rows], None, None
        return reduce_scatter_rows(g, ctx.group), None, None


def _swap_blocks(x: torch.Tensor, group) -> torch.Tensor:
    return all_to_all_rows(x.reshape(dist.get_world_size(group), -1, *x.shape[1:]), group)


class AllToAllRows(torch.autograd.Function):
    """``apply(x [S * B, ...], group)``: block ``d`` of ``x`` goes to rank
    ``d``, and block ``d`` of the result came from rank ``d`` (JAX's
    ``all_to_all(split_axis=0, concat_axis=0, tiled=False)``); the same
    exchange is its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _swap_blocks(x, group)

    @staticmethod
    def backward(ctx, g):
        return _swap_blocks(g, ctx.group), None


class PermuteRows(torch.autograd.Function):
    """``apply(x, group, offset)``: JAX's ``ppermute`` of one per-offset
    round, rank ``t`` sending ``x`` to ``(t - offset) % S`` and receiving
    from ``(t + offset) % S``; the backward sends the cotangent the other
    way, ``t -> (t + offset) % S``."""

    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        return permute_rows(x, group, -offset)

    @staticmethod
    def backward(ctx, g):
        return permute_rows(g, ctx.group, ctx.offset), None, None


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
    ``S * cap`` routed rows back to their owners (the reverse all-to-all).
    An int8 table's answers travel as two of these, its ``q`` rows and its
    ``[S, cap, 1]`` scales, neither with a gradient (the table is frozen)."""

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
