"""GraphSAGE with the max-pooling aggregator, written out plainly (Hamilton,
Ying and Leskovec, NeurIPS 2017, §3.3, Eq. 3; Algorithm 1 in its one-weight
form): layer ``l`` pools every node's row, ``p = relu(h @ Wp_l + bp_l)``,
takes the elementwise max of ``p`` over each node's neighbours (0 for a node
with none), and maps the node to ``relu(CONCAT(h_v, max) @ W_l)``; ``W_l``'s
first ``d_in`` rows take the node's own ``h``. A linear head gives the
logits; the loss is the mean softmax cross-entropy over the train split.
Float32 with TF32 off; the products go through
:func:`perfbench.reference.precision.mm`.

The max runs over the benchmark's own edge list (:class:`~perfbench.
reference.model.Csr`), in blocks of ``EDGE_BLOCK`` edges so that one
gathered block (2^20 rows of 512 f32, 2 GiB) fits beside the rest on the
card; the edge list is sorted by row, so each block's rows reduce in order,
without atomics. The max's gradient goes to the neighbour that holds it;
where ``k`` neighbours tie, ``1/k`` of it to each (:class:`CsrMax`).

It imports neither ``jax`` nor ``graphsage_tpu`` nor anything of
``graphsage_torch``.
"""

from __future__ import annotations

import torch

from perfbench.reference.model import Csr
from perfbench.reference.precision import mm, no_tf32

EDGE_BLOCK = 1 << 20


def _blocks(csr: Csr):
    """Each block of the sorted edge list: its edges' rows and neighbours,
    and the rows it holds with their edge counts (a row may continue in the
    next block)."""
    for lo in range(0, csr.src.numel(), EDGE_BLOCK):
        src, dst = csr.src[lo:lo + EDGE_BLOCK], csr.dst[lo:lo + EDGE_BLOCK]
        rows, lengths = torch.unique_consecutive(src, return_counts=True)
        yield src, dst, rows, lengths


class CsrMax(torch.autograd.Function):
    """``out[v] = max of x[u]`` over the neighbours ``u`` of ``v`` (0 for a
    node with none), each block's rows reduced in order (no atomics) and
    merged into the rows so far; the backward sends ``g[v] / k`` to each of
    the ``k`` neighbours whose value equals the max, column by column."""

    @staticmethod
    def forward(ctx, x, csr: Csr):
        out = torch.full_like(x, float("-inf"))
        for _, dst, rows, lengths in _blocks(csr):
            part = torch.segment_reduce(x.index_select(0, dst), "max", lengths=lengths,
                                        unsafe=True)
            out[rows] = torch.maximum(out[rows], part)
        out = torch.where((csr.degrees > 0)[:, None], out, 0.0)
        ties = torch.zeros_like(x)
        for src, dst, rows, lengths in _blocks(csr):
            hit = (x.index_select(0, dst) == out.index_select(0, src)).to(x.dtype)
            ties[rows] += torch.segment_reduce(hit, "sum", lengths=lengths, unsafe=True)
        ctx.csr = csr
        ctx.save_for_backward(x, out, ties)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out, ties = ctx.saved_tensors
        share = g / ties.clamp(min=1.0)
        dx = torch.zeros_like(x)
        for src, dst, _, _ in _blocks(ctx.csr):
            hit = x.index_select(0, dst) == out.index_select(0, src)
            dx.index_add_(0, dst, torch.where(hit, share.index_select(0, src), 0.0))
        return dx, None


def full_logits(x: torch.Tensor, csr: Csr, layers: list, head: torch.Tensor,
                precision: str = "f32", concat_self: bool = True) -> torch.Tensor:
    """Every node's logits; ``layers`` holds ``(W, Wp, bp)`` per layer.
    Without ``concat_self`` a layer maps the max alone."""
    no_tf32()
    h = x.to(torch.float32)
    for w, wp, bp in layers:
        agg = CsrMax.apply(torch.relu(mm(h, wp, precision) + bp), csr)
        h = torch.relu(mm(torch.cat([h, agg], dim=1) if concat_self else agg, w, precision))
    return mm(h, head, precision)
