"""Aggregation primitives: the counterpart of ``graphsage_tpu/ops/aggregate.py``.

Masked means and maxima over gathered neighborhoods (the minibatch path) and
CSR segment means and maxima (the full-graph path). The dispatchers keep the
JAX package's ``impl`` names so that configurations carry over:

* :func:`gather_mean` — ``"auto"`` and ``"onehot_pallas"`` run the
  gather-mean kernel (:mod:`graphsage_torch.ops.gather_mean`), ``"dma"`` the
  kernel with asynchronous row copies (:mod:`graphsage_torch.ops.gather_dma`);
  both backwards run the scatter-mean kernel. ``"take"`` and ``"unrolled"``
  are PyTorch ops.
* :func:`spmm_mean` — ``"auto"`` and ``"pallas_vmem"`` run the CSR SpMM
  kernel (:mod:`graphsage_torch.ops.spmm`) at any N, forward and backward;
  ``"xla"`` is a per-edge gather plus ``index_add_`` over the COO list.

Denominators follow the reference (quirk Q8): the number of *valid*
neighbors; rows with none give 0 (the guarded mean, quirk Q4). Every sum
here, and every scatter in a backward, accumulates in f32 whatever the
values' dtype and casts back: a bf16 running sum stalls once it reaches
about 256 times the addend (256 + 1 rounds to 256), and ``index_add_`` into
a bf16 tensor does the same. The maxima
give 0 to rows with no valid entry as well, and split the gradient evenly
among tied maxima, as JAX's ``max`` and ``segment_max`` do (``amax`` and
``scatter_reduce(..., "amax")``; ``torch.max(dim)`` would send all of it to
one index). Ties are common here: ReLU outputs are often exactly 0.
"""

from __future__ import annotations

import torch

from graphsage_torch.ops.gather_dma import gather_mean_dma as _gather_mean_dma_kernel
from graphsage_torch.ops.gather_mean import gather_mean as _gather_mean_kernel
from graphsage_torch.ops.spmm import spmm_mean as _spmm_mean_kernel

# The routes of spmm_mean.
SPMM_IMPLS = ("auto", "pallas_vmem", "xla")


class _Gather(torch.autograd.Function):
    """``index_select`` forward; backward ``index_add_`` into f32 zeros, cast
    to the table's dtype."""

    @staticmethod
    def forward(ctx, features, flat_ids):
        ctx.save_for_backward(flat_ids)
        ctx.shape, ctx.dtype = features.shape, features.dtype
        return features.index_select(0, flat_ids)

    @staticmethod
    def backward(ctx, grad):
        (flat_ids,) = ctx.saved_tensors
        dx = torch.zeros(ctx.shape, dtype=torch.float32, device=grad.device)
        return dx.index_add_(0, flat_ids, grad.to(torch.float32)).to(ctx.dtype), None


def gather(features: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Feature-store lookup: ``features[N, F]`` indexed by ``ids[...]``.

    ``index_select`` with an ``index_add_`` backward, not ``features[ids]``:
    indexing's backward sorts the ids and adds each run of equal ids in one
    warp, one row after another, and a frontier's masked slots name node 0
    tens of thousands of times (at the Pubmed preset's hop 1 on an H100,
    forward and backward: 14.1 ms against 0.14 ms; PERF.md). The backward
    sums in f32: the same padding piles thousands of terms on one bf16 row."""
    flat = _Gather.apply(features, ids.reshape(-1).long())
    return flat.reshape(*ids.shape, *features.shape[1:])


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``x[..., k, F]`` over axis -2, counting only ``mask[..., k]``;
    rows with zero valid entries give 0. Summed in f32; ``x``'s dtype."""
    m = mask.to(torch.float32)[..., None]
    total = (x.to(torch.float32) * m).sum(dim=-2)
    return (total / m.sum(dim=-2).clamp(min=1.0)).to(x.dtype)


def masked_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max of ``x[..., k, F]`` over axis -2 under ``mask[..., k]``; 0 where
    every entry is masked (the max-pooling aggregator's reduction)."""
    neg = torch.finfo(x.dtype).min
    out = torch.where(mask[..., None], x, neg).amax(dim=-2)
    return torch.where(mask.any(dim=-1, keepdim=True), out, 0.0)


def segment_mean_csr(
    values: torch.Tensor,
    edge_src: torch.Tensor,
    edge_mask: torch.Tensor,
    num_nodes: int,
) -> torch.Tensor:
    """Per-destination mean of per-edge ``values[E_pad, F]`` grouped by
    ``edge_src`` (COO rows). Padding edges (``edge_mask=False``) contribute 0.

    Both sums accumulate in f32 whatever the input dtype (a bf16 running sum
    stalls once it exceeds ~256x the addend); the result has ``values``'
    dtype.
    """
    w32 = edge_mask.to(torch.float32)
    src = edge_src.long()
    summed = torch.zeros(
        (num_nodes, values.shape[-1]), dtype=torch.float32, device=values.device
    ).index_add_(0, src, values.to(torch.float32) * w32[:, None])
    counts = torch.zeros(
        num_nodes, dtype=torch.float32, device=values.device
    ).index_add_(0, src, w32)
    return (summed / counts.clamp(min=1.0)[:, None]).to(values.dtype)


def segment_max_csr(
    values: torch.Tensor,
    edge_src: torch.Tensor,
    edge_mask: torch.Tensor,
    num_nodes: int,
) -> torch.Tensor:
    """Per-destination max of per-edge ``values[E_pad, F]`` grouped by
    ``edge_src``; rows with no valid edge give 0."""
    neg = torch.finfo(values.dtype).min
    masked = torch.where(edge_mask[:, None], values, neg)
    src = edge_src.long()[:, None].expand_as(values)
    maxed = values.new_full((num_nodes, values.shape[-1]), neg).scatter_reduce(
        0, src, masked, "amax", include_self=False)
    any_valid = torch.zeros(num_nodes, dtype=torch.int32, device=values.device
                            ).index_add_(0, edge_src.long(), edge_mask.to(torch.int32))
    return torch.where((any_valid > 0)[:, None], maxed, 0.0)


def gather_mean(
    features: torch.Tensor,
    idx: torch.Tensor,
    mask: torch.Tensor,
    impl: str = "auto",
    bf16: bool = False,
) -> torch.Tensor:
    """Fused ``masked_mean(features[idx], mask)`` -> ``[B, F]`` dispatcher.

    The kernel routes (``"auto"``, ``"onehot_pallas"``, ``"dma"``) take an
    f32 or bf16 table and return f32; ``"take"`` and ``"unrolled"`` return
    the table's dtype, as in the JAX package. ``bf16`` (round an f32 table
    to bf16 first) applies to the ``"auto"``/``"onehot_pallas"`` route only,
    as there.
    """
    if impl in ("auto", "onehot_pallas"):
        return _gather_mean_kernel(features, idx, mask, bf16=bf16)
    if impl == "unrolled":
        w = mask.to(torch.float32)
        acc = torch.zeros(
            (*idx.shape[:-1], features.shape[1]), dtype=torch.float32,
            device=features.device,
        )
        for j in range(idx.shape[-1]):
            acc = acc + gather(features, idx[..., j]).to(torch.float32) * w[..., j : j + 1]
        return (acc / w.sum(dim=-1, keepdim=True).clamp(min=1.0)).to(features.dtype)
    if impl == "take":
        return masked_mean(gather(features, idx), mask)
    if impl == "dma":
        return _gather_mean_dma_kernel(features, idx, mask)
    raise ValueError(f"unknown gather_mean impl {impl!r}")


def spmm_mean(
    features: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_mask: torch.Tensor,
    num_nodes: int,
    indptr: torch.Tensor | None = None,
    impl: str = "auto",
    symmetric: bool = True,
    num_edges: int | None = None,
    *,
    subset: bool = False,
    transpose: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Full-graph mean aggregation ``out[v] = mean_{(v,u) in E} features[u]``
    (the row-normalized SpMM ``D^-1 A X``) in the features' dtype, summed in
    f32, as JAX's ``"auto"`` (``"xla"``) returns it. ``symmetric``
    (``Graph.symmetric``) picks the kernel route's backward; ``num_edges``
    (``Graph.num_edges``) lets it count its bytes.

    ``subset``: the edges are those of ``num_nodes`` rows of the table's
    adjacency (a :class:`~graphsage_torch.data.graph.RowBlock`: ``edge_src``
    local row ids, ``indptr`` their CSR), and the result is ``[num_nodes,
    F]``; ``transpose``, the CSR of the rows' transpose, lets the kernel
    route's backward run kernel 3 (:func:`graphsage_torch.ops.spmm.spmm_mean`)."""
    if impl in ("auto", "pallas_vmem"):
        if indptr is None:
            raise ValueError(f"spmm_mean impl={impl!r} requires indptr")
        return _spmm_mean_kernel(features, indptr, edge_dst, symmetric=symmetric,
                                 num_edges=num_edges, subset=subset, transpose=transpose)
    if impl == "xla":
        return segment_mean_csr(gather(features, edge_dst), edge_src, edge_mask, num_nodes)
    raise ValueError(f"unknown spmm_mean impl {impl!r}")
