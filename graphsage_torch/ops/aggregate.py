"""Aggregation primitives: the counterpart of ``graphsage_tpu/ops/aggregate.py``.

Masked means over gathered neighborhoods (the minibatch path) and CSR
segment means (the full-graph path). The dispatchers keep the JAX package's
``impl`` names so that configurations carry over:

* :func:`gather_mean` — ``"auto"`` and ``"onehot_pallas"`` run the
  gather-mean kernel (:mod:`graphsage_torch.ops.gather_mean`), ``"dma"`` the
  kernel with asynchronous row copies (:mod:`graphsage_torch.ops.gather_dma`);
  both backwards run the scatter-mean kernel. ``"take"`` and ``"unrolled"``
  are PyTorch ops.
* :func:`spmm_mean` — ``"auto"`` and ``"pallas_vmem"`` run the CSR SpMM
  kernel (:mod:`graphsage_torch.ops.spmm`) at any N, forward and backward;
  ``"xla"`` is a per-edge gather plus ``index_add_`` over the COO list.

Denominators follow the reference (quirk Q8): the number of *valid*
neighbors; rows with none give 0 (the guarded mean, quirk Q4).
"""

from __future__ import annotations

import torch

from graphsage_torch.ops.gather_dma import gather_mean_dma as _gather_mean_dma_kernel
from graphsage_torch.ops.gather_mean import gather_mean as _gather_mean_kernel
from graphsage_torch.ops.spmm import spmm_mean as _spmm_mean_kernel


def gather(features: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Feature-store lookup: ``features[N, F]`` indexed by ``ids[...]``."""
    return features[ids.long()]


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``x[..., k, F]`` over axis -2, counting only ``mask[..., k]``;
    rows with zero valid entries give 0."""
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(dim=-2) / m.sum(dim=-2).clamp(min=1.0)


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


def gather_mean(
    features: torch.Tensor,
    idx: torch.Tensor,
    mask: torch.Tensor,
    impl: str = "auto",
    bf16: bool = False,
) -> torch.Tensor:
    """Fused ``masked_mean(features[idx], mask)`` -> ``[B, F]`` dispatcher.

    ``bf16`` applies to the ``"auto"``/``"onehot_pallas"`` route only, as in
    the JAX package; ``"dma"`` reads the table as f32.
    """
    if impl in ("auto", "onehot_pallas"):
        return _gather_mean_kernel(features, idx, mask, bf16=bf16)
    if impl == "unrolled":
        w = mask.to(features.dtype)
        acc = torch.zeros(
            (*idx.shape[:-1], features.shape[1]), dtype=features.dtype,
            device=features.device,
        )
        for j in range(idx.shape[-1]):
            acc = acc + gather(features, idx[..., j]) * w[..., j : j + 1]
        return acc / w.sum(dim=-1, keepdim=True).clamp(min=1.0)
    if impl == "take":
        return masked_mean(gather(features, idx), mask)
    if impl == "dma":
        return _gather_mean_dma_kernel(features.to(torch.float32), idx, mask)
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
) -> torch.Tensor:
    """Full-graph mean aggregation ``out[v] = mean_{(v,u) in E} features[u]``
    (the row-normalized SpMM ``D^-1 A X``), f32 on the kernel route.
    ``symmetric`` (``Graph.symmetric``) picks the kernel route's backward."""
    if impl in ("auto", "pallas_vmem"):
        if indptr is None:
            raise ValueError(f"spmm_mean impl={impl!r} requires indptr")
        return _spmm_mean_kernel(features.to(torch.float32), indptr, edge_dst,
                                 symmetric=symmetric)
    if impl == "xla":
        return segment_mean_csr(gather(features, edge_dst), edge_src, edge_mask, num_nodes)
    raise ValueError(f"unknown spmm_mean impl {impl!r}")
