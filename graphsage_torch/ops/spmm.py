"""CSR mean-SpMM: Hopper kernel 3 (``csrc/spmm_mean.cu``), the port of
``graphsage_tpu/ops/pallas_spmm.py:_kernel``.

``spmm_mean(features[N, F], indptr[N+1], edge_dst[E_pad]) -> [N, F]`` f32:

    out[v] = scale(v) * sum_{e in [indptr[v], indptr[v+1])} features[edge_dst[e]]

with ``scale(v) = 1 / max(deg v, 1)`` under ``normalize`` (the mean) and 1
without it (the plain sum). Only ``edge_dst[:indptr[N]]`` is read, so padded
edges never count. The kernel splits the row ends and edges into equal
chunks (merge path, :func:`chunking`), so a hub row is shared by many warps;
its pieces are summed in a fixed order, and the result is bitwise repeatable.

The backward follows ``graphsage_tpu/ops/pallas_spmm.py:_bwd``: with
``gs = g / max(deg, 1)`` (under ``normalize``), a symmetric adjacency gives
``dX = A gs``, the same kernel with ``normalize=False``; a directed one gives
the transpose ``dX = A^T gs``, a plain ``index_add_`` on either device (the
JAX package leaves it to XLA). Both devices go through one
``autograd.Function``, so the CPU runs the card's backward formula.

A CUDA tensor goes to the kernel (or an exception); a CPU tensor goes to
the plain PyTorch version :func:`spmm_mean_plain`, which also serves as the
reference the kernel is held against on the card. ``indptr`` must be a
valid CSR offset array into ``edge_dst`` and every used id must lie in
``[0, N)``, as :func:`graphsage_torch.data.graph.build_graph` guarantees.
"""

from __future__ import annotations

import torch

from graphsage_torch.ops import _build

# Kernel launches since the last reset (a run sets it to 0 and reads it back
# to show that its path went through the kernel).
launches = 0


def spmm_mean_plain(
    features: torch.Tensor,
    indptr: torch.Tensor,
    edge_dst: torch.Tensor,
    normalize: bool = True,
) -> torch.Tensor:
    """The plain PyTorch version: per-edge row gather + ``index_add_`` in f32."""
    n = indptr.numel() - 1
    deg = (indptr[1:] - indptr[:-1]).long()
    e = int(indptr[-1])
    src = torch.repeat_interleave(torch.arange(n, device=features.device), deg)
    rows = features[edge_dst[:e].long()].to(torch.float32)
    out = torch.zeros((n, features.shape[1]), dtype=torch.float32,
                      device=features.device).index_add_(0, src, rows)
    if normalize:
        out = out / deg.clamp(min=1).to(torch.float32)[:, None]
    return out


def spmm_transpose_plain(
    g: torch.Tensor, indptr: torch.Tensor, edge_dst: torch.Tensor
) -> torch.Tensor:
    """``A^T g`` for the CSR adjacency ``A``: ``out[edge_dst[e]] += g[v]`` for
    each edge ``e`` of row ``v``, f32 (the directed backward)."""
    n = indptr.numel() - 1
    deg = (indptr[1:] - indptr[:-1]).long()
    e = int(indptr[-1])
    src = torch.repeat_interleave(torch.arange(n, device=g.device), deg)
    return torch.zeros((n, g.shape[1]), dtype=torch.float32,
                       device=g.device).index_add_(0, edge_dst[:e].long(),
                                                   g.to(torch.float32)[src])


def _check(features: torch.Tensor, indptr: torch.Tensor, edge_dst: torch.Tensor) -> None:
    if features.dim() != 2:
        raise ValueError(f"features must be [N, F], got {tuple(features.shape)}")
    if indptr.dim() != 1 or indptr.numel() != features.shape[0] + 1:
        raise ValueError(
            f"indptr must be [N+1] = [{features.shape[0] + 1}], got "
            f"{tuple(indptr.shape)}"
        )
    if edge_dst.dim() != 1:
        raise ValueError(f"edge_dst must be 1-D, got {tuple(edge_dst.shape)}")
    if features.dtype != torch.float32:
        raise TypeError(f"features must be float32, got {features.dtype}")
    if indptr.dtype != torch.int32 or edge_dst.dtype != torch.int32:
        raise TypeError(
            f"indptr and edge_dst must be int32, got {indptr.dtype} and "
            f"{edge_dst.dtype}"
        )
    if not (features.device == indptr.device == edge_dst.device):
        raise ValueError(
            f"features, indptr and edge_dst lie on {features.device}, "
            f"{indptr.device} and {edge_dst.device}"
        )
    if not (features.is_contiguous() and indptr.is_contiguous()
            and edge_dst.is_contiguous()):
        raise ValueError("features, indptr and edge_dst must be contiguous")


# About 31 warps for each of the H100's 132 SMs: the kernel is bound by the
# latency of each warp's dependent loads, so more, shorter chunks run faster
# until the per-chunk search and carry cost more than they save.
TARGET_CHUNKS = 4096
MIN_CHUNK, MAX_CHUNK = 16, 512  # MAX_CHUNK: a block's windows fit 48 KB


def chunking(num_items: int) -> tuple[int, int]:
    """``(chunk, num_chunks)``: the kernel's merge-path split of ``num_items``
    row ends and edges into equal chunks, one warp each, about
    ``TARGET_CHUNKS`` of them."""
    chunk = min(MAX_CHUNK, max(MIN_CHUNK, -(-num_items // TARGET_CHUNKS)))
    return chunk, max(1, -(-num_items // chunk))


def _launch(features, indptr, edge_dst, normalize: bool) -> torch.Tensor:
    global launches
    n, f = features.shape
    out = torch.empty((n, f), dtype=torch.float32, device=features.device)
    if n == 0 or f == 0:
        return out
    # E = indptr[N] lives on the card; edge_dst's length bounds it, and the
    # chunks past the last item return at once.
    items = n + edge_dst.numel()
    if items >= 2**31:
        raise ValueError(f"spmm_mean kernel: N + E_pad = {items} needs 64-bit offsets")
    chunk, num_chunks = chunking(items)
    # Per chunk: one F-wide f32 carry row, then one int32 row id. Freed on
    # return: the caching allocator gives it out again only to work queued
    # after these kernels on this stream.
    scratch = torch.empty(num_chunks * (f + 1), dtype=torch.float32,
                          device=features.device)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    with torch.cuda.device(features.device):
        err = _build.library().gsage_spmm_mean_f32(
            features.data_ptr(), indptr.data_ptr(), edge_dst.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), n, f, int(normalize), chunk,
            num_chunks, stream,
        )
    _build.check(err, "spmm_mean kernel")
    launches += 1
    return out


class _SpmmMean(torch.autograd.Function):
    """``forward(features, indptr, edge_dst, normalize, symmetric, fwd)``
    runs ``fwd`` (the kernel wrapper or the plain version); see the module
    docstring for the backward."""

    @staticmethod
    def forward(ctx, features, indptr, edge_dst, normalize, symmetric, fwd):
        ctx.save_for_backward(indptr, edge_dst)
        ctx.normalize, ctx.symmetric, ctx.fwd = normalize, symmetric, fwd
        return fwd(features, indptr, edge_dst, normalize)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
        indptr, edge_dst = ctx.saved_tensors
        gs = grad.to(torch.float32)
        if ctx.normalize:
            deg = (indptr[1:] - indptr[:-1]).clamp(min=1).to(torch.float32)
            gs = gs / deg[:, None]
        gs = gs.contiguous()
        if ctx.symmetric:
            dx = ctx.fwd(gs, indptr, edge_dst, False)
        else:
            dx = spmm_transpose_plain(gs, indptr, edge_dst)
        return dx, None, None, None, None, None


def spmm_mean(
    features: torch.Tensor,
    indptr: torch.Tensor,
    edge_dst: torch.Tensor,
    normalize: bool = True,
    symmetric: bool = True,
) -> torch.Tensor:
    """CSR (mean-)SpMM ``[N, F]`` f32 (see module docstring). ``symmetric``
    says that the adjacency equals its transpose, which picks the backward."""
    _check(features, indptr, edge_dst)
    if features.device.type == "cpu":
        fwd = spmm_mean_plain
    elif features.device.type == "cuda":
        fwd = _launch
    else:
        raise ValueError(f"no spmm_mean for device {features.device}")
    return _SpmmMean.apply(features, indptr, edge_dst, normalize, symmetric, fwd)
