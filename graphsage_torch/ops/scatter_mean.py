"""Masked scatter-mean, the gather-mean backward: Hopper kernel 2
(``csrc/scatter_mean.cu``), the port of
``graphsage_tpu/ops/pallas_onehot.py:_scatter_kernel``.

``scatter_mean(g[B, F], idx[B, k], mask[B, k], num_rows) -> [num_rows, F]``
f32, the feature cotangent of :func:`graphsage_torch.ops.gather_mean.gather_mean`:

    dX[idx[b, j]] += g[b] / max(sum_j mask[b, j], 1)   for each valid (b, j)

Repeated ids sum. A CUDA tensor goes to the kernel (or an exception); a CPU
tensor goes to the plain PyTorch version :func:`scatter_mean_plain`, which
also serves as the reference the kernel is held against on the card. Ids in
masked slots are never read and may hold anything; ids in valid slots must
lie in ``[0, num_rows)``. The kernel sums with atomics, in an order that
changes from run to run.

The kernel's entry point writes the whole output, zeros included (a
zeroing kernel, then the scatter kernel, on the stream), so the wrapper
allocates it with ``torch.empty``.
"""

from __future__ import annotations

import torch

from graphsage_torch.ops import _build

# Kernel launches since the last reset (a run sets it to 0 and reads it back
# to show that its path went through the kernel).
launches = 0


def scatter_mean_plain(
    g: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """The plain PyTorch version: per-slot rows ``g[b] / cnt[b]`` for the
    valid slots, ``index_add_`` into zeros, in f32."""
    k = idx.shape[1]
    cnt = mask.sum(dim=1, keepdim=True).clamp(min=1).to(torch.float32)
    per_slot = (g.to(torch.float32) / cnt).repeat_interleave(k, dim=0)
    valid = mask.reshape(-1)
    return torch.zeros(
        (num_rows, g.shape[1]), dtype=torch.float32, device=g.device
    ).index_add_(0, idx.reshape(-1)[valid].long(), per_slot[valid])


def _check(g: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor) -> None:
    if g.dim() != 2:
        raise ValueError(f"g must be [B, F], got {tuple(g.shape)}")
    if idx.dim() != 2 or idx.shape != mask.shape or idx.shape[0] != g.shape[0]:
        raise ValueError(
            f"idx and mask must both be [B, k] with B = {g.shape[0]}, got "
            f"{tuple(idx.shape)} and {tuple(mask.shape)}"
        )
    if g.dtype != torch.float32:
        raise TypeError(f"g must be float32, got {g.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if not (g.device == idx.device == mask.device):
        raise ValueError(
            f"g, idx and mask lie on {g.device}, {idx.device} and {mask.device}"
        )
    if not (g.is_contiguous() and idx.is_contiguous() and mask.is_contiguous()):
        raise ValueError("g, idx and mask must be contiguous")


def _launch(g: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
            num_rows: int) -> torch.Tensor:
    global launches
    b, k = idx.shape
    f = g.shape[1]
    if b == 0 or f == 0 or k == 0:  # nothing to scatter
        return torch.zeros((num_rows, f), dtype=torch.float32, device=g.device)
    dx = torch.empty((num_rows, f), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        err = _build.library().gsage_scatter_mean_f32(
            g.data_ptr(), idx.data_ptr(), mask.data_ptr(), dx.data_ptr(),
            num_rows, b, k, f, stream,
        )
    _build.check(err, "scatter_mean kernel")
    launches += 1
    return dx


def scatter_mean(
    g: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Masked scatter-mean ``[num_rows, F]`` f32 (see module docstring)."""
    _check(g, idx, mask)
    if g.device.type == "cpu":
        return scatter_mean_plain(g, idx, mask, num_rows)
    if g.device.type != "cuda":
        raise ValueError(f"no scatter_mean for device {g.device}")
    return _launch(g, idx, mask, num_rows)
